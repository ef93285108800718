"""Fault-tolerant training for the PyTorch port (copy of the layout of
``lightgbm_tpu/robustness/``, docs/Robustness.md):

* :mod:`.checkpoint` — atomic versioned checkpoints, bitwise resume,
  keep-last-K retention, atomic file writers; over ranks the
  coordinated two-phase checkpoint and the N -> M reshard.
* :mod:`.elastic`    — the multi-rank watchdog: heartbeats, classified
  bounded aborts (``ElasticError``, exit code 43).
* :mod:`.preempt`    — SIGTERM/SIGINT to graceful checkpoint-and-stop.
* :mod:`.guards`     — the non-finite gradient guard
  (``raise | skip_iter | rollback``) and loss-spike detection.
* :mod:`.retry`      — bounded jittered-exponential-backoff wrapper
  for checkpoint and model reads.
* :mod:`.faults`     — the deterministic fault-injection harness
  (``LGBM_TPU_FAULTS`` / the ``faults`` param), the rank kinds included.
"""

from .faults import (FaultPlan, fault_plan_active, get_fault_plan,
                     set_fault_plan)
from .guards import (GUARD_POLICIES, LossSpikeDetector, LossSpikeError,
                     NonFiniteGradientError, finite_ok)
from .preempt import PreemptionGuard
from .retry import backoff_delays, retry_call

__all__ = [
    "FaultPlan", "fault_plan_active", "get_fault_plan",
    "set_fault_plan", "GUARD_POLICIES", "LossSpikeDetector",
    "LossSpikeError", "NonFiniteGradientError", "finite_ok",
    "PreemptionGuard", "backoff_delays", "retry_call",
]
