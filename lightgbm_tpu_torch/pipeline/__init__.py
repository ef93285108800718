"""Continuous refit-and-promote: the self-updating serving loop (port
of ``lightgbm_tpu/pipeline/``, the same modules and ``__all__``).

Every piece of the production loop exists elsewhere in the port —
``Booster.refit`` and ``train(init_model=)`` (incremental training),
``engine.train_many`` (tenant batches), bit-identical checkpoints
(``robustness/checkpoint.py``), the fleet registry and deterministic
canary/shadow router (``serving/fleet.py``, ``serving/router.py``), the
live metrics plane and flight recorder (``observability/``), end-to-end
tracing — and this package connects them into the loop a deployment
runs:

    tail traffic -> refit -> checkpoint -> publish -> canary ramp
        -> promote (or auto-rollback)     ... repeat, forever.

Modules:

* :mod:`~lightgbm_tpu_torch.pipeline.logsource` — labeled training windows
  from a deterministic replay stream (drift injected via the
  ``robustness/faults.py`` grammar) or by tailing a serving-log JSONL.
* :mod:`~lightgbm_tpu_torch.pipeline.trainer` — turns a labeled window into
  a candidate model by leaf-value/coefficient refit or continued
  training, checkpointing each candidate.
* :mod:`~lightgbm_tpu_torch.pipeline.publisher` — registers candidates into
  the fleet's model registry with atomic hot reload; a rejected
  publish marks the candidate rejected and degrades fleet health.
* :mod:`~lightgbm_tpu_torch.pipeline.ramp` — drives the canary router
  through configured traffic stages, watches latency/quality/parity/
  flight-recorder signals and auto-rolls back on regression; the
  promote/rollback decision itself is a pure function
  (:func:`~lightgbm_tpu_torch.pipeline.ramp.evaluate_stage`).
* :mod:`~lightgbm_tpu_torch.pipeline.driver` — the long-lived
  ``task=pipeline`` process: preemption-safe, every stage a span on
  the trace timeline and a ``lgbm_pipeline_stage{stage}`` gauge.

The JAX package's docs/Pipeline.md gives the stage diagram and the
rollback semantics, which the port keeps.
"""

from .driver import PipelineDriver, run_pipeline
from .logsource import LabeledWindow, ReplayLogSource, TailLogSource
from .publisher import Publisher
from .ramp import (RampController, RampThresholds, StageMetrics,
                   StageVerdict, evaluate_stage)
from .trainer import Candidate, RefitTrainer

__all__ = [
    "Candidate", "LabeledWindow", "PipelineDriver", "Publisher",
    "RampController", "RampThresholds", "RefitTrainer",
    "ReplayLogSource", "StageMetrics", "StageVerdict", "TailLogSource",
    "evaluate_stage", "run_pipeline",
]
