"""Non-finite guards and loss-spike detection for the boosting loop
(port of ``lightgbm_tpu/robustness/guards.py``).

Custom objectives, extreme learning rates and bad rows produce NaN/inf
gradients; left unchecked they poison the score buffer and every later
tree silently. The guard is one device reduction over the
gradient/hessian pair, ``isfinite(g).all() & isfinite(h).all()``, after
the gradients, then one host read of its bool — one dispatch and one
sync an iteration, checked when ``guard_policy`` is enabled. (JAX's
``_finite_ok`` is an XLA program, not a Pallas kernel, and JAX folds it
into its gradient program; the port keeps it one reduction.)

Policies (``guard_policy`` config param):

* ``raise``     — abort training with :class:`NonFiniteGradientError`.
* ``skip_iter`` — record the event, append a no-op constant tree for
  the iteration and keep going (the model stays aligned with the
  iteration counter).
* ``rollback``  — restore the last valid checkpoint and re-seed the
  iteration counter from it (the training driver owns the restore; the
  guard raises with ``policy='rollback'`` to request it). Bounded by
  ``guard_max_rollbacks`` per run so a deterministic failure cannot
  loop forever.

Loss-spike detection (``guard_loss_spike`` config param, factor > 1):
at every eval boundary, a smaller-is-better metric jumping above
``factor`` x its previous value (or going non-finite) counts a
``guard.loss_spikes`` event and applies the policy.

Telemetry: ``guard.nonfinite_iters``, ``guard.skipped_iters``,
``guard.loss_spikes``, ``guard.rollbacks``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from ..utils.log import LightGBMError, log_warning

GUARD_POLICIES = ("off", "raise", "skip_iter", "rollback")


class NonFiniteGradientError(LightGBMError):
    """Non-finite gradients/hessians detected at one iteration. The
    ``policy`` field tells the training driver what was requested
    (``raise`` propagates; ``rollback`` asks for a checkpoint
    restore)."""

    def __init__(self, iteration: int, policy: str,
                 what: str = "gradients"):
        super().__init__(
            f"non-finite {what} at iteration {iteration} "
            f"(guard_policy={policy})")
        self.iteration = iteration
        self.policy = policy
        self.what = what
        # black box first, handling second: even a trip a rollback
        # recovers from dumps the faulting iteration's ring records
        # before they age out (observability/flightrec.py; no-op when
        # no recorder is armed)
        from ..observability.flightrec import record_guard_trip
        record_guard_trip("nonfinite", iteration, policy=policy,
                          what=what)


class LossSpikeError(LightGBMError):
    """Eval metric spiked past the configured factor under
    ``guard_policy=raise``."""

    def __init__(self, iteration: int, dataset: str, metric: str,
                 value: float, prev: float, factor: float):
        super().__init__(
            f"loss spike at iteration {iteration}: {dataset} {metric} "
            f"= {value:g} (previous {prev:g}, factor {factor:g})")
        self.iteration = iteration


def finite_ok_device(grad, hess):
    """The all-finite reduction over one iteration's gradient pair, a
    bool tensor on the gradients' device (no host read)."""
    import torch
    return torch.isfinite(grad).all() & torch.isfinite(hess).all()


def finite_ok(grad, hess) -> bool:
    """``finite_ok_device``, then its one host read."""
    return bool(finite_ok_device(grad, hess).item())


class LossSpikeDetector:
    """Tracks previous values per (dataset, metric) and flags spikes on
    smaller-is-better metrics. Stateful across iterations; rollback
    restores do NOT clear it (a restored iteration re-producing the
    same spike should still be visible)."""

    def __init__(self, factor: float):
        self.factor = float(factor)
        self._prev: Dict[Tuple[str, str], float] = {}

    @property
    def enabled(self) -> bool:
        return self.factor > 1.0

    def check(self, iteration: int, results) -> Optional[Tuple]:
        """``results``: [(dataset, metric, value, bigger_better), ...]
        from one eval boundary. Returns the first spiking entry as
        ``(dataset, metric, value, prev)`` or None; updates state."""
        if not self.enabled:
            return None
        spike = None
        for ds, metric, value, bigger in results or []:
            if bigger:      # spike detection targets losses
                continue
            key = (ds, metric)
            prev = self._prev.get(key)
            v = float(value)
            if not math.isfinite(v):
                if spike is None:
                    spike = (ds, metric, v, prev if prev is not None
                             else float("nan"))
            elif prev is not None and math.isfinite(prev) \
                    and v > max(prev, 1e-30) * self.factor:
                if spike is None:
                    spike = (ds, metric, v, prev)
            # only finite values become the new baseline
            if math.isfinite(v):
                self._prev[key] = v
        if spike is not None:
            from ..observability.telemetry import get_telemetry
            get_telemetry().count("guard.loss_spikes")
            ds, metric, v, prev = spike
            log_warning(f"guard: loss spike at iteration {iteration}: "
                        f"{ds} {metric} = {v:g} (previous {prev:g}, "
                        f"factor {self.factor:g})")
            from ..observability.flightrec import record_guard_trip
            record_guard_trip("loss_spike", iteration, dataset=ds,
                              metric=metric, value=v, prev=prev,
                              factor=self.factor)
        return spike
