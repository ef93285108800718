"""Traffic routing for the fleet: weighted canary splits + shadowing
(copy of ``lightgbm_tpu/serving/router.py`` for the PyTorch port: the
same decisions for the same rules; the fleet that executes them comes
with ROADMAP.md Queue 1 item 10.2).

Every request names a logical **model** (the fleet default when
omitted); the router resolves it to the concrete registry entry that
should serve it:

* **canary split** — a rule ``model -> (canary_target, weight)`` sends
  exactly ``weight`` of the traffic to the canary variant. The split is
  a *deterministic weighted round-robin* (an error-diffusion
  accumulator, not a coin flip): over any window of N requests the
  canary receives ``round(N * weight)`` of them, so weight 0 is
  *never* and weight 1 is *always* — exact semantics tests and
  gradual rollouts both rely on.
* **shadow mirror** — a rule ``model -> shadow_target`` duplicates the
  request to the shadow model. Shadow responses are compared against
  the primary for parity (counted, logged on mismatch) and **never
  returned to the caller**; a missing or draining shadow target is
  counted and skipped, never an error on the primary path.
* **promotion** — ``promote(model)`` atomically makes the canary
  target the primary (weight resets to 0); the old primary keeps
  serving in-flight requests through the registry's draining
  machinery.

The router is pure decision logic — the
fleet engine (item 10.2) owns execution
(replica choice, shadow dispatch, parity bookkeeping).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from ..utils.log import log_info


class RouteDecision:
    """Resolved routing for one request."""

    __slots__ = ("model", "target", "is_canary", "shadow")

    def __init__(self, model: str, target: str, is_canary: bool = False,
                 shadow: Optional[str] = None):
        self.model = model          # the logical name the caller used
        self.target = target        # the registry entry that serves it
        self.is_canary = is_canary
        self.shadow = shadow        # mirror target or None

    def describe(self) -> Dict[str, Any]:
        return {"model": self.model, "target": self.target,
                "is_canary": self.is_canary, "shadow": self.shadow}


class _Rule:
    __slots__ = ("primary", "canary", "weight", "acc", "shadow")

    def __init__(self):
        self.primary: Optional[str] = None   # None -> the model itself
        self.canary: Optional[str] = None
        self.weight = 0.0
        self.acc = 0.0              # error-diffusion accumulator
        self.shadow: Optional[str] = None


class Router:
    """Per-model canary/shadow rules; thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: Dict[str, _Rule] = {}

    def _rule(self, model: str) -> _Rule:
        r = self._rules.get(model)
        if r is None:
            r = self._rules[model] = _Rule()
        return r

    # -- configuration -------------------------------------------------
    def set_canary(self, model: str, target: Optional[str],
                   weight: float = 0.0) -> None:
        """Split ``weight`` in [0, 1] of ``model`` traffic to
        ``target``; ``target=None`` (or weight 0 with no target)
        clears the rule."""
        w = float(weight)
        if not (0.0 <= w <= 1.0):
            raise ValueError(
                f"canary weight must be in [0, 1], got {w}")
        with self._lock:
            r = self._rule(model)
            r.canary = target or None
            r.weight = w if target else 0.0
            r.acc = 0.0

    def set_shadow(self, model: str, target: Optional[str]) -> None:
        """Mirror ``model`` traffic to ``target`` (None clears)."""
        with self._lock:
            self._rule(model).shadow = target or None

    def promote(self, model: str) -> Optional[str]:
        """Make the canary target the primary for ``model``: every
        subsequent request for the logical name routes to the promoted
        entry, and the canary rule resets. The old primary stops
        receiving new traffic; requests already dispatched finish on
        the version they checked out. Returns the promoted target name
        (None when no canary is configured)."""
        with self._lock:
            r = self._rules.get(model)
            if r is None or r.canary is None:
                return None
            target = r.canary
            r.primary, r.canary, r.weight, r.acc = target, None, 0.0, 0.0
        log_info(f"serving fleet: promoted canary {target!r} to "
                 f"primary for model {model!r}")
        return target

    # -- decisions -----------------------------------------------------
    def route(self, model: str) -> RouteDecision:
        with self._lock:
            r = self._rules.get(model)
            if r is None:
                return RouteDecision(model, model)
            is_canary = False
            if r.canary is not None and r.weight > 0.0:
                # deterministic weighted round-robin: accumulate the
                # weight and emit a canary exactly each time the
                # accumulator crosses 1 — weight w sends round(N*w) of
                # any N requests to the canary, with weight 1.0 always
                # and weight 0.0 never (no sampling noise)
                r.acc += r.weight
                if r.acc >= 1.0 - 1e-12:
                    r.acc -= 1.0
                    is_canary = True
            target = r.canary if is_canary else (r.primary or model)
            return RouteDecision(model, target, is_canary=is_canary,
                                 shadow=r.shadow)

    def describe(self) -> Dict[str, Any]:
        with self._lock:
            return {
                model: {"primary": r.primary or model,
                        "canary": r.canary, "weight": r.weight,
                        "shadow": r.shadow}
                for model, r in sorted(self._rules.items())
                if r.canary is not None or r.shadow is not None
                or r.primary is not None}


__all__: List[str] = ["Router", "RouteDecision"]
