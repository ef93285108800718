"""Candidate publisher: registry publish + promote/rollback execution
(port of ``lightgbm_tpu/pipeline/publisher.py``).

The publisher owns the mapping between pipeline candidates and the
fleet's model registry:

* ``publish(candidate)`` loads the candidate's model text into the
  fleet under a per-candidate name (``<model>.cand<id>``) with the
  registry's atomic hot reload — a thread fleet pins the version's
  stack on the device once and captures its (bucket, kind) CUDA graphs
  at warmup, a process fleet has every worker do so. A REJECTED
  publish (torn text, integrity failure, warmup crash) marks the
  candidate ``rejected``, leaves every previous version serving, and
  degrades
  ``FleetEngine.health()`` (``last_reload_error``) — the ramp
  controller treats that as a hard abort, so a failed candidate can
  never sit in canary.
* ``start_canary`` / ``set_weight`` drive the deterministic weighted
  canary split (``serving/router.py``) for the logical model name.
* ``promote(candidate)`` makes the candidate the primary for the
  logical name (the router's atomic promotion; the old primary keeps
  serving requests already dispatched).
* ``rollback(candidate)`` clears the canary rule — the old primary
  is still the primary and has served uninterrupted throughout
  (availability 1.0 is the whole point of the ramp).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..observability.telemetry import get_telemetry
from ..observability.tracing import get_tracer
from ..utils.log import log_info, log_warning
from .trainer import Candidate


class Publisher:
    """Registers candidates into a FleetEngine; see module doc."""

    def __init__(self, fleet, model: str = "default"):
        self.fleet = fleet
        self.model = model          # the logical (routed) model name
        self.history: List[Candidate] = []

    def candidate_name(self, cand: Candidate) -> str:
        return f"{self.model}.cand{cand.cid:05d}"

    # ------------------------------------------------------------------
    def publish(self, cand: Candidate) -> Optional[str]:
        """Atomically publish the candidate; returns its registry name
        or None when the publish was rejected (candidate marked)."""
        name = self.candidate_name(cand)
        tel = get_telemetry()
        self.history.append(cand)
        with get_tracer().span("pipeline.publish", cat="pipeline",
                               args={"candidate": cand.cid,
                                     "name": name}) as sp:
            try:
                with tel.span("pipeline.publish"):
                    # the candidate's booster is the AOT artifact
                    # donor: the fleet validates and serves the TEXT
                    # (the parity standard); a process fleet's workers
                    # pin the artifact's stack
                    cand.version = self.fleet.load_model(
                        name, cand.model_text,
                        aot_booster=cand.booster)
            except Exception as e:
                cand.mark("rejected", f"publish_failed: {e}")
                tel.count("pipeline.publish_failures")
                log_warning(
                    f"pipeline: publish of candidate {cand.cid} "
                    f"rejected (old versions keep serving): {e}")
                sp.finish(error=str(e)[:128])
                return None
        cand.name = name
        cand.mark("published")
        tel.count("pipeline.publishes")
        log_info(f"pipeline: candidate {cand.cid} published as "
                 f"{name!r} v{cand.version}")
        return name

    # ------------------------------------------------------------------
    def primary_name(self) -> str:
        """The concrete registry entry currently serving the logical
        model (follows past promotions)."""
        rules = self.fleet.router.describe().get(self.model) or {}
        return rules.get("primary") or self.model

    def set_weight(self, cand: Candidate, weight: float) -> None:
        if cand.name is None:
            raise ValueError(f"candidate {cand.cid} is not published")
        self.fleet.router.set_canary(self.model, cand.name, weight)

    start_canary = set_weight

    def promote(self, cand: Candidate) -> str:
        promoted = self.fleet.promote_canary(self.model)
        cand.mark("promoted")
        get_telemetry().count("pipeline.promotions")
        log_info(f"pipeline: candidate {cand.cid} PROMOTED "
                 f"({promoted!r} is now primary for {self.model!r})")
        return promoted

    def rollback(self, cand: Candidate, reason: str) -> None:
        """Clear the canary rule; the old primary (which never stopped
        serving) remains primary. The candidate stays in the registry
        for post-mortem but receives no traffic (on the card it keeps
        its pinned stack and its CUDA graphs)."""
        self.fleet.router.set_canary(self.model, None)
        cand.mark("rolled_back", reason)
        get_telemetry().count("pipeline.rollbacks")
        log_warning(f"pipeline: candidate {cand.cid} ROLLED BACK "
                    f"({reason}); {self.primary_name()!r} keeps "
                    "serving")

    def describe(self) -> Dict[str, Any]:
        return {"model": self.model,
                "primary": self.primary_name(),
                "candidates": [c.describe() for c in self.history]}


__all__ = ["Publisher"]
