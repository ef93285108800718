"""Canary ramp controller: staged traffic, watched metrics, rollback
(port of ``lightgbm_tpu/pipeline/ramp.py``).

The controller walks a published candidate through configured traffic
stages (e.g. 5% -> 25% -> 50%) on the fleet's **deterministic**
weighted canary router. At every stage it collects a
:class:`StageMetrics` sample from the live planes —

* **latency** — canary-vs-primary p99 over the stage's own requests
  (the same numbers land in ``fleet_request_latency_ms{model}``);
* **quality** — candidate and primary scored on a clean holdout
  window (higher is better; default metric is negative MSE, which
  orders identically to logloss/accuracy for probability outputs);
* **serving parity** — the candidate served through the fleet must be
  **bit-identical** to its own direct host prediction (the serving
  parity invariant every model version in this repo carries); any
  mismatch means the published artifact is not the candidate;
* **flight-recorder trips** and non-shed **errors** during the stage;
* **fleet health** — a degraded fleet (replica down, or a rejected
  publish leaving ``last_reload_error`` behind) is a hard abort.

— and feeds it to :func:`evaluate_stage`, a **pure function** of
(metrics, thresholds) returning ``advance`` or ``rollback`` with the
reasons. All promote/rollback policy lives in that function so the
decision logic unit-tests against synthetic metric streams without an
engine (tests/test_pipeline.py).

On ``rollback`` the canary rule is cleared immediately — the primary
never stopped serving the non-canary share, so availability through a
bad candidate is 1.0 by construction. After the last stage passes,
the candidate is atomically promoted to primary.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..observability.metrics import get_metrics
from ..observability.telemetry import get_telemetry
from ..observability.tracing import get_tracer
from ..utils.log import log_info
from .publisher import Publisher
from .trainer import Candidate

STAGE_GAUGE = "pipeline_stage"


def set_stage(stage: str) -> None:
    """Publish the pipeline's current stage as the one-hot
    ``lgbm_pipeline_stage{stage=...}`` gauge on GET /metrics."""
    mx = get_metrics()
    mx.clear_gauge(STAGE_GAUGE)
    mx.set_gauge(STAGE_GAUGE, 1.0, labels={"stage": stage})


# ----------------------------------------------------------------------
@dataclasses.dataclass
class RampThresholds:
    """Regression gates; see evaluate_stage for exact semantics."""

    latency_regression_pct: float = 100.0  # canary p99 over primary %
    latency_floor_ms: float = 5.0          # ignore p99s under this
    quality_drop: float = 0.02             # max primary-minus-canary
    max_parity_mismatches: int = 0
    max_flightrec_trips: int = 0
    max_error_rate: float = 0.0            # non-shed errors / requests
    # SLO burn gate (observability/slo.py): a stage observing a worst
    # burn rate above this rolls back. 0.0 disables the gate — burn
    # only gates a ramp when the pipeline declares a tolerance
    # (``pipeline_max_slo_burn`` config)
    max_slo_burn: float = 0.0


@dataclasses.dataclass
class StageMetrics:
    """One stage's observed sample (synthetic in unit tests)."""

    stage: int = 0
    weight: float = 0.0
    requests: int = 0
    canary_requests: int = 0
    canary_p99_ms: Optional[float] = None
    baseline_p99_ms: Optional[float] = None
    canary_quality: Optional[float] = None
    baseline_quality: Optional[float] = None
    parity_mismatches: int = 0
    flightrec_trips: int = 0
    errors: int = 0
    health_status: str = "ok"
    last_reload_error: Optional[Dict[str, Any]] = None
    # worst SLO burn rate observed during the stage (None = no SLO
    # engine running; never trips a gate)
    slo_burn: Optional[float] = None


@dataclasses.dataclass
class StageVerdict:
    decision: str                   # "advance" | "rollback"
    reasons: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.decision == "advance"


def evaluate_stage(m: StageMetrics,
                   th: Optional[RampThresholds] = None) -> StageVerdict:
    """PURE promote/rollback decision for one canary stage.

    Rollback when any of: fleet health not ``ok`` (a rejected publish
    or a down replica — the hard aborts), a non-shed error rate above
    ``max_error_rate``, any serving-parity mismatch past
    ``max_parity_mismatches``, any flight-recorder trip past
    ``max_flightrec_trips``, an SLO burn rate above ``max_slo_burn``
    (when that gate is armed), a quality drop beyond ``quality_drop``,
    or a canary p99 exceeding the primary p99 by more than
    ``latency_regression_pct`` percent (only when the canary p99 is
    above ``latency_floor_ms`` — micro-benchmark noise below the
    floor never trips the gate). Otherwise advance. Missing samples
    (None) never trip a gate.
    """
    th = th or RampThresholds()
    reasons: List[str] = []
    if m.health_status != "ok":
        detail = ""
        if m.last_reload_error:
            detail = f" (last_reload_error: " \
                     f"{m.last_reload_error.get('code')})"
        reasons.append(f"fleet_health:{m.health_status}{detail}")
    elif m.last_reload_error is not None:
        reasons.append("fleet_health:last_reload_error "
                       f"({m.last_reload_error.get('code')})")
    if m.requests > 0 and m.errors / m.requests > th.max_error_rate:
        reasons.append(f"error_rate:{m.errors}/{m.requests}")
    if m.parity_mismatches > th.max_parity_mismatches:
        reasons.append(f"serving_parity:{m.parity_mismatches}"
                       " mismatched probes")
    if m.flightrec_trips > th.max_flightrec_trips:
        reasons.append(f"flight_recorder:{m.flightrec_trips} trips")
    if th.max_slo_burn > 0 and m.slo_burn is not None \
            and m.slo_burn > th.max_slo_burn:
        reasons.append(f"slo_burn:{m.slo_burn:.3g} "
                       f"(> {th.max_slo_burn:g})")
    if m.canary_quality is not None and m.baseline_quality is not None:
        drop = m.baseline_quality - m.canary_quality
        if drop > th.quality_drop:
            reasons.append(f"quality_drop:{drop:.6g} "
                           f"(> {th.quality_drop:g})")
    if m.canary_p99_ms is not None and m.baseline_p99_ms is not None \
            and m.canary_p99_ms > th.latency_floor_ms:
        limit = m.baseline_p99_ms * \
            (1.0 + th.latency_regression_pct / 100.0)
        if m.canary_p99_ms > limit:
            reasons.append(
                f"latency_p99:{m.canary_p99_ms:.3g}ms "
                f"(> {limit:.3g}ms = primary "
                f"{m.baseline_p99_ms:.3g}ms "
                f"+{th.latency_regression_pct:g}%)")
    return StageVerdict("rollback" if reasons else "advance", reasons)


def default_quality(pred: np.ndarray, y: np.ndarray) -> float:
    """Higher-is-better default quality: negative MSE (works for both
    probability outputs and regression targets)."""
    pred = np.asarray(pred, np.float64).reshape(len(y), -1)[:, 0]
    return -float(np.mean((pred - np.asarray(y, np.float64)) ** 2))


# ----------------------------------------------------------------------
class RampController:
    """Drives the canary ramp for one candidate; see module doc."""

    def __init__(self, publisher: Publisher,
                 stages: Sequence[float] = (0.05, 0.25, 0.5),
                 stage_requests: int = 64,
                 thresholds: Optional[RampThresholds] = None,
                 quality_fn: Callable[[np.ndarray, np.ndarray],
                                      float] = default_quality,
                 parity_rows: int = 32,
                 trips_fn: Optional[Callable[[], int]] = None,
                 collect_fn: Optional[Callable] = None,
                 slo_fn: Optional[Callable[[], float]] = None):
        self.publisher = publisher
        self.fleet = publisher.fleet
        self.stages = [float(w) for w in stages]
        for w in self.stages:
            if not (0.0 < w <= 1.0):
                raise ValueError(
                    f"canary stage weights must be in (0, 1], got {w}")
        self.stage_requests = max(int(stage_requests), 1)
        self.thresholds = thresholds or RampThresholds()
        self.quality_fn = quality_fn
        self.parity_rows = int(parity_rows)
        self._trips_fn = trips_fn or self._default_trips
        self._collect_fn = collect_fn
        # worst current SLO burn (observability/slo.py SLOEngine
        # .max_burn); None = no SLO engine wired, gate stays silent
        self._slo_fn = slo_fn
        self.verdicts: List[Tuple[StageMetrics, StageVerdict]] = []

    @staticmethod
    def _default_trips() -> int:
        """Flight-recorder trips observed so far: the armed recorder's
        trip list plus every guard counter (a trip is recorded even
        when a rollback recovers)."""
        from ..observability.flightrec import active_recorder
        rec = active_recorder()
        # worker deaths are excluded: a process-fleet worker dying is
        # already the availability/health signal, and the supervisor
        # heals it — counting its dump as a "trip" would make every
        # chaos-window ramp roll back a healthy candidate
        n = len([t for t in rec.trips
                 if t.get("kind") not in ("worker_death",)]) \
            if rec is not None else 0
        tel = get_telemetry()
        n += int(sum(v for k, v in tel.counters.items()
                     if k.startswith("guard.")))
        return n

    # ------------------------------------------------------------------
    def ramp(self, cand: Candidate, holdout) -> bool:
        """Walk ``cand`` through every stage; promote on full pass,
        roll back (and return False) on the first regression."""
        if cand.name is None:
            # a candidate whose publish was rejected never ramps
            # (satellite: rejected != sitting in canary forever)
            self.publisher.rollback(
                cand, cand.reason or "publish_rejected")
            return False
        tel = get_telemetry()
        tracer = get_tracer()
        self.verdicts = []
        for si, weight in enumerate(self.stages):
            stage_name = f"canary_{int(round(weight * 100))}"
            set_stage(stage_name)
            self.publisher.set_weight(cand, weight)
            with tracer.span("pipeline.ramp_stage", cat="pipeline",
                             args={"candidate": cand.cid,
                                   "stage": si, "weight": weight}):
                with tel.span("pipeline.ramp"):
                    m = (self._collect_fn or self._collect_stage)(
                        si, weight, cand, holdout)
                v = evaluate_stage(m, self.thresholds)
            self.verdicts.append((m, v))
            tel.record("pipeline_stage", candidate=cand.cid, stage=si,
                       weight=weight, decision=v.decision,
                       reasons=";".join(v.reasons),
                       requests=m.requests,
                       canary_requests=m.canary_requests,
                       slo_burn=m.slo_burn)
            if not v.ok:
                set_stage("rollback")
                self.publisher.rollback(cand, "; ".join(v.reasons))
                return False
            log_info(f"pipeline: candidate {cand.cid} passed stage "
                     f"{si} ({weight:.0%} canary, "
                     f"{m.canary_requests}/{m.requests} canary "
                     "requests)")
        set_stage("promote")
        self.publisher.promote(cand)
        return True

    # ------------------------------------------------------------------
    def _collect_stage(self, si: int, weight: float, cand: Candidate,
                       holdout) -> StageMetrics:
        """Observe one live stage: drive ``stage_requests`` holdout
        requests through the ROUTED logical model (the deterministic
        router sends exactly the configured share to the candidate),
        then probe quality and bit-parity out of band."""
        from ..serving.errors import ServingError
        Xh, yh = holdout
        n = len(Xh)
        trips0 = self._trips_fn()
        can_lat: List[float] = []
        base_lat: List[float] = []
        errors = 0
        futs = []
        for i in range(self.stage_requests):
            lo = (i * 7) % max(n - 1, 1)
            t0 = time.monotonic()
            try:
                fut = self.fleet.submit(Xh[lo:lo + 1],
                                        model=self.publisher.model)
            except ServingError:
                errors += 1
                continue
            futs.append((t0, fut))
        canary_requests = 0
        for t0, fut in futs:
            try:
                fut.result(timeout=30.0)
            except ServingError:
                errors += 1
                continue
            dt = (time.monotonic() - t0) * 1000.0
            if fut.meta.get("is_canary"):
                canary_requests += 1
                can_lat.append(dt)
            else:
                base_lat.append(dt)

        m = StageMetrics(stage=si, weight=weight,
                         requests=self.stage_requests,
                         canary_requests=canary_requests,
                         errors=errors)
        if can_lat:
            m.canary_p99_ms = float(np.percentile(can_lat, 99))
        if base_lat:
            m.baseline_p99_ms = float(np.percentile(base_lat, 99))

        # quality: candidate vs current primary on the clean holdout,
        # queried by their CONCRETE registry names (bypasses routing)
        try:
            cpred = self.fleet.predict(Xh, model=cand.name)
            ppred = self.fleet.predict(
                Xh, model=self.publisher.primary_name())
            m.canary_quality = self.quality_fn(cpred, yh)
            m.baseline_quality = self.quality_fn(ppred, yh)
        except ServingError:
            errors += 1
            m.errors = errors

        # serving parity: the served candidate must equal its own
        # direct host prediction bit-for-bit
        try:
            k = min(self.parity_rows, n)
            served = np.asarray(
                self.fleet.predict(Xh[:k], model=cand.name))
            direct = np.asarray(self._direct_predict(cand, Xh[:k]))
            if served.shape != direct.shape \
                    or not np.array_equal(served, direct):
                m.parity_mismatches += 1
        except ServingError:
            errors += 1
            m.errors = errors

        m.flightrec_trips = self._trips_fn() - trips0
        if self._slo_fn is not None:
            try:
                m.slo_burn = float(self._slo_fn())
            except Exception:  # noqa: BLE001 - a broken SLO probe
                m.slo_burn = None   # must not fail the stage itself
        h = self.fleet.health()
        status = str(h.get("status"))
        if status == "degraded" and h.get("last_reload_error") is None \
                and h.get("isolation") == "process" \
                and not h.get("replicas_quarantined"):
            # a worker died and the supervisor is respawning it: the
            # process fleet SELF-HEALS, requests re-dispatched to
            # survivors (availability holds) — not candidate-
            # correlated regression, so the ramp proceeds. Quarantine
            # (respawn exhausted) stays a hard abort.
            get_telemetry().count("pipeline.ramp_through_respawn")
            status = "ok"
        m.health_status = status
        m.last_reload_error = h.get("last_reload_error")
        return m

    def _direct_predict(self, cand: Candidate, X) -> np.ndarray:
        """``Booster.predict`` of the PUBLISHED artifact (the model
        text, exactly what the registry loaded) on the fleet's device —
        the served output must be bit-identical to this (the serving
        route's float64 walk is ``Booster.predict``'s)."""
        from ..basic import Booster
        loaded = getattr(cand, "_loaded_ref", None)
        if loaded is None:
            loaded = Booster(model_str=cand.model_text,
                             device=self.fleet.device)
            cand._loaded_ref = loaded
        return np.asarray(loaded.predict(X))


__all__ = ["RampController", "RampThresholds", "StageMetrics",
           "StageVerdict", "evaluate_stage", "default_quality",
           "set_stage", "STAGE_GAUGE"]
