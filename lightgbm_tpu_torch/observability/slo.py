"""Declarative SLOs evaluated as multi-window burn rates (copy of
``lightgbm_tpu/observability/slo.py`` for the PyTorch port: the same
grammar, errors and burn-rate evaluation; for one serving engine
``counts_fn`` is ``ServingEngine.stats`` and the latency SLI reads
``serving_request_latency_ms``).

The federation half of this plane (metrics.py ``merge_snapshot``)
makes the parent process hold the FLEET's cumulative state: bucket-
merged request-latency histograms plus the fleet engine's request /
error / shed / unavailable counters. This module turns that state
into machine-checkable objectives:

  * :class:`SLOSpec` — one declarative objective. Three kinds:
    ``availability`` (fraction of attempts that got a response),
    ``latency`` (fraction of requests under ``threshold_ms``, read
    from the merged ``fleet_request_latency_ms`` buckets) and
    ``error_rate`` (fraction of dispatched requests that did not fail
    non-shed). Specs load from config (``slo_specs``) or the
    ``LGBM_TPU_SLOS`` env as ``name:kind:objective[:threshold_ms]``
    strings.
  * :class:`SLOEngine` — samples the cumulative good/total pairs on
    an interval, keeps a bounded ring of (timestamp, counts) and
    evaluates each spec over several look-back windows as a **burn
    rate**: ``(bad_fraction over the window) / (1 - objective)``.
    Burn 1.0 means the error budget is being spent exactly at the
    sustainable rate; 14.4 over 1h is the classic page threshold.

Every evaluation is surfaced three ways: ``lgbm_slo_burn{slo,window}``
gauges on the metrics registry, a structured ``slo`` telemetry record
per evaluation, and :func:`last_evaluation` for the HTTP ``GET /slo``
route, the flight recorder and ``pipeline/ramp.py``'s stage gate
(``max_slo_burn`` threshold). docs/Observability.md has a worked
burn-rate example.
"""

from __future__ import annotations

import os
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.log import log_info, log_warning
from .metrics import get_metrics
from .telemetry import get_telemetry

SLO_KINDS = ("availability", "latency", "error_rate")

# default objectives: deliberately loose — these are the "a fleet
# should at least do this" floor, not a production contract; real
# deployments declare their own via slo_specs / LGBM_TPU_SLOS
DEFAULT_SPEC_STRINGS = (
    "availability:availability:0.999",
    "latency_p99:latency:0.99:250",
    "errors:error_rate:0.999",
)
DEFAULT_WINDOWS = ("1m", "5m", "30m")

_WINDOW_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*(ms|s|m|h|d)\s*$")
_WINDOW_UNITS = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0,
                 "d": 86400.0}


def parse_window(spec: str) -> float:
    """``"5m"`` / ``"90s"`` / ``"1h"`` -> seconds (float)."""
    m = _WINDOW_RE.match(str(spec))
    if not m:
        raise ValueError(f"bad SLO window {spec!r} "
                         "(want e.g. '30s', '5m', '1h')")
    return float(m.group(1)) * _WINDOW_UNITS[m.group(2)]


@dataclass(frozen=True)
class SLOSpec:
    """One declarative objective: ``objective`` is the good-event
    fraction (0.999 = "three nines"); ``threshold_ms`` is the latency
    bound for ``kind="latency"`` specs (ignored otherwise)."""

    name: str
    kind: str
    objective: float
    threshold_ms: float = 0.0

    def __post_init__(self):
        if self.kind not in SLO_KINDS:
            raise ValueError(
                f"SLO {self.name!r}: unknown kind {self.kind!r} "
                f"(want one of {', '.join(SLO_KINDS)})")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"SLO {self.name!r}: objective must be in (0, 1), "
                f"got {self.objective}")
        if self.kind == "latency" and self.threshold_ms <= 0:
            raise ValueError(
                f"SLO {self.name!r}: latency kind needs a positive "
                "threshold_ms")

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    def describe(self) -> Dict[str, Any]:
        d = {"name": self.name, "kind": self.kind,
             "objective": self.objective}
        if self.kind == "latency":
            d["threshold_ms"] = self.threshold_ms
        return d


def parse_slo_spec(text: str) -> SLOSpec:
    """``name:kind:objective[:threshold_ms]`` -> :class:`SLOSpec`."""
    parts = [p.strip() for p in str(text).split(":")]
    if len(parts) not in (3, 4):
        raise ValueError(
            f"bad SLO spec {text!r} "
            "(want name:kind:objective[:threshold_ms])")
    name, kind, obj = parts[0], parts[1], float(parts[2])
    thr = float(parts[3]) if len(parts) == 4 else 0.0
    return SLOSpec(name=name, kind=kind, objective=obj,
                   threshold_ms=thr)


def parse_slo_specs(texts) -> List[SLOSpec]:
    specs = [parse_slo_spec(t) for t in texts if str(t).strip()]
    seen = set()
    for s in specs:
        if s.name in seen:
            raise ValueError(f"duplicate SLO name {s.name!r}")
        seen.add(s.name)
    return specs


def specs_from_config(config=None) -> List[SLOSpec]:
    """Resolution order: explicit ``slo_specs`` config, then the
    ``LGBM_TPU_SLOS`` env (comma-separated), then the defaults."""
    raw = list(getattr(config, "slo_specs", None) or [])
    if not raw:
        env = os.environ.get("LGBM_TPU_SLOS", "").strip()
        if env:
            raw = [p for p in env.split(",") if p.strip()]
    if not raw:
        raw = list(DEFAULT_SPEC_STRINGS)
    return parse_slo_specs(raw)


def windows_from_config(config=None) -> List[str]:
    ws = list(getattr(config, "slo_windows", None) or [])
    if not ws:
        ws = list(DEFAULT_WINDOWS)
    for w in ws:
        parse_window(w)     # validate eagerly
    return [str(w) for w in ws]


@dataclass
class _Sample:
    t: float
    # spec name -> (bad_cumulative, total_cumulative)
    counts: Dict[str, Tuple[float, float]] = field(default_factory=dict)


class SLOEngine:
    """Samples cumulative SLIs and evaluates burn rates per window.

    ``counts_fn`` supplies the fleet's cumulative request counters
    (a fleet's ``FleetEngine.slo_counts``, or one engine's
    ``ServingEngine.stats``); latency SLIs read the registry's bucket-merged
    ``fleet_request_latency_ms`` (local + every federated worker
    shard), falling back to ``serving_request_latency_ms`` for a
    single-engine process. All math is on CUMULATIVE pairs, so a
    missed sample only widens one window — it can never double-count.
    """

    HIST_NAMES = ("fleet_request_latency_ms",
                  "serving_request_latency_ms")

    def __init__(self, specs: Optional[List[SLOSpec]] = None,
                 windows: Optional[List[str]] = None,
                 counts_fn: Optional[Callable[[], Dict[str, int]]]
                 = None,
                 interval_s: float = 5.0,
                 registry=None, include_shed_errors: bool = False):
        self.specs = list(specs) if specs is not None \
            else parse_slo_specs(DEFAULT_SPEC_STRINGS)
        self.windows = [str(w) for w in (windows or DEFAULT_WINDOWS)]
        self._window_s = {w: parse_window(w) for w in self.windows}
        self.counts_fn = counts_fn
        self.interval_s = max(float(interval_s), 0.05)
        self._registry = registry
        self.include_shed_errors = bool(include_shed_errors)
        self._lock = threading.Lock()
        self._ring: List[_Sample] = []
        # ring depth: enough samples to cover the longest window at
        # the configured cadence (+2 so the window edge interpolates
        # against a sample strictly older than the window)
        span = max(self._window_s.values()) if self._window_s else 60.0
        self._ring_max = int(span / self.interval_s) + 2
        self._last_eval: Optional[Dict[str, Any]] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- SLI sources ---------------------------------------------------
    def _registry_now(self):
        return self._registry if self._registry is not None \
            else get_metrics()

    def _latency_pair(self, threshold_ms: float) -> Tuple[float, float]:
        """Cumulative (bad, total) for a latency SLI: observations
        above ``threshold_ms`` across every local + federated series
        of the request-latency histogram."""
        reg = self._registry_now()
        for name in self.HIST_NAMES:
            h = reg.merged_hist(name)
            if h.count <= 0:
                continue
            good = 0
            for i, edge in enumerate(h.bounds):
                if edge <= threshold_ms:
                    good += h.counts[i]
                else:
                    break
            return float(h.count - good), float(h.count)
        return 0.0, 0.0

    def _pairs(self) -> Dict[str, Tuple[float, float]]:
        counts = {}
        if self.counts_fn is not None:
            try:
                counts = dict(self.counts_fn() or {})
            except Exception:  # noqa: BLE001 - a dying fleet still
                counts = {}    # gets availability math from history
        req = float(counts.get("requests", 0))
        errors = float(counts.get("errors", 0))
        shed = float(counts.get("shed", 0))
        unavailable = float(counts.get("unavailable", 0))
        out: Dict[str, Tuple[float, float]] = {}
        for spec in self.specs:
            if spec.kind == "availability":
                # every attempt counts; failing to even dispatch
                # (unavailable) and failing after dispatch (errors)
                # both spend the budget. Shed is intentional
                # backpressure — excluded unless opted in.
                bad = unavailable + errors
                total = req + unavailable
                if self.include_shed_errors:
                    bad, total = bad + shed, total + shed
                out[spec.name] = (bad, total)
            elif spec.kind == "error_rate":
                bad = errors + (shed if self.include_shed_errors
                                else 0.0)
                out[spec.name] = (bad, req)
            else:
                out[spec.name] = self._latency_pair(spec.threshold_ms)
        return out

    # -- sampling / evaluation -----------------------------------------
    def sample(self, now: Optional[float] = None) -> None:
        s = _Sample(t=time.monotonic() if now is None else float(now),
                    counts=self._pairs())
        with self._lock:
            self._ring.append(s)
            if len(self._ring) > self._ring_max:
                del self._ring[:len(self._ring) - self._ring_max]

    def _window_delta(self, name: str, now: float,
                      window_s: float) -> Optional[Tuple[float, float]]:
        """(bad_delta, total_delta) between now's sample and the
        newest sample at least ``window_s`` old (cumulative pairs, so
        any two samples difference exactly)."""
        with self._lock:
            ring = list(self._ring)
        if len(ring) < 2:
            return None
        latest = ring[-1]
        base = None
        for s in ring[:-1]:
            if now - s.t >= window_s:
                base = s        # newest sample older than the window
            else:
                break
        if base is None:
            base = ring[0]      # short history: use what we have
        b0, t0 = base.counts.get(name, (0.0, 0.0))
        b1, t1 = latest.counts.get(name, (0.0, 0.0))
        if t1 < t0 or b1 < b0:
            # cumulative counters went backwards (registry reset):
            # treat the latest sample as the new origin
            return b1, t1
        return b1 - b0, t1 - t0

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Evaluate every spec over every window, publish the gauges
        and the telemetry record, and return the evaluation dict."""
        self.sample(now)
        t = time.monotonic() if now is None else float(now)
        reg = self._registry_now()
        tel = get_telemetry()
        out: Dict[str, Any] = {"at": time.time(), "slos": []}
        worst = 0.0
        for spec in self.specs:
            entry = dict(spec.describe())
            entry["windows"] = {}
            for w in self.windows:
                d = self._window_delta(spec.name, t, self._window_s[w])
                if d is None:
                    continue
                bad, total = d
                if total <= 0:
                    burn, ratio = 0.0, 0.0
                else:
                    ratio = bad / total
                    burn = ratio / spec.budget
                burn = round(burn, 6)
                entry["windows"][w] = {
                    "burn": burn, "bad_fraction": round(ratio, 8),
                    "bad": bad, "total": total}
                reg.set_gauge("slo_burn", burn,
                              labels={"slo": spec.name, "window": w})
                worst = max(worst, burn)
            burns = [v["burn"] for v in entry["windows"].values()]
            entry["max_burn"] = max(burns) if burns else 0.0
            entry["breached"] = bool(
                burns and min(burns) > 1.0)   # every window burning
            out["slos"].append(entry)
            tel.record("slo", name=spec.name, slo_kind=spec.kind,
                       objective=spec.objective,
                       max_burn=entry["max_burn"],
                       breached=entry["breached"],
                       windows={w: v["burn"]
                                for w, v in entry["windows"].items()})
        out["max_burn"] = round(worst, 6)
        with self._lock:
            self._last_eval = out
        _set_last_engine(self)
        return out

    def last_evaluation(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._last_eval

    def max_burn(self, window: Optional[str] = None) -> float:
        """Worst current burn across specs (one window, or all) — the
        scalar ``pipeline/ramp.py`` gates stages on. 0.0 until the
        first evaluation lands."""
        ev = self.last_evaluation()
        if not ev:
            return 0.0
        if window is None:
            return float(ev.get("max_burn", 0.0))
        worst = 0.0
        for entry in ev.get("slos", []):
            v = entry.get("windows", {}).get(window)
            if v:
                worst = max(worst, float(v["burn"]))
        return worst

    def report(self) -> Dict[str, Any]:
        """The run_report / flight-recorder section: spec'd
        objectives plus the latest evaluation."""
        return {"specs": [s.describe() for s in self.specs],
                "windows": list(self.windows),
                "interval_s": self.interval_s,
                "last": self.last_evaluation()}

    # -- background loop -----------------------------------------------
    def start(self) -> "SLOEngine":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="lgbm-slo")
        self._thread.start()
        log_info("slo: engine started "
                 f"({len(self.specs)} spec(s), windows "
                 f"{','.join(self.windows)}, every {self.interval_s}s)")
        _set_last_engine(self)
        return self

    def stop(self) -> None:
        self._stop.set()
        th = self._thread
        self._thread = None
        if th is not None and th.is_alive():
            th.join(timeout=2.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate()
            except Exception as e:  # noqa: BLE001 - keep evaluating
                log_warning(f"slo: evaluation failed: {e}")


# -- module accessors (HTTP /slo, flightrec, run_report) ---------------
_last_engine_lock = threading.Lock()
_last_engine: Optional[SLOEngine] = None


def _set_last_engine(engine: SLOEngine) -> None:
    global _last_engine
    with _last_engine_lock:
        _last_engine = engine


def get_slo_engine() -> Optional[SLOEngine]:
    with _last_engine_lock:
        return _last_engine


def last_evaluation() -> Optional[Dict[str, Any]]:
    eng = get_slo_engine()
    return None if eng is None else eng.last_evaluation()


def engine_from_config(config=None, counts_fn=None,
                       registry=None) -> SLOEngine:
    """Build (not start) an engine from config/env: specs via
    :func:`specs_from_config`, windows via ``slo_windows``, cadence
    via ``slo_eval_interval_s``."""
    return SLOEngine(
        specs=specs_from_config(config),
        windows=windows_from_config(config),
        counts_fn=counts_fn,
        interval_s=float(getattr(config, "slo_eval_interval_s", 5.0)
                         or 5.0),
        registry=registry)
