"""Live metrics plane: Prometheus-text aggregation over the telemetry
(copy of ``lightgbm_tpu/observability/metrics.py`` for the PyTorch port;
the same render, so the same observations give the same text).

The :class:`~lightgbm_tpu_torch.observability.telemetry.Telemetry` is
post-hoc — counters and records surface only in the JSONL trace after
the run. This module makes the same state (plus new log-bucketed
latency/phase histograms and scrape-time collectors) continuously
queryable:

  * :class:`LogHistogram` — geometric-bucket histogram whose p50/p95/
    p99 are derivable from the buckets alone (no raw-sample storage),
    fed by the serving engine (per-bucket request latency) and the
    training loop (per-iteration phase wall times);
  * :class:`MetricsRegistry` — one process-wide registry
    (``get_metrics()``) holding the histograms, scrape-time gauge
    **collectors** (serving queue depth / shed / timeout counts,
    ``memory_snapshot()`` device-memory gauges), and a renderer for
    the Prometheus text exposition format (version 0.0.4);
  * an **exporter** — a stdlib HTTP thread serving ``GET /metrics``
    for the training CLI (``metrics_port`` config param or
    ``LGBM_TPU_METRICS_PORT``); the serving frontend mounts the same
    renderer on its own ``GET /metrics`` route.

Scrape cost model: rendering reads host-side Python state only — no
device dispatches and **no implicit device->host transfers** are ever
issued by a scrape (``memory_snapshot`` reads the CUDA caching
allocator's statistics, never tensor contents). Nothing in training
starts the exporter; a front end does (``start_exporter``).
"""

from __future__ import annotations

import bisect
import re
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.log import log_info, log_warning
from .telemetry import get_telemetry, memory_snapshot

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# per-metric bucket layouts: (start, factor, count). The factor-sqrt(2)
# geometric ladder bounds the within-bucket quantile error at ~41%
# worst-case before interpolation; with the linear interpolation in
# LogHistogram.quantile the derived p50/p95/p99 land inside the true
# value's bucket (asserted by tests).
_HIST_LAYOUTS: Dict[str, Tuple[float, float, int]] = {
    # serving request latency, milliseconds: 0.05 ms .. ~1.6e6 ms
    "serving_request_latency_ms": (0.05, 2.0 ** 0.5, 50),
    # fleet request latency, per-(model, tenant) labels: same ladder
    "fleet_request_latency_ms": (0.05, 2.0 ** 0.5, 50),
    # per-iteration phase wall time, seconds: 0.1 ms .. ~100 s
    "train_phase_seconds": (1e-4, 2.0 ** 0.5, 40),
}
_DEFAULT_LAYOUT = (0.001, 2.0 ** 0.5, 60)

# per-metric cap on DISTINCT label sets: per-tenant / per-worker labels
# must not be able to grow the scrape without bound. Overflowing series
# are dropped (not silently: lgbm_metrics_dropped_series{metric} counts
# them) — the cap protects the scrape, it never raises.
DEFAULT_MAX_SERIES = 256

Labels = Tuple[Tuple[str, str], ...]


def hist_layout(name: str) -> Tuple[float, float, int]:
    """The (start, factor, count) bucket layout of a histogram name —
    deterministic per name, which is what makes cross-process bucket
    merges exact (federation: worker and parent agree on the edges)."""
    return _HIST_LAYOUTS.get(str(name), _DEFAULT_LAYOUT)


def _labels_key(labels: Optional[Dict[str, Any]]) -> Labels:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class LogHistogram:
    """Geometric-bucket histogram: fixed memory, derivable quantiles.

    ``bounds[i]`` is the inclusive upper edge of bucket ``i``; one
    overflow bucket catches everything past the last edge. Negative
    and zero observations land in the first bucket (latencies and
    durations; there is no use for a negative edge here).
    """

    __slots__ = ("bounds", "counts", "sum", "count", "_lock")

    def __init__(self, start: float, factor: float, n: int):
        b, bounds = float(start), []
        for _ in range(n):
            bounds.append(b)
            b *= factor
        self.bounds: List[float] = bounds
        self.counts: List[int] = [0] * (n + 1)   # + overflow
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def quantile(self, q: float) -> Optional[float]:
        """q in [0, 1]; linear interpolation inside the target bucket.
        None when empty. The overflow bucket reports its lower edge."""
        with self._lock:
            counts = list(self.counts)
            total = self.count
        if total <= 0:
            return None
        target = q * total
        seen = 0.0
        for i, c in enumerate(counts):
            if c and seen + c >= target:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else None
                if hi is None:
                    return lo
                frac = (target - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return self.bounds[-1]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counts = list(self.counts)
            total, s = self.count, self.sum
        out = {"bounds": [round(b, 9) for b in self.bounds],
               "counts": counts, "count": total,
               "sum": round(s, 6)}
        for q, name in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            v = self.quantile(q)
            out[name] = None if v is None else round(v, 4)
        return out

    def merge_counts(self, counts: List[int],
                     total: Optional[int] = None,
                     sum_: float = 0.0) -> bool:
        """Merge another histogram's bucket counts into this one.
        EXACT for identical layouts (elementwise add — the federation
        premise: buckets merge, quantiles don't); a layout mismatch is
        rejected (returns False) rather than silently corrupting the
        buckets."""
        if len(counts) != len(self.counts):
            return False
        add = [int(c) for c in counts]
        n = int(total) if total is not None else sum(add)
        with self._lock:
            for i, c in enumerate(add):
                self.counts[i] += c
            self.count += n
            self.sum += float(sum_)
        return True


# ---------------------------------------------------------------------
# Prometheus text helpers
_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(name: str, prefix: str = "lgbm_") -> str:
    n = _NAME_BAD.sub("_", str(name))
    if not re.match(r"[a-zA-Z_:]", n):
        n = "_" + n
    return prefix + n if not n.startswith(prefix) else n


# Prometheus text 0.0.4 escaping. Label values escape backslash,
# double-quote and newline; HELP text escapes backslash and newline
# (quotes are legal there). Single-pass via str.translate so no
# replacement can ever re-process another's output — the classic
# sequential-replace corruption (escaping the backslashes a previous
# pass introduced) is impossible by construction.
_LABEL_ESCAPES = str.maketrans({"\\": r"\\", '"': r'\"', "\n": r"\n"})
_HELP_ESCAPES = str.maketrans({"\\": r"\\", "\n": r"\n"})


def _escape_label(v: str) -> str:
    return str(v).translate(_LABEL_ESCAPES)


def _escape_help(v: str) -> str:
    return str(v).translate(_HELP_ESCAPES)


def _label_str(labels: Labels, extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v: Any) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class MetricsRegistry:
    """Process-wide aggregation point; see module docstring."""

    def __init__(self):
        self._lock = threading.Lock()
        self._hists: Dict[Tuple[str, Labels], LogHistogram] = {}
        # collectors: scrape-time callables returning {name: value};
        # each is tied to an owner via weakref and pruned when the
        # owner is collected. Same-name values from live collectors
        # are SUMMED (several serving engines in one process = one
        # process-level total).
        self._collectors: List[Tuple[Any, Callable[[], Dict]]] = []
        # exemplars: per-(name, labels) the single WORST observation
        # seen, with the trace id that produced it — the jump-off from
        # a p99 number to the end-to-end timeline of the request behind
        # it (docs/Observability.md "Tracing")
        self._exemplars: Dict[Tuple[str, Labels], Dict[str, Any]] = {}
        # labeled gauges set explicitly (collectors can only export
        # bare names): e.g. lgbm_pipeline_stage{stage="canary"}
        self._gauges: Dict[Tuple[str, Labels], float] = {}
        self.include_memory = True
        # label-cardinality bound: per-metric count of distinct label
        # sets; past the cap new series are dropped and counted in
        # lgbm_metrics_dropped_series{metric} (0 disables the cap)
        self.max_series_per_metric = DEFAULT_MAX_SERIES
        self._dropped: Dict[str, int] = {}
        self._hist_overflow: Dict[str, LogHistogram] = {}
        # federated worker shards (merge_snapshot): worker_id -> the
        # latest cumulative state shipped on the heartbeat piggyback,
        # rendered under a `worker` label on the parent scrape with a
        # staleness gauge per worker. fed_stale_after_s additionally
        # flags a shard stale at render time when no merge refreshed
        # it recently (a slow worker, not only a declared-dead one).
        self._federated: Dict[str, Dict[str, Any]] = {}
        self.fed_stale_after_s = 3.0

    # -- cardinality ---------------------------------------------------
    def _series_full(self, store: Dict[Tuple[str, Labels], Any],
                     name: str) -> bool:
        """Lock held. True when metric ``name`` is at its series cap —
        the caller drops the new series and counts the overflow."""
        cap = self.max_series_per_metric
        if cap <= 0:
            return False
        if sum(1 for k in store if k[0] == name) < cap:
            return False
        self._dropped[name] = self._dropped.get(name, 0) + 1
        return True

    def dropped_series(self) -> Dict[str, int]:
        """Per-metric count of label sets dropped at the cardinality
        cap (the lgbm_metrics_dropped_series series)."""
        with self._lock:
            return dict(self._dropped)

    # -- histograms ----------------------------------------------------
    def hist(self, name: str,
             labels: Optional[Dict[str, Any]] = None) -> LogHistogram:
        key = (str(name), _labels_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                start, factor, n = hist_layout(name)
                if key[1] and self._series_full(self._hists, key[0]):
                    # over the cap: observations still land somewhere
                    # (one detached overflow histogram per metric) but
                    # never mint a new rendered series
                    h = self._hist_overflow.get(key[0])
                    if h is None:
                        h = LogHistogram(start, factor, n)
                        self._hist_overflow[key[0]] = h
                    return h
                h = LogHistogram(start, factor, n)
                self._hists[key] = h
        return h

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, Any]] = None) -> None:
        self.hist(name, labels).observe(value)

    def snapshots(self, prefix: str = "") -> List[Dict[str, Any]]:
        """Histogram snapshots (for ``hist`` telemetry records and the
        flight recorder), optionally filtered by name prefix."""
        with self._lock:
            items = list(self._hists.items())
        out = []
        for (name, labels), h in sorted(items):
            if prefix and not name.startswith(prefix):
                continue
            snap = h.snapshot()
            if not snap["count"]:
                continue
            snap["name"] = name
            snap["labels"] = dict(labels)
            out.append(snap)
        return out

    # -- labeled gauges ------------------------------------------------
    def set_gauge(self, name: str, value: float,
                  labels: Optional[Dict[str, Any]] = None) -> None:
        """Set a labeled gauge series (rendered in the gauge section;
        unlike collectors, the label set rides the exposition)."""
        key = (str(name), _labels_key(labels))
        with self._lock:
            if key not in self._gauges and key[1] \
                    and self._series_full(self._gauges, key[0]):
                return
            self._gauges[key] = float(value)

    def clear_gauge(self, name: str) -> None:
        """Drop every series of a labeled gauge (e.g. before setting
        the one active ``lgbm_pipeline_stage`` stage)."""
        with self._lock:
            for key in [k for k in self._gauges if k[0] == str(name)]:
                del self._gauges[key]

    def labeled_gauges(self, prefix: str = "") -> Dict[str, float]:
        with self._lock:
            items = list(self._gauges.items())
        return {f"{name}{_label_str(labels)}": v
                for (name, labels), v in sorted(items)
                if not prefix or name.startswith(prefix)}

    # -- exemplars -----------------------------------------------------
    def exemplar_max(self, name: str, value: float,
                     labels: Optional[Dict[str, Any]] = None,
                     trace_id: Optional[str] = None,
                     **attrs) -> bool:
        """Keep ``value`` as the series' exemplar iff it is the worst
        seen so far; returns True when it took the slot."""
        key = (str(name), _labels_key(labels))
        v = float(value)
        with self._lock:
            cur = self._exemplars.get(key)
            if cur is not None and cur["value"] >= v:
                return False
            self._exemplars[key] = {"value": v, "trace_id": trace_id,
                                    **attrs}
        return True

    def exemplars(self, prefix: str = "") -> List[Dict[str, Any]]:
        with self._lock:
            items = list(self._exemplars.items())
        out = []
        for (name, labels), ex in sorted(items):
            if prefix and not name.startswith(prefix):
                continue
            out.append({"name": name, "labels": dict(labels), **ex})
        return out

    # -- collectors ----------------------------------------------------
    def register_collector(self, fn: Callable[[], Dict],
                           owner: Any = None) -> None:
        ref = weakref.ref(owner) if owner is not None else None
        with self._lock:
            self._collectors.append((ref, fn))

    def _collect(self) -> Dict[str, float]:
        with self._lock:
            collectors = list(self._collectors)
        out: Dict[str, float] = {}
        dead = []
        for ref, fn in collectors:
            if ref is not None and ref() is None:
                dead.append((ref, fn))
                continue
            try:
                for k, v in (fn() or {}).items():
                    try:
                        out[k] = out.get(k, 0.0) + float(v)
                    except (TypeError, ValueError):
                        continue
            except Exception as e:  # a collector must never kill a scrape
                log_warning(f"metrics collector failed: {e}")
        if dead:
            with self._lock:
                self._collectors = [c for c in self._collectors
                                    if c not in dead]
        return out

    def collector_values(self) -> Dict[str, float]:
        """The summed scrape-time collector gauges (e.g. the fleet's
        ``fleet_requests``/``fleet_errors`` counts) — the SLO engine's
        counter source."""
        return self._collect()

    # -- federation (worker shards) ------------------------------------
    def _shard(self, worker_id: str) -> Dict[str, Any]:
        """Lock held. The mutable shard for one worker id."""
        shard = self._federated.get(worker_id)
        if shard is None:
            shard = self._federated[worker_id] = {
                "hists": {}, "gauges": {}, "counters": {},
                "updated": time.monotonic(), "stale": False}
        return shard

    def merge_snapshot(self, worker_id: str,
                       snap: Optional[Dict[str, Any]]) -> None:
        """Merge one worker's metrics delta (the heartbeat piggyback)
        into this registry's federated state. The delta carries only
        CHANGED series, each with its full cumulative bucket counts —
        merge is therefore replace-per-series and idempotent (a
        re-delivered delta cannot double-count), and a quiet series
        keeps its last-known value instead of disappearing. Every
        merge refreshes the shard's staleness clock."""
        wid = str(worker_id)
        with self._lock:
            shard = self._shard(wid)
            shard["updated"] = time.monotonic()
            shard["stale"] = False
            if not snap:
                return
            for h in snap.get("hists") or []:
                try:
                    key = (str(h["n"]), _labels_key(h.get("l")))
                    counts = [int(c) for c in h["c"]]
                except (KeyError, TypeError, ValueError):
                    continue
                _, _, n = hist_layout(key[0])
                if len(counts) != n + 1:
                    continue      # layout mismatch: refuse, don't lie
                shard["hists"][key] = {
                    "counts": counts,
                    "count": int(h.get("t", sum(counts))),
                    "sum": float(h.get("s", 0.0))}
            for g in snap.get("gauges") or []:
                try:
                    shard["gauges"][(str(g["n"]),
                                     _labels_key(g.get("l")))] = \
                        float(g["v"])
                except (KeyError, TypeError, ValueError):
                    continue
            for k, v in (snap.get("counters") or {}).items():
                try:
                    shard["counters"][str(k)] = float(v)
                except (TypeError, ValueError):
                    continue

    def set_worker_stale(self, worker_id: str,
                         stale: bool = True) -> None:
        """Flip a worker shard's staleness flag (the supervisor calls
        this the moment it declares the worker dead — faster than the
        render-time age threshold). Marking fresh also resets the age
        clock (a just-spawned worker has not scraped yet)."""
        with self._lock:
            shard = self._shard(str(worker_id))
            shard["stale"] = bool(stale)
            if not stale:
                shard["updated"] = time.monotonic()

    def drop_worker(self, worker_id: str) -> None:
        with self._lock:
            self._federated.pop(str(worker_id), None)

    def federation_workers(self) -> List[Dict[str, Any]]:
        """Per-worker shard status: id, snapshot age, staleness (flag
        OR age past ``fed_stale_after_s``), series count."""
        now = time.monotonic()
        with self._lock:
            items = sorted(self._federated.items())
            thresh = float(self.fed_stale_after_s)
            return [{"worker": wid,
                     "age_s": round(now - s["updated"], 3),
                     "stale": bool(s["stale"]
                                   or (thresh > 0 and
                                       now - s["updated"] > thresh)),
                     "series": len(s["hists"]) + len(s["gauges"])}
                    for wid, s in items]

    def merged_hist(self, name: str,
                    include_local: bool = True) -> LogHistogram:
        """One histogram bucket-merging every series of ``name``: all
        local label sets plus every federated worker shard. Exact by
        construction (identical per-name layouts); the derived
        quantiles are the fleet-level p50/p95/p99 the SLO engine and
        the `GET /metrics` consumers read."""
        start, factor, n = hist_layout(name)
        out = LogHistogram(start, factor, n)
        with self._lock:
            local = [h for (nm, _), h in self._hists.items()
                     if nm == str(name)] if include_local else []
            if include_local:
                # over-cap observations live in the detached overflow
                # histogram: never rendered, but the merged totals (and
                # the SLO quantiles) must still count them
                ov = self._hist_overflow.get(str(name))
                if ov is not None:
                    local.append(ov)
            fed = [dict(e) for s in self._federated.values()
                   for (nm, _), e in s["hists"].items()
                   if nm == str(name)]
        for h in local:
            with h._lock:
                counts, total, s = list(h.counts), h.count, h.sum
            out.merge_counts(counts, total, s)
        for e in fed:
            out.merge_counts(e["counts"], e["count"], e["sum"])
        return out

    def merged_snapshot(self, name: str,
                        include_local: bool = True) -> Dict[str, Any]:
        snap = self.merged_hist(name, include_local).snapshot()
        snap["name"] = str(name)
        return snap

    # -- rendering -----------------------------------------------------
    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4) of everything:
        telemetry counters/gauges/dists, collector gauges, memory
        snapshot gauges and the histograms."""
        tel = get_telemetry()
        L: List[str] = []

        with tel._lock:
            counters = dict(tel.counters)
            gauges = dict(tel.gauges)
            dists = {k: list(v) for k, v in tel.dists.items()}

        # one TYPE/HELP declaration per metric family for the WHOLE
        # exposition — parent series and federated worker shards share
        # families, and the format forbids re-declaring one
        declared: set = set()

        for name in sorted(counters):
            mn = _metric_name(name) + "_total"
            declared.add(mn)
            L.append(f"# HELP {mn} telemetry counter "
                     f"{_escape_help(name)}")
            L.append(f"# TYPE {mn} counter")
            L.append(f"{mn} {_fmt(counters[name])}")

        numeric_gauges: Dict[str, float] = {}
        for name, v in gauges.items():
            try:
                numeric_gauges[_metric_name(name)] = float(v)
            except (TypeError, ValueError):
                continue
        for name, v in self._collect().items():
            numeric_gauges[_metric_name(name)] = v
        if self.include_memory:
            for name, v in memory_snapshot().items():
                try:
                    numeric_gauges[_metric_name(name)] = float(v)
                except (TypeError, ValueError):
                    continue
        for mn in sorted(numeric_gauges):
            declared.add(mn)
            L.append(f"# HELP {mn} gauge")
            L.append(f"# TYPE {mn} gauge")
            L.append(f"{mn} {_fmt(numeric_gauges[mn])}")

        with self._lock:
            labeled = sorted(self._gauges.items())
        for (name, labels), v in labeled:
            base = _metric_name(name)
            if base not in declared:
                declared.add(base)
                L.append(f"# HELP {base} gauge")
                L.append(f"# TYPE {base} gauge")
            L.append(f"{base}{_label_str(labels)} {_fmt(v)}")

        for name in sorted(dists):
            n, s, mn_v, mx_v = dists[name]
            base = _metric_name(name)
            declared.add(base)
            L.append(f"# HELP {base} telemetry distribution "
                     f"{_escape_help(name)}")
            L.append(f"# TYPE {base} summary")
            L.append(f"{base}_count {_fmt(n)}")
            L.append(f"{base}_sum {_fmt(s)}")
            for suffix, v in (("_min", mn_v), ("_max", mx_v)):
                g = base + suffix
                declared.add(g)
                L.append(f"# HELP {g} gauge")
                L.append(f"# TYPE {g} gauge")
                L.append(f"{g} {_fmt(v)}")

        with self._lock:
            hist_items = sorted(self._hists.items())
        for (name, labels), h in hist_items:
            base = _metric_name(name)
            if base not in declared:
                declared.add(base)
                L.append(f"# HELP {base} log-bucketed histogram "
                         f"{_escape_help(name)}")
                L.append(f"# TYPE {base} histogram")
            with h._lock:
                counts = list(h.counts)
                total, s = h.count, h.sum
            cum = 0
            for i, edge in enumerate(h.bounds):
                cum += counts[i]
                le = _label_str(labels, f'le="{repr(float(edge))}"')
                L.append(f"{base}_bucket{le} {cum}")
            cum += counts[-1]
            le = _label_str(labels, 'le="+Inf"')
            L.append(f"{base}_bucket{le} {cum}")
            ls = _label_str(labels)
            L.append(f"{base}_sum{ls} {_fmt(s)}")
            L.append(f"{base}_count{ls} {total}")

        self._render_federated(L, declared)
        self._render_dropped(L)

        # slowest-observation exemplars: the trace id rides as a label
        # so a dashboard can link a p99 spike straight to its timeline
        with self._lock:
            ex_items = sorted(self._exemplars.items())
        return self._render_exemplars(L, ex_items)

    def _render_federated(self, L: List[str], typed: set) -> None:
        """Worker-shard series: the same metric names with a `worker`
        label, plus per-worker staleness/age gauges. One parent scrape
        therefore carries the whole fleet — no per-worker ports, no
        new sockets."""
        now = time.monotonic()
        with self._lock:
            shards = [(wid, {"hists": dict(s["hists"]),
                             "gauges": dict(s["gauges"]),
                             "counters": dict(s["counters"]),
                             "updated": s["updated"],
                             "stale": s["stale"]})
                      for wid, s in sorted(self._federated.items())]
            thresh = float(self.fed_stale_after_s)
        if not shards:
            return
        for wid, s in shards:
            for name in sorted(s["counters"]):
                mn = _metric_name(name) + "_total"
                if mn not in typed:
                    typed.add(mn)
                    L.append(f"# HELP {mn} telemetry counter "
                             f"{_escape_help(name)}")
                    L.append(f"# TYPE {mn} counter")
                L.append(f"{mn}{_label_str((('worker', wid),))} "
                         f"{_fmt(s['counters'][name])}")
            for (name, labels) in sorted(s["gauges"]):
                base = _metric_name(name)
                if base not in typed:
                    typed.add(base)
                    L.append(f"# HELP {base} gauge")
                    L.append(f"# TYPE {base} gauge")
                wl = labels + (("worker", wid),)
                L.append(f"{base}{_label_str(wl)} "
                         f"{_fmt(s['gauges'][(name, labels)])}")
            for (name, labels) in sorted(s["hists"]):
                e = s["hists"][(name, labels)]
                base = _metric_name(name)
                if base not in typed:
                    typed.add(base)
                    L.append(f"# HELP {base} log-bucketed histogram "
                             f"{_escape_help(name)}")
                    L.append(f"# TYPE {base} histogram")
                start, factor, n = hist_layout(name)
                wl = labels + (("worker", wid),)
                cum, edge = 0, start
                for i in range(n):
                    cum += e["counts"][i]
                    le = _label_str(wl, f'le="{repr(float(edge))}"')
                    L.append(f"{base}_bucket{le} {cum}")
                    edge *= factor
                cum += e["counts"][-1]
                inf = _label_str(wl, 'le="+Inf"')
                L.append(f"{base}_bucket{inf} {cum}")
                ls = _label_str(wl)
                L.append(f"{base}_sum{ls} {_fmt(e['sum'])}")
                L.append(f"{base}_count{ls} {e['count']}")
        for mn, help_ in (("lgbm_worker_stale",
                           "1 when the worker shard is stale (dead or "
                           "silent past the staleness threshold)"),
                          ("lgbm_worker_snapshot_age_seconds",
                           "seconds since the worker's last merged "
                           "metrics delta")):
            L.append(f"# HELP {mn} {help_}")
            L.append(f"# TYPE {mn} gauge")
            for wid, s in shards:
                age = now - s["updated"]
                v = age if mn.endswith("seconds") else float(
                    bool(s["stale"] or (thresh > 0 and age > thresh)))
                L.append(f"{mn}{_label_str((('worker', wid),))} "
                         f"{_fmt(round(v, 3))}")

    def _render_dropped(self, L: List[str]) -> None:
        with self._lock:
            dropped = sorted(self._dropped.items())
        if not dropped:
            return
        mn = "lgbm_metrics_dropped_series"
        L.append(f"# HELP {mn} label sets dropped at the per-metric "
                 "cardinality cap")
        L.append(f"# TYPE {mn} counter")
        for name, n in dropped:
            L.append(f"{mn}{_label_str((('metric', name),))} {n}")

    def _render_exemplars(self, L: List[str], ex_items) -> str:
        ex_typed: set = set()
        for (name, labels), ex in ex_items:
            base = _metric_name(name)
            if base not in ex_typed:
                ex_typed.add(base)
                L.append(f"# HELP {base} slowest-observation exemplar "
                         f"{_escape_help(name)}")
                L.append(f"# TYPE {base} gauge")
            extra = f'trace_id="{_escape_label(ex.get("trace_id") or "")}"'
            L.append(f"{base}{_label_str(labels, extra)} "
                     f"{_fmt(ex['value'])}")
        return "\n".join(L) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._hists.clear()
            self._collectors.clear()
            self._exemplars.clear()
            self._gauges.clear()
            self._dropped.clear()
            self._hist_overflow.clear()
            self._federated.clear()
            self.include_memory = True
            self.max_series_per_metric = DEFAULT_MAX_SERIES
            self.fed_stale_after_s = 3.0


_REGISTRY = MetricsRegistry()


def get_metrics() -> MetricsRegistry:
    return _REGISTRY


def metrics_text() -> str:
    return _REGISTRY.render()


def maybe_configure(config=None) -> None:
    """Apply the registry-shaped config params (``metrics_max_series``
    cardinality cap); call-anywhere idempotent."""
    cap = getattr(config, "metrics_max_series", None)
    if cap is not None:
        _REGISTRY.max_series_per_metric = int(cap)


# ---------------------------------------------------------------------
class FederationClient:
    """Worker-side half of the metrics federation: builds the delta a
    worker piggybacks on its heartbeat ``pong``.

    Each call to :meth:`delta` walks the local registry + telemetry
    and emits only series that CHANGED since the previous call — but
    every emitted series carries its full cumulative state (bucket
    counts, gauge value, counter total), so the supervisor's
    :meth:`MetricsRegistry.merge_snapshot` is replace-per-series and a
    lost or re-delivered pong can never double-count. A respawned
    worker starts a fresh client, re-ships everything once, and its
    cumulative counts simply replace the dead incarnation's shard.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 telemetry=None):
        self._registry = registry or get_metrics()
        self._telemetry = telemetry
        self._sent_hists: Dict[Tuple[str, Labels], int] = {}
        self._sent_gauges: Dict[Tuple[str, Labels], float] = {}
        self._sent_counters: Dict[str, float] = {}

    def delta(self) -> Dict[str, Any]:
        reg = self._registry
        tel = self._telemetry or get_telemetry()
        with reg._lock:
            hist_items = list(reg._hists.items())
            gauge_items = list(reg._gauges.items())
        hists: List[Dict[str, Any]] = []
        for key, h in hist_items:
            with h._lock:
                counts, total, s = list(h.counts), h.count, h.sum
            if self._sent_hists.get(key) == total:
                continue
            self._sent_hists[key] = total
            hists.append({"n": key[0], "l": dict(key[1]), "c": counts,
                          "t": total, "s": round(s, 6)})
        gauges: List[Dict[str, Any]] = []
        for key, v in gauge_items:
            if self._sent_gauges.get(key) == v:
                continue
            self._sent_gauges[key] = v
            gauges.append({"n": key[0], "l": dict(key[1]), "v": v})
        # telemetry numeric gauges + the device-memory gauges: the
        # worker owns its own CUDA context, so these are exactly the
        # per-worker device stats the parent scrape cannot see itself
        flat: Dict[str, float] = {}
        counters, raw_gauges = tel.counter_state()
        for name, v in raw_gauges.items():
            try:
                flat[str(name)] = float(v)
            except (TypeError, ValueError):
                continue
        try:
            for name, v in memory_snapshot().items():
                try:
                    flat[str(name)] = float(v)
                except (TypeError, ValueError):
                    continue
        except Exception:   # a metrics delta must never kill a pong
            pass
        for name, v in sorted(flat.items()):
            key = (name, ())
            if self._sent_gauges.get(key) == v:
                continue
            self._sent_gauges[key] = v
            gauges.append({"n": name, "v": v})
        out_c: Dict[str, float] = {}
        for name, v in counters.items():
            if self._sent_counters.get(name) == v:
                continue
            self._sent_counters[name] = float(v)
            out_c[str(name)] = float(v)
        out: Dict[str, Any] = {}
        if hists:
            out["hists"] = hists
        if gauges:
            out["gauges"] = gauges
        if out_c:
            out["counters"] = out_c
        return out


# ---------------------------------------------------------------------
# exporter: GET /metrics for processes without a serving frontend
class _MetricsHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_GET(self):  # noqa: N802 - http.server API
        if self.path.split("?", 1)[0] != "/metrics":
            body = b"not found; scrape /metrics\n"
            self.send_response(404)
        else:
            try:
                body = metrics_text().encode("utf-8")
                self.send_response(200)
            except Exception as e:  # defensive: scrape must answer
                body = f"# metrics render failed: {e}\n".encode()
                self.send_response(500)
        self.send_header("Content-Type", CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet: scrapes are periodic
        pass


_EXPORTER: List[Optional[Tuple[ThreadingHTTPServer,
                               threading.Thread]]] = [None]


def start_exporter(port: int,
                   host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Start the /metrics exporter thread; ``port=0`` binds an
    ephemeral port (``server.server_address`` has the real one).
    Idempotent per process: a running exporter is returned as-is."""
    if _EXPORTER[0] is not None:
        return _EXPORTER[0][0]
    server = ThreadingHTTPServer((host, int(port)), _MetricsHandler)
    thread = threading.Thread(target=server.serve_forever,
                              name="lgbm-metrics-exporter", daemon=True)
    thread.start()
    _EXPORTER[0] = (server, thread)
    addr = server.server_address
    log_info(f"metrics exporter on http://{addr[0]}:{addr[1]}/metrics")
    return server


def stop_exporter() -> None:
    entry = _EXPORTER[0]
    _EXPORTER[0] = None
    if entry is not None:
        server, thread = entry
        server.shutdown()
        server.server_close()
        thread.join(timeout=2.0)


def maybe_start_exporter(config=None) -> Optional[ThreadingHTTPServer]:
    """Config/env-driven exporter startup (the training-CLI opt-in):
    ``metrics_port`` config param, else ``LGBM_TPU_METRICS_PORT``.
    0/unset = off. Also enables ring-only telemetry so counters and
    phase histograms exist without a JSONL opt-in."""
    import os
    port = int(getattr(config, "metrics_port", 0) or 0)
    host = str(getattr(config, "metrics_host", "") or "127.0.0.1")
    if port <= 0:
        env = os.environ.get("LGBM_TPU_METRICS_PORT", "").strip()
        if not env:
            return None
        try:
            port = int(env)
        except ValueError:
            log_warning(f"LGBM_TPU_METRICS_PORT={env!r} is not a port")
            return None
        if port <= 0:
            return None
    get_telemetry().ensure_ring()
    try:
        return start_exporter(port, host)
    except OSError as e:
        log_warning(f"metrics exporter failed to bind port {port}: {e}")
        return None
