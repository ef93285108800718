"""Structured training telemetry: spans, counters, per-iteration records
(copy of ``lightgbm_tpu/observability/telemetry.py`` for the PyTorch
port: the same record kinds and field names, docs/Observability.md, so
``tools/run_report.py`` renders the port's file).

One process-wide :class:`Telemetry` instance (``get_telemetry()``)
collects

  * hierarchical **spans** — named wall-clock regions that nest
    (``with tel.span("train"): ...``) and accumulate per dotted path.
    The span context also drives ``utils/log.py``'s ``global_timer``
    (the reference's -DTIMETAG analog) and can open a named
    ``torch.profiler.record_function`` region;
  * typed **counters / gauges / distributions** — plain host floats
    (rows binned, histogram builds, collective payload bytes, ...);
  * **per-iteration records** — phase wall times (grad/grow/tree/
    update) accumulated by ``span(..., phase=True)`` between iteration
    boundaries, flushed by ``end_iteration``;
  * **build accounting** — the port's one compile is the kernel
    library's nvcc build (``ops/_native.py:BUILD_INFO``: its seconds,
    and whether this process built it or reused a built one), reported
    under ``train_end``'s ``compile`` key as JAX reports its jit
    compiles;
  * **launch accounting** — each ``iter`` record's ``counts`` carry the
    iteration's deltas of ``ops/_native.py:LAUNCHES`` and
    ``ROUTE_LAUNCHES`` as ``launch.<kernel>`` (0 on the CPU, where the
    plain versions launch nothing), beside ``host.dispatches`` (every
    device step the training loop issues, counted at its call site, on
    the kernel route and the plain one alike) and ``host.syncs`` (the
    loop's host reads: ``.cpu()``, ``.item()``, ``.tolist()``).

Records flow to pluggable sinks: an in-memory ring buffer, a JSONL
file (``LGBM_TPU_TELEMETRY=/path`` env or the ``telemetry_out`` config
parameter), and a verbosity-honoring summary printer.

Cost model: when disabled, every hook is a single attribute check and
``span()`` returns a shared no-op context manager — no host syncs and
no extra device->host transfers are ever issued by this module (the
launch deltas read host dicts); phase
spans measure HOST wall time around dispatches and values recorded at
iteration boundaries are already materialized by the caller.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..utils.log import Timer, get_verbosity, global_timer, log_info, \
    log_warning
from .tracing import get_tracer

class RingSink:
    """Bounded in-memory record buffer (the default sink)."""

    def __init__(self, maxlen: int = 4096):
        self._buf: deque = deque(maxlen=maxlen)

    def emit(self, rec: Dict[str, Any]) -> None:
        self._buf.append(rec)

    @property
    def records(self) -> List[Dict[str, Any]]:
        return list(self._buf)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


# record kinds worth an immediate file flush: run/summary boundaries
# are rare and losing them to buffer timing makes short CLI runs and
# preempted runs undiagnosable
_FLUSH_KINDS = ("run_start", "train_end", "serving_stats", "probe")


class JsonlSink:
    """Append-mode JSONL file sink; one record per line.

    Trailing-record durability: boundary records (``_FLUSH_KINDS``)
    flush immediately, and the module registers ONE process-wide
    ``atexit`` flush (plus the preemption handler's signal-time flush,
    robustness/preempt.py) so short CLI runs and preempted runs no
    longer lose whatever happened to sit in the stdio buffer."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    def _ensure(self):
        if self._fh is None:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "a")
        return self._fh

    def emit(self, rec: Dict[str, Any]) -> None:
        try:
            self._ensure().write(json.dumps(rec, default=_json_default)
                                 + "\n")
            if rec.get("kind") in _FLUSH_KINDS:
                self._fh.flush()
        except OSError as e:  # telemetry must never kill training
            log_warning(f"telemetry sink write failed: {e}")

    def flush(self) -> None:
        if self._fh is not None:
            try:
                self._fh.flush()
            except OSError:
                pass

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None


class SummarySink:
    """Prints a one-shot summary on ``train_end`` records, honoring the
    ``verbosity`` parameter (silent below verbosity 1)."""

    def emit(self, rec: Dict[str, Any]) -> None:
        if rec.get("kind") != "train_end" or get_verbosity() < 1:
            return
        parts = [f"{rec.get('iters', '?')} iters in "
                 f"{rec.get('dur_s', 0.0):.3f}s"]
        if rec.get("rows_per_s"):
            parts.append(f"{rec['rows_per_s'] / 1e6:.3f} Mrow-iters/s")
        comp = rec.get("compile") or {}
        if comp.get("count"):
            parts.append(f"compile {comp['count']}x "
                         f"{comp.get('seconds', 0.0):.2f}s")
        log_info("[telemetry] " + ", ".join(parts))
        phases = rec.get("phase_totals") or {}
        if phases:
            tot = sum(phases.values()) or 1.0
            body = "  ".join(f"{k}={v:.3f}s({100 * v / tot:.0f}%)"
                             for k, v in sorted(phases.items(),
                                                key=lambda kv: -kv[1]))
            log_info(f"[telemetry] phases: {body}")

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def _json_default(o):
    try:
        return float(o)
    except (TypeError, ValueError):
        return str(o)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Active span: telemetry accumulation + global_timer bridge +
    optional ``torch.profiler`` record_function region + the
    trace-correlation bridge (every telemetry span lands on the
    tracing.py timeline with ids when the tracer is enabled — the
    training side of the end-to-end trace plane rides this, no second
    instrumentation pass)."""

    __slots__ = ("tel", "name", "phase", "trace", "timer_on", "_t0",
                 "_path", "_ann", "_tspan")

    def __init__(self, tel: "Telemetry", name: str, phase: bool,
                 trace: Optional[str], timer_on: bool, tracer):
        self.tel = tel
        self.name = name
        self.phase = phase
        self.trace = trace
        self.timer_on = timer_on
        self._ann = None
        self._tspan = None if tracer is None \
            else tracer._begin(name, "train", None, None, scoped=True)

    def __enter__(self):
        tel = self.tel
        if tel._enabled:
            tel._stack.append(self.name)
            self._path = "/".join(tel._stack)
        else:
            self._path = None
        if self.timer_on:
            global_timer.begin(self.name)
        if self.trace is not None:
            from ..utils.log import annotate
            self._ann = annotate(self.trace)
            self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        if self._ann is not None:
            self._ann.__exit__(*exc)
        if self.timer_on:
            global_timer.end(self.name)
        if self._tspan is not None:
            self._tspan.finish()
        tel = self.tel
        if self._path is not None and tel._enabled:
            if tel._stack and tel._stack[-1] == self.name:
                tel._stack.pop()
            with tel._lock:
                acc = tel.spans.setdefault(self._path, [0.0, 0])
                acc[0] += dur
                acc[1] += 1
                if self.phase:
                    tel._iter_phases[self.name] = \
                        tel._iter_phases.get(self.name, 0.0) + dur
        return False


class Telemetry:
    """Process-wide telemetry aggregator. See module docstring."""

    def __init__(self):
        self._enabled = False
        # serving's flusher + worker threads mutate the counter/gauge/
        # dist dicts concurrently with the training thread; one
        # process-wide lock keeps the read-modify-write increments from
        # losing updates
        self._lock = threading.Lock()
        self._sinks: list = []
        self._ring: Optional[RingSink] = None
        self._stack: List[str] = []
        self.spans: Dict[str, list] = {}      # path -> [total_s, count]
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, Any] = {}
        self.dists: Dict[str, list] = {}      # name -> [n, sum, min, max]
        self._iter_phases: Dict[str, float] = {}
        self._iter_counts: Dict[str, float] = {}
        self._t0 = time.perf_counter()
        self._run_started = False
        self._launch_base = _launch_snapshot()
        self.last_iter: Optional[Dict[str, Any]] = None

    # -- lifecycle -----------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def configure(self, jsonl_path: Optional[str] = None,
                  ring: int = 4096, summary: bool = True) -> "Telemetry":
        """(Re)build the sink list and enable collection."""
        for s in self._sinks:
            s.close()
        self._sinks = []
        self._ring = RingSink(maxlen=ring)
        self._sinks.append(self._ring)
        if jsonl_path:
            self._sinks.append(JsonlSink(jsonl_path))
        if summary:
            self._sinks.append(SummarySink())
        self._enabled = True
        self._t0 = time.perf_counter()
        self._launch_base = _launch_snapshot()
        _install_atexit_flush()
        return self

    def ensure_started(self, config=None) -> None:
        """Idempotent env/config-driven startup: enables collection when
        ``LGBM_TPU_TELEMETRY`` (env) or ``telemetry_out`` (config/CLI)
        names a JSONL path, and emits the one-time ``run_start`` record.
        Called from every training entry point; a no-op when neither
        knob is set and telemetry was not enabled programmatically."""
        # the trace-correlation plane (tracing.py) shares this seam:
        # trace_out / LGBM_TPU_TRACE and the profiler window arm here,
        # so every entry point that starts telemetry starts tracing
        get_tracer().ensure_started(config)
        path = (getattr(config, "telemetry_out", "") or "").strip() \
            or os.environ.get("LGBM_TPU_TELEMETRY", "").strip()
        if not self._enabled:
            if not path:
                return
            self.configure(jsonl_path=path)
        elif path and not any(isinstance(s, JsonlSink)
                              for s in self._sinks):
            # ring-only mode can be enabled first (a record_telemetry
            # callback, bench warm-up); an env/config JSONL path must
            # still attach its sink instead of being silently dropped
            self._sinks.append(JsonlSink(path))
            if not any(isinstance(s, SummarySink) for s in self._sinks):
                self._sinks.append(SummarySink())
        if not self._run_started:
            self._run_started = True
            self.record("run_start", **_run_meta(config))

    def ensure_ring(self, ring: int = 4096) -> None:
        """Enable ring-buffer-only collection (no file) when telemetry
        is off — used by the ``record_telemetry`` callback and bench so
        counters/records exist without any env/config opt-in."""
        if not self._enabled:
            self.configure(jsonl_path=None, ring=ring, summary=False)

    def disable(self) -> None:
        self.flush()
        for s in self._sinks:
            s.close()
        self._enabled = False
        self._run_started = False

    def reset(self) -> None:
        """Test helper: drop all accumulated state and sinks."""
        self.disable()
        self.__init__()

    # -- spans ---------------------------------------------------------
    def span(self, name: str, phase: bool = False,
             trace: Optional[str] = None):
        """Timed region. ``phase=True`` also accumulates the duration
        into the current iteration's phase table; ``trace=<name>`` opens
        a named ``torch.profiler.record_function`` region."""
        timer_on = Timer._enabled
        tracer = get_tracer()
        if not self._enabled and not timer_on and trace is None \
                and not tracer._enabled:
            return _NULL_SPAN
        return _Span(self, name, phase, trace, timer_on,
                     tracer if tracer._enabled else None)

    # -- metrics -------------------------------------------------------
    def count(self, name: str, value: float = 1.0) -> None:
        if self._enabled:
            v = float(value)
            with self._lock:
                self.counters[name] = self.counters.get(name, 0.0) + v

    def count_iter(self, name: str, value: float = 1.0) -> None:
        """Counter that ALSO accumulates into the current iteration's
        ``counts`` table (flushed into the ``iter`` record by
        ``end_iteration``, like phase spans). Used for the dispatch/
        host-sync accounting: ``host.dispatches`` counts device-program
        launches our training loop issues, ``host.syncs`` counts
        blocking device->host fetches. Both are counted at the call
        sites in models/gbdt.py, basic.py and learner/*, NOT inferred —
        a site the loop stops issuing simply stops being counted."""
        if self._enabled:
            v = float(value)
            with self._lock:
                self.counters[name] = self.counters.get(name, 0.0) + v
                self._iter_counts[name] = \
                    self._iter_counts.get(name, 0.0) + v

    def gauge(self, name: str, value) -> None:
        if self._enabled:
            with self._lock:
                self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        if self._enabled:
            v = float(value)
            with self._lock:
                d = self.dists.get(name)
                if d is None:
                    self.dists[name] = [1, v, v, v]
                else:
                    d[0] += 1
                    d[1] += v
                    d[2] = min(d[2], v)
                    d[3] = max(d[3], v)

    def counter_state(self) -> Tuple[Dict[str, float], Dict[str, Any]]:
        """Consistent (counters, gauges) copies under one lock hold —
        the federation client's snapshot source (metrics.py
        ``FederationClient``); also handy for tests."""
        with self._lock:
            return dict(self.counters), dict(self.gauges)

    # -- records -------------------------------------------------------
    def record(self, kind: str, **fields) -> None:
        if not self._enabled:
            return
        rec: Dict[str, Any] = {
            "kind": kind,
            "t": round(time.perf_counter() - self._t0, 6)}
        rec.update(fields)
        for s in self._sinks:
            s.emit(rec)

    def end_iteration(self, iteration: int, **fields) -> None:
        """Close one boosting iteration: emits an ``iter`` record with
        the phase wall times accumulated since the previous boundary and
        the iteration's kernel launches (``launch.<kernel>``: the deltas
        of ``ops/_native.py``'s counters since the previous boundary).
        Call only at iteration boundaries — the fields passed must
        already be host values (no device syncs are issued here)."""
        if not self._enabled:
            return
        now = _launch_snapshot()
        with self._lock:
            phases = {k: round(v, 6)
                      for k, v in self._iter_phases.items()}
            self._iter_phases = {}
            counts = {k: v for k, v in self._iter_counts.items()}
            self._iter_counts = {}
            for name, v in now.items():
                counts[f"launch.{name}"] = float(
                    v - self._launch_base.get(name, 0))
            self._launch_base = now
        # feed the live metrics plane (observability/metrics.py): the
        # per-iteration phase wall times become the
        # train_phase_seconds{phase=...} histogram a /metrics scrape
        # can derive p50/p95/p99 from
        try:
            from .metrics import get_metrics
            reg = get_metrics()
            for name, dur in phases.items():
                reg.observe("train_phase_seconds", dur,
                            labels={"phase": name})
        except Exception:  # metrics must never kill an iteration
            pass
        rec = dict(iter=int(iteration), phases=phases, **fields)
        if counts:
            rec["counts"] = counts
        self.last_iter = rec
        self.record("iter", **rec)

    def eval_results(self, iteration: int, results) -> None:
        """Emit one ``eval`` record: [[dataset, metric, value,
        bigger_is_better], ...] at an iteration boundary."""
        if not self._enabled or not results:
            return
        self.record("eval", iter=int(iteration),
                    results=[[r[0], r[1], float(r[2]), bool(r[3])]
                             for r in results])

    def phase_totals(self) -> Dict[str, float]:
        """Per-phase totals across all iterations so far (seconds),
        derived from phase spans at any depth."""
        out: Dict[str, float] = {}
        for path, (tot, _cnt) in self.spans.items():
            name = path.rsplit("/", 1)[-1]
            if name in ("grad", "grow", "tree", "update", "eval",
                        "hist", "split", "partition"):
                out[name] = out.get(name, 0.0) + tot
        return {k: round(v, 6) for k, v in out.items()}

    def compile_stats(self) -> Dict[str, float]:
        """The kernel library's build (``ops/_native.py:BUILD_INFO``):
        ``count`` 1 when this process ran nvcc, ``cache_hits`` 1 when it
        loaded a library already built, ``seconds`` the build's wall
        time (0 when reused or not loaded)."""
        from ..ops import _native
        info = _native.BUILD_INFO
        built = info.get("built")
        return {"count": int(built is True),
                "seconds": round(float(info.get("seconds") or 0.0), 6),
                "trace_seconds": 0.0,
                "cache_hits": int(built is False)}

    @property
    def records(self) -> List[Dict[str, Any]]:
        return self._ring.records if self._ring is not None else []

    def flush(self) -> None:
        for s in self._sinks:
            s.flush()


def _launch_snapshot() -> Dict[str, int]:
    """The kernel launch counters as they stand (host dicts)."""
    from ..ops import _native
    out = dict(_native.LAUNCHES)
    out.update(_native.ROUTE_LAUNCHES)
    return out


def _run_meta(config=None) -> Dict[str, Any]:
    meta: Dict[str, Any] = {"pid": os.getpid(),
                            "wall_time": time.time()}
    try:
        import torch
        meta["torch_version"] = torch.__version__
        cuda = torch.cuda.is_available()
        meta["backend"] = "cuda" if cuda else "cpu"
        meta["device_count"] = torch.cuda.device_count() if cuda else 0
        if cuda:
            meta["device_name"] = torch.cuda.get_device_name(0)
    except Exception:  # pragma: no cover
        pass
    if config is not None:
        keys = ("objective", "tree_learner", "num_leaves",
                "num_iterations", "learning_rate", "max_bin",
                "bagging_fraction", "bagging_freq", "feature_fraction",
                "num_class", "boosting")
        meta["config"] = {k: getattr(config, k) for k in keys
                          if hasattr(config, k)}
    return meta


def memory_snapshot() -> Dict[str, Any]:
    """The CUDA caching allocator's statistics, for end-of-train records
    and crash dumps: bytes allocated now and at peak, and the
    allocator's own counters; ``{}`` without a card (the CPU path holds
    no device memory)."""
    out: Dict[str, Any] = {}
    try:
        import torch
        if not torch.cuda.is_available() \
                or not torch.cuda.is_initialized():
            return out
        out["device_bytes_in_use"] = int(torch.cuda.memory_allocated())
        out["device_peak_bytes"] = int(torch.cuda.max_memory_allocated())
        stats = torch.cuda.memory_stats()
        for key in ("reserved_bytes.all.current", "num_alloc_retries",
                    "num_ooms"):
            if key in stats:
                out[key] = int(stats[key])
    except Exception:  # memory stats are best-effort
        pass
    return out


def traced_bytes(tree) -> int:
    """Payload size (bytes) of a tensor or a (nested) list, tuple or
    dict of tensors and arrays: the sum of their ``nbytes`` (shape and
    dtype only, never the contents)."""
    if isinstance(tree, dict):
        return sum(traced_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(traced_bytes(v) for v in tree)
    nbytes = getattr(tree, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    return 0


_TELEMETRY = Telemetry()
_ATEXIT_INSTALLED = [False]


def _atexit_flush() -> None:
    """Interpreter-exit flush of the singleton's sinks, so a short CLI
    run never loses trailing records to buffer timing. Also invoked
    from the preemption signal handler (flush() is async-signal-safe
    enough: pure-Python file flushes, no locks held across it)."""
    tel = _TELEMETRY
    if tel._enabled:
        try:
            tel.flush()
        except Exception:  # interpreter may be tearing down
            pass


def _install_atexit_flush() -> None:
    if not _ATEXIT_INSTALLED[0]:
        _ATEXIT_INSTALLED[0] = True
        atexit.register(_atexit_flush)


def get_telemetry() -> Telemetry:
    return _TELEMETRY


def telemetry_enabled() -> bool:
    return _TELEMETRY._enabled
