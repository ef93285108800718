"""ServingEngine: micro-batched, shape-bucketed inference on the card
(port of ``lightgbm_tpu/serving/engine.py``).

Request lifecycle::

    submit()/predict() -> bounded queue -> deadline flusher thread
        -> coalesce into one batch -> group by (kind, route)
        -> pad to power-of-two bucket -> one graph replay
        -> slice per request -> fulfill futures

The per-request cost is amortized two ways: the model registry pins
each version's stacked trees on the device once, and every dispatch
pads its row count to a configured power-of-two bucket, so each
(model-version, bucket, kind) is captured as a CUDA graph exactly once
(``serving/programs.py``) — :meth:`_warmup` captures the configured
buckets before the version takes traffic, so steady-state traffic of
arbitrary batch sizes triggers zero new captures (``graph_captures`` in
:meth:`stats`). On the CPU the same programs run eagerly.

Degradation is graceful and structured: a full queue sheds
(:class:`QueueFullError`, policy ``reject_new`` or ``drop_oldest``), a
passed deadline raises :class:`RequestTimeoutError`, and a device-route
failure falls back to the CPU walk when ``fallback_to_host`` (counted
in ``fallbacks`` and warned, never silent). A program that fails to
capture while a version warms up fails the load: the previous version
keeps serving and :meth:`health` reports ``degraded``.

Routes: the port's predictor walks raw float64 features, so every
source (a trained booster, model text, npz) serves on the engine's
``device`` (a CUDA device; None: the card, or raise) and equals the
JAX package's float64 host loop to the bit. ``device="auto"`` and
``"always"`` send every request, ``pred_leaf`` included, to the
engine's device (``auto`` thereby mirrors the port's own
``Booster.predict``); ``"never"`` is the caller's explicit request for
the walk on the CPU (``host``).
"""

from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..observability.metrics import get_metrics
from ..observability.telemetry import get_telemetry
from ..observability.tracing import (get_tracer, profile_boundary,
                                     program_args)
from ..utils.log import log_info, log_warning
from .errors import (EngineStoppedError, InvalidRequestError,
                     QueueFullError, RequestTimeoutError, ServingError)
from .programs import BucketProgram
from .registry import ModelRegistry

KINDS = ("predict", "raw_score", "pred_leaf")


def _pow2_buckets(spec) -> Tuple[int, ...]:
    """Normalize a bucket spec ("1,8,64" / iterable) to sorted unique
    powers of two (rounded up, as the JAX package rounds them)."""
    if isinstance(spec, str):
        vals = [int(v) for v in spec.replace(";", ",").split(",") if v]
    else:
        vals = [int(v) for v in spec]
    out = set()
    for v in vals:
        if v <= 0:
            raise ValueError(f"bucket sizes must be positive, got {v}")
        b = 1
        while b < v:
            b <<= 1
        out.add(b)
    if not out:
        raise ValueError("at least one bucket is required")
    return tuple(sorted(out))


def bucket_for(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest configured bucket >= n (callers chunk at max(buckets),
    so n never exceeds it)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class ServingConfig:
    """Engine tuning knobs; see docs/Serving.md for guidance."""

    buckets: Tuple[int, ...] = (1, 8, 64, 512)
    max_batch_rows: int = 0          # 0 -> max(buckets)
    max_queue: int = 1024            # queued requests before shedding
    flush_interval_ms: float = 2.0   # micro-batch coalescing window
    request_timeout_ms: float = 1000.0
    shed_policy: str = "reject_new"  # or "drop_oldest"
    device: str = "auto"             # auto | always | never
    warmup: bool = True
    # pred_leaf is a device route in the port, so it warms up too
    warmup_kinds: Tuple[str, ...] = KINDS
    fallback_to_host: bool = True
    aot: bool = True                 # publish/attach AOT artifacts

    def __post_init__(self):
        self.buckets = _pow2_buckets(self.buckets)
        if not self.max_batch_rows:
            self.max_batch_rows = self.buckets[-1]
        if self.shed_policy not in ("reject_new", "drop_oldest"):
            raise ValueError(
                f"unknown shed_policy {self.shed_policy!r}")
        if self.device not in ("auto", "always", "never"):
            raise ValueError(f"unknown device mode {self.device!r}")

    @classmethod
    def from_config(cls, cfg) -> "ServingConfig":
        """Build from the lightgbm Config's ``serving_*`` params."""
        kw: Dict[str, Any] = {}
        if getattr(cfg, "serving_buckets", None):
            kw["buckets"] = cfg.serving_buckets
        for src_name, dst in (("serving_max_queue", "max_queue"),
                              ("serving_flush_ms", "flush_interval_ms"),
                              ("serving_timeout_ms",
                               "request_timeout_ms"),
                              ("serving_shed_policy", "shed_policy"),
                              ("serving_device", "device"),
                              ("serving_warmup", "warmup"),
                              ("serving_aot", "aot")):
            if hasattr(cfg, src_name):
                kw[dst] = getattr(cfg, src_name)
        return cls(**kw)


class _Request:
    __slots__ = ("rows", "kind", "t_enqueue", "deadline", "event",
                 "result", "error", "meta", "ctx", "qspan", "t_perf",
                 "t_perf_done", "wspans")

    def __init__(self, rows: np.ndarray, kind: str,
                 timeout_s: Optional[float]):
        self.rows = rows
        self.kind = kind
        self.t_enqueue = time.monotonic()
        self.t_perf = time.perf_counter()
        self.deadline = None if timeout_s is None \
            else self.t_enqueue + timeout_s
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[ServingError] = None
        self.meta: Dict[str, Any] = {}
        # trace correlation (observability/tracing.py): the request's
        # TraceContext and its open queue-wait span (started at submit
        # on the caller's thread, finished on the flusher thread when
        # the request is pulled into a batch)
        self.ctx = None
        self.qspan = None
        self.t_perf_done: Optional[float] = None
        # span records a process-fleet worker shipped back with the
        # reply (procfleet._resolve fills it; the supervisor's request
        # watcher replays them under the parent trace)
        self.wspans: Optional[List[Dict[str, Any]]] = None


class ServingFuture:
    """Handle for an async :meth:`ServingEngine.submit`."""

    __slots__ = ("_req",)

    def __init__(self, req: _Request):
        self._req = req

    def done(self) -> bool:
        return self._req.event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._req.event.wait(timeout):
            raise RequestTimeoutError(
                "result not ready within caller wait",
                waited_s=timeout)
        if self._req.error is not None:
            raise self._req.error
        return self._req.result

    @property
    def meta(self) -> Dict[str, Any]:
        return dict(self._req.meta)


class ServingEngine:
    """Embeddable serving frontend; see module docstring. ``device``
    (as ``lt.Booster``'s) is where versions pin and serve; a given
    ``registry`` brings its own."""

    def __init__(self, source=None,
                 config: Optional[ServingConfig] = None,
                 registry: Optional[ModelRegistry] = None,
                 auto_start: bool = True, device=None):
        self.config = config or ServingConfig()
        self.registry = registry or ModelRegistry(device)
        self.device = self.registry.device
        self._auto_start = auto_start
        self._cond = threading.Condition()
        self._queue: List[_Request] = []
        self._queued_rows = 0
        self._stop = False
        self._started = False
        self._thread: Optional[threading.Thread] = None
        self._stats_lock = threading.Lock()
        self._counts: Dict[str, float] = {}
        self._latencies: List[float] = []   # bounded reservoir (ms)
        self._latency_cap = 8192
        self._bucket_seen = set()           # (version, bucket)
        # per-(kind, bucket) slowest-request exemplar: latency + the
        # trace id of the request behind it (docs/Observability.md)
        self._slowest: Dict[str, Dict[str, Any]] = {}
        self._queue_peak = 0
        self._warmup_s = 0.0
        self._last_reload_error: Optional[Dict[str, Any]] = None
        # live metrics plane (observability/metrics.py): request
        # latency lands in the per-(kind, bucket) log histogram and a
        # scrape-time collector exposes the counters + queue depth as
        # gauges on GET /metrics. The collector holds only a weakref —
        # a dropped engine unregisters itself.
        self._metrics = get_metrics()
        ref = weakref.ref(self)

        def _collect() -> Dict[str, float]:
            eng = ref()
            if eng is None:
                return {}
            with eng._stats_lock:
                out = {f"serving_{k}": v
                       for k, v in eng._counts.items()}
                out["serving_queue_peak"] = eng._queue_peak
            out["serving_queue_depth"] = eng.queue_depth
            return out

        self._metrics.register_collector(_collect, owner=self)
        if source is not None:
            self.load(source)

    # -- model lifecycle -----------------------------------------------
    def load(self, source, aot=None) -> int:
        """Load + warm up + atomically activate a model version; the
        previous version (if any) drains. Returns the new version id.
        In-flight and queued requests never fail across the swap.

        ``aot`` names a predict artifact (serving/aot.py) built by the
        publisher for this exact model text — attaching it pins the
        bundle's stack instead of restacking the parsed trees. Artifact
        trouble restacks the trees rather than failing the load (the
        model text itself is intact), counted in
        ``aot_attach_failures`` and warned.

        A failed (re)load — e.g. a torn model file rejected by the
        registry's integrity checks — raises, KEEPS the previous
        version serving, and flags the engine degraded (surfaced in
        ``health()``) until a load succeeds."""
        pin = self.config.device != "never"
        try:
            mv = self.registry.load(source, pin_device=False)
            if aot and self.config.aot and pin:
                self._attach_aot(mv, aot, source)
            if pin:
                mv.pin_device(self.device)   # no-op once attached
            if self.config.warmup:
                self._warmup(mv)
        except Exception as e:
            self._last_reload_error = {
                "error": str(e),
                "code": getattr(e, "code", type(e).__name__),
                "source": str(source)[:256],
                "at": time.time(),
            }
            self._count("reload_failures")
            log_warning(f"serving: model load failed "
                        f"(still serving the previous version): {e}")
            raise
        had_old = self.registry.current() is not None
        self.registry.activate(mv)
        self._last_reload_error = None
        if had_old:
            self._count("reloads")
        return mv.version

    reload = load

    def _attach_aot(self, mv, path: str, source) -> None:
        """Attach an AOT artifact to a fresh version; the sha binds it
        to the model text being loaded. Failure counts and restacks the
        parsed trees (publish-time round-trip already validated the
        bundle, so a failure here is artifact loss — e.g. a cleaned
        cache dir — not a correctness hazard)."""
        from .aot import load_artifact, text_sha
        try:
            expected = text_sha(source) if isinstance(source, str) \
                and "\n" in source else None
            mv.attach_aot(load_artifact(path, expected_sha=expected,
                                        device=self.device))
            self._count("aot_attach")
        except Exception as e:
            self._count("aot_attach_failures")
            log_warning(f"serving: AOT artifact unusable ({e}); "
                        "serving the restacked model text")

    def _warmup(self, mv) -> None:
        """Capture every configured (bucket, kind) program for the new
        version BEFORE it takes traffic (reload pays the captures off
        the hot path). A version served on the CPU walk has nothing to
        capture."""
        if not mv.device_ready:
            return
        tel = get_telemetry()
        t0 = time.perf_counter()
        with tel.span("serving.warmup"):
            for b in self.config.buckets:
                x = np.zeros((b, mv.num_features))
                for kind in self.config.warmup_kinds:
                    self._compute(mv, x, kind, "device")
        dur = time.perf_counter() - t0
        with self._stats_lock:
            self._warmup_s = dur
        self._count("warmup_buckets", len(self.config.buckets))
        log_info(f"serving: warmed {len(self.config.buckets)} buckets "
                 f"{list(self.config.buckets)} for v{mv.version} in "
                 f"{dur:.2f}s")

    @property
    def version(self) -> Optional[int]:
        mv = self.registry.current()
        return None if mv is None else mv.version

    # -- engine lifecycle ----------------------------------------------
    def start(self) -> "ServingEngine":
        with self._cond:
            if self._started:
                return self
            self._stop = False
            self._started = True
            self._thread = threading.Thread(
                target=self._flush_loop, name="lgbm-serving-flusher",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 10.0) -> None:
        """Stop the flusher. ``drain=True`` serves everything already
        queued first; otherwise queued requests fail with
        EngineStoppedError."""
        with self._cond:
            if not drain:
                for r in self._queue:
                    self._fail(r, EngineStoppedError(
                        "engine stopped before dispatch"))
                self._queue.clear()
                self._queued_rows = 0
            self._stop = True
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout)
        with self._cond:
            self._started = False
            self._thread = None
            for r in self._queue:     # drain thread died / timed out
                self._fail(r, EngineStoppedError(
                    "engine stopped before dispatch"))
            self._queue.clear()
            self._queued_rows = 0
        tel = get_telemetry()
        if tel.enabled:
            tel.record("serving_stats", **self.stats())
            # histogram snapshots ride the trace as ``hist`` records so
            # tools/run_report.py can render offline what a /metrics
            # scrape would have shown live
            for snap in self._metrics.snapshots(prefix="serving_"):
                tel.record("hist", **snap)
            tel.flush()
        get_tracer().flush()   # persist the request timeline

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- request entry -------------------------------------------------
    def _validate(self, rows) -> np.ndarray:
        try:
            arr = np.asarray(rows, np.float64)
        except (TypeError, ValueError) as e:
            raise InvalidRequestError(f"rows not numeric: {e}") from e
        if arr.ndim == 1:
            arr = arr[None, :]
        if arr.ndim != 2 or arr.shape[0] == 0 or arr.shape[1] == 0:
            raise InvalidRequestError(
                f"rows must be a non-empty 2-D matrix, got shape "
                f"{arr.shape}")
        mv = self.registry.current()
        if mv is None:
            raise ServingError("no model loaded")
        nfeat = mv.num_features
        if arr.shape[1] != nfeat:
            raise InvalidRequestError(
                f"expected {nfeat} features per row, got "
                f"{arr.shape[1]}", expected=nfeat, got=arr.shape[1])
        return arr

    def submit(self, rows, kind: str = "predict",
               timeout_ms: Optional[float] = None,
               trace_ctx=None) -> ServingFuture:
        """Enqueue a request; returns a future. Raises QueueFullError
        under the reject_new shed policy when the queue is at
        max_queue. ``trace_ctx`` parents the request's spans (the
        HTTP frontend / fleet dispatch hand their context down)."""
        if kind not in KINDS:
            raise InvalidRequestError(
                f"unknown kind {kind!r}; one of {KINDS}")
        arr = self._validate(rows)
        t = self.config.request_timeout_ms if timeout_ms is None \
            else timeout_ms
        req = _Request(arr, kind, None if t <= 0 else t / 1000.0)
        tracer = get_tracer()
        if tracer.enabled:
            ctx = trace_ctx or tracer.current() or tracer.new_trace()
            req.ctx = ctx
            req.qspan = tracer.begin_span(
                "serving.queue_wait", cat="serving", ctx=ctx,
                args={"kind": kind, "rows": len(arr)})
            req.meta["trace_id"] = ctx.trace_id
        with self._cond:
            if self._stop:
                raise EngineStoppedError("engine is stopped")
            if len(self._queue) >= self.config.max_queue:
                self._count("shed")
                if self.config.shed_policy == "reject_new":
                    raise QueueFullError(
                        "request queue full",
                        max_queue=self.config.max_queue,
                        queue_depth=len(self._queue))
                oldest = self._queue.pop(0)
                self._queued_rows -= len(oldest.rows)
                self._fail(oldest, QueueFullError(
                    "shed by a newer request (drop_oldest)",
                    max_queue=self.config.max_queue))
            self._queue.append(req)
            self._queued_rows += len(req.rows)
            self._queue_peak = max(self._queue_peak, len(self._queue))
            self._cond.notify_all()
        self._count("requests")
        self._count("rows", len(arr))
        if self._auto_start and not self._started:
            self.start()
        return ServingFuture(req)

    def predict(self, rows, kind: str = "predict",
                timeout_ms: Optional[float] = None) -> np.ndarray:
        """Synchronous predict through the micro-batching queue."""
        fut = self.submit(rows, kind, timeout_ms=timeout_ms)
        t = self.config.request_timeout_ms if timeout_ms is None \
            else timeout_ms
        # caller-side wait gets slack past the engine deadline so the
        # flusher's structured timeout (not the wait) is what surfaces
        wait = None if t <= 0 else t / 1000.0 + 5.0
        return fut.result(timeout=wait)

    def predict_now(self, rows, kind: str = "predict") -> np.ndarray:
        """Bypass the queue: validate, route and dispatch on the
        calling thread (the C-API single-row fast path and closed-loop
        benchmarks; no flusher required)."""
        if kind not in KINDS:
            raise InvalidRequestError(
                f"unknown kind {kind!r}; one of {KINDS}")
        arr = self._validate(rows)
        t0 = time.monotonic()
        tracer = get_tracer()
        trace_id = None
        if tracer.enabled:
            with tracer.span("serving.request", cat="serving",
                             args={"kind": kind, "rows": len(arr),
                                   "route_mode": "bypass"}) as sp:
                trace_id = sp.ctx.trace_id
                with self.registry.checkout() as mv:
                    route = self._route_for(mv, len(arr), kind)
                    out = self._compute_safe(mv, arr, kind, route)
        else:
            with self.registry.checkout() as mv:
                route = self._route_for(mv, len(arr), kind)
                out = self._compute_safe(mv, arr, kind, route)
        self._count("requests")
        self._count("rows", len(arr))
        self._observe_latency((time.monotonic() - t0) * 1000.0,
                              kind=kind, rows=len(arr),
                              trace_id=trace_id)
        return out

    # -- flusher -------------------------------------------------------
    def _flush_loop(self) -> None:
        while True:
            batch: List[_Request] = []
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait()
                if not self._queue and self._stop:
                    return
                # deadline-based coalescing: hold the batch open until
                # the oldest request's flush deadline or the row budget
                flush_at = self._queue[0].t_enqueue \
                    + self.config.flush_interval_ms / 1000.0
                while not self._stop:
                    now = time.monotonic()
                    if now >= flush_at \
                            or self._queued_rows \
                            >= self.config.max_batch_rows:
                        break
                    self._cond.wait(timeout=flush_at - now)
                total = 0
                while self._queue:
                    r = self._queue[0]
                    if batch and total + len(r.rows) \
                            > self.config.max_batch_rows:
                        break
                    batch.append(self._queue.pop(0))
                    total += len(r.rows)
                    self._queued_rows -= len(r.rows)
            if batch:
                try:
                    self._dispatch(batch)
                except Exception as e:  # never kill the flusher
                    err = e if isinstance(e, ServingError) \
                        else ServingError(f"dispatch failed: {e}")
                    for r in batch:
                        self._fail(r, err)

    def _dispatch(self, batch: List[_Request]) -> None:
        now = time.monotonic()
        live: List[_Request] = []
        for r in batch:
            # the queue-wait span closes HERE for every outcome — a
            # request timing out in the queue still leaves its wait on
            # the timeline (that wait IS the diagnosis)
            queue_ms = round((now - r.t_enqueue) * 1000.0, 3)
            r.meta["queue_ms"] = queue_ms
            if r.deadline is not None and now > r.deadline:
                if r.qspan is not None:
                    r.qspan.finish(queue_ms=queue_ms, outcome="timeout")
                    r.qspan = None
                self._count("timeouts")
                self._fail(r, RequestTimeoutError(
                    "deadline passed before dispatch",
                    timeout_ms=self.config.request_timeout_ms))
            else:
                if r.qspan is not None:
                    r.qspan.finish(queue_ms=queue_ms)
                    r.qspan = None
                live.append(r)
        if not live:
            return
        self._count("batches")
        with self.registry.checkout() as mv:
            groups: Dict[Tuple[str, str], List[_Request]] = {}
            for r in live:
                route = self._route_for(mv, len(r.rows), r.kind)
                groups.setdefault((r.kind, route), []).append(r)
            for (kind, route), reqs in groups.items():
                self._run_group(mv, kind, route, reqs)

    def _run_group(self, mv, kind: str, route: str,
                   reqs: List[_Request]) -> None:
        x = np.concatenate([r.rows for r in reqs]) if len(reqs) > 1 \
            else reqs[0].rows
        tracer = get_tracer()
        # the coalesced batch is one span (parented under the FIRST
        # request's trace; the other member traces join it via their
        # own per-request events carrying batch_span)
        bspan = tracer.begin_span(
            "serving.batch", cat="serving",
            ctx=reqs[0].ctx,
            args={"kind": kind, "route": route, "rows": len(x),
                  "requests": len(reqs)}) \
            if tracer.enabled and reqs[0].ctx is not None else None
        t_c0 = time.perf_counter()
        try:
            if bspan is not None:
                with tracer.attach(bspan.ctx):
                    out = self._compute_safe(mv, x, kind, route)
            else:
                out = self._compute_safe(mv, x, kind, route)
        except ServingError as e:
            if bspan is not None:
                bspan.finish(error=e.code)
            for r in reqs:
                self._fail(r, e)
            return
        except Exception as e:
            if bspan is not None:
                bspan.finish(error="compute_failed")
            err = ServingError(f"compute failed: {e}")
            for r in reqs:
                self._fail(r, err)
            return
        t_c1 = time.perf_counter()
        compute_ms = round((t_c1 - t_c0) * 1000.0, 3)
        if bspan is not None:
            bspan.finish(compute_ms=compute_ms)
        profile_boundary("serving.batch")
        lo = 0
        done_t = time.monotonic()
        for r in reqs:
            n = len(r.rows)
            r.result = out[lo:lo + n]
            lo += n
            lat = (done_t - r.t_enqueue) * 1000.0
            r.meta.update(version=mv.version, route=route, kind=kind,
                          batch_rows=len(x), latency_ms=round(lat, 3),
                          compute_ms=compute_ms)
            if r.ctx is not None:
                # one summary event per request decomposing its
                # latency: queue-wait (enqueue -> batch pull) vs the
                # shared batch compute (device dispatch included)
                tracer.emit_complete(
                    "serving.request", r.t_perf,
                    r.t_perf + (done_t - r.t_enqueue),
                    cat="serving", ctx=r.ctx,
                    args={"kind": kind, "route": route, "rows": n,
                          "queue_ms": r.meta.get("queue_ms"),
                          "compute_ms": compute_ms,
                          "batch_rows": len(x),
                          "batch_span": bspan.ctx.span_id
                          if bspan is not None else None,
                          "latency_ms": round(lat, 3)})
            self._observe_latency(lat, kind=kind, rows=n,
                                  trace_id=r.ctx.trace_id
                                  if r.ctx is not None else None)
            r.t_perf_done = time.perf_counter()
            r.event.set()

    # -- routing & compute ---------------------------------------------
    def _route_for(self, mv, n_rows: int, kind: str) -> str:
        # auto and always: the engine's device for every kind and size,
        # as the port's Booster.predict (no size threshold: the JAX
        # package's device_min_cells skips an XLA compile)
        if self.config.device == "never" or not mv.device_ready:
            return "host"
        return "device"

    def _compute_safe(self, mv, x: np.ndarray, kind: str,
                      route: str) -> np.ndarray:
        if route == "device":
            try:
                return self._compute(mv, x, kind, "device")
            except Exception as e:
                if not self.config.fallback_to_host:
                    raise
                self._count("fallbacks")
                log_warning(f"serving: device path failed ({e}); "
                            "falling back to the CPU walk")
        return self._compute(mv, x, kind, "host")

    def _compute(self, mv, x: np.ndarray, kind: str,
                 route: str) -> np.ndarray:
        from .. import predictor
        if route != "device":
            return predictor.predict(
                mv.src, x, "cpu", raw_score=kind == "raw_score",
                pred_leaf=kind == "pred_leaf").numpy()
        # device: chunk at the largest bucket; each chunk runs its
        # bucket's program (pad, walk, add, convert), captured once
        cap = self.config.buckets[-1]
        tracer = get_tracer()
        parts: List[np.ndarray] = []
        for lo in range(0, len(x), cap):
            chunk = x[lo:lo + cap]
            n = len(chunk)
            b = bucket_for(n, self.config.buckets)
            key = (mv.version, b)
            with self._stats_lock:
                hit = key in self._bucket_seen
                if not hit:
                    self._bucket_seen.add(key)
            self._count("bucket_hits" if hit else "bucket_misses")
            prog = self._program(mv, b, kind)
            if tracer.enabled:
                dargs = program_args("serve_rows")
                dargs.update(bucket=b, rows=n, version=mv.version,
                             graph=prog.graph is not None)
                with tracer.span("device.dispatch", cat="device",
                                 args=dargs):
                    out = prog.run(chunk)
            else:
                out = prog.run(chunk)
            if prog.graph is not None:
                self._count("graph_replays")
            parts.append(out)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _program(self, mv, bucket: int, kind: str) -> BucketProgram:
        """The version's (bucket, kind) program, captured on first use
        (the warmup's, for the configured kinds)."""
        key = (bucket, kind)
        with mv.program_lock:
            prog = mv.programs.get(key)
            if prog is None:
                prog = BucketProgram(mv.src, mv.stacked, bucket, kind,
                                     mv.num_features, mv.device)
                mv.programs[key] = prog
                if prog.graph is not None:
                    self._count("graph_captures")
        return prog

    # -- bookkeeping ---------------------------------------------------
    def _fail(self, req: _Request, err: ServingError) -> None:
        if req.qspan is not None:   # shed/stop before dispatch
            req.qspan.finish(outcome=err.code)
            req.qspan = None
        req.error = err
        req.meta.update(error=err.code)
        self._count("errors")
        req.t_perf_done = time.perf_counter()
        req.event.set()

    def _count(self, name: str, value: float = 1.0) -> None:
        with self._stats_lock:
            self._counts[name] = self._counts.get(name, 0.0) + value
        get_telemetry().count(f"serving.{name}", value)

    def _observe_latency(self, ms: float, kind: str = "predict",
                         rows: int = 0,
                         trace_id: Optional[str] = None) -> None:
        with self._stats_lock:
            if len(self._latencies) >= self._latency_cap:
                # reservoir half-drop keeps recent traffic dominant
                del self._latencies[:self._latency_cap // 2]
            self._latencies.append(ms)
        get_telemetry().observe("serving.latency_ms", ms)
        # per-bucket request latency histogram: the bucket label is the
        # pow2 shape bucket the request's row count maps to, so a
        # /metrics scrape can read p50/p95/p99 per bucket
        b = bucket_for(max(int(rows), 1), self.config.buckets)
        self._metrics.observe("serving_request_latency_ms", ms,
                              labels={"kind": kind, "bucket": b})
        # slowest-request exemplar per bucket: the trace id of the
        # worst request rides /metrics and serving_stats, linking the
        # p99 number to the timeline that explains it
        self._metrics.exemplar_max(
            "serving_slowest_request_ms", ms,
            labels={"kind": kind, "bucket": b}, trace_id=trace_id)
        with self._stats_lock:
            key = f"{kind}/{b}"
            cur = self._slowest.get(key)
            if cur is None or ms > cur["latency_ms"]:
                self._slowest[key] = {"latency_ms": round(ms, 3),
                                      "trace_id": trace_id}

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def stats(self) -> Dict[str, Any]:
        """Counter + latency snapshot (also emitted as the
        ``serving_stats`` telemetry record on stop)."""
        with self._stats_lock:
            counts = dict(self._counts)
            lats = list(self._latencies)
            slowest = {k: dict(v) for k, v in self._slowest.items()}
        out: Dict[str, Any] = {
            "requests": int(counts.get("requests", 0)),
            "rows": int(counts.get("rows", 0)),
            "batches": int(counts.get("batches", 0)),
            "shed": int(counts.get("shed", 0)),
            "timeouts": int(counts.get("timeouts", 0)),
            "fallbacks": int(counts.get("fallbacks", 0)),
            "errors": int(counts.get("errors", 0)),
            "reloads": int(counts.get("reloads", 0)),
            "bucket_hits": int(counts.get("bucket_hits", 0)),
            "bucket_misses": int(counts.get("bucket_misses", 0)),
            "queue_depth": self.queue_depth,
            "queue_peak": self._queue_peak,
            # the CUDA graphs behind the device route (0 on the CPU,
            # where the programs run eagerly) and the last warmup's
            # seconds, captures included
            "graph_captures": int(counts.get("graph_captures", 0)),
            "graph_replays": int(counts.get("graph_replays", 0)),
            "warmup_s": round(self._warmup_s, 6),
        }
        total_b = out["bucket_hits"] + out["bucket_misses"]
        out["bucket_hit_rate"] = round(out["bucket_hits"] / total_b, 4) \
            if total_b else None
        # AOT artifact lifecycle (serving/aot.py): attaches pinned the
        # published stack; failures mean the model text was restacked
        for k in ("aot_attach", "aot_attach_failures"):
            if k in counts:
                out[k] = int(counts[k])
        if slowest:
            out["slowest_request"] = slowest
        if lats:
            arr = np.asarray(lats)
            out["latency_ms"] = {
                "count": len(lats),
                "p50": round(float(np.percentile(arr, 50)), 3),
                "p95": round(float(np.percentile(arr, 95)), 3),
                "p99": round(float(np.percentile(arr, 99)), 3),
                "max": round(float(arr.max()), 3),
            }
        mv = self.registry.current()
        if mv is not None:
            out["model"] = mv.describe()
        return out

    def health(self) -> Dict[str, Any]:
        mv = self.registry.current()
        if mv is None:
            status = "no_model"
        elif self._last_reload_error is not None:
            # degraded-but-serving: the last (hot) reload was rejected
            # (torn file, digest mismatch, parse error) and the
            # previous version is still taking traffic
            status = "degraded"
        else:
            status = "ok"
        out = {
            "status": status,
            "version": None if mv is None else mv.version,
            "device_ready": bool(mv is not None and mv.device_ready),
            "started": self._started,
            "queue_depth": self.queue_depth,
            "buckets": list(self.config.buckets),
            "versions": self.registry.versions(),
        }
        if self._last_reload_error is not None:
            out["last_reload_error"] = dict(self._last_reload_error)
        return out
