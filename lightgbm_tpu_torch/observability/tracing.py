"""End-to-end trace correlation: identity + timelines for every unit
of work (copy of ``lightgbm_tpu/observability/tracing.py`` for the
PyTorch port: the same ids, events and export, so ``tools/run_report.py``
renders either package's file; the profiler window drives
``torch.profiler`` in place of ``jax.profiler``).

The metrics plane answers *how slow*; this module answers *where*
and *which request*. Every request (serving) and every iteration
(training) gets a **trace id**, every timed region inside it a **span
id** with a parent link, so a fleet p99 tail spike can be walked from
the HTTP frontend through fleet dispatch, canary/shadow routing,
tenant admission, engine queueing/micro-batching, down to the named
kernel wrapper that ran on the device — and a training regression can
be walked from the iteration into the grad/hist/split/partition/
update phases.

Id scheme
---------
* ``trace_id`` — 16 hex chars (64-bit), one per *unit of work*: an
  HTTP/fleet/serving request, or one training iteration. Propagated
  unchanged across threads and components; callers can supply their
  own via the ``X-Trace-Id`` HTTP header (plain hex, or W3C-style
  ``<trace_id>-<span_id>``).
* ``span_id`` — 8 hex chars, one per timed region. Every span event
  carries ``trace_id``/``span_id``/``parent_id`` in its ``args`` so
  any span can be joined back to its request.

Context propagation is thread-local (``with tracer.span(...)``
nests), with explicit :class:`TraceContext` hand-off for queue
crossings: ``begin_span(..., ctx=...)`` starts a detached span in one
thread that ``finish()``\\ es in another (the serving engine's
queue-wait spans live like this).

Sink
----
A bounded in-memory ring of Chrome-trace-event dicts, exported as one
JSON object (``{"traceEvents": [...]}``) loadable by Perfetto /
``chrome://tracing`` and rendered offline by ``tools/run_report.py``.
Spans are complete (``ph="X"``) events; flow events (``ph="s"/"t"``)
chain a request's spans across threads so Perfetto draws the arrows.
Export path: ``trace_out`` config param or ``LGBM_TPU_TRACE`` env
(``Tracer.ensure_started``), written atomically on ``flush()``/
``export()``/atexit.

Profiler window
---------------
``profile_dir`` param / ``LGBM_TPU_PROFILE_DIR`` env arms a ONE-SHOT
``torch.profiler.profile(activities=[CPU, CUDA])`` capture aligned to
span boundaries: the capture starts at iteration-boundary
``LGBM_TPU_PROFILE_SKIP`` (default 1 — boundary 0 holds the kernel
library's build) and stops ``LGBM_TPU_PROFILE_SPANS`` (default 4)
boundaries later, so the device trace covers a handful of
*steady-state* spans instead of the whole run. At the stop the capture
is written as a Chrome trace, ``<profile_dir>/torch_trace_<pid>.json``.

Cost model
----------
Disabled (the default), every hook is one attribute check: ``span()``
returns a shared no-op context manager, ``begin_span()`` a shared
no-op handle, ``current()`` ``None``. Enabled, spans record host wall
clock only — this module never imports torch at module level, never
issues a device launch and never reads device values, so tracing adds
**zero host syncs** to the hot paths it observes.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..utils.log import log_info, log_warning

SCHEMA_VERSION = 1
_DEFAULT_MAX_EVENTS = 65536


def _gen_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class TraceContext:
    """Immutable (trace_id, span_id) pair linking a span to its trace."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id, _gen_id(4))

    def describe(self) -> Dict[str, str]:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TraceContext({self.trace_id}/{self.span_id})"


class _NullHandle:
    """Shared no-op span handle (tracing disabled)."""

    __slots__ = ()
    ctx = None

    def finish(self, **args) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_HANDLE = _NullHandle()


class _SpanHandle:
    """One open span. ``scoped=True`` handles pop the thread-local
    stack on finish (the ``with tracer.span(...)`` form and must
    finish on the opening thread); detached handles (``begin_span``)
    may finish from any thread."""

    __slots__ = ("tracer", "name", "cat", "ctx", "parent_id", "t0",
                 "args", "tid", "scoped", "_done")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 ctx: TraceContext, parent_id: Optional[str],
                 scoped: bool, args: Optional[Dict[str, Any]]):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.ctx = ctx
        self.parent_id = parent_id
        self.t0 = time.perf_counter()
        self.args = args
        self.tid = threading.get_ident()
        self.scoped = scoped
        self._done = False

    def finish(self, _end_t: Optional[float] = None, **extra) -> None:
        """Close the span. ``_end_t`` (a ``time.perf_counter()``
        reading) backdates the end edge — used when the real
        completion happened earlier than the bookkeeping (a future
        collected after the work finished)."""
        if self._done:
            return
        self._done = True
        t1 = _end_t if _end_t is not None else time.perf_counter()
        args = dict(self.args) if self.args else {}
        if extra:
            args.update(extra)
        self.tracer._finish_span(self, max(t1, self.t0), args)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
        return False


class Tracer:
    """Process-wide tracer; see module docstring."""

    def __init__(self):
        self._enabled = False
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=_DEFAULT_MAX_EVENTS)
        self._tls = threading.local()
        self._path: Optional[str] = None
        # open spans, keyed by id(handle): the flight recorder dumps
        # these as the span stacks of in-flight work at trip time
        self._open: Dict[int, _SpanHandle] = {}
        self._t0 = time.perf_counter()
        self._epoch_us = time.time() * 1e6 - self._t0 * 1e6
        self._thread_names_emitted: set = set()
        self._flows_started: set = set()
        self.dropped = 0

    # -- lifecycle -----------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def configure(self, path: Optional[str] = None,
                  max_events: int = 0) -> "Tracer":
        """Enable collection; ``path`` is where ``flush()`` exports."""
        if max_events:
            with self._lock:
                self._events = deque(self._events, maxlen=int(max_events))
        if path:
            self._path = path
        self._enabled = True
        _install_atexit_export()
        return self

    def ensure_started(self, config=None) -> None:
        """Idempotent env/config-driven startup: enables tracing when
        ``LGBM_TPU_TRACE`` (env) or ``trace_out`` (config) names an
        export path. Called from ``Telemetry.ensure_started`` so every
        training/serving entry point passes through here. Also arms
        the one-shot profiler window when ``profile_dir`` /
        ``LGBM_TPU_PROFILE_DIR`` is set."""
        arm_profile_window(config)
        if self._enabled:
            return
        path = (getattr(config, "trace_out", "") or "").strip() \
            or os.environ.get("LGBM_TPU_TRACE", "").strip()
        if path:
            n = os.environ.get("LGBM_TPU_TRACE_EVENTS", "").strip()
            self.configure(path=path,
                           max_events=int(n) if n.isdigit() else 0)

    def disable(self) -> None:
        self._enabled = False

    def reset(self) -> None:
        """Test helper: drop all state."""
        self._enabled = False
        with self._lock:
            self._events.clear()
            self._open.clear()
            self._thread_names_emitted.clear()
            self._flows_started.clear()
        self._path = None
        self.dropped = 0
        self._tls = threading.local()

    # -- context -------------------------------------------------------
    def _stack(self) -> List[TraceContext]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> Optional[TraceContext]:
        """The innermost thread-local span context, or None."""
        if not self._enabled:
            return None
        st = getattr(self._tls, "stack", None)
        return st[-1] if st else None

    def new_trace(self) -> TraceContext:
        return TraceContext(_gen_id(8), _gen_id(4))

    def from_header(self, header: Optional[str]) -> TraceContext:
        """Parse an ``X-Trace-Id`` header (``<trace_id>`` or
        ``<trace_id>-<span_id>``) into a context; a missing/garbage
        header gets a fresh trace."""
        if header:
            parts = str(header).strip().lower().split("-")
            tid = parts[0][:32]
            if tid and all(c in "0123456789abcdef" for c in tid):
                sid = parts[1][:16] if len(parts) > 1 \
                    and parts[1] else _gen_id(4)
                return TraceContext(tid, sid)
        return self.new_trace()

    def attach(self, ctx: Optional[TraceContext]):
        """Context manager making ``ctx`` the thread-local parent —
        the cross-thread hand-off (flusher threads, request workers)."""
        if not self._enabled or ctx is None:
            return _NULL_HANDLE
        return _Attach(self, ctx)

    # -- spans ---------------------------------------------------------
    def span(self, name: str, cat: str = "",
             ctx: Optional[TraceContext] = None,
             args: Optional[Dict[str, Any]] = None):
        """Scoped span for ``with`` use. Parent: explicit ``ctx``, else
        the thread-local current span, else a fresh trace (a top-level
        span roots its own trace)."""
        if not self._enabled:
            return _NULL_HANDLE
        return self._begin(name, cat, ctx, args, scoped=True)

    def begin_span(self, name: str, cat: str = "",
                   ctx: Optional[TraceContext] = None,
                   args: Optional[Dict[str, Any]] = None):
        """Detached span: does not touch the thread-local stack, may
        ``finish()`` from another thread (queue crossings)."""
        if not self._enabled:
            return _NULL_HANDLE
        return self._begin(name, cat, ctx, args, scoped=False)

    def _begin(self, name: str, cat: str, ctx: Optional[TraceContext],
               args: Optional[Dict[str, Any]], scoped: bool):
        parent = ctx if ctx is not None else self.current()
        if parent is None:
            child = self.new_trace()
            parent_id = None
        else:
            child = parent.child()
            parent_id = parent.span_id
        h = _SpanHandle(self, name, cat, child, parent_id, scoped, args)
        if scoped:
            self._stack().append(child)
        with self._lock:
            self._open[id(h)] = h
            if parent_id is None:
                # root span: open the flow so cross-thread children can
                # draw arrows back to it
                self._flows_started.add(child.trace_id)
                self._emit_locked({
                    "name": name, "cat": cat or "trace", "ph": "s",
                    "id": int(child.trace_id[:8], 16),
                    "ts": self._ts_us(h.t0), "pid": os.getpid(),
                    "tid": h.tid})
        return h

    def _finish_span(self, h: _SpanHandle, t1: float,
                     args: Dict[str, Any]) -> None:
        if h.scoped:
            st = self._stack()
            if st and st[-1] is h.ctx:
                st.pop()
            elif h.ctx in st:       # tolerate mis-nested finishes
                st.remove(h.ctx)
        args["trace_id"] = h.ctx.trace_id
        args["span_id"] = h.ctx.span_id
        if h.parent_id:
            args["parent_id"] = h.parent_id
        ev = {"name": h.name, "cat": h.cat or "span", "ph": "X",
              "ts": self._ts_us(h.t0),
              "dur": max(round((t1 - h.t0) * 1e6, 3), 0.0),
              "pid": os.getpid(), "tid": h.tid, "args": args}
        with self._lock:
            self._open.pop(id(h), None)
            cross_thread = (h.parent_id is not None
                            and h.tid != threading.get_ident())
            self._emit_locked(ev)
            if (cross_thread or h.parent_id is None) \
                    and h.ctx.trace_id in self._flows_started \
                    and h.parent_id is not None:
                self._emit_locked({
                    "name": h.name, "cat": h.cat or "span", "ph": "t",
                    "id": int(h.ctx.trace_id[:8], 16),
                    "ts": self._ts_us(h.t0), "pid": os.getpid(),
                    "tid": h.tid})

    def instant(self, name: str, cat: str = "",
                ctx: Optional[TraceContext] = None,
                args: Optional[Dict[str, Any]] = None) -> None:
        """Zero-duration marker event (redispatches, guard trips)."""
        if not self._enabled:
            return
        a = dict(args) if args else {}
        c = ctx if ctx is not None else self.current()
        if c is not None:
            a["trace_id"] = c.trace_id
        with self._lock:
            self._emit_locked({
                "name": name, "cat": cat or "mark", "ph": "i", "s": "t",
                "ts": self._ts_us(time.perf_counter()),
                "pid": os.getpid(),
                "tid": threading.get_ident(), "args": a})

    def emit_complete(self, name: str, t0: float, t1: float,
                      cat: str = "",
                      ctx: Optional[TraceContext] = None,
                      parent_id: Optional[str] = None,
                      args: Optional[Dict[str, Any]] = None) -> None:
        """Record an already-measured region (``t0``/``t1`` are
        ``time.perf_counter()`` readings) — the per-request summary
        events the serving engine emits at fulfillment."""
        if not self._enabled:
            return
        a = dict(args) if args else {}
        if ctx is not None:
            a["trace_id"] = ctx.trace_id
            a["span_id"] = ctx.span_id
            if parent_id:
                a["parent_id"] = parent_id
        with self._lock:
            self._emit_locked({
                "name": name, "cat": cat or "span", "ph": "X",
                "ts": self._ts_us(t0),
                "dur": max(round((t1 - t0) * 1e6, 3), 0.0),
                "pid": os.getpid(),
                "tid": threading.get_ident(), "args": a})

    def perf_from_wall(self, wall_s: float) -> float:
        """Map a ``time.time()`` reading onto THIS tracer's
        ``perf_counter`` timeline. Worker processes report their span
        boundaries as wall-clock seconds (the only clock two processes
        share); this converts them so :meth:`emit_complete` renders
        remote spans on the parent timeline."""
        return float(wall_s) - self._epoch_us / 1e6

    def replay_remote_spans(self, records: List[Dict[str, Any]],
                            ctx: TraceContext,
                            cat: str = "worker") -> int:
        """Re-emit span records shipped back from a worker process
        under the parent trace.

        ``records`` is the worker's ``spans`` reply payload: dicts of
        ``{"name", "t0", "t1"}`` (wall-clock seconds) plus optional
        ``"args"`` and ``"root": True`` on the request-level span.
        The root is re-parented under ``ctx`` (the parent-side span
        that dispatched the request); every other record becomes a
        child of the root, so Perfetto shows one cross-process tree
        per trace id. Returns the number of spans emitted."""
        if not self._enabled or not records:
            return 0
        recs = [r for r in records if isinstance(r, dict)]
        roots = [r for r in recs if r.get("root")]
        root = roots[0] if roots else (recs[0] if recs else None)
        if root is None:
            return 0
        root_ctx = ctx.child()
        n = 0
        for rec in recs:
            try:
                t0 = self.perf_from_wall(float(rec["t0"]))
                t1 = self.perf_from_wall(float(rec["t1"]))
                name = str(rec.get("name", "worker.span"))
            except (KeyError, TypeError, ValueError):
                continue
            if rec is root:
                sctx, parent = root_ctx, ctx.span_id
            else:
                sctx = TraceContext(ctx.trace_id, _gen_id(4))
                parent = root_ctx.span_id
            args = rec.get("args")
            self.emit_complete(name, t0, t1, cat=cat, ctx=sctx,
                               parent_id=parent,
                               args=dict(args) if isinstance(
                                   args, dict) else None)
            n += 1
        return n

    # -- event plumbing ------------------------------------------------
    def _ts_us(self, t_perf: float) -> float:
        return round(self._epoch_us + t_perf * 1e6, 3)

    def _emit_locked(self, ev: Dict[str, Any]) -> None:
        tid = ev.get("tid")
        if tid is not None and tid not in self._thread_names_emitted:
            self._thread_names_emitted.add(tid)
            for th in threading.enumerate():
                if th.ident == tid:
                    self._events.append({
                        "name": "thread_name", "ph": "M",
                        "pid": ev["pid"], "tid": tid,
                        "args": {"name": th.name}})
                    break
        if len(self._events) == self._events.maxlen:
            self.dropped += 1
        self._events.append(ev)

    @property
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def active_spans(self) -> List[Dict[str, Any]]:
        """Open spans right now (the flight recorder's view of
        in-flight requests / the current iteration): one record per
        span with its ids, elapsed time and owning thread."""
        now = time.perf_counter()
        with self._lock:
            opens = list(self._open.values())
        names = {t.ident: t.name for t in threading.enumerate()}
        out = []
        for h in sorted(opens, key=lambda h: h.t0):
            out.append({
                "name": h.name, "cat": h.cat,
                "trace_id": h.ctx.trace_id, "span_id": h.ctx.span_id,
                "parent_id": h.parent_id,
                "elapsed_ms": round((now - h.t0) * 1e3, 3),
                "thread": names.get(h.tid, str(h.tid)),
                "args": dict(h.args) if h.args else {}})
        return out

    # -- export --------------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """The full sink as one Chrome-trace-event JSON object
        (Perfetto / chrome://tracing loadable)."""
        with self._lock:
            events = list(self._events)
            dropped = self.dropped
        meta = [{"name": "process_name", "ph": "M", "pid": os.getpid(),
                 "args": {"name": "lightgbm_tpu"}}]
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms",
                "otherData": {"schema": SCHEMA_VERSION,
                              "dropped_events": dropped,
                              "pid": os.getpid()}}

    def export(self, path: Optional[str] = None) -> Optional[str]:
        """Atomically write the Chrome trace JSON; returns the path or
        None (no path configured / write failed — never raises)."""
        p = path or self._path
        if not p:
            return None
        tmp = f"{p}.{os.getpid()}.tmp"
        try:
            d = os.path.dirname(os.path.abspath(p))
            os.makedirs(d, exist_ok=True)
            with open(tmp, "w") as fh:
                json.dump(self.chrome_trace(), fh)
                fh.write("\n")
            os.replace(tmp, p)
            return p
        except OSError as e:  # tracing must never kill the run
            log_warning(f"trace export failed: {e}")
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None

    def flush(self) -> None:
        if self._enabled and self._path:
            self.export()


class _Attach:
    __slots__ = ("tracer", "ctx", "_pushed")

    def __init__(self, tracer: Tracer, ctx: TraceContext):
        self.tracer = tracer
        self.ctx = ctx
        self._pushed = False

    def __enter__(self):
        self.tracer._stack().append(self.ctx)
        self._pushed = True
        return self

    def __exit__(self, *exc):
        if self._pushed:
            st = self.tracer._stack()
            if st and st[-1] is self.ctx:
                st.pop()
            elif self.ctx in st:
                st.remove(self.ctx)
        return False


_TRACER = Tracer()
_ATEXIT_INSTALLED = [False]


def get_tracer() -> Tracer:
    return _TRACER


def tracing_enabled() -> bool:
    return _TRACER._enabled


def _atexit_export() -> None:
    try:
        _TRACER.flush()
    except Exception:  # interpreter may be tearing down
        pass


def _install_atexit_export() -> None:
    if not _ATEXIT_INSTALLED[0]:
        _ATEXIT_INSTALLED[0] = True
        atexit.register(_atexit_export)


# ---------------------------------------------------------------------
# one-shot torch.profiler capture window, aligned to span boundaries
class ProfileWindow:
    """State machine: armed -> capturing -> done. ``boundary()`` is
    called at iteration/block/batch span boundaries; the capture
    starts after ``skip`` boundaries and stops ``spans`` boundaries
    later (or at ``close()``). One-shot per process — a second
    training run never restarts a finished capture."""

    def __init__(self):
        self.dir: Optional[str] = None
        self.skip = 1
        self.spans = 4
        self.state = "off"          # off | armed | capturing | done
        self._boundaries = 0
        self._timer_prev = False
        self._prof = None
        self.trace_path: Optional[str] = None
        self._lock = threading.Lock()

    def arm(self, dirname: str) -> None:
        with self._lock:
            if self.state != "off":
                return
            self.dir = dirname
            env = os.environ
            self.skip = int(env.get("LGBM_TPU_PROFILE_SKIP", "1") or 1)
            self.spans = int(env.get("LGBM_TPU_PROFILE_SPANS", "4") or 4)
            self.state = "armed"
            log_info(f"profiler window armed: dir={dirname} "
                     f"skip={self.skip} spans={self.spans}")

    @property
    def armed(self) -> bool:
        return self.state in ("armed", "capturing")

    def boundary(self, label: str = "iter") -> None:
        """One span boundary passed; drives the start/stop edges."""
        with self._lock:
            if self.state not in ("armed", "capturing"):
                return
            self._boundaries += 1
            if self.state == "armed" and self._boundaries > self.skip:
                self._start(label)
            elif self.state == "capturing" \
                    and self._boundaries > self.skip + self.spans:
                self._stop(label)

    def close(self) -> None:
        """End of the traced region: stop a capture still in flight."""
        with self._lock:
            if self.state == "capturing":
                self._stop("close")

    def _start(self, label: str) -> None:
        try:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self.state = "capturing"
            # host-side phase timers cover the same window (the
            # reference's -DTIMETAG analog): cleared + enabled for the
            # capture, dumped + restored at stop
            from ..utils.log import Timer, global_timer
            self._timer_prev = Timer._enabled
            Timer.enable(True)
            global_timer.acc.clear()
            get_tracer().instant("profile.start", cat="profile",
                                 args={"dir": self.dir, "at": label})
            log_info(f"profiler capture started ({label}) -> "
                     f"{self.dir}")
        except Exception as e:  # profiling is best-effort everywhere
            self.state = "done"
            log_warning(f"profiler start failed: {e}")

    def _stop(self, label: str) -> None:
        try:
            prof, self._prof = self._prof, None
            prof.stop()
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(self.dir,
                                f"torch_trace_{os.getpid()}.json")
            prof.export_chrome_trace(path)
            self.trace_path = path
            get_tracer().instant("profile.stop", cat="profile",
                                 args={"dir": self.dir, "at": label})
            log_info(f"profiler capture stopped ({label}); trace in "
                     f"{path}")
        except Exception as e:  # pragma: no cover - backend-dependent
            log_warning(f"profiler stop failed: {e}")
        try:
            from ..utils.log import Timer, global_timer
            if global_timer.acc:
                global_timer.print_all()
            Timer.enable(getattr(self, "_timer_prev", False))
        except Exception:  # pragma: no cover - teardown safety
            pass
        self.state = "done"


_PROFILE = ProfileWindow()


def profile_window() -> ProfileWindow:
    return _PROFILE


def arm_profile_window(config=None) -> bool:
    """Arm the one-shot capture when ``profile_dir`` (config) or
    ``LGBM_TPU_PROFILE_DIR`` (env) names a directory. Idempotent."""
    d = (getattr(config, "profile_dir", "") or "").strip() \
        or os.environ.get("LGBM_TPU_PROFILE_DIR", "").strip()
    if not d:
        return False
    _PROFILE.arm(d)
    return _PROFILE.armed


def profile_boundary(label: str = "iter") -> None:
    """Span-boundary hook (iteration end / fused block end / serving
    batch end). One attribute check when no window is armed."""
    if _PROFILE.state in ("armed", "capturing"):
        _PROFILE.boundary(label)


def profile_close() -> None:
    _PROFILE.close()


# ---------------------------------------------------------------------
def program_args(program: str) -> Dict[str, Any]:
    """Span args for a device launch attributed to a kernel wrapper
    (``ops/*_cuda.py``): the kernel's name, its wrapper module, and
    whether ``ops/_native.py:LAUNCHES`` counts it (an uncounted name in
    a timeline is a smell: every kernel's wrapper counts its launches)."""
    from ..ops import _native
    return {"program": program,
            "wrapper": _KERNEL_WRAPPERS.get(program, ""),
            "registered": program in _native.LAUNCHES}


# the wrapper module of each kernel counted in ops/_native.py:LAUNCHES
_KERNEL_WRAPPERS = {
    "hist_segment": "ops/hist_cuda.py",
    "hist_rows": "ops/hist_cuda.py",
    "hist_rows_batched": "ops/hist_cuda.py",
    "partition_segment": "ops/partition_cuda.py",
    "split_scan": "ops/split_scan_cuda.py",
    "fused_split_step_segment": "ops/split_step_cuda.py",
    "fused_split_step_leaf": "ops/split_step_cuda.py",
    "fused_split_step_leaf_batched": "ops/split_step_cuda.py",
    "tree_shap": "ops/tree_shap_cuda.py",
    "hist_multival": "ops/hist_multival_cuda.py",
}
