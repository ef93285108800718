"""Process-per-replica fleet isolation: supervisor side (port of
``lightgbm_tpu/serving/procfleet.py``).

A thread-mode :class:`~lightgbm_tpu_torch.serving.fleet.Replica` is a
set of engines inside the serving process — a device OOM, runtime abort
or segfault in any replica kills the whole pool and the HTTP frontend
with it. ``serving_isolation=process`` moves each replica's engines
into their OWN spawned OS process (own CUDA context, own flight
recorder; ``serving/worker.py`` is the child entry point), supervised
from this thin host over a length-prefixed local socket:

* **framing** — 4-byte big-endian length + one JSON object per frame,
  the JAX package's frames byte for byte (rows/results as nested lists:
  ``json`` round-trips float64 exactly, so process-mode responses stay
  bit-identical to thread mode; a result frame also names its dtype,
  so ``pred_leaf`` comes back int32 as the engine made it);
* **spawn** — a fresh interpreter (``subprocess.Popen`` of ``python -m
  lightgbm_tpu_torch.serving.worker``, never a fork: the supervisor
  usually holds a CUDA context already). The worker is told the
  fleet's device in its config; a worker told ``cuda`` that finds no
  usable CUDA device fails its hello (``spawn_failed``) and never
  serves on the CPU;
* **handshake** — the worker dials the supervisor's listener with the
  bounded deterministic backoff from ``robustness/retry.py`` (the
  reference's socket-linker design: retried point-to-point connects)
  and authenticates with a per-incarnation token;
* **heartbeats** — the monitor pings every ``replica_heartbeat_ms``;
  any frame from the worker refreshes liveness. A worker that exits
  (nonzero status, OOM kill) or goes quiet past
  ``replica_heartbeat_timeout_ms`` is declared dead: its reason is
  classified into the ``tools/probe_taxonomy.py`` worker codes
  (``spawn_failed`` / ``heartbeat_lost`` / ``oom_killed`` /
  ``respawn_exhausted``), its in-flight AND queued requests fail with
  ``EngineStoppedError`` so the fleet's eager re-dispatch moves them
  to survivors, its crash dump (``<crash_dump>.worker<rid>.json``) is
  collected into the parent's flight-recorder artifact, and the
  worker **respawns** with bounded deterministic backoff, capped by
  ``replica_restart_max``. A flapping replica is quarantined:
  ``health()`` degrades, the pool never dies.

A CUDA graph does not outlive its process: every worker incarnation
uploads its own stacks and captures its own programs, buckets x kinds a
model (the JAX package's respawn replays its compiled programs from
the persistent compile cache instead). What an incarnation paid is
``cold_start_captures`` (the engines' ``graph_captures``), where the
JAX package reports ``cold_start_compiles``.

Process-level fault kinds (``crash_replica`` / ``hang_replica`` /
``oom_replica``, robustness/faults.py) are armed in the SUPERVISOR's
fault plan (consumed-once stays consumed-once across respawns) and
honored inside the worker via a ``fault`` frame.

"""

from __future__ import annotations

import json
import os
import secrets
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from ..observability.metrics import get_metrics
from ..observability.telemetry import get_telemetry
from ..observability.tracing import get_tracer
from ..utils.log import log_info, log_warning
from .engine import ServingFuture, _Request
from .errors import (EngineStoppedError, InvalidRequestError,
                     ModelLoadError, ModelNotFoundError, QueueFullError,
                     QuotaExceededError, ReplicaUnavailableError,
                     RequestTimeoutError, ServingError)

_FRAME_MAX = 256 << 20
_ERROR_BY_CODE = {cls.code: cls for cls in (
    ServingError, QueueFullError, RequestTimeoutError,
    EngineStoppedError, ModelLoadError, ModelNotFoundError,
    QuotaExceededError, ReplicaUnavailableError, InvalidRequestError)}

# replica state machine (docs/Serving.md "Process isolation"); the
# numeric codes are the lgbm_fleet_replica_state{rid} gauge values
STATE_CODES = {"ok": 0, "draining": 1, "dead": 2, "quarantined": 3}


# ---------------------------------------------------------------------
# wire framing (shared with serving/worker.py)
def send_frame(sock_, obj: Dict[str, Any],
               lock: Optional[threading.Lock] = None) -> None:
    body = json.dumps(obj).encode()
    if len(body) > _FRAME_MAX:
        raise ServingError(f"frame too large ({len(body)} bytes)")
    payload = struct.pack(">I", len(body)) + body
    if lock is not None:
        with lock:
            sock_.sendall(payload)
    else:
        sock_.sendall(payload)


def _recv_exact(sock_, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock_.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def recv_frame(sock_) -> Optional[Dict[str, Any]]:
    """One frame, or None on a clean/broken EOF."""
    head = _recv_exact(sock_, 4)
    if head is None:
        return None
    (n,) = struct.unpack(">I", head)
    if n > _FRAME_MAX:
        raise ServingError(f"oversized frame ({n} bytes)")
    body = _recv_exact(sock_, n)
    if body is None:
        return None
    return json.loads(body)


def error_from_frame(msg: Dict[str, Any]) -> ServingError:
    cls = _ERROR_BY_CODE.get(str(msg.get("code")), ServingError)
    err = cls(str(msg.get("message", msg.get("code", "worker error"))))
    err.details = dict(msg.get("details") or {})
    return err


@dataclass
class ProcFleetOptions:
    """Supervisor tuning (the ``replica_*`` config params)."""

    restart_max: int = 3
    heartbeat_ms: float = 200.0
    heartbeat_timeout_ms: float = 3000.0
    spawn_timeout_s: float = 120.0
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    # a worker that stays alive this long earns its restart budget
    # back: the cap is for FLAPPING replicas, not for a long-lived
    # pool that absorbs an occasional crash a day
    flap_reset_s: float = 30.0
    # metrics federation (docs/Observability.md): workers piggyback
    # registry/telemetry deltas on their heartbeat pongs and the
    # parent scrape renders the whole fleet under a ``worker`` label
    federation: bool = True
    # shared-memory row transport (shm_ring.py): one ring per worker
    # incarnation; batches whose payload reaches shm_min_bytes move as
    # raw f64 blocks instead of JSON arrays (below it, JSON framing is
    # cheaper than the slot round-trip)
    shm: bool = True
    shm_slots: int = 4
    shm_slot_bytes: int = 1 << 20
    shm_min_bytes: int = 16384

    @classmethod
    def from_config(cls, cfg) -> "ProcFleetOptions":
        return cls(
            restart_max=int(getattr(cfg, "replica_restart_max", 3)),
            heartbeat_ms=float(getattr(cfg, "replica_heartbeat_ms",
                                       200.0)),
            heartbeat_timeout_ms=float(getattr(
                cfg, "replica_heartbeat_timeout_ms", 3000.0)),
            spawn_timeout_s=float(getattr(
                cfg, "replica_spawn_timeout_s", 120.0)),
            federation=bool(getattr(cfg, "serving_federation", True)),
            shm=bool(getattr(cfg, "serving_shm", True)),
            shm_slots=int(getattr(cfg, "serving_shm_slots", 4)),
            shm_slot_bytes=int(getattr(cfg, "serving_shm_slot_bytes",
                                       1 << 20)),
            shm_min_bytes=int(getattr(cfg, "serving_shm_min_bytes",
                                      16384)))


class _WorkerHandle:
    """One incarnation of a worker process: Popen + socket + pending."""

    def __init__(self, proc: subprocess.Popen, conn: socket.socket,
                 rid: int, incarnation: int, shm_ring=None,
                 shm_min_bytes: int = 0):
        self.proc = proc
        self.conn = conn
        self.rid = rid
        self.incarnation = incarnation
        self.pid = proc.pid
        # per-incarnation shm ring (shm_ring.py); torn down with the
        # handle so a dead reader's busy slots can never wedge a fresh
        # incarnation
        self.shm_ring = shm_ring
        self.shm_min_bytes = int(shm_min_bytes)
        self.shm_fallbacks = 0
        self.wlock = threading.Lock()
        self.plock = threading.Lock()
        self.pending: Dict[int, _Request] = {}
        self.next_id = 0
        self.last_seen = time.monotonic()
        self.created_at = time.monotonic()
        self.closed = False
        self.worker_stats: Dict[str, Any] = {}
        self.worker_load = 0
        # control round-trips outstanding (load_model / warm): the
        # worker's control loop is single-threaded, so a long warmup
        # (graph captures) legitimately silences it — the monitor must not read that
        # silence as heartbeat_lost (request_sync's own timeout owns
        # liveness while this is nonzero)
        self.control_inflight = 0
        self._acks: Dict[int, Dict[str, Any]] = {}
        self._ack_cond = threading.Condition()
        self._recv_thread = threading.Thread(
            target=self._recv_loop, daemon=True,
            name=f"lgbm-worker{rid}-recv")
        self._recv_thread.start()

    # -- request plumbing ---------------------------------------------
    def _new_id(self) -> int:
        with self.plock:
            self.next_id += 1
            return self.next_id

    def submit(self, model: str, rows: np.ndarray, kind: str,
               timeout_ms: Optional[float],
               trace: Optional[Dict[str, str]]) -> ServingFuture:
        t = None if timeout_ms is None or timeout_ms <= 0 \
            else timeout_ms / 1000.0
        req = _Request(rows, kind, t)
        mid = self._new_id()
        with self.plock:
            if self.closed:
                raise EngineStoppedError(
                    f"replica {self.rid} worker is down",
                    replica=self.rid)
            self.pending[mid] = req
        frame = {"type": "submit", "id": mid, "model": model,
                 "kind": kind, "timeout_ms": timeout_ms,
                 "trace": trace}
        # large payloads ride the shm ring (a memcpy + tiny ticket);
        # small batches, a full ring, or an oversized block fall back
        # to JSON rows — same bytes either way (f64 end to end)
        ticket = None
        ring = self.shm_ring
        want_shm = ring is not None and rows.nbytes >= self.shm_min_bytes
        if want_shm:
            with self.wlock:     # single writer per ring
                ticket = ring.try_write(rows)
        if ticket is not None:
            frame["shm"] = ticket
        else:
            if want_shm:
                self.shm_fallbacks += 1
            frame["rows"] = rows.tolist()
        try:
            send_frame(self.conn, frame, lock=self.wlock)
        except OSError as e:
            with self.plock:
                self.pending.pop(mid, None)
            raise EngineStoppedError(
                f"replica {self.rid} worker socket failed: {e}",
                replica=self.rid) from e
        return ServingFuture(req)

    def request_sync(self, frame: Dict[str, Any],
                     timeout_s: float) -> Dict[str, Any]:
        """A control round trip (load_model / warm): send, await ack."""
        mid = self._new_id()
        frame = dict(frame, id=mid)
        with self.plock:
            self.control_inflight += 1
        try:
            try:
                send_frame(self.conn, frame, lock=self.wlock)
            except OSError as e:
                raise EngineStoppedError(
                    f"replica {self.rid} worker socket failed: {e}",
                    replica=self.rid) from e
            deadline = time.monotonic() + timeout_s
            with self._ack_cond:
                while mid not in self._acks:
                    left = deadline - time.monotonic()
                    if left <= 0 or self.closed:
                        raise EngineStoppedError(
                            f"replica {self.rid} worker did not ack "
                            f"{frame['type']} within {timeout_s}s",
                            replica=self.rid)
                    self._ack_cond.wait(min(left, 0.2))
                return self._acks.pop(mid)
        finally:
            with self.plock:
                self.control_inflight -= 1

    def send(self, frame: Dict[str, Any]) -> bool:
        try:
            send_frame(self.conn, frame, lock=self.wlock)
            return True
        except OSError:
            return False

    # -- receiver ------------------------------------------------------
    def _recv_loop(self) -> None:
        try:
            while True:
                msg = recv_frame(self.conn)
                if msg is None:
                    return
                self.last_seen = time.monotonic()
                t = msg.get("type")
                if t == "result":
                    self._resolve(msg, error=False)
                elif t == "error":
                    self._resolve(msg, error=True)
                elif t == "pong":
                    self.worker_stats = msg.get("stats") or {}
                    self.worker_load = int(msg.get("load", 0))
                    fed = msg.get("fed")
                    if fed is not None:
                        # heartbeat-piggybacked metrics delta: merge
                        # into the parent registry under this worker's
                        # shard (any pong also refreshes staleness)
                        try:
                            get_metrics().merge_snapshot(
                                str(self.rid), fed)
                        except Exception:  # noqa: BLE001 - a bad
                            pass           # delta must not kill recv
                elif t == "ack":
                    with self._ack_cond:
                        self._acks[int(msg.get("id", -1))] = msg
                        self._ack_cond.notify_all()
                # "bye" and unknown frames only refresh liveness
        except (OSError, ValueError, ServingError):
            return   # monitor declares the death; receivers just stop

    def _resolve(self, msg: Dict[str, Any], error: bool) -> None:
        with self.plock:
            req = self.pending.pop(int(msg.get("id", -1)), None)
        if req is None:
            return
        if error:
            req.error = error_from_frame(msg)
            req.meta.update(error=req.error.code,
                            replica_pid=self.pid)
        else:
            req.result = np.asarray(msg.get("result"),
                                    dtype=msg.get("dtype"))
            req.meta.update(msg.get("meta") or {})
            req.meta["replica_pid"] = self.pid
        spans = msg.get("spans")
        if spans:
            req.wspans = spans
        req.t_perf_done = time.perf_counter()
        req.event.set()

    # -- teardown ------------------------------------------------------
    def fail_pending(self, err: ServingError) -> int:
        with self.plock:
            reqs = list(self.pending.values())
            self.pending.clear()
        for req in reqs:
            req.error = err
            req.meta.update(error=err.code)
            req.t_perf_done = time.perf_counter()
            req.event.set()
        return len(reqs)

    def close(self) -> None:
        self.closed = True
        with self._ack_cond:
            self._ack_cond.notify_all()
        try:
            self.conn.close()
        except OSError:
            pass
        ring, self.shm_ring = self.shm_ring, None
        if ring is not None:
            with self.wlock:     # let an in-flight try_write finish
                ring.destroy()


class _WorkerEngineProxy:
    """The per-model engine facade of a ProcessReplica: quacks enough
    of ServingEngine for FleetEngine's dispatch/stats paths (submit,
    stop, queue_depth, stats); the real engine lives in the worker."""

    def __init__(self, replica: "ProcessReplica", name: str):
        self._replica = replica
        self._name = name

    @property
    def queue_depth(self) -> int:
        return 0      # queued work is counted by the replica's load()

    def submit(self, rows, kind: str = "predict",
               timeout_ms: Optional[float] = None,
               trace_ctx=None) -> ServingFuture:
        return self._replica._submit(self._name, rows, kind,
                                     timeout_ms, trace_ctx)

    def stop(self, drain: bool = True) -> None:
        pass          # worker lifetime is replica-level

    def _warmup(self, mv) -> None:
        pass          # the worker warms itself on load_model/warm

    def stats(self) -> Dict[str, Any]:
        h = self._replica._handle
        if h is None:
            return {}
        models = (h.worker_stats or {}).get("models") or {}
        return dict(models.get(self._name) or {})


class ProcessReplica:
    """One supervised worker process; duck-types fleet.Replica."""

    STATES = ("ok", "draining", "dead", "quarantined")
    is_process = True

    def __init__(self, rid: int, supervisor: "WorkerSupervisor"):
        self.rid = rid
        self._supervisor = supervisor
        self._lock = threading.Lock()
        self._engines: Dict[str, _WorkerEngineProxy] = {}
        self.state = "dead"          # ok only after hello + warm
        self.outstanding = 0
        self.futures: "weakref.WeakSet" = weakref.WeakSet()
        self.started_at = time.time()
        # the graphs the current incarnation captured from spawn to
        # ready (every model's load and the warm), and per model
        self.cold_start_captures: Optional[int] = None
        self.captures: Dict[str, int] = {}
        self.cold_start_s: Optional[float] = None
        # the device the worker serves on, from its hello, and where
        # the incarnation's time to ready went (ms): the interpreter and
        # its imports, the device's first allocation (a CUDA context),
        # the connect, the models' load and warm
        self.device: Optional[str] = None
        self.spawn_split_ms: Dict[str, float] = {}
        self.deaths = 0
        self.restarts = 0
        self.incarnation = 0
        self.last_death: Dict[str, Any] = {}
        self.restart_ready_ms: Optional[float] = None
        # per-model AOT attach state from the worker's load acks: True
        # means the worker pinned that model's published artifact;
        # False means it restacked the model text
        self.aot_models: Dict[str, bool] = {}
        self._handle: Optional[_WorkerHandle] = None
        self._no_respawn = False
        self._respawning = False
        # inf until the first death: a replica the supervisor has not
        # spawned yet must never be "healed" by the respawn pump
        self._next_respawn_at = float("inf")

    @property
    def pid(self) -> Optional[int]:
        h = self._handle
        return None if h is None else h.pid

    def engine_for(self, name: str) -> _WorkerEngineProxy:
        with self._lock:
            eng = self._engines.get(name)
            if eng is None:
                eng = self._engines[name] = _WorkerEngineProxy(
                    self, name)
            return eng

    def _submit(self, name: str, rows, kind: str,
                timeout_ms: Optional[float], trace_ctx) -> ServingFuture:
        h = self._handle
        if h is None or h.closed or self.state not in ("ok", "draining"):
            raise EngineStoppedError(
                f"replica {self.rid} worker is not serving "
                f"(state={self.state})", replica=self.rid)
        trace = None
        if trace_ctx is not None:
            trace = {"trace_id": trace_ctx.trace_id,
                     "span_id": trace_ctx.span_id}
        arr = np.asarray(rows, np.float64)
        if arr.ndim == 1:
            arr = arr[None, :]
        fut = h.submit(name, arr, kind, timeout_ms, trace)
        if trace_ctx is not None:
            # join the worker's side of the request to the parent
            # trace: one complete event per request, emitted when the
            # worker answers, carrying its queue/compute decomposition
            self._supervisor._trace_worker_request(
                self.rid, fut, trace_ctx)
        return fut

    def warm(self, names: Optional[List[str]] = None) -> None:
        h = self._handle
        if h is None:
            return
        ack = h.request_sync(
            {"type": "warm", "names": names},
            timeout_s=self._supervisor.opts.spawn_timeout_s)
        self.cold_start_captures = ack.get("captures")
        self.cold_start_s = ack.get("dur_s")

    def load(self) -> int:
        h = self._handle
        with self._lock:
            out = self.outstanding
        pending = 0 if h is None else len(h.pending)
        worker_q = 0 if h is None else h.worker_load
        return out + max(pending, worker_q)

    def stop(self, drain: bool = True) -> None:
        self._supervisor.stop_worker(self, drain=drain)

    def stats_lite(self) -> Dict[str, Any]:
        h = self._handle
        return {} if h is None else dict(h.worker_stats or {})

    def shm_stats(self) -> Optional[Dict[str, Any]]:
        h = self._handle
        if h is None or h.shm_ring is None:
            return None
        out = h.shm_ring.stats()
        out["fallbacks"] = h.shm_fallbacks
        return out

    def describe(self) -> Dict[str, Any]:
        with self._lock:
            models = sorted(self._engines)
        return {"replica": self.rid, "state": self.state,
                "isolation": "process", "pid": self.pid,
                "device": self.device,
                "spawn_split_ms": dict(self.spawn_split_ms),
                "load": self.load(), "models": models,
                "shm": self.shm_stats(),
                "aot_models": dict(self.aot_models),
                "cold_start_captures": self.cold_start_captures,
                "captures": dict(self.captures),
                "cold_start_s": self.cold_start_s,
                "started_at": self.started_at,
                "incarnation": self.incarnation,
                "restarts": self.restarts,
                "restart_ready_ms": self.restart_ready_ms,
                "last_death": dict(self.last_death)}


class WorkerSupervisor:
    """Spawns, monitors, heals and reaps the fleet's worker processes.

    Owned by a FleetEngine in ``serving_isolation=process`` mode; the
    fleet calls back into :meth:`FleetEngine._on_replica_death
    <lightgbm_tpu_torch.serving.fleet.FleetEngine>` for the re-dispatch /
    accounting side of a death, and this class owns everything
    process-shaped: sockets, heartbeats, fault pumping, respawn
    backoff, quarantine, crash-dump collection and child reaping.
    """

    def __init__(self, fleet, opts: Optional[ProcFleetOptions] = None):
        self._fleet_ref = weakref.ref(fleet)
        self.opts = opts or ProcFleetOptions()
        self._lock = threading.Lock()
        self._replicas: List[ProcessReplica] = []
        # publish-ordered model state replayed to every (re)spawned
        # worker: name -> load_model frame (text or path source)
        self._model_state: Dict[str, Dict[str, Any]] = {}
        self._awaiting: Dict[str, "_HelloSlot"] = {}
        self._stopping = False
        # respawns in flight: shutdown waits for them, so that none
        # leaves a worker behind
        self._respawn_threads: List[threading.Thread] = []
        # monitor ticks on this instead of bare time.sleep so
        # shutdown() interrupts the wait instead of riding it out
        self._stop_evt = threading.Event()
        self.worker_dumps: List[Dict[str, Any]] = []
        # federated-shard staleness: a worker whose last snapshot is
        # older than the heartbeat timeout is rendered stale even if
        # nobody declared it dead yet (slow-worker semantics)
        get_metrics().fed_stale_after_s = \
            max(self.opts.heartbeat_timeout_ms / 1000.0, 0.05)
        self._listener = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(64)
        self.port = self._listener.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="lgbm-procfleet-accept")
        self._accept_thread.start()
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop, daemon=True,
            name="lgbm-procfleet-monitor")
        self._monitor_thread.start()
        # escalation / interpreter-exit safety net: a supervisor that
        # dies ungracefully must still reap its children (satellite:
        # "second signal escalates and still reaps children")
        from ..robustness.preempt import register_escalation_cleanup
        register_escalation_cleanup(self.reap)
        import atexit
        atexit.register(self.reap)

    # -- spawn / handshake --------------------------------------------
    def new_replica(self) -> ProcessReplica:
        with self._lock:
            rid = len(self._replicas)
            rep = ProcessReplica(rid, self)
            self._replicas.append(rep)
        return rep

    def _worker_env(self, rep: ProcessReplica,
                    token: str) -> Dict[str, str]:
        env = dict(os.environ)
        env["LGBM_TPU_WORKER_RID"] = str(rep.rid)
        env["LGBM_TPU_WORKER_TOKEN"] = token
        fleet = self._fleet_ref()
        cfg = getattr(fleet, "config", None)
        env["LGBM_TPU_WORKER_CONFIG"] = json.dumps({
            "buckets": list(getattr(cfg, "buckets", (1,))),
            "max_queue": getattr(cfg, "max_queue", 1024),
            "flush_interval_ms": getattr(cfg, "flush_interval_ms", 2.0),
            "request_timeout_ms": getattr(cfg, "request_timeout_ms",
                                          1000.0),
            "shed_policy": getattr(cfg, "shed_policy", "reject_new"),
            "device": getattr(cfg, "device", "auto"),
            "warmup": bool(getattr(cfg, "warmup", True)),
            "fallback_to_host": bool(getattr(cfg, "fallback_to_host",
                                             True)),
            "aot": bool(getattr(cfg, "aot", True)),
            # the fleet's torch device: the worker serves there or
            # fails its hello, never on another
            "torch_device": str(getattr(fleet, "device", "cuda")),
        })
        # each incarnation gets its own ring (or none): never inherit
        # a stale segment name from the supervisor's environment
        from .shm_ring import ENV_VAR as _SHM_ENV
        env.pop(_SHM_ENV, None)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep \
            + env.get("PYTHONPATH", "")
        # the supervisor's plan drives process faults (consumed-once
        # must survive respawns); a worker re-parsing the spec would
        # re-arm every event from scratch
        env.pop("LGBM_TPU_FAULTS", None)
        # per-worker observability sinks: appending to the parent's
        # JSONL from many processes would interleave torn lines
        for var in ("LGBM_TPU_TELEMETRY", "LGBM_TPU_TRACE"):
            if env.get(var):
                env[var] = f"{env[var]}.worker{rep.rid}"
        env["LGBM_TPU_FEDERATION"] = \
            "1" if self.opts.federation else "0"
        return env

    def spawn(self, rep: ProcessReplica) -> None:
        """Spawn + handshake + model replay + warm; raises on failure
        (the caller decides whether that is fatal or a respawn miss):
        no hello within ``spawn_timeout_s``, a worker that exits before
        it, and a hello that reports the device unusable."""
        token = secrets.token_hex(16)
        slot = _HelloSlot()
        with self._lock:
            self._awaiting[token] = slot
        t0 = time.perf_counter()
        t_wall = time.time()
        # per-incarnation row-transport ring, created BEFORE the child
        # so its geometry can ride the spawn env; shm trouble (e.g.
        # /dev/shm unavailable) degrades to JSON framing, never fails
        # the spawn
        ring = None
        if self.opts.shm:
            try:
                from .shm_ring import ShmRing
                ring = ShmRing.create(self.opts.shm_slots,
                                      self.opts.shm_slot_bytes)
            except Exception as e:  # noqa: BLE001 - degrade to JSON
                log_warning(f"procfleet: shm ring unavailable for "
                            f"replica {rep.rid} ({e}); JSON framing")
                ring = None
        env = self._worker_env(rep, token)
        if ring is not None:
            from .shm_ring import ENV_VAR as _SHM_ENV
            env[_SHM_ENV] = ring.env_spec()
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 "lightgbm_tpu_torch.serving.worker",
                 "--connect", f"127.0.0.1:{self.port}",
                 "--rid", str(rep.rid)],
                env=env)
        except OSError as e:
            with self._lock:
                self._awaiting.pop(token, None)
            if ring is not None:
                ring.destroy()
            raise ServingError(f"worker spawn failed: {e}") from e
        conn = slot.wait(self.opts.spawn_timeout_s,
                         alive=lambda: proc.poll() is None
                         and not self._stopping)
        with self._lock:
            self._awaiting.pop(token, None)
        hello = slot.hello or {}
        if conn is None or hello.get("error"):
            if conn is not None:
                conn.close()
            _kill_proc(proc)
            if ring is not None:
                ring.destroy()
            if conn is None:
                raise ServingError(
                    f"replica {rep.rid} worker never said hello within "
                    f"{self.opts.spawn_timeout_s}s "
                    f"(exit={proc.poll()})")
            raise ServingError(
                f"replica {rep.rid} worker failed its hello on device "
                f"{hello.get('device')}: {hello.get('error')}")
        rep.device = hello.get("device")
        t_hello = time.time()
        split = {}
        try:
            t_main = float(hello["t_main"])
            t_device = float(hello["t_device"])
            split = {"start": (t_main - t_wall) * 1e3,
                     "device": (t_device - t_main) * 1e3,
                     "hello": (t_hello - t_device) * 1e3}
        except (KeyError, TypeError, ValueError):
            pass             # a worker that does not time its start
        rep.incarnation += 1
        handle = _WorkerHandle(proc, conn, rep.rid, rep.incarnation,
                               shm_ring=ring,
                               shm_min_bytes=self.opts.shm_min_bytes)
        rep._handle = handle
        try:
            # replay the fleet's published model state, then warm: a
            # fresh CUDA context captures every (bucket, kind) program
            # of every model again (cold_start_captures records what
            # the incarnation paid)
            rep.captures = {}
            for name, frame in list(self._model_state.items()):
                ack = handle.request_sync(dict(frame),
                                          self.opts.spawn_timeout_s)
                if not ack.get("ok"):
                    raise ServingError(
                        f"replica {rep.rid} worker failed to load "
                        f"{name!r}: {ack.get('message')}")
                rep.aot_models[name] = bool(ack.get("aot"))
                rep.captures[name] = int(ack.get("captures", 0))
            rep.warm()
            rep.cold_start_captures = int(rep.cold_start_captures or 0) \
                + sum(rep.captures.values())
            if self._stopping:
                raise ServingError(f"replica {rep.rid} spawned while the "
                                   "supervisor stopped")
        except BaseException:
            # a failed replay/warm must not leak a live worker: the
            # next respawn would overwrite rep._handle and make this
            # incarnation invisible to reap()/shutdown
            rep._handle = None
            handle.close()
            _kill_proc(proc)
            raise
        rep.state = "ok"
        # a (re)spawned worker's shard is live again the moment it can
        # heartbeat; its first pong replaces the dead incarnation's
        # cumulative series wholesale
        get_metrics().set_worker_stale(str(rep.rid), False)
        ready_ms = round((time.perf_counter() - t0) * 1000.0, 3)
        rep.restart_ready_ms = ready_ms
        split["load"] = (time.time() - t_hello) * 1e3
        rep.spawn_split_ms = {k: round(v, 3) for k, v in split.items()}
        self._note(rep, "ready", ready_ms=ready_ms,
                   captures=rep.cold_start_captures, device=rep.device)
        log_info(f"procfleet: replica {rep.rid} worker up "
                 f"(pid={handle.pid}, inc={rep.incarnation}, "
                 f"device={rep.device}, ready_ms={ready_ms}, "
                 f"captures={rep.cold_start_captures})")

    def spawn_pool(self, reps: List[ProcessReplica]) -> None:
        """Spawn several workers concurrently (a worker pays a full
        interpreter + torch import and a CUDA context on start;
        serializing the pool would multiply that bill by the replica
        count)."""
        errs: List[BaseException] = []

        def one(rep):
            try:
                self.spawn(rep)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errs.append(e)

        threads = [threading.Thread(target=one, args=(r,), daemon=True)
                   for r in reps]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self.opts.spawn_timeout_s + 10.0)
        if errs:
            raise errs[0]
        # a spawn thread that outlived its join timeout (or finished
        # without bringing the replica to "ok") must be a loud failure:
        # proceeding would hand the fleet replicas in an indeterminate,
        # possibly never-ready state
        stuck = [r.rid for r, t in zip(reps, threads)
                 if t.is_alive() or r.state != "ok"]
        if stuck:
            raise ServingError(
                f"replica spawn did not complete for rid(s) {stuck} "
                f"within {self.opts.spawn_timeout_s + 10.0:.0f}s")

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return
            try:
                conn.settimeout(10.0)
                hello = recv_frame(conn)
                conn.settimeout(None)
            except (OSError, ValueError, ServingError):
                conn.close()
                continue
            slot = None
            if isinstance(hello, dict) and hello.get("type") == "hello":
                with self._lock:
                    slot = self._awaiting.get(str(hello.get("token")))
            if slot is None:
                conn.close()      # stale incarnation / stranger
                continue
            slot.put(conn, hello)

    # -- model lifecycle ----------------------------------------------
    def set_model_source(self, name: str, source,
                         aot_path: Optional[str] = None) -> None:
        """Record (and normalize) the source for replay on respawn.
        ``aot_path`` names the publish-time AOT artifact bundle
        (serving/aot.py); it rides the same frame so every respawn
        pins the published stack instead of restacking the text."""
        frame: Dict[str, Any] = {"type": "load_model", "name": name}
        if isinstance(source, str):
            if "\n" in source:
                frame["text"] = source
            else:
                frame["path"] = source
        elif hasattr(source, "model_to_string"):    # basic.Booster
            frame["text"] = source.model_to_string()
        else:
            raise ModelLoadError(
                "process-isolated fleets need a file path, model text "
                f"or Booster source for {name!r}, got "
                f"{type(source).__name__}")
        if aot_path:
            frame["aot"] = aot_path
        self._model_state[name] = frame

    def broadcast_model(self, name: str) -> None:
        """Push a (re)published model to every live worker; a worker
        that fails the load is declared dead (the respawn replays the
        new state, so it can never serve a stale version)."""
        frame = self._model_state[name]
        for rep in self.live_replicas():
            h = rep._handle
            if h is None:
                continue
            try:
                ack = h.request_sync(dict(frame),
                                     self.opts.spawn_timeout_s)
                if not ack.get("ok"):
                    raise ServingError(str(ack.get("message")))
                rep.aot_models[name] = bool(ack.get("aot"))
                rep.captures[name] = int(ack.get("captures", 0))
            except ServingError as e:
                log_warning(f"procfleet: replica {rep.rid} rejected "
                            f"model {name!r} ({e}); recycling worker")
                self._declare_death(rep, "load_failed", str(e),
                                    kill=True)

    # -- monitor / healing --------------------------------------------
    def live_replicas(self) -> List[ProcessReplica]:
        with self._lock:
            return [r for r in self._replicas
                    if r.state in ("ok", "draining")]

    def _monitor_loop(self) -> None:
        from ..robustness.faults import get_fault_plan
        interval = max(self.opts.heartbeat_ms / 1000.0, 0.02)
        while not self._stopping:
            self._stop_evt.wait(interval)
            plan = get_fault_plan()
            now = time.monotonic()
            for rep in self.live_replicas():
                h = rep._handle
                if h is None:
                    continue
                if plan is not None:
                    self._pump_faults(plan, rep, h)
                if rep.restarts and rep.state == "ok" \
                        and (now - h.created_at) \
                        > self.opts.flap_reset_s:
                    rep.restarts = 0    # earned the budget back
                code = h.proc.poll()
                if code is not None:
                    self._declare_death(
                        rep, _classify_exit(code),
                        f"worker pid {h.pid} exited with {code}")
                    continue
                if h.control_inflight > 0:
                    # a load_model/warm round-trip is outstanding: the
                    # worker's single-threaded control loop cannot
                    # answer pings while it captures, and killing a
                    # healthy worker mid-publish would turn every slow
                    # hot-reload into a respawn storm. request_sync's
                    # own timeout (and broadcast_model's death path)
                    # covers a worker that truly hangs here.
                    h.last_seen = now
                    continue
                if (now - h.last_seen) * 1000.0 \
                        > self.opts.heartbeat_timeout_ms:
                    self._declare_death(
                        rep, "heartbeat_lost",
                        f"no frame from pid {h.pid} for "
                        f"{(now - h.last_seen):.2f}s", kill=True)
                    continue
                h.send({"type": "ping", "t": time.time()})
            self._pump_respawns()

    def _pump_faults(self, plan, rep: ProcessReplica,
                     h: _WorkerHandle) -> None:
        ev = plan.take("crash_replica", rid=rep.rid)
        if ev is not None:
            h.send({"type": "fault", "kind": "crash",
                    "signal": int(ev.params.get("signal", 9))})
            return
        ev = plan.take("hang_replica", rid=rep.rid)
        if ev is not None:
            h.send({"type": "fault", "kind": "hang",
                    "ms": int(ev.params.get("ms", 0))})
            return
        ev = plan.take("oom_replica", rid=rep.rid)
        if ev is not None:
            h.send({"type": "fault", "kind": "oom"})

    def inject_fault(self, rid: int, kind: str, **params) -> bool:
        """Direct process-fault injection (the chaos storm's lever;
        the fault-plan grammar is the declarative front of the same
        frames). kind in crash|hang|oom."""
        with self._lock:
            reps = [r for r in self._replicas if r.rid == rid]
        if not reps or reps[0]._handle is None \
                or reps[0].state != "ok":
            return False
        frame = {"type": "fault", "kind": kind}
        frame.update(params)
        return reps[0]._handle.send(frame)

    def declare_lost(self, rep: ProcessReplica) -> None:
        """A submit found the worker's socket broken. A worker that was
        killed under traffic is seen first here, before the monitor's
        next tick: its death is classified by its exit status when the
        process has ended within half a second, else ``socket_lost``
        (and the worker is killed)."""
        h = rep._handle
        code = None
        if h is not None:
            try:
                code = h.proc.wait(0.5)
            except subprocess.TimeoutExpired:
                code = None
        if code is not None:
            self._declare_death(rep, _classify_exit(code),
                                f"worker pid {h.pid} exited with {code}")
        else:
            self._declare_death(rep, "socket_lost",
                                "submit failed on a live-looking worker",
                                kill=True)

    def _declare_death(self, rep: ProcessReplica, reason_code: str,
                       detail: str, kill: bool = False) -> None:
        with rep._lock:
            if rep.state == "dead" or rep.state == "quarantined":
                return
            rep.state = "dead"
        h = rep._handle
        rep._handle = None
        rep.last_death = {"reason_code": reason_code,
                          "detail": detail[:240],
                          "at": time.time(),
                          "incarnation": rep.incarnation}
        if h is not None:
            if kill:
                _kill_proc(h.proc)
            h.close()
            failed = h.fail_pending(EngineStoppedError(
                f"replica {rep.rid} worker died ({reason_code})",
                replica=rep.rid, reason_code=reason_code))
        else:
            failed = 0
        # the shard stays visible (last-known counts) but is marked
        # stale within this monitor tick — dead series read as stale,
        # never as frozen-fresh
        get_metrics().set_worker_stale(str(rep.rid), True)
        self._collect_worker_dump(rep, reason_code)
        self._note(rep, "dead", reason_code=reason_code,
                   detail=detail[:240], failed_requests=failed)
        log_warning(f"procfleet: replica {rep.rid} worker DEAD "
                    f"({reason_code}: {detail}); {failed} request(s) "
                    "failed for re-dispatch")
        fleet = self._fleet_ref()
        if fleet is not None:
            fleet._on_replica_death(rep, reason_code)
        rep._next_respawn_at = time.monotonic() + self._backoff(rep)

    def _backoff(self, rep: ProcessReplica) -> float:
        from ..robustness.retry import backoff_delays
        delays = list(backoff_delays(
            attempts=self.opts.restart_max + 2,
            base_delay_s=self.opts.backoff_base_s,
            max_delay_s=self.opts.backoff_max_s,
            desc=f"replica{rep.rid} respawn"))
        i = min(rep.restarts, len(delays) - 1) if delays else 0
        return delays[i] if delays else 0.0

    def _pump_respawns(self) -> None:
        with self._lock:
            reps = list(self._replicas)
        now = time.monotonic()
        for rep in reps:
            if rep.state != "dead" or rep._no_respawn \
                    or rep._respawning or self._stopping:
                continue
            if now < getattr(rep, "_next_respawn_at", 0.0):
                continue
            if rep.restarts >= self.opts.restart_max:
                rep.state = "quarantined"
                self._note(rep, "quarantined",
                           restarts=rep.restarts,
                           reason_code="respawn_exhausted")
                fleet = self._fleet_ref()
                if fleet is not None:
                    fleet._count("replica_quarantines")
                    fleet._note_replica_state(rep)
                log_warning(
                    f"procfleet: replica {rep.rid} QUARANTINED after "
                    f"{rep.restarts} restart(s) (respawn_exhausted); "
                    "the pool degrades but keeps serving")
                continue
            rep._respawning = True
            t = threading.Thread(target=self._respawn, args=(rep,),
                                 daemon=True,
                                 name=f"lgbm-respawn-{rep.rid}")
            t.start()
            with self._lock:
                self._respawn_threads = [
                    x for x in self._respawn_threads if x.is_alive()]
                self._respawn_threads.append(t)

    def _respawn(self, rep: ProcessReplica) -> None:
        fleet = self._fleet_ref()
        try:
            rep.restarts += 1
            if fleet is not None:
                fleet._count("replica_restarts")
            get_telemetry().count("fleet.replica_restarts")
            self.spawn(rep)
            self._note(rep, "respawned", restarts=rep.restarts,
                       ready_ms=rep.restart_ready_ms)
            if fleet is not None:
                fleet._note_replica_state(rep)
        except Exception as e:  # noqa: BLE001 - retried by the monitor
            rep.state = "dead"
            rep.last_death = {"reason_code": "spawn_failed",
                              "detail": str(e)[:240],
                              "at": time.time()}
            self._note(rep, "dead", reason_code="spawn_failed",
                       detail=str(e)[:240])
            rep._next_respawn_at = time.monotonic() + self._backoff(rep)
        finally:
            rep._respawning = False

    # -- dump collection ----------------------------------------------
    def _collect_worker_dump(self, rep: ProcessReplica,
                             reason_code: str) -> None:
        """Fold the child's flight-recorder dump and exit reason into
        the parent artifact (satellite 2: the parent's black box holds
        the whole fleet's last words, not just its own)."""
        from ..observability.flightrec import (active_recorder,
                                               resolve_dump_path,
                                               worker_dump_path)
        entry: Dict[str, Any] = {
            "rid": rep.rid, "reason_code": reason_code,
            "incarnation": rep.incarnation, "wall_time": time.time()}
        base = os.environ.get("LGBM_TPU_CRASH_DUMP", "").strip() \
            or (resolve_dump_path() or "")
        if base:
            path = worker_dump_path(base, rep.rid)
            try:
                with open(path) as fh:
                    entry["dump"] = json.load(fh)
                entry["dump_path"] = path
            except (OSError, ValueError):
                pass
        self.worker_dumps.append(entry)
        del self.worker_dumps[:-16]
        rec = active_recorder()
        if rec is not None:
            rec.note("worker_death", rid=rep.rid,
                     reason_code=reason_code)
            rec.dump(f"worker_death:{reason_code}",
                     worker_dumps=list(self.worker_dumps))

    # -- teardown ------------------------------------------------------
    def stop_worker(self, rep: ProcessReplica,
                    drain: bool = True) -> None:
        h = rep._handle
        rep._no_respawn = True
        if rep.state in ("ok", "draining"):
            rep.state = "draining" if drain else "dead"
        if h is None:
            rep.state = "dead"
            return
        if drain:
            h.send({"type": "drain"})
            deadline = time.monotonic() + 10.0
            while h.proc.poll() is None \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
        if h.proc.poll() is None:
            _kill_proc(h.proc, term_first=drain)
        h.close()
        h.fail_pending(EngineStoppedError(
            f"replica {rep.rid} stopped", replica=rep.rid))
        rep._handle = None
        rep.state = "dead"
        get_metrics().set_worker_stale(str(rep.rid), True)
        self._note(rep, "stopped", drained=bool(drain))

    def shutdown(self, drain: bool = True) -> None:
        self._stopping = True
        self._stop_evt.set()
        try:
            self._listener.close()
        except OSError:
            pass
        # a respawn in flight sees _stopping and kills its worker
        with self._lock:
            respawns = list(self._respawn_threads)
        for t in respawns:
            t.join(self.opts.spawn_timeout_s + 10.0)
        with self._lock:
            reps = list(self._replicas)
        for rep in reps:
            self.stop_worker(rep, drain=drain)
        self.reap()

    def reap(self) -> None:
        """Last-resort child reaper: kill any worker still alive. Safe
        from signal handlers and atexit; never raises."""
        with self._lock:
            reps = list(self._replicas)
        for rep in reps:
            h = rep._handle
            if h is not None and h.proc.poll() is None:
                _kill_proc(h.proc)

    # -- observability -------------------------------------------------
    def _note(self, rep: ProcessReplica, event: str, **info) -> None:
        get_telemetry().record(
            "replica", rid=rep.rid, event=event, pid=rep.pid,
            incarnation=rep.incarnation, state=rep.state, **info)
        get_metrics().set_gauge(
            "lgbm_fleet_replica_state",
            STATE_CODES.get(rep.state, -1),
            labels={"rid": rep.rid})

    def _trace_worker_request(self, rid: int, fut: ServingFuture,
                              ctx) -> None:
        tracer = get_tracer()
        if not tracer.enabled:
            return
        req = fut._req

        def emit():
            req.event.wait(60.0)
            end = req.t_perf_done or time.perf_counter()
            meta = dict(req.meta)
            wspans = getattr(req, "wspans", None)
            if wspans:
                # the worker shipped its own span records back with
                # the reply: replay them under this request's trace so
                # Perfetto shows decode -> queue wait -> device ->
                # encode INSIDE the worker as one cross-process tree
                try:
                    if tracer.replay_remote_spans(
                            wspans, ctx, cat="worker"):
                        return
                except Exception:  # noqa: BLE001 - fall back below
                    pass
            # no worker spans (federation off / old worker): keep the
            # parent-side opaque interval so the request still shows
            tracer.emit_complete(
                "worker.request", req.t_perf, end, cat="fleet",
                ctx=ctx,
                args={"replica": rid,
                      "pid": meta.get("replica_pid"),
                      "kind": req.kind,
                      "queue_ms": meta.get("queue_ms"),
                      "compute_ms": meta.get("compute_ms"),
                      "error": meta.get("error")})

        threading.Thread(target=emit, daemon=True,
                         name=f"lgbm-worker{rid}-trace").start()


class _HelloSlot:
    """Rendezvous for one spawn's authenticated hello connection (and
    the hello itself: the worker's device, or why it has none)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._conn: Optional[socket.socket] = None
        self.hello: Optional[Dict[str, Any]] = None

    def put(self, conn: socket.socket,
            hello: Optional[Dict[str, Any]] = None) -> None:
        with self._cond:
            self._conn = conn
            self.hello = hello
            self._cond.notify_all()

    def wait(self, timeout_s: float,
             alive=lambda: True) -> Optional[socket.socket]:
        """The connection, or None at the deadline or as soon as
        ``alive()`` is false (the worker exited before its hello)."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._conn is None:
                left = deadline - time.monotonic()
                if left <= 0 or not alive():
                    return None
                self._cond.wait(min(left, 0.2))
            return self._conn


def _classify_exit(code: int) -> str:
    """Worker exit status -> a probe_taxonomy worker reason code."""
    if code == 137 or code == -signal.SIGKILL:
        return "oom_killed"
    if code < 0:
        return f"signal_{-code}"
    return "crashed" if code else "exited"


def _kill_proc(proc: subprocess.Popen, term_first: bool = False) -> None:
    try:
        if term_first:
            proc.terminate()
            try:
                proc.wait(2.0)
                return
            except subprocess.TimeoutExpired:
                pass
        proc.kill()
        proc.wait(5.0)
    except (OSError, subprocess.TimeoutExpired):
        pass
