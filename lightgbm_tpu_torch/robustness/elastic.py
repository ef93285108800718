"""The elastic watchdog of a multi-rank training run (port of
``lightgbm_tpu/robustness/elastic.py``): a heartbeat side-channel that
turns a lost or wedged rank into a bounded, classified failure.

A rank that dies mid-iteration (a preempted host, an OOM kill) leaves
the others inside a collective. Gloo may raise ("Connection closed by
peer") or may wait out the process group's timeout; either way the
survivors learn nothing of what happened. This module adds:

* a **heartbeat side-channel** over stdlib TCP sockets: rank 0 listens,
  every other rank dials in with the bounded backoff of :mod:`.retry`
  and sends a frame every ``elastic_heartbeat_ms`` (4-byte big-endian
  length + JSON, at most ``_FRAME_MAX`` bytes);
* **monitor threads** that classify a failure into the reason codes of
  :data:`ELASTIC_REASON_CODES`:

  - ``peer_lost``: a rank's connection closed without a goodbye, its
    heartbeats went stale past ``elastic_heartbeat_timeout_ms``, or it
    never joined (rank 0's verdict, broadcast to every rank);
  - ``collective_stall``: the channel is healthy but this rank saw no
    iteration boundary for ``elastic_stall_timeout_ms``;
  - ``coordinator_lost``: rank 0's connection closed or went quiet
    (the other ranks' verdict);

* a **bounded abort**: the failure is counted (``elastic.aborts``,
  ``elastic.abort.<reason>``), recorded on the telemetry timeline
  (``elastic`` records) and raised as :class:`ElasticError` at the next
  iteration boundary (``check``), or where a collective raised inside
  the iteration (``classify``, called by the engine). A rank that
  reaches neither, wedged in a collective that cannot complete, exits
  with :data:`ELASTIC_EXIT_CODE` after ``elastic_abort_grace_ms``,
  printing one ``ELASTIC_ABORT reason=<code> rank=<r> ...`` line to
  stderr that :func:`classify_elastic_failure` parses back.

The watchdog adds no collective: host threads and sockets only.

**The side-channel's address** (``resolve_elastic_port``):
``elastic_port`` when it is set; else the coordinator's port +
:data:`ELASTIC_PORT_OFFSET` where the group has one (the config's
machine list, or a ``tcp://host:port`` rendezvous), at that host. A
group that met through ``file://`` (or ``env://``) has no coordinator
port: there rank 0 binds port 0 and publishes ``host:port`` once, at the
watchdog's start, under a key of the group's own store
(``torch.distributed``'s default store), which the other ranks read;
the host is ``MASTER_ADDR`` when set, else 127.0.0.1 (the ranks of such
a group share a host, as a rendezvous file on a local path implies). The
key carries the number of watchdogs this process has started, so that
successive runs in one group never read an older run's port. A store
read is a rendezvous, not a collective inside training.

Fault drills (:mod:`.faults`): ``drop_heartbeat@rank=R`` silences rank
R's sender (taken here, never in the training loop); ``kill_rank`` and
``stall_rank`` fire at the engine's iteration boundary
(:func:`~.faults.maybe_rank_fault`).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..utils.log import LightGBMError, log_info, log_warning

# the exit status of a rank aborted by the watchdog; outside the shell
# and signal ranges, so that drill harnesses can assert on it
ELASTIC_EXIT_CODE = 43

# elastic_port 0 resolves to the coordinator's port + this offset
ELASTIC_PORT_OFFSET = 521

_FRAME_MAX = 1 << 20   # heartbeat frames are tiny; bound hostile input

# the port's copy of tools/probe_taxonomy.py:58-90 (the port imports
# nothing of tools/): the reason codes and the abort-evidence classifier
ELASTIC_REASON_CODES = ("peer_lost", "collective_stall",
                        "coordinator_lost", "unknown")

_ELASTIC_SIGNATURES = (
    (("coordinator_lost", "coordinator went quiet",
      "coordinator heartbeat"), "coordinator_lost"),
    (("collective_stall", "no iteration boundary",
      "stall timeout"), "collective_stall"),
    (("peer_lost", "heartbeat connection closed",
      "heartbeats stale", "never joined"), "peer_lost"),
)

# watchdogs started in this process (the store key's sequence number)
_STARTED = [0]


def classify_elastic_failure(detail: str) -> str:
    """Abort evidence -> one of :data:`ELASTIC_REASON_CODES`: an explicit
    ``reason=<code>`` token wins, else the free-text signatures."""
    d = (detail or "").lower()
    if not d.strip():
        return "unknown"
    for tok in d.replace(",", " ").split():
        if tok.startswith("reason="):
            code = tok[len("reason="):]
            if code in ELASTIC_REASON_CODES:
                return code
    for needles, code in _ELASTIC_SIGNATURES:
        if any(n in d for n in needles):
            return code
    return "unknown"


def send_frame(sock_, obj: Dict[str, Any],
               lock: Optional[threading.Lock] = None) -> None:
    """One frame: 4-byte big-endian length + one JSON object."""
    body = json.dumps(obj).encode()
    payload = struct.pack(">I", len(body)) + body
    if lock is not None:
        with lock:
            sock_.sendall(payload)
    else:
        sock_.sendall(payload)


def _recv_exact(sock_, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock_.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


def recv_frame(sock_) -> Optional[Dict[str, Any]]:
    """One frame, or None on EOF, reset, oversize or garbage (every one
    of which the callers treat as a lost peer)."""
    head = _recv_exact(sock_, 4)
    if head is None:
        return None
    (n,) = struct.unpack(">I", head)
    if n > _FRAME_MAX:
        return None
    body = _recv_exact(sock_, n)
    if body is None:
        return None
    try:
        return json.loads(body)
    except ValueError:
        return None


class ElasticError(LightGBMError):
    """A watchdog-classified distributed failure (bounded, not hung)."""

    def __init__(self, reason_code: str, rank: int, detail: str = "",
                 iteration: int = -1):
        self.reason_code = reason_code
        self.rank = int(rank)
        self.detail = detail
        # the last iteration boundary the watchdog saw
        self.iteration = int(iteration)
        super().__init__(
            f"elastic: distributed training aborted "
            f"(reason={reason_code} rank={rank}): {detail}")


def abort_line(reason: str, rank: int, iteration: int,
               detail: str) -> str:
    """The one line an aborting rank prints (``classify_elastic_failure``
    reads its ``reason=`` token back)."""
    return (f"ELASTIC_ABORT reason={reason} rank={rank} "
            f"iter={iteration} detail={detail[:200]}")


def elastic_exit(err: ElasticError) -> None:
    """What the program running a rank does with a raised
    :class:`ElasticError`: print its abort line to stderr, flush the
    telemetry and exit with :data:`ELASTIC_EXIT_CODE` (without tearing
    down a process group whose peer is gone)."""
    sys.stderr.write(abort_line(err.reason_code, err.rank, err.iteration,
                                err.detail) + "\n")
    sys.stderr.flush()
    sys.stdout.flush()
    try:
        from ..observability.telemetry import get_telemetry
        get_telemetry().flush()
    except Exception:  # noqa: BLE001 - the exit must happen
        pass
    os._exit(ELASTIC_EXIT_CODE)


def _tcp_coordinator(init_method: Optional[str]
                     ) -> Optional[Tuple[str, int]]:
    if not init_method or not init_method.startswith("tcp://"):
        return None
    host, _, port = init_method[len("tcp://"):].split("/")[0] \
        .partition(":")
    return (host, int(port)) if port.isdigit() else None


def resolve_elastic_port(config, machines,
                         init_method: Optional[str] = None) -> int:
    """The side-channel's port: ``elastic_port`` when set, else the
    coordinator's port (the machine list's first entry, or the
    ``tcp://`` rendezvous) + :data:`ELASTIC_PORT_OFFSET`; 0 where the
    group has no coordinator port (rank 0 then binds an ephemeral port
    and publishes it through the group's store)."""
    p = int(getattr(config, "elastic_port", 0) or 0)
    if p:
        return p
    if machines:
        return int(machines[0][1]) + ELASTIC_PORT_OFFSET
    tcp = _tcp_coordinator(init_method)
    if tcp is not None:
        return tcp[1] + ELASTIC_PORT_OFFSET
    return 0


def resolve_elastic_host(machines, init_method: Optional[str] = None
                         ) -> str:
    """Rank 0's address: the machine list's first host, the ``tcp://``
    rendezvous host, else ``MASTER_ADDR`` or 127.0.0.1."""
    if machines:
        return machines[0][0]
    tcp = _tcp_coordinator(init_method)
    if tcp is not None:
        return tcp[0]
    return os.environ.get("MASTER_ADDR", "127.0.0.1")


def watchdog_bounds_s(config) -> float:
    """The longest a failure takes the watchdog to abort a rank: the
    larger of the stall and heartbeat timeouts, plus the grace window
    (the process group's own timeout must not be shorter)."""
    return (max(float(config.elastic_stall_timeout_ms),
                float(config.elastic_heartbeat_timeout_ms))
            + float(config.elastic_abort_grace_ms)) / 1000.0


class ElasticWatchdog:
    """Per-rank collective watchdog over the heartbeat side-channel.

    Rank 0 hosts the listener and declares ``peer_lost``; the other
    ranks dial in and declare ``coordinator_lost``; every rank watches
    its own iteration progress for ``collective_stall``. One instance a
    training run: ``start()`` / ``progress(i)`` / ``check()`` /
    ``classify(exc)`` / ``stop()``. ``port`` 0 with a ``store`` is the
    ephemeral port published under ``store_key`` (see the module
    docstring)."""

    def __init__(self, rank: int, world_size: int, host: str,
                 port: int, *, heartbeat_ms: float = 500.0,
                 heartbeat_timeout_ms: float = 10000.0,
                 stall_timeout_ms: float = 120000.0,
                 abort_grace_ms: float = 5000.0,
                 store=None, store_key: str = ""):
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.host = host
        self.port = int(port)
        self.heartbeat_s = max(float(heartbeat_ms), 10.0) / 1000.0
        self.hb_timeout_s = max(float(heartbeat_timeout_ms),
                                50.0) / 1000.0
        self.stall_timeout_s = max(float(stall_timeout_ms),
                                   100.0) / 1000.0
        self.grace_s = max(float(abort_grace_ms), 100.0) / 1000.0
        self._store = store
        self._store_key = store_key
        self.iteration = -1
        self.timeline: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._failure: Optional[Tuple[str, int, str]] = None
        self._stopped = False
        self._started = False
        self._grace_timer: Optional[threading.Timer] = None
        self._threads: List[threading.Thread] = []
        # the monitor loops wait on this, so that stop() and _fail()
        # interrupt a wait instead of riding it out
        self._wake = threading.Event()
        self._last_progress = time.monotonic()
        # rank 0
        self._listener: Optional[socket.socket] = None
        self._conns: Dict[int, socket.socket] = {}
        self._conn_locks: Dict[int, threading.Lock] = {}
        self._last_seen: Dict[int, float] = {}
        self._clean_bye: set = set()
        # the other ranks
        self._sock: Optional[socket.socket] = None
        self._send_lock = threading.Lock()
        self._drop_heartbeats = False
        self._coord_bye = False

    # -- construction --------------------------------------------------
    @classmethod
    def from_config(cls, config, rank: int, world_size: int, machines,
                    init_method: Optional[str] = None, store=None
                    ) -> "ElasticWatchdog":
        """The watchdog of a run under ``config``: the address by
        ``resolve_elastic_port`` / ``resolve_elastic_host``; ``store``
        (the group's) publishes an ephemeral port."""
        _STARTED[0] += 1
        return cls(
            rank, world_size, resolve_elastic_host(machines, init_method),
            resolve_elastic_port(config, machines, init_method),
            heartbeat_ms=float(config.elastic_heartbeat_ms),
            heartbeat_timeout_ms=float(config.elastic_heartbeat_timeout_ms),
            stall_timeout_ms=float(config.elastic_stall_timeout_ms),
            abort_grace_ms=float(config.elastic_abort_grace_ms),
            store=store, store_key=f"lgbm_tpu_torch/elastic/{_STARTED[0]}")

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "ElasticWatchdog":
        if self._started:
            return self
        self._started = True
        self._last_progress = time.monotonic()
        if self.rank == 0:
            self._start_coordinator()
        else:
            self._start_client()
        self._spawn(self._stall_monitor, "elastic-stall")
        self._event("watchdog_start", rank=self.rank,
                    world_size=self.world_size, port=self.port)
        log_info(f"elastic: watchdog up (rank {self.rank}/"
                 f"{self.world_size}, side-channel port {self.port})")
        return self

    def progress(self, iteration: int) -> None:
        """Mark an iteration boundary (resets the stall clock)."""
        self.iteration = int(iteration)
        self._last_progress = time.monotonic()

    def failure(self) -> Optional[Tuple[str, int, str]]:
        with self._lock:
            return self._failure

    def check(self) -> None:
        """Raise the pending :class:`ElasticError` (at an iteration
        boundary: the clean half of the bounded abort)."""
        f = self.failure()
        if f is None:
            return
        self.stop(clean=False)
        raise ElasticError(*f, iteration=self.iteration)

    def classify(self, exc: BaseException) -> Optional[ElasticError]:
        """A collective raised inside an iteration (gloo's "Connection
        closed by peer", where XLA would hang): wait up to the heartbeat
        timeout for this rank's verdict and return it as an
        :class:`ElasticError` (the watchdog stopped), or None when the
        channel saw nothing wrong (the error is not a lost rank's)."""
        deadline = time.monotonic() + self.hb_timeout_s + self.heartbeat_s
        while self.failure() is None and time.monotonic() < deadline:
            self._wake.wait(0.02)
        f = self.failure()
        if f is None:
            return None
        reason, rank, detail = f
        self._event("collective_raised", reason_code=reason, rank=rank,
                    error=str(exc)[:200], iteration=self.iteration)
        self.stop(clean=False)
        return ElasticError(reason, rank,
                            f"{detail} (the collective raised: "
                            f"{str(exc)[:200]})", iteration=self.iteration)

    def stop(self, clean: bool = True) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            timer, self._grace_timer = self._grace_timer, None
        self._wake.set()
        if timer is not None:
            timer.cancel()
        if clean and self.rank != 0 and self._sock is not None:
            try:
                send_frame(self._sock, {"type": "goodbye",
                                        "rank": self.rank},
                           self._send_lock)
            except OSError:
                pass
        if clean and self.rank == 0:
            self._broadcast({"type": "bye"})
        self._event("watchdog_stop", rank=self.rank, clean=clean)
        for s in list(self._conns.values()) + [self._sock,
                                               self._listener]:
            if s is not None:
                # shutdown (not only close) wakes the threads blocked in
                # accept() or recv() on the socket
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass
        me = threading.current_thread()
        for t in self._threads:
            if t is not me:
                t.join(timeout=max(self.heartbeat_s, 1.0))

    # -- internals -----------------------------------------------------
    def _spawn(self, fn, name: str) -> None:
        t = threading.Thread(target=fn, name=name, daemon=True)
        t.start()
        self._threads.append(t)

    def _event(self, event: str, **fields) -> None:
        rec = {"event": event, **fields}
        self.timeline.append({"t": time.time(), **rec})
        try:
            from ..observability.telemetry import get_telemetry
            get_telemetry().record("elastic", **rec)
        except Exception:  # noqa: BLE001 - never break the watchdog
            pass

    def _fail(self, reason: str, rank: int, detail: str) -> None:
        with self._lock:
            if self._failure is not None or self._stopped:
                return
            self._failure = (reason, int(rank), detail)
        self._wake.set()
        log_warning(f"elastic: {reason} (rank {rank}): {detail}")
        self._event("abort", reason_code=reason, rank=int(rank),
                    detail=detail[:200], iteration=self.iteration)
        try:
            from ..observability.telemetry import get_telemetry
            tel = get_telemetry()
            tel.count("elastic.aborts")
            tel.count(f"elastic.abort.{reason}")
            tel.flush()
        except Exception:  # noqa: BLE001
            pass
        if self.rank == 0:
            # every surviving rank must abort, not only the one that
            # noticed: broadcast the verdict over the side-channel
            self._broadcast({"type": "abort", "reason": reason,
                             "rank": int(rank), "detail": detail})
        # the unclean half of the bounded abort: a rank wedged inside a
        # collective never reaches check(); one grace window, then exit
        timer = threading.Timer(self.grace_s, self._hard_abort)
        timer.daemon = True
        with self._lock:
            if not self._stopped:
                self._grace_timer = timer
                timer.start()

    def _hard_abort(self) -> None:
        with self._lock:
            if self._stopped or self._failure is None:
                return
            reason, rank, detail = self._failure
        sys.stderr.write(abort_line(reason, rank, self.iteration, detail)
                         + "\n")
        sys.stderr.flush()
        try:
            from ..observability.telemetry import get_telemetry
            get_telemetry().flush()
        except Exception:  # noqa: BLE001
            pass
        os._exit(ELASTIC_EXIT_CODE)

    # -- stall monitor (every rank) ------------------------------------
    def _stall_monitor(self) -> None:
        while True:
            self._wake.wait(min(self.heartbeat_s, 0.2))
            with self._lock:
                if self._stopped or self._failure is not None:
                    return
            idle = time.monotonic() - self._last_progress
            if idle > self.stall_timeout_s:
                self._fail(
                    "collective_stall", self.rank,
                    f"no iteration boundary for {idle:.1f}s "
                    f"(stall timeout {self.stall_timeout_s:.1f}s) "
                    f"at iteration {self.iteration}")
                return

    # -- coordinator (rank 0) ------------------------------------------
    def _start_coordinator(self) -> None:
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind(("", self.port))
        ls.listen(max(self.world_size, 8))
        self._listener = ls
        if self.port == 0:
            self.port = ls.getsockname()[1]
            if self._store is not None:
                self._store.set(self._store_key, f"{self.host}:{self.port}")
        self._spawn(self._accept_loop, "elastic-accept")
        self._spawn(self._peer_monitor, "elastic-peers")

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # the listener closed by stop()
            with self._lock:
                if self._stopped:
                    try:
                        conn.close()
                    except OSError:
                        pass
                    return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._spawn(lambda c=conn: self._serve_conn(c),
                        "elastic-conn")

    def _serve_conn(self, conn: socket.socket) -> None:
        rank = None
        while True:
            msg = recv_frame(conn)
            if msg is None:
                break
            kind = msg.get("type")
            if kind == "hello":
                rank = int(msg.get("rank", -1))
                with self._lock:
                    self._conns[rank] = conn
                    self._conn_locks[rank] = threading.Lock()
                    self._last_seen[rank] = time.monotonic()
                self._event("peer_hello", rank=rank, pid=msg.get("pid"))
            elif kind == "hb" and rank is not None:
                with self._lock:
                    self._last_seen[rank] = time.monotonic()
                try:
                    from ..observability.telemetry import get_telemetry
                    get_telemetry().count("elastic.heartbeats")
                except Exception:  # noqa: BLE001
                    pass
            elif kind == "goodbye" and rank is not None:
                self._clean_bye.add(rank)
                self._event("peer_goodbye", rank=rank)
        # EOF: after a goodbye a finished rank, else a dead one, declared
        # at once rather than on staleness
        if rank is not None and rank not in self._clean_bye:
            with self._lock:
                stopped = self._stopped
            if not stopped:
                self._fail("peer_lost", rank,
                           f"rank {rank} heartbeat connection closed "
                           "without goodbye")

    def _peer_monitor(self) -> None:
        # the ranks get one timeout window to dial in before absence
        # itself is a failure
        t0 = time.monotonic()
        expected = set(range(1, self.world_size))
        while True:
            self._wake.wait(min(self.heartbeat_s, 0.2))
            with self._lock:
                if self._stopped or self._failure is not None:
                    return
                seen = dict(self._last_seen)
            now = time.monotonic()
            missing = expected - set(seen) - self._clean_bye
            if missing and now - t0 > self.hb_timeout_s:
                r = min(missing)
                self._fail("peer_lost", r,
                           f"rank {r} never joined the heartbeat "
                           f"channel within {self.hb_timeout_s:.1f}s")
                return
            for r, last in seen.items():
                if r in self._clean_bye:
                    continue
                if now - last > self.hb_timeout_s:
                    self._fail(
                        "peer_lost", r,
                        f"rank {r} heartbeats stale for "
                        f"{now - last:.1f}s (timeout "
                        f"{self.hb_timeout_s:.1f}s)")
                    return
            # keepalives let the clients tell a live but idle
            # coordinator from a dead one
            self._broadcast({"type": "hb", "rank": 0,
                             "iter": self.iteration})

    def _broadcast(self, obj: Dict[str, Any]) -> None:
        with self._lock:
            conns = dict(self._conns)
        for r, c in conns.items():
            try:
                send_frame(c, obj, self._conn_locks.get(r))
            except OSError:
                pass

    # -- client (rank > 0) ---------------------------------------------
    def _start_client(self) -> None:
        from .retry import retry_call
        if self.port == 0 and self._store is not None:
            host, _, port = self._store.get(self._store_key).decode() \
                .rpartition(":")
            self.host, self.port = host, int(port)
        self._sock = retry_call(
            socket.create_connection, (self.host, self.port),
            timeout=self.hb_timeout_s,
            attempts=int(os.environ.get("LGBM_TPU_ELASTIC_ATTEMPTS", 8)),
            base_delay_s=float(os.environ.get(
                "LGBM_TPU_ELASTIC_BACKOFF_S", 0.25)),
            max_delay_s=5.0, retry_on=(OSError,),
            desc=f"elastic side-channel {self.host}:{self.port}")
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        send_frame(self._sock, {"type": "hello", "rank": self.rank,
                                "pid": os.getpid()}, self._send_lock)
        self._spawn(self._sender_loop, "elastic-send")
        self._spawn(self._client_recv_loop, "elastic-recv")

    def _sender_loop(self) -> None:
        from .faults import get_fault_plan
        while True:
            self._wake.wait(self.heartbeat_s)
            with self._lock:
                if self._stopped or self._failure is not None:
                    return
            if not self._drop_heartbeats:
                plan = get_fault_plan()
                if plan is not None and plan.take(
                        "drop_heartbeat", rank=self.rank) is not None:
                    # the drill: the rank goes on training but falls
                    # silent; rank 0 must declare peer_lost
                    self._drop_heartbeats = True
                    self._event("heartbeats_dropped", rank=self.rank)
            if self._drop_heartbeats:
                continue
            try:
                send_frame(self._sock, {"type": "hb", "rank": self.rank,
                                        "iter": self.iteration},
                           self._send_lock)
                from ..observability.telemetry import get_telemetry
                get_telemetry().count("elastic.heartbeats")
            except Exception:  # noqa: BLE001 - EOF: the recv loop's
                pass

    def _client_recv_loop(self) -> None:
        import select
        # a blocking socket, with select for staleness: a read timeout
        # is an OSError, which recv_frame cannot tell from EOF
        try:
            self._sock.settimeout(None)
        except OSError:
            return  # stop() closed the socket before the loop began
        last_from_coord = time.monotonic()
        while True:
            with self._lock:
                if self._stopped or self._failure is not None:
                    return
            try:
                readable, _w, _x = select.select(
                    [self._sock], [], [], min(self.heartbeat_s, 0.5))
            except (OSError, ValueError):
                return  # the socket closed under us by stop()
            if not readable:
                if time.monotonic() - last_from_coord > self.hb_timeout_s:
                    self._fail("coordinator_lost", 0,
                               "coordinator went quiet past "
                               f"{self.hb_timeout_s:.1f}s")
                    return
                continue
            msg = recv_frame(self._sock)
            if msg is None:
                if self._coord_bye:
                    return  # a clean shutdown
                with self._lock:
                    stopped = self._stopped
                if not stopped:
                    self._fail("coordinator_lost", 0,
                               "coordinator heartbeat connection closed")
                return
            last_from_coord = time.monotonic()
            kind = msg.get("type")
            if kind == "abort":
                self._fail(str(msg.get("reason", "peer_lost")),
                           int(msg.get("rank", -1)),
                           f"coordinator broadcast: "
                           f"{msg.get('detail', '')}")
                return
            if kind == "bye":
                self._coord_bye = True
