"""Process-fleet worker: one ServingEngine pool in its own process
(port of ``lightgbm_tpu/serving/worker.py``).

``python -m lightgbm_tpu_torch.serving.worker --connect HOST:PORT --rid
K`` is spawned by the :class:`~lightgbm_tpu_torch.serving.procfleet.
WorkerSupervisor`. The worker owns a full serving stack — its own CUDA
context, its own model registries and engines (each version's stack
uploaded and its programs captured in this process), its own flight
recorder (dump path ``<crash_dump>.worker<rid>.json`` via the
``LGBM_TPU_WORKER_RID`` env the supervisor sets) — and talks to the
supervisor over one length-prefixed JSON socket:

  supervisor -> worker: ``load_model`` / ``warm`` / ``submit`` /
      ``ping`` / ``fault`` / ``drain`` / ``shutdown``
  worker -> supervisor: ``hello`` / ``ack`` / ``result`` / ``error``
      / ``pong`` / ``bye``

The worker serves on the device its config names
(``torch_device``): before it dials the supervisor it makes sure that
device is usable, and a worker told ``cuda`` that finds none sends a
hello carrying the error and exits — it never serves on the CPU. The
connect is retried with the bounded deterministic backoff from
``robustness/retry.py`` (the socket-linker pattern). The serving route
loads no hand-written kernel, so nothing here builds one.

Crash containment is the whole point: the worker honors the
process-level fault kinds (``crash`` kills itself with a signal,
``hang`` stops answering, ``oom`` exits with the OOM-kill status 137)
and a worker death of ANY kind — fault-injected or real — is visible
to the supervisor only as a dead process / stale heartbeat, exactly
like a real device OOM or runtime abort would be. When the control
socket reaches EOF (the supervisor died), the worker stops its
engines and exits: workers can never outlive their supervisor.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple


def _connect(host: str, port: int, rid: int) -> socket.socket:
    from ..robustness.retry import backoff_delays
    delays = list(backoff_delays(attempts=8, base_delay_s=0.05,
                                 max_delay_s=2.0,
                                 desc=f"worker{rid} connect"))
    last: Optional[OSError] = None
    for i in range(len(delays) + 1):
        try:
            return socket.create_connection((host, port), timeout=10.0)
        except OSError as e:
            last = e
            if i < len(delays):
                time.sleep(delays[i])
    raise last or OSError("connect failed")


def _device_check(name: str) -> Tuple[Any, Optional[str]]:
    """The torch device the worker serves on, and why it cannot (None
    when it can): a CUDA device must be visible and take an allocation."""
    import torch
    try:
        dev = torch.device(name)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                return dev, "CUDA is not available in the worker"
            torch.zeros(1, device=dev)
        return dev, None
    except Exception as e:  # noqa: BLE001 - reported in the hello
        return None, f"{type(e).__name__}: {e}"


class _Worker:
    def __init__(self, conn: socket.socket, rid: int, device):
        from .procfleet import recv_frame, send_frame
        self._recv_frame = recv_frame
        self._send_frame = send_frame
        self.conn = conn
        self.rid = rid
        self.device = device
        self.wlock = threading.Lock()
        self.engines: Dict[str, Any] = {}     # name -> ServingEngine
        self.cfg = self._serving_config()
        # shared-memory row transport (shm_ring.py): the supervisor
        # creates one ring per worker incarnation and hands its
        # geometry down via LGBM_TPU_WORKER_SHM; absent/broken env
        # means every submit carries JSON rows (the fallback path)
        from .shm_ring import ShmRing
        self.shm = ShmRing.attach_from_env()
        # metrics federation (docs/Observability.md): deltas of this
        # worker's registry/telemetry state ride each heartbeat pong
        self._fed: Any = None
        self._fed_on = os.environ.get("LGBM_TPU_FEDERATION",
                                      "1") != "0"
        # (id, fut, tinfo) triples the completion thread resolves back
        # over the socket as the engine fulfills them; tinfo carries
        # the wall-clock span anchors when the submit was traced
        self.outstanding: List[Tuple[int, Any, Any]] = []
        self.out_lock = threading.Lock()
        self.out_event = threading.Event()
        self.draining = False
        threading.Thread(target=self._completion_loop, daemon=True,
                         name="lgbm-worker-complete").start()

    @staticmethod
    def _serving_config():
        import dataclasses

        from .engine import ServingConfig
        kw = _raw_config()
        if not kw:
            return ServingConfig()
        # a newer supervisor may ship knobs this worker build doesn't
        # know (or fleet-level extras like shm geometry); keep only
        # real ServingConfig fields instead of dying on TypeError
        known = {f.name for f in dataclasses.fields(ServingConfig)}
        return ServingConfig(**{k: v for k, v in kw.items()
                                if k in known})

    def send(self, obj: Dict[str, Any]) -> None:
        try:
            self._send_frame(self.conn, obj, lock=self.wlock)
        except OSError:
            pass        # the supervisor is gone; the recv loop exits

    # -- model lifecycle ----------------------------------------------
    def _engine_for(self, name: str):
        from .engine import ServingEngine
        from .registry import ModelRegistry
        eng = self.engines.get(name)
        if eng is None:
            eng = ServingEngine(config=self.cfg,
                                registry=ModelRegistry(self.device))
            self.engines[name] = eng
        return eng

    def _captures(self) -> int:
        """The CUDA graphs this worker's engines captured (0 on the
        CPU, where the programs run eagerly)."""
        return sum(int(eng.stats()["graph_captures"])
                   for eng in list(self.engines.values()))

    def load_model(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        name = str(msg.get("name"))
        source = msg.get("text") if msg.get("text") is not None \
            else msg.get("path")
        eng = self._engine_for(name)
        before = self._captures()
        version = eng.load(source, aot=msg.get("aot"))
        mv = eng.registry.current()
        return {"ok": True, "version": version,
                "aot": bool(getattr(mv, "aot", None)),
                "device": str(eng.device),
                "captures": self._captures() - before}

    def warm(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        names = msg.get("names") or sorted(self.engines)
        before = self._captures()
        t0 = time.perf_counter()
        for name in names:
            eng = self.engines.get(name)
            if eng is None:
                continue
            mv = eng.registry.current()
            if mv is not None and self.cfg.warmup:
                eng._warmup(mv)
        return {"ok": True, "captures": self._captures() - before,
                "dur_s": round(time.perf_counter() - t0, 4)}

    # -- requests ------------------------------------------------------
    def submit(self, msg: Dict[str, Any]) -> None:
        import numpy as np

        from .errors import ModelNotFoundError, ServingError
        mid = int(msg.get("id", -1))
        name = str(msg.get("model"))
        # wall-clock span anchors (time.time() is the only clock this
        # process shares with the supervisor; the parent tracer maps
        # the readings onto its perf_counter timeline on replay)
        tinfo = None
        if msg.get("trace"):
            tinfo = {"t0": time.time(),
                     "kind": str(msg.get("kind", "predict"))}
        try:
            eng = self.engines.get(name)
            if eng is None:
                raise ModelNotFoundError(
                    f"model {name!r} is not loaded on worker "
                    f"{self.rid}", model=name)
            d0 = time.time()
            ticket = msg.get("shm")
            if ticket is not None:
                if self.shm is None:
                    raise ServingError(
                        "submit names an shm slot but this worker has "
                        "no ring attached")
                rows = np.asarray(self.shm.read(ticket), np.float64)
            else:
                rows = np.asarray(msg.get("rows"), np.float64)
            if tinfo is not None:
                tinfo["decode"] = (d0, time.time())
            fut = eng.submit(rows, str(msg.get("kind", "predict")),
                             timeout_ms=msg.get("timeout_ms"))
        except ServingError as e:
            self.send({"type": "error", "id": mid, "code": e.code,
                       "message": str(e), "details": e.details})
            return
        except Exception as e:  # noqa: BLE001 - wire it, don't die
            self.send({"type": "error", "id": mid,
                       "code": "serving_error", "message": str(e)})
            return
        with self.out_lock:
            self.outstanding.append((mid, fut, tinfo))
        self.out_event.set()

    def _completion_loop(self) -> None:
        from .errors import ServingError
        while True:
            with self.out_lock:
                items = list(self.outstanding)
            if not items:
                self.out_event.wait(0.05)
                self.out_event.clear()
                continue
            done: List[Tuple[int, Any, Any]] = []
            for mid, fut, tinfo in items:
                if fut.done():
                    done.append((mid, fut, tinfo))
            if not done:
                # deliberate 1ms completion poll: device futures have
                # no event to wait on, and the thread is daemon inside
                # a worker process that dies with its supervisor
                time.sleep(0.001)  # graftsync: allow[GS302]
                continue
            with self.out_lock:
                self.outstanding = [p for p in self.outstanding
                                    if p not in done]
            for mid, fut, tinfo in done:
                try:
                    out = fut.result(timeout=0)
                    e0 = time.time()
                    payload = out.tolist()
                    meta = _jsonable_meta(fut.meta)
                    frame = {"type": "result", "id": mid,
                             "result": payload, "dtype": str(out.dtype),
                             "meta": meta}
                    spans = self._spans(tinfo, meta, encode=(
                        e0, time.time()))
                    if spans:
                        frame["spans"] = spans
                    self.send(frame)
                except ServingError as e:
                    frame = {"type": "error", "id": mid,
                             "code": e.code, "message": str(e),
                             "details": _jsonable_meta(e.details)}
                    spans = self._spans(
                        tinfo, _jsonable_meta(getattr(
                            fut, "meta", {}) or {}))
                    if spans:
                        frame["spans"] = spans
                    self.send(frame)
                except Exception as e:  # noqa: BLE001
                    self.send({"type": "error", "id": mid,
                               "code": "serving_error",
                               "message": str(e)})

    def _spans(self, tinfo: Optional[Dict[str, Any]],
               meta: Dict[str, Any],
               encode: Optional[Tuple[float, float]] = None
               ) -> Optional[List[Dict[str, Any]]]:
        """Build the wall-clock span records shipped back with a
        traced reply: the request root plus the decode / queue-wait /
        device / encode decomposition. Queue and device intervals are
        reconstructed from the engine's own measured ``queue_ms`` /
        ``compute_ms`` meta, anchored at decode end — the engine
        measures them, this just places them on the shared clock."""
        if tinfo is None:
            return None
        try:
            now = time.time()
            t0 = float(tinfo["t0"])
            recs: List[Dict[str, Any]] = [{
                "name": "worker.request", "root": True,
                "t0": t0, "t1": now,
                "args": {"replica": self.rid, "pid": os.getpid(),
                         "kind": tinfo.get("kind"),
                         "queue_ms": meta.get("queue_ms"),
                         "compute_ms": meta.get("compute_ms"),
                         "error": meta.get("error")}}]
            cursor = t0
            dec = tinfo.get("decode")
            if dec:
                recs.append({"name": "worker.decode",
                             "t0": float(dec[0]), "t1": float(dec[1])})
                cursor = float(dec[1])
            q_ms = meta.get("queue_ms")
            if isinstance(q_ms, (int, float)):
                q1 = min(cursor + float(q_ms) / 1000.0, now)
                recs.append({"name": "worker.queue_wait",
                             "t0": cursor, "t1": q1})
                cursor = q1
            c_ms = meta.get("compute_ms")
            if isinstance(c_ms, (int, float)):
                c1 = min(cursor + float(c_ms) / 1000.0, now)
                recs.append({"name": "worker.device",
                             "t0": cursor, "t1": c1,
                             "args": {"bucket": meta.get("bucket")}})
            if encode:
                recs.append({"name": "worker.encode",
                             "t0": float(encode[0]),
                             "t1": float(encode[1])})
            return recs
        except Exception:  # noqa: BLE001 - spans must never block
            return None    # the reply itself

    def pong(self, msg: Dict[str, Any]) -> None:
        stats = {"models": {}, "graph_captures": self._captures(),
                 "device": str(self.device)}
        if self.device.type == "cuda":
            import torch
            stats["device_reserved_bytes"] = int(
                torch.cuda.memory_reserved(self.device))
            stats["device_allocated_bytes"] = int(
                torch.cuda.memory_allocated(self.device))
        if self.shm is not None:
            stats["shm_reads"] = self.shm.reads
        load = 0
        for name, eng in self.engines.items():
            s = eng.stats()
            stats["models"][name] = {
                k: v for k, v in s.items()
                if isinstance(v, (int, float)) and not isinstance(
                    v, bool)}
            load += eng.queue_depth
        with self.out_lock:
            load += len(self.outstanding)
        frame = {"type": "pong", "t": msg.get("t"), "load": load,
                 "stats": stats}
        if self._fed_on:
            # piggyback the metrics-federation delta: cumulative
            # per-series state for everything that changed since the
            # previous pong (idempotent to merge, safe to lose — the
            # next delta re-ships whatever is still changing)
            try:
                if self._fed is None:
                    from ..observability.metrics import \
                        FederationClient
                    self._fed = FederationClient()
                frame["fed"] = self._fed.delta()
            except Exception:  # noqa: BLE001 - never break heartbeat
                pass
        self.send(frame)

    # -- faults --------------------------------------------------------
    def fault(self, msg: Dict[str, Any]) -> None:
        kind = str(msg.get("kind"))
        from ..utils.log import log_warning
        log_warning(f"worker {self.rid}: honoring injected fault "
                    f"{kind!r}")
        if kind == "crash":
            os.kill(os.getpid(), int(msg.get("signal", 9)))
        elif kind == "hang":
            # sleeping the RECEIVE loop is the hang: pings pile up
            # unanswered and the supervisor's heartbeat timeout fires
            time.sleep(float(msg.get("ms", 0)) / 1000.0)
        elif kind == "oom":
            os._exit(137)   # the kernel OOM reaper's signature status

    # -- teardown ------------------------------------------------------
    def drain(self) -> None:
        self.draining = True
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            with self.out_lock:
                if not self.outstanding:
                    break
            time.sleep(0.01)
        for eng in self.engines.values():
            eng.stop(drain=True)
        self.send({"type": "bye", "rid": self.rid})

    def shutdown(self, drain: bool = False) -> None:
        for eng in self.engines.values():
            try:
                eng.stop(drain=drain)
            except Exception:  # noqa: BLE001 - exiting anyway
                pass
        if self.shm is not None:
            self.shm.close()    # never unlink: the supervisor owns it

    # -- main loop -----------------------------------------------------
    def run(self) -> int:
        while True:
            try:
                msg = self._recv_frame(self.conn)
            except (OSError, ValueError):
                msg = None
            if msg is None:
                # supervisor gone (EOF/reset): stop and exit — a
                # worker never outlives its supervisor (no orphans)
                self.shutdown(drain=False)
                return 0
            t = msg.get("type")
            if t == "submit":
                self.submit(msg)
            elif t == "ping":
                self.pong(msg)
            elif t in ("load_model", "warm"):
                try:
                    ack = self.load_model(msg) if t == "load_model" \
                        else self.warm(msg)
                except Exception as e:  # noqa: BLE001 - wire it
                    ack = {"ok": False, "message": str(e)[:500]}
                ack.update(type="ack", id=msg.get("id"))
                self.send(ack)
            elif t == "fault":
                self.fault(msg)
            elif t == "drain":
                self.drain()
                return 0
            elif t == "shutdown":
                self.shutdown()
                return 0


def _raw_config() -> Dict[str, Any]:
    """The supervisor's ``LGBM_TPU_WORKER_CONFIG`` (empty without one)."""
    raw = os.environ.get("LGBM_TPU_WORKER_CONFIG", "").strip()
    return json.loads(raw) if raw else {}


def _jsonable_meta(meta: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in (meta or {}).items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
    return out


def main(argv: Optional[List[str]] = None) -> int:
    t_main = time.time()     # the interpreter and its imports are done
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--connect", required=True,
                    help="supervisor listener host:port")
    ap.add_argument("--rid", type=int, required=True)
    args = ap.parse_args(argv)
    host, _, port = args.connect.rpartition(":")

    os.environ.setdefault("LGBM_TPU_WORKER_RID", str(args.rid))
    # the device first (before the connect: the supervisor's accept
    # loop reads each hello under a short timeout), then authenticate
    # (the supervisor's spawn timeout is ticking), then bring the
    # serving stack up
    dev, err = _device_check(
        str(_raw_config().get("torch_device", "cuda")))
    t_device = time.time()
    conn = _connect(host or "127.0.0.1", int(port), args.rid)
    conn.settimeout(None)

    from .procfleet import send_frame
    hello = {"type": "hello", "rid": args.rid, "pid": os.getpid(),
             "token": os.environ.get("LGBM_TPU_WORKER_TOKEN", ""),
             "device": None if dev is None else str(dev),
             "t_main": t_main, "t_device": t_device}
    if err is not None:
        hello["error"] = err
    send_frame(conn, hello)
    if err is not None:
        conn.close()
        return 3

    from ..observability.flightrec import arm_recorder, dump_exception
    from ..observability.telemetry import get_telemetry
    get_telemetry().ensure_started()
    get_telemetry().ensure_ring()
    arm_recorder()           # own black box at <dump>.worker<rid>.json

    # SIGTERM = the supervisor's graceful stop path racing a socket
    # drain; treat it as "stop now, cleanly"
    worker = _Worker(conn, args.rid, dev)

    def _term(signum, frame):
        worker.shutdown(drain=False)
        os._exit(0)

    try:
        signal.signal(signal.SIGTERM, _term)
    except (ValueError, OSError):
        pass

    try:
        return worker.run()
    except BaseException as e:  # noqa: BLE001 - last words, then die
        dump_exception(e if isinstance(e, Exception)
                       else RuntimeError(repr(e)))
        raise


if __name__ == "__main__":
    sys.exit(main())
