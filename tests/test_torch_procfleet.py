"""The port's process fleet (``serving/procfleet.py``,
``serving/worker.py``) on the CPU, against the JAX package's.

Frames from either package are byte-equal and read by the other; the
replica fault grammar, the exit classification, the isolation and ring
config params and ``ProcFleetOptions.from_config`` equal the JAX
package's; ``_mark_dead`` fails and re-dispatches the requests still
queued in a dead thread replica; ``shutdown`` interrupts the monitor's
wait.

Three tests spawn one shared fleet of 2 CPU workers (each worker is a
fresh interpreter, ``python -m lightgbm_tpu_torch.serving.worker``; every
wait is bounded and the module's fixture stops and reaps the workers
in a ``finally``): its responses byte-equal to the port's thread fleet
on both transports (JSON frames and the shared-memory ring) and across
a reload; a SIGKILLed worker loses no request and respawns; an armed
``crash_replica`` is classified and respawned once, and a worker told a
device it cannot use fails its hello (``spawn_failed``).
"""

import dataclasses
import os
import signal
import socket
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.robustness.faults import FaultPlan as JPlan
from lightgbm_tpu.serving import ProcFleetOptions as JOpts
from lightgbm_tpu.serving import procfleet as jpf
from lightgbm_tpu_torch.robustness.faults import FaultPlan, set_fault_plan
from lightgbm_tpu_torch.serving import (EngineStoppedError, FleetEngine,
                                        ProcFleetOptions, ServingConfig)
from lightgbm_tpu_torch.serving import procfleet as ppf

KINDS = (("predict", {}), ("raw_score", {"raw_score": True}),
         ("pred_leaf", {"pred_leaf": True}))
WAIT = 30.0


@pytest.fixture(scope="module", autouse=True)
def _lock_order_guarded():
    # every lock the supervisor and the engines create is instrumented;
    # a lock-order inversion fails the module outright
    if os.environ.get("LGBM_SYNC_GUARDS", "1") == "0":
        yield
        return
    from tools.graftsync.runtime import lock_order_guard
    with lock_order_guard():
        yield


def _toy(n=400, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.5 * X[:, 1] - 0.3 * X[:, 2] > 0).astype(np.float64)
    return X, y


def _text(seed=0, leaves=7, rounds=6):
    X, y = _toy(seed=seed)
    return lgb.train({"objective": "binary", "num_leaves": leaves,
                      "verbosity": -1}, lgb.Dataset(X, label=y),
                     num_boost_round=rounds).model_to_string()


def _wait(cond, timeout=WAIT, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


# ----------------------------------------------------------------------
def _raw_frame(mod, obj):
    a, b = socket.socketpair()
    try:
        mod.send_frame(a, obj)
        a.close()
        buf = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return buf
            buf += chunk
    finally:
        a.close()
        b.close()


def test_frames_equal_the_jax_frames():
    vals = [1.0 / 3.0, 1e-308, -0.0, 12345.678901234567, float("nan")]
    frames = [{"type": "submit", "id": 3, "model": "m", "kind": "predict",
               "rows": [[0.1, -2.5e-17, 3.0]], "timeout_ms": None,
               "trace": None},
              {"type": "result", "id": 3, "result": vals,
               "dtype": "float64", "meta": {"queue_ms": 0.25}},
              {"type": "hello", "rid": 1, "pid": 7, "token": "ab",
               "device": "cuda"},
              {"type": "shm", "shm": {"slot": 0, "seq": 2, "nrows": 4,
                                      "ncols": 6, "dtype": 0}}]
    for obj in frames:
        raw = _raw_frame(ppf, obj)
        assert raw == _raw_frame(jpf, obj)
        assert int.from_bytes(raw[:4], "big") == len(raw) - 4
    # either side reads the other's frame; float64 round-trips exactly
    for wmod, rmod in ((ppf, jpf), (jpf, ppf)):
        a, b = socket.socketpair()
        try:
            wmod.send_frame(a, frames[1])
            got = rmod.recv_frame(b)["result"]
            assert np.asarray(got).tobytes() == np.asarray(vals).tobytes()
            a.close()
            assert rmod.recv_frame(b) is None       # clean EOF
        finally:
            a.close()
            b.close()
    assert ppf._FRAME_MAX == jpf._FRAME_MAX
    assert ppf.STATE_CODES == jpf.STATE_CODES
    for code, cls in ppf._ERROR_BY_CODE.items():
        frame = {"code": code, "message": "m", "details": {"k": 1}}
        err, jerr = ppf.error_from_frame(frame), jpf.error_from_frame(frame)
        assert type(err) is cls and err.code == jerr.code == code
        assert err.to_dict() == jerr.to_dict()
        assert err.http_status == jerr.http_status


def test_replica_fault_grammar_matches_jax():
    spec = ("crash_replica@rid=2,signal=9;hang_replica@rid=0,ms=500;"
            "oom_replica@rid=1")
    plan, jplan = FaultPlan.parse(spec), JPlan.parse(spec)
    assert [e.kind for e in plan.events] == [e.kind for e in jplan.events] \
        == ["crash_replica", "hang_replica", "oom_replica"]
    for p in (plan, jplan):
        assert p.take("crash_replica", rid=0) is None
        ev = p.take("crash_replica", rid=2)
        assert ev is not None and ev.params["signal"] == 9
        assert p.take("crash_replica", rid=2) is None      # once
        assert p.take("hang_replica", rid=0).params["ms"] == 500
        assert p.take("oom_replica", rid=1) is not None
        assert p.pending() == []


@pytest.mark.parametrize("code", [0, 1, 3, 137, -9, -6, -15, -11])
def test_classify_exit_matches_jax(code):
    assert ppf._classify_exit(code) == jpf._classify_exit(code)


def test_isolation_and_shm_config_params_match_jax():
    from lightgbm_tpu.config import Config as JCfg
    from lightgbm_tpu_torch.config import Config
    for params in ({"serving_isolation": "process",
                    "replica_restart_max": 2, "replica_heartbeat_ms": 50},
                   {"isolation": "process", "shm": False},
                   {"serving_shm_slots": 8, "serving_shm_min_bytes": 0,
                    "serving_aot": False, "serving_quota_unit": "bytes",
                    "replica_spawn_timeout_s": 7.5,
                    "replica_heartbeat_timeout_ms": 900}):
        cfg, jcfg = Config.from_params(params), JCfg.from_params(params)
        assert dataclasses.asdict(ProcFleetOptions.from_config(cfg)) \
            == dataclasses.asdict(JOpts.from_config(jcfg))
        for key in ("serving_isolation", "replica_restart_max",
                    "serving_shm", "serving_shm_slots", "serving_aot"):
            assert getattr(cfg, key) == getattr(jcfg, key), key
        assert ServingConfig.from_config(cfg).aot == cfg.serving_aot
    for bad in ({"serving_isolation": "container"},
                {"replica_restart_max": -1}, {"replica_heartbeat_ms": 0},
                {"serving_shm_slots": 0}, {"serving_shm_slot_bytes": 16}):
        with pytest.raises(ValueError):
            JCfg.from_params(bad)
        with pytest.raises(ValueError):
            Config.from_params(bad)


def test_mark_dead_redispatches_queued_futures():
    """A replica discovered dead (``_mark_dead``, not ``kill_replica``)
    fails the requests still queued in its engines, and every one of
    them re-dispatches: none lost."""
    text = _text()
    X, _ = _toy()
    ref = lt.Booster(model_str=text, device="cpu")
    fl = FleetEngine(models={"alpha": text},
                     config=ServingConfig(buckets=(4,), warmup=False,
                                          flush_interval_ms=500.0,
                                          request_timeout_ms=30000),
                     replicas=2, default_model="alpha", device="cpu")
    try:
        futs = [fl.submit(X[i:i + 1]) for i in range(10)]
        victim = futs[0]._replica
        queued = [f for f in futs if f._replica is victim]
        assert queued
        fl._mark_dead(victim)
        for i, f in enumerate(futs):
            assert _same(f.result(timeout=WAIT), ref.predict(X[i:i + 1]))
        st = fl.stats()
        assert st["errors"] == 0 and st["redispatches"] >= len(queued)
        assert all(f.meta["replica"] != victim.rid for f in queued)
        assert victim.state == "dead"
        with pytest.raises(EngineStoppedError):
            victim.engine_for("beta")       # no new engine on the dead
        assert fl.submit(X[:1])._replica is not victim
    finally:
        fl.stop()


def test_shutdown_interrupts_monitor_wait():
    class _FleetStub:  # weakref-able stand-in; no replicas spawn
        pass

    sup = ppf.WorkerSupervisor(_FleetStub(),
                               ProcFleetOptions(heartbeat_ms=30000))
    try:
        t0 = time.monotonic()
        sup.shutdown(drain=False)
        assert time.monotonic() - t0 < 5.0
        sup._monitor_thread.join(timeout=5.0)
        assert not sup._monitor_thread.is_alive()
    finally:
        sup.shutdown(drain=False)


# ----------------------------------------------------------------------
# a shared fleet of 2 CPU workers (bounded spawn bill)
@pytest.fixture(scope="module")
def proc_fleet():
    texts = {"alpha": _text(), "beta": _text(seed=11, leaves=5, rounds=4),
             "gamma": _text(seed=9, leaves=9, rounds=5)}
    X, _ = _toy()
    fl = FleetEngine(
        models={"alpha": texts["alpha"], "beta": texts["beta"]},
        config=ServingConfig(buckets=(4, 16, 64), flush_interval_ms=1.0,
                             request_timeout_ms=30000),
        replicas=2, default_model="alpha", isolation="process",
        device="cpu",
        proc_opts=ProcFleetOptions(heartbeat_ms=50,
                                   heartbeat_timeout_ms=5000,
                                   spawn_timeout_s=90, backoff_base_s=0.05,
                                   restart_max=5, shm_min_bytes=2048,
                                   shm_slot_bytes=16384))
    try:
        yield fl, texts, X
    finally:
        fl.stop(drain=False)
        fl._proc_supervisor.reap()


def test_process_fleet_equals_the_thread_fleet(proc_fleet):
    """Both transports (16 rows x 6 features: 768 B of JSON rows; 64
    rows: 3,072 B through the ring; 300 rows: 14,400 B, chunked at the
    largest bucket in the worker) and a reload broadcast to both
    workers: every response byte-equal to the port's thread fleet."""
    fl, texts, X = proc_fleet
    assert all(r.state == "ok" and r.pid and r.device == "cpu"
               for r in fl.replicas)
    assert all(r.cold_start_captures == 0 for r in fl.replicas)
    thread = FleetEngine(
        models={"alpha": texts["alpha"], "beta": texts["beta"]},
        config=ServingConfig(buckets=(4, 16, 64), flush_interval_ms=1.0),
        replicas=1, default_model="alpha", device="cpu")
    try:
        writes0 = sum(r.shm_stats()["writes"] for r in fl.replicas)
        for n in (1, 16, 64, 300):
            for model in ("alpha", "beta"):
                for kind, _kw in KINDS:
                    a = fl.predict(X[:n], model=model, kind=kind)
                    b = thread.predict(X[:n], model=model, kind=kind)
                    assert _same(a, b), (n, model, kind, a.dtype)
        shm = [r.shm_stats() for r in fl.replicas]
        assert sum(s["writes"] for s in shm) - writes0 == 12, shm
        assert sum(s["oversize_misses"] + s["full_misses"]
                   + s["fallbacks"] for s in shm) == 0, shm
        assert fl.reload(texts["gamma"], model="alpha") \
            == thread.reload(texts["gamma"], model="alpha") == 2
        for n in (5, 64):
            for rep in fl.replicas:   # each worker got the new version
                fut = rep.engine_for("alpha").submit(X[:n])
                assert _same(fut.result(WAIT),
                             thread.predict(X[:n], model="alpha"))
        assert fl.stats()["errors"] == 0
        h = fl.health()
        assert h["isolation"] == "process" and h["status"] == "ok"
        assert {d["device"] for d in h["replicas"]} == {"cpu"}
        _wait(lambda: all(r.stats_lite().get("models")
                          for r in fl.replicas), 10)
        for r in fl.replicas:
            st = r.stats_lite()
            assert st["device"] == "cpu" and st["graph_captures"] == 0
    finally:
        thread.stop()


def test_process_fleet_sigkill_zero_lost_and_respawn(proc_fleet):
    fl, texts, X = proc_fleet
    ref = lt.Booster(model_str=texts["beta"], device="cpu")
    assert _wait(lambda: all(r.state == "ok" for r in fl.replicas))
    futs = [fl.submit(X[i:i + 2], model="beta") for i in range(16)]
    victim = futs[0]._replica
    old_pid, restarts0, inc0 = victim.pid, victim.restarts, \
        victim.incarnation
    os.kill(old_pid, signal.SIGKILL)          # a real crash, no frame
    for i, f in enumerate(futs):
        assert _same(f.result(timeout=WAIT), ref.predict(X[i:i + 2]))
    assert fl.stats()["errors"] == 0, "requests were lost in the kill"
    assert _wait(lambda: victim.last_death.get("reason_code")
                 == "oom_killed")
    assert _wait(lambda: victim.state == "ok"
                 and victim.incarnation > inc0, 60), victim.describe()
    assert victim.restarts == restarts0 + 1 and victim.pid != old_pid
    assert victim.restart_ready_ms is not None
    assert victim.cold_start_captures == 0 and victim.device == "cpu"
    assert _same(fl.predict(X[:5], model="beta"), ref.predict(X[:5]))
    assert fl.stats().get("replica_restarts", 0) >= 1
    assert fl.stats().get("replica_deaths", 0) >= 1


def test_process_fleet_crash_replica_and_failed_hello(proc_fleet):
    """``crash_replica`` armed in the supervisor's plan is honoured in
    the worker, classified and respawned, and fires once across the
    respawn; a worker told ``cuda`` on a machine without one fails its
    hello, which the respawn path records as ``spawn_failed``."""
    fl, texts, X = proc_fleet
    assert _wait(lambda: all(r.state == "ok" for r in fl.replicas), 60)
    victim = fl.replicas[1]
    inc0 = victim.incarnation
    plan = set_fault_plan(f"crash_replica@rid={victim.rid},signal=9")
    try:
        assert _wait(lambda: victim.incarnation > inc0
                     and victim.state == "ok", 60), victim.describe()
        assert plan.pending() == []
        assert victim.last_death["reason_code"] == "oom_killed"
        assert victim.incarnation == inc0 + 1
        ref = lt.Booster(model_str=texts["beta"], device="cpu")
        assert _same(fl.predict(X[:3], model="beta"), ref.predict(X[:3]))
    finally:
        set_fault_plan(None)
    if torch.cuda.is_available():
        return

    class _CudaFleet:  # a fleet whose device the worker cannot use
        config = ServingConfig(buckets=(4,))
        device = torch.device("cuda")

        def _count(self, name, value=1.0):
            pass

        def _note_replica_state(self, rep, event=None):
            pass

    stub = _CudaFleet()
    sup = ppf.WorkerSupervisor(stub, ProcFleetOptions(spawn_timeout_s=60,
                                                      shm=False))
    try:
        rep = sup.new_replica()
        t0 = time.monotonic()
        sup._respawn(rep)
        assert time.monotonic() - t0 < 60
        assert rep.state == "dead" and rep._handle is None
        assert rep.last_death["reason_code"] == "spawn_failed"
        assert "failed its hello" in rep.last_death["detail"]
        assert "CUDA" in rep.last_death["detail"]
    finally:
        sup.shutdown(drain=False)


# ----------------------------------------------------------------------
# marked slow, as the JAX package's are: each spawns fleets of its own
# (several worker start-ups), past what the tier-1 run should pay
def _pid_alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


@pytest.mark.slow
def test_quarantine_after_restart_budget():
    """A flapping replica exhausts ``replica_restart_max`` and is
    quarantined: health degrades, the pool keeps serving, the state
    gauge reads quarantined; stop reaps every worker."""
    from lightgbm_tpu_torch.observability.metrics import get_metrics
    text = _text()
    X, _ = _toy()
    ref = lt.Booster(model_str=text, device="cpu")
    fl = FleetEngine(
        models={"alpha": text},
        config=ServingConfig(buckets=(4,), flush_interval_ms=1.0,
                             request_timeout_ms=30000),
        replicas=2, default_model="alpha", isolation="process",
        device="cpu",
        proc_opts=ProcFleetOptions(heartbeat_ms=50,
                                   heartbeat_timeout_ms=5000,
                                   spawn_timeout_s=90, backoff_base_s=0.05,
                                   restart_max=1, flap_reset_s=3600.0))
    try:
        victim = fl.replicas[0]
        os.kill(victim.pid, signal.SIGKILL)
        assert _wait(lambda: victim.state == "ok" and victim.restarts == 1,
                     60)
        os.kill(victim.pid, signal.SIGKILL)
        assert _wait(lambda: victim.state == "quarantined", 60), \
            victim.describe()
        h = fl.health()
        assert h["status"] == "degraded" and h["replicas_quarantined"] == 1
        assert _same(fl.predict(X[:4]), ref.predict(X[:4]))
        assert fl.stats().get("replica_quarantines", 0) == 1
        gauges = get_metrics().labeled_gauges(
            prefix="lgbm_fleet_replica_state")
        key = f'lgbm_fleet_replica_state{{rid="{victim.rid}"}}'
        assert gauges.get(key) == ppf.STATE_CODES["quarantined"]
    finally:
        fl.stop()
    for rep in fl.replicas:
        if rep.pid:
            assert not _pid_alive(rep.pid)


_PREEMPT_SCRIPT = r"""
import os, sys, time, json
sys.path.insert(0, {repo!r})
import numpy as np
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.robustness.preempt import PreemptionGuard
from lightgbm_tpu_torch.serving import (FleetEngine, ProcFleetOptions,
                                        ServingConfig)
rng = np.random.RandomState(0)
X = rng.randn(200, 6)
y = (X[:, 0] > 0).astype(np.float64)
bst = lt.train({{"objective": "binary", "num_leaves": 5,
                 "verbosity": -1}}, lt.Dataset(X, label=y), 3,
               device="cpu")
guard = PreemptionGuard().install()
assert guard.installed
fl = FleetEngine(models={{"m": bst.model_to_string()}},
                 config=ServingConfig(buckets=(4,), flush_interval_ms=1.0),
                 replicas=1, default_model="m", isolation="process",
                 device="cpu",
                 proc_opts=ProcFleetOptions(heartbeat_ms=50,
                                            spawn_timeout_s=90))
with open({pidfile!r}, "w") as fh:
    json.dump([r.pid for r in fl.replicas], fh)
print("READY", flush=True)
futs = [fl.submit(X[i:i+1]) for i in range(4)]
while not guard.requested:
    time.sleep(0.02)
if {hang!r} == "hang":
    while True:
        time.sleep(0.5)
for f in futs:
    f.result(timeout=30)
fl.stop(drain=True)
guard.uninstall()
print("CLEAN", flush=True)
"""


def _run_preempt_child(tmp_path, hang):
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pidfile = str(tmp_path / f"workers_{hang}.json")
    script = _PREEMPT_SCRIPT.format(repo=repo, pidfile=pidfile, hang=hang)
    proc = subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        lines.append(line)
        if "READY" in line:
            break
        if proc.poll() is not None:
            raise AssertionError("child died early:\n" + "".join(lines))
    import json
    with open(pidfile) as fh:
        pids = json.load(fh)
    assert pids and all(_pid_alive(p) for p in pids)
    return proc, pids


@pytest.mark.slow
@pytest.mark.parametrize("hang", ["clean", "hang"])
def test_preempt_drains_or_escalates_and_reaps(tmp_path, hang):
    """SIGTERM to a supervisor drains its workers and exits clean; a
    second SIGTERM to a wedged one escalates and still reaps them."""
    import subprocess
    proc, pids = _run_preempt_child(tmp_path, hang)
    try:
        proc.send_signal(signal.SIGTERM)
        if hang == "hang":
            time.sleep(1.0)
            assert proc.poll() is None
            proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=90)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise AssertionError("the supervisor did not end")
        if hang == "hang":
            assert proc.returncode != 0
        else:
            assert proc.returncode == 0 and "CLEAN" in out, out
        assert _wait(lambda: not any(_pid_alive(p) for p in pids), 15), \
            f"orphan workers: {pids}"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
