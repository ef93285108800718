"""The port's elastic plane (``lightgbm_tpu_torch/robustness/elastic.py``
and the coordinated checkpoint of ``robustness/checkpoint.py``): the
port-side twins of every case of ``tests/test_elastic.py``, run against
the port, plus the port's own rules (the side-channel port published
through a group's store, a raising collective classified by the
watchdog's verdict).

Everything here is hermetic: real sockets and threads on localhost, two
watchdogs in one process, no process group. The coordinated checkpoint
is driven in one process by giving ``CheckpointManager`` a world. The
2-process drill (kill, resume, shrink, guard) is
``tests/test_torch_elastic_drill.py``.
"""

import json
import shutil
import socket
import struct
import threading
import time

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.parallel import distributed as dist
from lightgbm_tpu_torch.parallel.distributed import WorldInfo
from lightgbm_tpu_torch.robustness import elastic as el
from lightgbm_tpu_torch.robustness.checkpoint import (COMMIT_MARKER,
                                                      CheckpointManager,
                                                      config_fingerprint)
from lightgbm_tpu_torch.robustness.elastic import (ELASTIC_EXIT_CODE,
                                                   ELASTIC_REASON_CODES,
                                                   ElasticError,
                                                   ElasticWatchdog,
                                                   classify_elastic_failure,
                                                   recv_frame,
                                                   resolve_elastic_port,
                                                   send_frame)
from lightgbm_tpu_torch.robustness.faults import (FaultPlan,
                                                  maybe_rank_fault,
                                                  set_fault_plan)
from lightgbm_tpu_torch.utils.log import LightGBMError


@pytest.fixture(autouse=True)
def _clean_faults():
    set_fault_plan(None)
    yield
    set_fault_plan(None)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait(pred, timeout: float = 8.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _defuse(wd: ElasticWatchdog) -> ElasticWatchdog:
    """The unclean half of the abort is os._exit: never let a test's
    grace timer take the pytest process down."""
    wd._hard_abort = lambda: None
    return wd


def _pair(**kw):
    """A coordinator (rank 0) and one client (rank 1) on a free port,
    not started; timeouts for sub-second verdicts."""
    port = _free_port()
    defaults = dict(heartbeat_ms=20.0, heartbeat_timeout_ms=400.0,
                    stall_timeout_ms=60000.0, abort_grace_ms=60000.0)
    defaults.update(kw)
    coord = _defuse(ElasticWatchdog(0, 2, "127.0.0.1", port, **defaults))
    client = _defuse(ElasticWatchdog(1, 2, "127.0.0.1", port, **defaults))
    return coord, client


# -- framing -----------------------------------------------------------
def test_frame_roundtrip_and_locked_send():
    a, b = socket.socketpair()
    try:
        send_frame(a, {"type": "hb", "rank": 3, "iter": 7})
        assert recv_frame(b) == {"type": "hb", "rank": 3, "iter": 7}
        send_frame(a, {"type": "goodbye"}, threading.Lock())
        assert recv_frame(b) == {"type": "goodbye"}
    finally:
        a.close()
        b.close()


def test_frame_eof_oversize_and_garbage():
    a, b = socket.socketpair()
    a.close()
    assert recv_frame(b) is None  # EOF
    b.close()
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack(">I", el._FRAME_MAX + 1))
        assert recv_frame(b) is None  # oversize: hostile, not a frame
        a2, b2 = socket.socketpair()
        try:
            body = b"{not json"
            a2.sendall(struct.pack(">I", len(body)) + body)
            assert recv_frame(b2) is None
        finally:
            a2.close()
            b2.close()
    finally:
        a.close()
        b.close()


# -- structured error / port / taxonomy --------------------------------
def test_elastic_error_is_structured():
    e = ElasticError("peer_lost", 3, "rank 3 heartbeats stale")
    assert isinstance(e, LightGBMError)
    assert (e.reason_code, e.rank) == ("peer_lost", 3)
    assert "reason=peer_lost" in str(e) and "rank=3" in str(e)


def test_resolve_elastic_port():
    machines = [("10.0.0.1", 12400), ("10.0.0.2", 12400)]
    cfg = Config.from_params({"elastic_port": 7777})
    assert resolve_elastic_port(cfg, machines) == 7777
    cfg = Config.from_params({})
    assert resolve_elastic_port(cfg, machines) == \
        12400 + el.ELASTIC_PORT_OFFSET
    # the port's rule for groups without a machine list: a tcp://
    # rendezvous has a coordinator port; file:// has none (0: rank 0
    # publishes an ephemeral port through the group's store)
    assert resolve_elastic_port(cfg, [], "tcp://10.0.0.9:29500") == \
        29500 + el.ELASTIC_PORT_OFFSET
    assert el.resolve_elastic_host([], "tcp://10.0.0.9:29500") == "10.0.0.9"
    assert resolve_elastic_port(cfg, [], "file:///tmp/rdzv") == 0
    assert resolve_elastic_port(cfg, []) == 0
    assert el.resolve_elastic_host(machines) == "10.0.0.1"


def test_classify_elastic_failure():
    # the explicit reason= token (ELASTIC_ABORT lines) wins
    assert classify_elastic_failure(
        "ELASTIC_ABORT reason=collective_stall rank=0 iter=5 "
        "detail=no iteration boundary") == "collective_stall"
    # free-text evidence falls back to signatures
    assert classify_elastic_failure(
        "rank 1 heartbeats stale for 2.0s") == "peer_lost"
    assert classify_elastic_failure(
        "rank 1 never joined the heartbeat channel") == "peer_lost"
    assert classify_elastic_failure(
        "coordinator went quiet past 2.0s") == "coordinator_lost"
    assert classify_elastic_failure("") == "unknown"
    assert classify_elastic_failure("segfault somewhere") == "unknown"
    for code in ELASTIC_REASON_CODES:
        assert classify_elastic_failure(f"x reason={code} y") == code
    line = el.abort_line("peer_lost", 1, 4, "rank 1 heartbeat connection "
                         "closed without goodbye")
    assert line.startswith("ELASTIC_ABORT reason=peer_lost rank=1 iter=4")
    assert classify_elastic_failure(line) == "peer_lost"


# -- watchdog protocol -------------------------------------------------
def test_watchdog_clean_lifecycle():
    coord, client = _pair()
    try:
        coord.start()
        client.start()
        assert _wait(lambda: 1 in coord._conns)
        assert _wait(lambda: coord._last_seen.get(1) is not None)
        client.progress(4)
        client.stop()  # clean goodbye
        assert _wait(lambda: any(
            e["event"] == "peer_goodbye" for e in coord.timeline))
        coord.stop()
        assert coord.failure() is None
        assert client.failure() is None
        events = [e["event"] for e in coord.timeline]
        assert events[0] == "watchdog_start"
        assert "peer_hello" in events
    finally:
        client.stop()
        coord.stop()


def test_peer_lost_on_unannounced_death():
    coord, client = _pair()
    try:
        coord.start()
        client.start()
        assert _wait(lambda: 1 in coord._conns)
        client._sock.close()  # SIGKILL analog: EOF, no goodbye
        assert _wait(lambda: coord.failure() is not None)
        reason, rank, detail = coord.failure()
        assert (reason, rank) == ("peer_lost", 1)
        assert "without goodbye" in detail
        with pytest.raises(ElasticError) as ei:
            coord.check()
        assert ei.value.reason_code == "peer_lost"
        assert ei.value.rank == 1
    finally:
        client.stop()
        coord.stop()


def test_peer_lost_when_rank_never_joins():
    coord = _defuse(ElasticWatchdog(
        0, 2, "127.0.0.1", _free_port(), heartbeat_ms=20.0,
        heartbeat_timeout_ms=100.0, stall_timeout_ms=60000.0,
        abort_grace_ms=60000.0))
    try:
        coord.start()
        assert _wait(lambda: coord.failure() is not None)
        reason, rank, detail = coord.failure()
        assert (reason, rank) == ("peer_lost", 1)
        assert "never joined" in detail
    finally:
        coord.stop()


def test_coordinator_lost_on_connection_close():
    coord, client = _pair()
    try:
        coord.start()
        client.start()
        assert _wait(lambda: 1 in coord._conns)
        coord.stop(clean=False)  # the coordinator dies without a bye
        assert _wait(lambda: client.failure() is not None)
        reason, rank, _detail = client.failure()
        assert (reason, rank) == ("coordinator_lost", 0)
    finally:
        client.stop()
        coord.stop()


def test_coordinator_lost_on_silence():
    # a server that accepts and then says nothing: the client must tell
    # a live but mute peer from the keepalive-pinging coordinator
    port = _free_port()
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", port))
    srv.listen(1)
    client = _defuse(ElasticWatchdog(
        1, 2, "127.0.0.1", port, heartbeat_ms=20.0,
        heartbeat_timeout_ms=200.0, stall_timeout_ms=60000.0,
        abort_grace_ms=60000.0))
    conn = None
    try:
        client.start()
        srv.settimeout(5.0)
        conn, _addr = srv.accept()
        assert _wait(lambda: client.failure() is not None)
        reason, _rank, detail = client.failure()
        assert reason == "coordinator_lost"
        assert "quiet" in detail
    finally:
        client.stop()
        if conn is not None:
            conn.close()
        srv.close()


def test_abort_verdict_broadcast_reaches_clients():
    coord, client = _pair()
    try:
        coord.start()
        client.start()
        assert _wait(lambda: 1 in coord._conns)
        coord._fail("peer_lost", 7, "rank 7 heartbeats stale (test)")
        assert _wait(lambda: client.failure() is not None)
        reason, rank, detail = client.failure()
        assert (reason, rank) == ("peer_lost", 7)
        assert "coordinator broadcast" in detail
    finally:
        client.stop()
        coord.stop()


def test_collective_stall_detection():
    wd = _defuse(ElasticWatchdog(
        0, 1, "127.0.0.1", _free_port(), heartbeat_ms=20.0,
        heartbeat_timeout_ms=60000.0, stall_timeout_ms=100.0,
        abort_grace_ms=60000.0))
    try:
        wd.start()
        wd.progress(3)
        assert _wait(lambda: wd.failure() is not None)
        reason, rank, detail = wd.failure()
        assert (reason, rank) == ("collective_stall", 0)
        assert "no iteration boundary" in detail
        assert "at iteration 3" in detail
    finally:
        wd.stop()


def test_drop_heartbeat_fault_silences_sender():
    set_fault_plan("drop_heartbeat@rank=1")
    coord, client = _pair(heartbeat_ms=20.0, heartbeat_timeout_ms=300.0)
    try:
        coord.start()
        client.start()
        assert _wait(lambda: client._drop_heartbeats)
        assert any(e["event"] == "heartbeats_dropped"
                   for e in client.timeline)
        # the rank is alive (its socket is open), yet rank 0 must declare
        # peer_lost from the staleness alone
        assert _wait(lambda: coord.failure() is not None)
        reason, rank, detail = coord.failure()
        assert (reason, rank) == ("peer_lost", 1)
        assert "stale" in detail
    finally:
        client.stop()
        coord.stop()


# -- the port's own rules ------------------------------------------------
def test_ephemeral_port_published_through_the_store():
    """A group without a coordinator port (file://): rank 0 binds port 0
    and publishes host:port under the run's key; the client reads it."""
    import torch.distributed as tdist
    store = tdist.HashStore()
    cfg = Config.from_params({"elastic_heartbeat_ms": 20.0,
                              "elastic_heartbeat_timeout_ms": 400.0,
                              "elastic_abort_grace_ms": 60000.0})
    coord = _defuse(ElasticWatchdog.from_config(cfg, 0, 2, [],
                                                "file:///tmp/x", store))
    client = _defuse(ElasticWatchdog.from_config(cfg, 1, 2, [],
                                                 "file:///tmp/x", store))
    # the two ranks' n-th watchdogs share a key; here one process made
    # both, so the client reads the coordinator's
    client._store_key = coord._store_key
    assert coord.port == 0 and client.port == 0
    try:
        coord.start()
        assert coord.port > 0
        assert store.get(coord._store_key).decode() \
            == f"127.0.0.1:{coord.port}"
        client.start()
        assert client.port == coord.port
        assert _wait(lambda: 1 in coord._conns)
    finally:
        client.stop()
        coord.stop()
    assert coord.failure() is None and client.failure() is None


def test_raising_collective_takes_the_watchdog_verdict():
    """A collective that raises (gloo's "Connection closed by peer")
    becomes the watchdog's classified ElasticError; an error the channel
    did not see (no verdict within the heartbeat timeout) stays as it
    was."""
    coord, client = _pair(heartbeat_timeout_ms=300.0)
    try:
        coord.start()
        client.start()
        assert _wait(lambda: 1 in coord._conns)
        t0 = time.monotonic()
        assert coord.classify(RuntimeError("bad input")) is None
        assert time.monotonic() - t0 < 2.0
        client._sock.close()  # the peer dies
        err = coord.classify(RuntimeError("Connection closed by peer"))
        assert isinstance(err, ElasticError)
        assert (err.reason_code, err.rank) == ("peer_lost", 1)
        assert "Connection closed by peer" in err.detail
        assert coord._stopped
        assert any(e["event"] == "collective_raised"
                   for e in coord.timeline)
    finally:
        client.stop()
        coord.stop()


def test_watchdog_bounds():
    cfg = Config.from_params({"elastic_stall_timeout_ms": 3000.0,
                              "elastic_heartbeat_timeout_ms": 2000.0,
                              "elastic_abort_grace_ms": 500.0})
    assert el.watchdog_bounds_s(cfg) == 3.5
    assert el.watchdog_bounds_s(Config.from_params({})) == 125.0


# -- fault grammar rank kinds ------------------------------------------
def test_rank_fault_grammar_matching():
    plan = FaultPlan.parse("kill_rank@rank=1,iter=3;"
                           "stall_rank@rank=0,iter=2,ms=40;"
                           "drop_heartbeat@rank=1")
    assert plan.take("kill_rank", rank=0, iteration=3) is None
    assert plan.take("kill_rank", rank=1, iteration=2) is None
    ev = plan.take("kill_rank", rank=1, iteration=3)
    assert ev is not None
    assert plan.take("kill_rank", rank=1, iteration=3) is None  # once
    assert plan.take("drop_heartbeat", rank=0) is None
    assert plan.take("drop_heartbeat", rank=1) is not None


def test_stall_rank_fault_sleeps_training_thread():
    set_fault_plan("stall_rank@rank=0,iter=2,ms=60")
    t0 = time.monotonic()
    maybe_rank_fault(2, 0)
    assert time.monotonic() - t0 >= 0.055
    t0 = time.monotonic()
    maybe_rank_fault(2, 0)  # consumed: the second boundary is instant
    assert time.monotonic() - t0 < 0.05
    maybe_rank_fault(3, 1)  # a non-matching (rank, iter): no-op


# -- find_local_rank structured error ----------------------------------
def test_find_local_rank_absent_host_structured_error(monkeypatch):
    monkeypatch.delenv("LIGHTGBM_TPU_RANK", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    cfg = Config.from_params({"local_listen_port": 12345})
    machines = [("10.255.255.1", 12400), ("10.255.255.2", 12401)]
    with pytest.raises(LightGBMError) as ei:
        dist.find_local_rank(machines, cfg)
    msg = str(ei.value)
    assert "[0] 10.255.255.1:12400" in msg
    assert "[1] 10.255.255.2:12401" in msg
    assert "local addresses=" in msg and "127.0.0.1" in msg
    assert "local_listen_port=12345" in msg
    assert "LIGHTGBM_TPU_RANK" in msg


# -- config surface ----------------------------------------------------
def test_elastic_param_validation():
    with pytest.raises(ValueError):
        Config.from_params({"elastic_heartbeat_ms": 0})
    with pytest.raises(ValueError):
        Config.from_params({"elastic_port": 70000})
    with pytest.raises(ValueError):
        # the timeout must exceed the heartbeat interval
        Config.from_params({"elastic_heartbeat_ms": 500,
                            "elastic_heartbeat_timeout_ms": 500})
    cfg = Config.from_params({"elastic_hb_ms": 250})
    assert cfg.elastic_heartbeat_ms == 250
    cfg = Config.from_params({"reshard_resume": True})
    assert cfg.elastic_resume is True
    cfg = Config.from_params({"stall_timeout_ms": 9000})
    assert cfg.elastic_stall_timeout_ms == 9000


def test_fingerprint_ignores_elastic_and_topology_params():
    base = Config.from_params({"objective": "regression",
                               "verbosity": -1})
    tweaked = Config.from_params({
        "objective": "regression", "verbosity": -1,
        "elastic_heartbeat_ms": 77, "elastic_heartbeat_timeout_ms": 900,
        "elastic_resume": True, "elastic_port": 999,
        "elastic_watchdog": False, "elastic_barrier_s": 5,
        "local_listen_port": 12555})
    assert config_fingerprint(base) == config_fingerprint(tweaked)
    changed = Config.from_params({"objective": "regression",
                                  "verbosity": -1, "num_leaves": 50})
    assert config_fingerprint(base) != config_fingerprint(changed)


# -- coordinated checkpoints (one process, faked world) ----------------
def _data(n=300, f=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1]).astype(np.float32)
    return X, y


def _train(params, n_round, X, y):
    return lt.train(dict(params), lt.Dataset(X, label=y), n_round,
                    device="cpu")


def _params(ckpt_dir, **extra):
    p = {"objective": "regression", "num_leaves": 7, "verbosity": -1,
         "metric": "", "checkpoint_dir": str(ckpt_dir),
         "checkpoint_freq": 2}
    p.update(extra)
    return p


@pytest.fixture
def fake_world(monkeypatch):
    """Route the checkpoint manager through the coordinated protocol
    without a process group (rank 0 of a world of 1: the quorum is this
    process)."""
    make = CheckpointManager.from_config.__func__
    monkeypatch.setattr(CheckpointManager, "from_config", classmethod(
        lambda cls, cfg, world=None: make(cls, cfg, world=WorldInfo(0, 1))))


def test_coordinated_two_phase_layout(tmp_path, fake_world):
    X, y = _data()
    _train(_params(tmp_path / "ck"), 4, X, y)
    versions = sorted(p for p in (tmp_path / "ck").iterdir()
                      if p.name.startswith("ckpt_"))
    assert versions, "no coordinated checkpoint written"
    newest = versions[-1]
    names = {p.name for p in newest.iterdir()}
    assert "shard_00000.npz" in names
    assert "done_00000.json" in names  # the phase-1 fsync receipt
    assert "manifest.json" in names
    assert COMMIT_MARKER in names      # phase 2: the full-quorum marker
    assert "model.txt" in names
    manifest = json.loads((newest / "manifest.json").read_text())
    world = manifest["world"]
    assert world["size"] == 1
    assert "0" in world["data_fingerprints"]
    assert "shard_00000.npz" in manifest["files"]
    with np.load(newest / "shard_00000.npz") as z:
        # the score rows with their global range, the streams and bins
        assert list(z["train_score_ranges"][0]) == [0, len(y)]
        assert "tree_threshold_bin" in z.files
        assert "learner_row_order" in z.files
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.validate(str(newest)) is not None
    # a coordinated directory without its commit marker is torn
    (newest / COMMIT_MARKER).unlink()
    assert mgr.validate(str(newest)) is None


def test_coordinated_resume_bit_identical(tmp_path, fake_world):
    X, y = _data()
    # the same params (the model text holds them) for both runs: clean
    # first, then the interrupted and resumed pair in a fresh directory
    params = _params(tmp_path / "ck")
    clean = _train(params, 5, X, y)
    shutil.rmtree(tmp_path / "ck")
    _train(params, 2, X, y)            # interrupted at iteration 2
    resumed = _train(params, 5, X, y)  # resume=auto -> the world state
    assert resumed.resumed_iteration == 2
    assert resumed.model_to_string() == clean.model_to_string()


def test_torn_coordinated_checkpoint_pruned(tmp_path, fake_world):
    X, y = _data()
    _train(_params(tmp_path / "ck"), 4, X, y)  # versions at 2 and 4
    versions = sorted(p for p in (tmp_path / "ck").iterdir()
                      if p.name.startswith("ckpt_"))
    assert len(versions) == 2
    newest = versions[-1]
    (newest / COMMIT_MARKER).unlink()  # tear the newest write
    mgr = CheckpointManager(str(tmp_path / "ck"), world=WorldInfo(0, 1))
    found = mgr.latest_valid()
    assert found is not None
    path, manifest = found
    assert int(manifest["iteration"]) == 2  # fell back past the torn one
    assert not newest.exists(), \
        "a torn coordinated checkpoint must be pruned by rank 0"


def test_torn_checkpoint_kept_by_other_ranks(tmp_path, fake_world):
    """Pruning is rank 0's alone: rank 1 skips a torn version and
    leaves it."""
    X, y = _data()
    _train(_params(tmp_path / "ck"), 4, X, y)
    newest = sorted(p for p in (tmp_path / "ck").iterdir()
                    if p.name.startswith("ckpt_"))[-1]
    (newest / COMMIT_MARKER).unlink()
    mgr = CheckpointManager(str(tmp_path / "ck"), world=WorldInfo(1, 2))
    path, manifest = mgr.latest_valid()
    assert int(manifest["iteration"]) == 2 and newest.exists()


def test_world_mismatch_is_structured_error(tmp_path, fake_world):
    X, y = _data()
    params = _params(tmp_path / "ck")
    _train(params, 2, X, y)
    versions = sorted(p for p in (tmp_path / "ck").iterdir()
                      if p.name.startswith("ckpt_"))
    mpath = versions[-1] / "manifest.json"
    manifest = json.loads(mpath.read_text())
    # the manifest as if a 2-rank job on other machines wrote it
    manifest["world"]["size"] = 2
    manifest["world"]["machines"] = ["10.0.0.1:12400", "10.0.0.2:12400"]
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(LightGBMError) as ei:
        _train(params, 5, X, y)
    msg = str(ei.value)
    assert "world mismatch" in msg
    assert "2 rank(s)" in msg and "10.0.0.1:12400" in msg
    assert "elastic_resume" in msg
    # the explicit opt-in reshards instead (the reassembled raw scores)
    resumed = _train({**params, "elastic_resume": True}, 5, X, y)
    assert resumed.resumed_iteration == 2


def test_exit_code_constant_out_of_signal_range():
    # drills assert on rc 43; keep it clear of shell/signal encodings
    assert ELASTIC_EXIT_CODE == 43
    assert not (128 <= ELASTIC_EXIT_CODE <= 165)


def test_stop_interrupts_heartbeat_wait_and_joins_threads():
    # the sender and monitor loops wait on an event: stop() on a 30 s
    # heartbeat must not ride out the wait, and must join every thread
    coord, client = _pair(heartbeat_ms=30000.0,
                          heartbeat_timeout_ms=120000.0)
    try:
        coord.start()
        client.start()
        assert _wait(lambda: 1 in coord._conns)
        t0 = time.monotonic()
        client.stop()
        coord.stop()
        assert time.monotonic() - t0 < 5.0
        for wd in (coord, client):
            assert all(not t.is_alive() for t in wd._threads), \
                [t.name for t in wd._threads if t.is_alive()]
    finally:
        client.stop()
        coord.stop()
