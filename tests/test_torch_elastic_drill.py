"""The elastic drill of the port on the CPU: real rank processes in gloo
worlds (``torch_parallel_worker.py``'s ``elastic`` legs, a ``file://``
rendezvous under ``tmp_path``, each leg killed past 60 s), with the
watchdog's drill bounds (``DRILL_PARAMS``: heartbeats every 100 ms, a
2 s heartbeat timeout, a 3 s stall timeout, a 2 s abort grace) and a
coordinated checkpoint every iteration, on the data learner at 1023
bins (hist_rows and the scan on each rank's rows):

1. **reference**: 2 ranks, 6 iterations, undisturbed;
2. **kill**: ``kill_rank@rank=1,iter=3`` -- rank 1 SIGKILLs itself, and
   rank 0 exits with the elastic exit code 43 and a ``peer_lost``
   abort line, within the heartbeat timeout and the grace;
3. **resume**: 2 ranks again on the kill's checkpoints: the newest
   full-quorum version (iteration 3), then the model text (its trees)
   byte-equal to the reference's;
4. **shrink**: one process, ``elastic_resume=true``, on a copy of the
   kill's checkpoints: the 2 -> 1 reshard, byte-equal as well (the data
   learner's trees do not depend on the world's rows);
5. **guard**: the shrink without ``elastic_resume`` fails with the
   world-mismatch error.
"""

import os
import pickle
import shutil

import pytest

import torch_parallel_worker as W
from lightgbm_tpu_torch.robustness.elastic import (ELASTIC_EXIT_CODE,
                                                   classify_elastic_failure)


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("elastic_drill"))
    ck = os.path.join(out, "ck")
    legs = {"reference": W.spawn_leg(out, "reference", 2,
                                     os.path.join(out, "ck_ref")),
            "kill": W.spawn_leg(out, "kill", 2, ck)}
    for leg in ("shrink", "guard"):
        shutil.copytree(ck, os.path.join(out, f"ck_{leg}"))
    legs["resume"] = W.spawn_leg(out, "resume", 2, ck)
    for leg in ("shrink", "guard"):
        legs[leg] = W.spawn_leg(out, leg, 1, os.path.join(out, f"ck_{leg}"))

    def result(leg, rank):
        with open(os.path.join(out, f"{leg}.{rank}.pkl"), "rb") as fh:
            return pickle.load(fh)
    return legs, result


def test_reference_ranks_agree(drill):
    legs, result = drill
    codes, logs, _ = legs["reference"]
    assert codes == [0, 0], logs
    a, b = result("reference", 0), result("reference", 1)
    assert a["learner"] == "DataParallelTreeLearner"
    assert a["text"] == b["text"] and a["resumed"] is None
    assert a["text"].count("Tree=") == W.DRILL_ROUNDS


def test_kill_rank_gives_a_bounded_peer_lost_abort(drill):
    legs, _ = drill
    codes, logs, seconds = legs["kill"]
    assert codes[1] == -9, logs[1]          # SIGKILL: no goodbye
    assert codes[0] == ELASTIC_EXIT_CODE, logs[0]
    line = [ln for ln in logs[0].splitlines()
            if ln.startswith("ELASTIC_ABORT")]
    assert len(line) == 1, logs[0]
    assert "reason=peer_lost rank=1" in line[0]
    assert classify_elastic_failure(line[0]) == "peer_lost"
    # from rank 1's death to rank 0's exit: within the heartbeat timeout
    # and the grace window
    p = W.DRILL_PARAMS
    assert seconds < (p["elastic_heartbeat_timeout_ms"]
                      + p["elastic_abort_grace_ms"]) / 1000.0 + 2.0


def test_resume_is_byte_equal_to_the_reference(drill):
    legs, result = drill
    codes, logs, _ = legs["resume"]
    assert codes == [0, 0], logs
    ref = result("reference", 0)["text"]
    for r in range(2):
        res = result("resume", r)
        assert res["resumed"] == W.DRILL_KILL_ITER
        assert res["text"] == ref


def test_shrink_two_ranks_to_one_is_byte_equal(drill):
    legs, result = drill
    codes, logs, _ = legs["shrink"]
    assert codes == [0], logs
    res = result("shrink", 0)
    assert res["learner"] == "DataParallelTreeLearner"
    assert res["resumed"] == W.DRILL_KILL_ITER
    assert res["text"] == result("reference", 0)["text"]


def test_guard_refuses_the_shrink_without_elastic_resume(drill):
    legs, _ = drill
    codes, logs, _ = legs["guard"]
    assert codes[0] not in (0, ELASTIC_EXIT_CODE), logs
    assert "world mismatch" in logs[0]
    assert "2 rank(s)" in logs[0] and "elastic_resume=true" in logs[0]
