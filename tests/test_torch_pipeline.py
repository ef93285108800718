"""The port's continuous refit pipeline (``lightgbm_tpu_torch/pipeline/``)
on the CPU, against the JAX package's (``lightgbm_tpu/pipeline/``).

Without an engine: ``evaluate_stage`` over ``tests/test_pipeline.py``'s
ten synthetic stages (and an SLO burn stage) gives the JAX decision and
reasons, word for word; replay windows are bitwise the JAX package's
(clean, shifted, flipped once, ``peek_window``, regression), the drift
armed through each package's own fault plan; ``TailLogSource`` reads
what JAX's reads from one appended JSONL file; the stage gauge is one
labelled line on ``/metrics``.

With the engine, on ``tests/test_pipeline.py``'s base model (the JAX
package's 500 x 8 replay window, 7 leaves, 5 rounds, as text): a refit
candidate has JAX's trees with leaf values within 1e-5 (the
``tests/test_torch_refit.py`` tolerance), is byte-stable and is
checkpointed with keep-last-K pruning; a continue-mode candidate has
JAX's trees at the parity standard (structure exact, leaf values within
1e-5); tenant candidates of one ``train_many`` bucket are byte-equal to
the port's own ``lt.train`` twins on each tenant's rows and within the
parity standard of JAX's ``train_many`` (JAX's batch is not byte-equal
to its own twins: ROADMAP.md Queue 3), with JAX's report counts. A
3-cycle ``PipelineDriver`` run whose second training window has its
labels flipped gives JAX's statuses and reason codes (promoted, rolled
back on ``quality_drop``, promoted); a rejected publish never ramps; one
cycle runs over a process fleet of one CPU worker.
"""

import json
import os

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu import pipeline as jpipe
from lightgbm_tpu.pipeline import ramp as jramp
from lightgbm_tpu.robustness import faults as jfaults
from lightgbm_tpu_torch import pipeline as ppipe
from lightgbm_tpu_torch.observability.metrics import (get_metrics,
                                                      metrics_text)
from lightgbm_tpu_torch.pipeline import ramp as pramp
from lightgbm_tpu_torch.pipeline.trainer import (Candidate, RefitTrainer,
                                                 TenantRefitTrainer)
from lightgbm_tpu_torch.robustness import faults as pfaults

PARAMS = {"objective": "binary", "num_leaves": 7, "verbosity": -1}


def _plan(spec):
    """The same fault plan in both packages (each reads its own)."""
    jfaults.set_fault_plan(spec)
    pfaults.set_fault_plan(spec)


@pytest.fixture(autouse=True)
def _clean_faults():
    _plan(None)
    yield
    _plan(None)
    get_metrics().clear_gauge("pipeline_stage")


# ---- the promote/rollback decision: a pure function ---------------------

def _stage(mod, **over):
    m = mod.StageMetrics(stage=0, weight=0.25, requests=64,
                         canary_requests=16,
                         canary_p99_ms=12.0, baseline_p99_ms=11.0,
                         canary_quality=-0.05, baseline_quality=-0.06,
                         parity_mismatches=0, flightrec_trips=0,
                         errors=0, health_status="ok")
    for k, v in over.items():
        setattr(m, k, v)
    return m


# tests/test_pipeline.py:51-132's ten cases (and the SLO burn gate): each
# a list of (metrics overrides, thresholds, None for the defaults, or
# the stage replaced whole by StageMetrics(requests=8)), and the decisions
STAGE_CASES = {
    "clean": [({}, None, "advance")],
    "latency_regression": [
        ({"canary_p99_ms": 30.0, "baseline_p99_ms": 10.0},
         {"latency_regression_pct": 50.0}, "rollback")],
    "latency_under_floor": [
        ({"canary_p99_ms": 3.0, "baseline_p99_ms": 0.5},
         {"latency_regression_pct": 10.0, "latency_floor_ms": 5.0},
         "advance")],
    "quality_regression": [
        ({"canary_quality": -0.20, "baseline_quality": -0.05},
         {"quality_drop": 0.02}, "rollback"),
        ({"canary_quality": -0.06, "baseline_quality": -0.05},
         {"quality_drop": 0.02}, "advance")],
    "parity_mismatch": [({"parity_mismatches": 1}, None, "rollback")],
    "flight_recorder_trip": [({"flightrec_trips": 1}, None, "rollback")],
    "degraded_health": [
        ({"health_status": "degraded",
          "last_reload_error": {"code": "torn_model", "error": "x"}},
         None, "rollback"),
        ({"last_reload_error": {"code": "torn_model"}}, None, "rollback")],
    "error_rate": [({"errors": 3}, None, "rollback")],
    "missing_samples": [("bare", None, "advance")],
    "multiple_regressions": [
        ({"canary_p99_ms": 100.0, "baseline_p99_ms": 10.0,
          "canary_quality": -0.5, "parity_mismatches": 2},
         {"quality_drop": 0.01, "latency_regression_pct": 10.0},
         "rollback")],
    "slo_burn": [({"slo_burn": 20.0}, {"max_slo_burn": 14.4}, "rollback"),
                 ({"slo_burn": 20.0}, None, "advance")],
}


@pytest.mark.parametrize("case", list(STAGE_CASES))
def test_evaluate_stage_matches_jax(case):
    for over, th, want in STAGE_CASES[case]:
        verdicts = []
        for mod in (pramp, jramp):
            m = mod.StageMetrics(requests=8) if over == "bare" \
                else _stage(mod, **over)
            t = None if th is None else mod.RampThresholds(**th)
            verdicts.append(mod.evaluate_stage(m, t))
        port, ref = verdicts
        assert port.decision == ref.decision == want
        assert port.reasons == ref.reasons
        assert port.ok == (want == "advance")
    if case == "multiple_regressions":
        assert len(port.reasons) == 3


def test_ramp_thresholds_and_quality_match_jax():
    assert pramp.RampThresholds() == pramp.RampThresholds(
        **vars(jramp.RampThresholds()))
    rng = np.random.RandomState(5)
    pred, y = rng.rand(40, 1), (rng.rand(40) > 0.5).astype(float)
    assert pramp.default_quality(pred, y) == jramp.default_quality(pred, y)


# ---- replay and tail log sources ----------------------------------------

# (spec, seed, features, task, windows: rows each)
REPLAY_CASES = {
    "clean": (None, 9, 6, "binary", [64, 64, 64]),
    "shift_persists": ("drift@window=1,shift=2.0,feature=1", 0, 4,
                       "binary", [256, 256, 256]),
    "flip_once": ("drift@window=0,flip=1.0,once=1", 3, 4, "binary",
                  [128, 128]),
    "flip_half_regression": ("drift@window=1,flip=0.5,shift=-1.5,"
                             "feature=7", 4, 5, "regression",
                             [100, 50, 75]),
    "replaced": ("drift@window=1,shift=1.0;drift@window=2,flip=0.25",
                 2, 3, "binary", [32, 32, 32, 32]),
}


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_replay_windows_bitwise_jax(case):
    spec, seed, f, task, rows = REPLAY_CASES[case]
    _plan(spec)
    src = ppipe.ReplayLogSource(n_features=f, seed=seed, task=task)
    ref = jpipe.ReplayLogSource(n_features=f, seed=seed, task=task)
    for n in rows:
        assert src.next_index == ref.next_index
        a, b = src.next_window(n), ref.next_window(n)
        assert a.X.tobytes() == b.X.tobytes()
        assert a.y.tobytes() == b.y.tobytes()
        assert a.describe() == b.describe()
    # out of band: the same bytes as the in-band draw, clean or drifted
    for idx in range(len(rows)):
        for drifted in (False, True):
            a = src.peek_window(idx, 48, drifted=drifted)
            b = ref.peek_window(idx, 48, drifted=drifted)
            assert a.X.tobytes() == b.X.tobytes()
            assert a.y.tobytes() == b.y.tobytes()


def test_replay_drift_semantics():
    _plan("drift@window=0,flip=1.0,once=1")
    src = ppipe.ReplayLogSource(n_features=4, seed=3)
    poisoned = src.next_window(128)
    assert poisoned.drift and poisoned.drift["flip"] == 1.0
    assert src.next_window(128).drift is None      # once=1 disarmed
    clean = ppipe.ReplayLogSource(n_features=4, seed=3).peek_window(0, 128)
    np.testing.assert_array_equal(poisoned.y, 1.0 - clean.y)
    with pytest.raises(ValueError, match="binary or regression"):
        ppipe.ReplayLogSource(task="multiclass")


def test_tail_source_matches_jax(tmp_path):
    path = str(tmp_path / "serving_log.jsonl")
    lines = [json.dumps({"x": [float(i), 1.0 - i], "y": i % 2})
             for i in range(5)]
    lines += ["not json", json.dumps({"x": [9.0], "y": 1}),
              json.dumps({"x": [1.0, 2.0]})]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    srcs = [mod.TailLogSource(path, n_features=2, wait_s=0.2)
            for mod in (ppipe, jpipe)]

    def both(rows):
        a, b = (s.next_window(rows) for s in srcs)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.index == b.index and a.rows == b.rows
            assert a.X.tobytes() == b.X.tobytes()
            assert a.y.tobytes() == b.y.tobytes()
        return a

    w = both(3)
    np.testing.assert_array_equal(w.X[:, 0], [0.0, 1.0, 2.0])
    assert both(10).rows == 2                      # the partial remainder
    assert both(1) is None                         # drained
    with open(path, "a") as fh:                    # appended after a read
        for i in range(4):
            fh.write(json.dumps({"x": [10.0 + i, -1.0], "y": 1}) + "\n")
    assert both(4).rows == 4
    missing = ppipe.TailLogSource(str(tmp_path / "none.jsonl"), 2,
                                  wait_s=0.05)
    assert missing.next_window(4) is None


def test_stage_gauge_is_one_hot_labeled():
    get_metrics().reset()
    pramp.set_stage("refit")
    pramp.set_stage("canary_25")
    text = metrics_text()
    assert 'lgbm_pipeline_stage{stage="canary_25"} 1' in text
    assert 'stage="refit"' not in text
    assert len([ln for ln in text.splitlines()
                if ln.startswith("lgbm_pipeline_stage")]) == 1
    get_metrics().reset()


# ---- engine-backed: trainers against the JAX package's ------------------

@pytest.fixture(scope="module")
def base_model():
    """tests/test_pipeline.py:217-226's base model, as text."""
    w = jpipe.ReplayLogSource(n_features=8, seed=21).next_window(500)
    bst = lgb.train(dict(PARAMS), lgb.Dataset(w.X, label=w.y),
                    num_boost_round=5)
    return bst.model_to_string()


def _nodes(t):
    return (int(t.num_leaves), list(t.split_feature), list(t.threshold),
            list(t.decision_type), list(t.left_child), list(t.right_child))


def _models(port_text, jax_text):
    pm = lt.Booster(model_str=port_text, device="cpu").models
    jm = lgb.Booster(model_str=jax_text)._loaded.models
    assert len(pm) == len(jm)
    return pm, jm


def _parity(port_text, jax_text):
    """Structure exact, leaf values within 1e-5."""
    pm, jm = _models(port_text, jax_text)
    for a, b in zip(pm, jm):
        assert _nodes(a) == _nodes(b)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-5)
    return len(pm)


def _split(t, s):
    return (int(t.split_feature[s]), float(t.threshold[s]),
            int(t.decision_type[s]))


def parity_to_first_tie(port_text, jax_text):
    """The parity standard up to the first split where the packages
    part at a float32 tie: there both chosen gains agree within 1e-5 of
    the tree's root gain (two candidates the float32 and float64 sums
    order differently), or the one package's extra split gains at most
    that much (a noise-floor split, ROADMAP.md Queue 3). Later trees
    grow from other scores and are not compared. Returns the trees equal
    whole and the (tree, node) of the tie, or None."""
    pm, jm = _models(port_text, jax_text)
    for i, (a, b) in enumerate(zip(pm, jm)):
        tol = 1e-5 * float(np.abs(b.split_gain).max(initial=0.0))
        n = min(a.num_leaves, b.num_leaves) - 1
        s = next((s for s in range(n) if _split(a, s) != _split(b, s)),
                 None)
        if s is not None:
            assert abs(float(a.split_gain[s]) - float(b.split_gain[s])) \
                <= tol, (i, s)
            return i, (i, s)
        if a.num_leaves != b.num_leaves:
            extra = b if b.num_leaves > a.num_leaves else a
            assert np.all(np.abs(extra.split_gain[n:]) <= tol), (i, n)
            return i, (i, n)
        assert _nodes(a) == _nodes(b)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-5)
    return len(pm), None


def test_refit_candidate_matches_jax(base_model, tmp_path):
    win = ppipe.ReplayLogSource(n_features=8, seed=21).next_window(256)
    jwin = jpipe.ReplayLogSource(n_features=8, seed=21).next_window(256)
    t1 = RefitTrainer(base_model, mode="refit", decay=0.3,
                      checkpoint_dir=str(tmp_path / "cands"), device="cpu")
    t2 = RefitTrainer(base_model, mode="refit", decay=0.3, device="cpu")
    c1, c2 = t1.refit(win), t2.refit(win)
    assert c1.model_text == c2.model_text          # byte-stable
    assert c1.mode == "refit" and c1.window_index == 0
    assert c1.checkpoint_path and os.path.exists(
        os.path.join(c1.checkpoint_path, "manifest.json"))
    ref = jpipe.RefitTrainer(base_model, mode="refit", decay=0.3).refit(jwin)
    assert _parity(c1.model_text, ref.model_text) == 5
    # the leaves moved: the refit is not the base model
    assert c1.model_text != lt.Booster(model_str=base_model,
                                       device="cpu").model_to_string()


def test_candidate_checkpoints_keep_last_k(base_model, tmp_path):
    ck = str(tmp_path / "cands")
    src = ppipe.ReplayLogSource(n_features=8, seed=21)
    tr = RefitTrainer(base_model, mode="refit", decay=0.5,
                      checkpoint_dir=ck, checkpoint_keep=2, device="cpu")
    cands = [tr.refit(src.next_window(128)) for _ in range(3)]
    assert sorted(os.listdir(ck)) == ["cand_00002", "cand_00003"]
    # the text-backed branch: the model text alone, atomically written
    bare = Candidate(7, cands[0].model_text, "multiboost", 0)
    ppipe.trainer.checkpoint_candidate(bare, ck, 2)
    with open(os.path.join(bare.checkpoint_path, "model.txt")) as fh:
        assert fh.read() == cands[0].model_text
    assert sorted(os.listdir(ck)) == ["cand_00003", "cand_00007"]


def test_continue_candidate_matches_jax(base_model):
    win = ppipe.ReplayLogSource(n_features=8, seed=22).next_window(256)
    jwin = jpipe.ReplayLogSource(n_features=8, seed=22).next_window(256)
    params = dict(PARAMS, task="pipeline", pipeline_mode="continue",
                  serving_replicas=2, input_model="x")
    cand = RefitTrainer(base_model, params=params, mode="continue",
                        continue_iters=3, device="cpu").refit(win)
    ref = jpipe.RefitTrainer(base_model, params=params, mode="continue",
                             continue_iters=3).refit(jwin)
    assert _parity(cand.model_text, ref.model_text) == 8
    with pytest.raises(ValueError, match="pipeline_mode"):
        RefitTrainer(base_model, mode="retrain")


TENANTS = ["acme", "globex", "initech", "umbrella"]


def test_tenant_candidates_equal_their_twins_and_jax(base_model, tmp_path):
    win = ppipe.ReplayLogSource(n_features=8, seed=23).next_window(600)
    params = dict(PARAMS, task="pipeline", pipeline_tenants="x")
    tr = TenantRefitTrainer(TENANTS, params=params, num_boost_round=3,
                            checkpoint_dir=str(tmp_path / "t"),
                            device="cpu")
    cands = tr.refit_all(win)
    jtr = jpipe.trainer.TenantRefitTrainer(TENANTS, params=params,
                                           num_boost_round=3)
    jcands = jtr.refit_all(win)
    rep, jrep = tr.last_report, jtr.last_report
    assert rep["batched_models"] == jrep["batched_models"] == 4
    assert len(rep["buckets"]) == len(jrep["buckets"]) == 1
    assert len(rep["loop_fallback"]) == len(jrep["loop_fallback"]) == 0
    parts = tr.partition(win.rows)
    ties = {}
    for t in TENANTS:
        p = tr.tenant_params(t)
        assert p["bagging_seed"] == jtr.tenant_seed(t)
        assert "task" not in p and "pipeline_tenants" not in p
        twin = lt.train(dict(p), lt.Dataset(win.X, label=win.y).subset(
            parts[t]), 3, device="cpu")
        assert cands[t].model_text == twin.model_to_string()
        assert cands[t].checkpoint_path is not None
        ties[t] = parity_to_first_tie(cands[t].model_text,
                                       jcands[t].model_text)
    # 150 rows a tenant, 3 informative features of 8: past the fourth
    # split the gains are at the noise floor, where the float32 (JAX)
    # and float64 (port) sums rank candidates differently (ROADMAP.md
    # Queue 3); JAX's own batch parts from its twins at such nodes too
    assert ties == {"acme": (0, (0, 3)), "globex": (0, (0, 3)),
                    "initech": (3, None), "umbrella": (3, None)}


# ---- the driver: 3 cycles, the second poisoned --------------------------

def _driver_params(path, workdir, **over):
    p = {"task": "pipeline", "input_model": path, "verbosity": -1,
         "pipeline_window_rows": 192, "pipeline_holdout_rows": 96,
         "pipeline_stage_requests": 8, "pipeline_latency_slo_pct": 1000,
         "pipeline_dir": os.path.join(workdir, "cands"),
         "pipeline_replay_seed": 21, "serving_buckets": "1,64,512"}
    p.update(over)
    return p


def _codes(rec):
    return (rec["status"], [r.split(":")[0] for r in
                            (rec.get("reason") or "").split("; ") if r],
            [(s["decision"], [r.split(":")[0] for r in s["reasons"]])
             for s in rec.get("stages", [])])


@pytest.fixture(scope="module")
def base_file(base_model, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pipe") / "base.txt")
    with open(path, "w") as fh:
        fh.write(base_model)
    return path


@pytest.fixture(scope="module")
def jax_three_cycles(base_file, tmp_path_factory):
    jfaults.set_fault_plan("drift@window=2,flip=1,once=1")
    try:
        drv = jpipe.PipelineDriver(_driver_params(
            base_file, str(tmp_path_factory.mktemp("jax"))))
        return drv.run(max_cycles=3)
    finally:
        jfaults.set_fault_plan(None)


def test_three_cycles_match_jax(base_file, jax_three_cycles, tmp_path):
    _plan("drift@window=2,flip=1,once=1")
    drv = ppipe.PipelineDriver(_driver_params(
        base_file, str(tmp_path), device_type="cpu"))
    assert drv.device.type == "cpu"
    summary = drv.run(max_cycles=3)
    ref = jax_three_cycles
    got = [_codes(r) for r in summary["history"]]
    assert got == [_codes(r) for r in ref["history"]]
    assert [g[0] for g in got] == ["promoted", "rolled_back", "promoted"]
    assert got[1][1] == ["quality_drop"]
    for key in ("cycles", "promoted", "rolled_back", "preempted"):
        assert summary[key] == ref[key], key
    assert summary["primary"] == ref["primary"] == "default.cand00003"
    assert summary["history"][1]["window"]["drift"]["flip"] == 1.0
    assert sorted(os.listdir(os.path.join(str(tmp_path), "cands"))) == [
        "cand_00001", "cand_00002", "cand_00003"]


def test_rejected_publish_never_ramps(base_model):
    fleet = lt.FleetEngine(
        models={"default": base_model},
        config=lt.ServingConfig(buckets=(1, 64, 512),
                                flush_interval_ms=0.5),
        replicas=1, device="cpu")
    try:
        pub = ppipe.Publisher(fleet, model="default")
        cand = Candidate(1, base_model[: len(base_model) // 2], "refit", 0)
        assert pub.publish(cand) is None
        assert cand.status == "rejected"
        assert "publish_failed" in cand.reason
        h = fleet.health()
        assert h["status"] == "degraded"
        assert h["last_reload_error"]["model"] == "default.cand00001"
        ramp = ppipe.RampController(pub, stages=[0.5], stage_requests=4)
        hold = ppipe.ReplayLogSource(n_features=8, seed=21).next_window(64)
        assert not ramp.ramp(cand, (hold.X, hold.y))
        assert cand.status == "rolled_back"
        assert (fleet.router.describe().get("default") or {}).get(
            "canary") is None
        good = RefitTrainer(base_model, mode="refit", decay=0.5,
                            device="cpu").refit(hold)
        assert pub.publish(good) == "default.cand00001"
        assert fleet.health()["status"] == "ok"
        with pytest.raises(ValueError, match="in \\(0, 1\\]"):
            ppipe.RampController(pub, stages=[1.5])
    finally:
        fleet.stop()


def test_one_cycle_over_a_process_fleet(base_file, tmp_path):
    drv = ppipe.PipelineDriver(_driver_params(
        base_file, str(tmp_path), device_type="cpu",
        pipeline_canary_stages="0.5", serving_isolation="process",
        serving_replicas=1, replica_spawn_timeout_s=90,
        serving_timeout_ms=30000))
    try:
        assert drv.fleet.isolation == "process"
        summary = drv.run(max_cycles=1, stop_fleet=False)
        rec = summary["history"][0]
        assert rec["status"] == "promoted", rec
        assert rec["stages"][0]["decision"] == "advance"
        hold = ppipe.ReplayLogSource(n_features=8, seed=21).peek_window(
            1, 16)
        served = np.asarray(drv.fleet.predict(hold.X))
        cand = drv.publisher.history[0]
        direct = lt.Booster(model_str=cand.model_text,
                            device="cpu").predict(hold.X)
        assert served.tobytes() == np.asarray(direct).tobytes()
    finally:
        drv.stop()
        drv.fleet._proc_supervisor.reap()
