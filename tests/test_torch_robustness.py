"""The port's robustness plane (``lightgbm_tpu_torch/robustness/``)
against the JAX package's (``lightgbm_tpu/robustness/``) on the CPU.

Held against JAX: the fault grammar (``FaultPlan.parse(spec).pending()``,
the same strings), ``backoff_delays`` (the same floats),
``LossSpikeDetector`` (the same spikes on the same eval sequences),
``config_fingerprint`` (the same digest once ``device_type``, the one
parameter whose default differs, agrees), either package's
``CheckpointManager.validate`` on the other's directory, the
``skip_iter`` guard's model, and the resumed models of the options whose
JAX resume is sound (none, bagging, ``feature_fraction``) at the parity
standard (structure exact, leaf values within 1e-5, ties asserted).

The port's own contract, stricter than JAX's: a checkpointed run's trees
are byte-equal to the same run without checkpoints, and a resume (by
``sigterm`` or by ``nan_grad`` rolled back) is byte-equal to the
uninterrupted checkpointed run for every option in ``RESUME_OPTIONS``.
Every test resets the fault plan, the telemetry and the tracer of both
packages; a test that delivers a signal runs under a watchdog
(``faulthandler.dump_traceback_later``).
"""

import faulthandler
import json
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.robustness import checkpoint as jck
from lightgbm_tpu.robustness import faults as jfaults
from lightgbm_tpu.robustness import guards as jguards
from lightgbm_tpu.robustness import retry as jretry
from lightgbm_tpu_torch.robustness import checkpoint as ck
from lightgbm_tpu_torch.robustness import faults as faults
from lightgbm_tpu_torch.robustness import guards as guards
from lightgbm_tpu_torch.robustness import retry as retry
from torch_efb_data import compare_trees

torch.set_num_threads(2)

ROUNDS = 6
BASE = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
        "min_data_in_leaf": 10}
# a test that waits on a signal gives up after this many seconds
WATCHDOG_S = 120


@pytest.fixture(autouse=True)
def _clean_planes():
    """No fault plan, telemetry or tracer state leaks between tests (of
    either package)."""
    from lightgbm_tpu.observability.telemetry import get_telemetry as jtel
    from lightgbm_tpu.observability.tracing import get_tracer as jtr
    from lightgbm_tpu_torch.observability.telemetry import get_telemetry
    from lightgbm_tpu_torch.observability.tracing import get_tracer

    def reset():
        for mod in (faults, jfaults):
            mod.set_fault_plan(None)
        get_telemetry().reset()
        get_tracer().reset()
        jtel().reset()
        jtr().reset()
    reset()
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()
    reset()


def _data(n=1200, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.4 * rng.randn(n) > 0).astype(float)
    return X, y


def _trees(bst) -> str:
    """The model text up to ``parameters:`` (which records the plane
    params)."""
    return bst.model_to_string().split("parameters:")[0]


# ---------------------------------------------------------------------
SPECS = [
    "nan_grad@iteration=3",
    "nan_grad@iter=2,value=inf;sigterm@iteration=5",
    "torn_checkpoint@nth=2\nfail_read@times=3,match=manifest",
    "kill_rank@rank=1,iter=4; stall_rank@rank=0,iter=2,ms=50",
    "drop_heartbeat@rank=1;drift@window=3,shift=0.5,once=1",
    "crash_replica@rid=2,signal=9;hang_replica@rid=0,ms=300;oom_replica@rid=1",
    "bogus@x=1;sigterm",
    "",
]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_grammar_matches_jax(spec):
    port, ref = faults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    assert port.pending() == ref.pending()
    assert [(e.kind, e.params) for e in port.events] \
        == [(e.kind, e.params) for e in ref.events]
    assert faults._KNOWN_KINDS == jfaults._KNOWN_KINDS


def test_fault_plan_take_consumes_like_jax(monkeypatch):
    spec = "fail_read@times=2,match=abc;nan_grad@iteration=1"
    port, ref = faults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    calls = [("fail_read", {"path": "x/abc"}), ("fail_read", {"path": "q"}),
             ("nan_grad", {"iteration": 0}), ("fail_read", {"path": "abc"}),
             ("nan_grad", {"iteration": 1}), ("fail_read", {"path": "abc"}),
             ("nan_grad", {"iteration": 1})]
    got = [(port.take(k, **c) is None, ref.take(k, **c) is None)
           for k, c in calls]
    assert all(a == b for a, b in got)
    assert port.pending() == ref.pending() == []
    # the env variable, parsed once while it is unchanged
    monkeypatch.setenv("LGBM_TPU_FAULTS", "nan_grad@iteration=7")
    plan = faults.get_fault_plan()
    assert plan is faults.get_fault_plan() and faults.fault_plan_active()
    assert plan.pending() == jfaults.get_fault_plan().pending()


@pytest.mark.parametrize("attempts,base,cap,desc", [
    (5, 0.1, 5.0, "checkpoint manifest /x"), (3, 0.05, 0.08, ""),
    (8, 1.0, 4.0, "torch.distributed init"), (1, 0.1, 1.0, "one")])
def test_backoff_delays_match_jax(attempts, base, cap, desc):
    port = list(retry.backoff_delays(attempts, base, cap, desc=desc))
    ref = list(jretry.backoff_delays(attempts, base, cap, desc=desc))
    assert port == ref and len(port) == max(attempts - 1, 0)


def test_retry_call_counts_and_gives_up():
    slept = []
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("blip")
        return "ok"
    assert retry.retry_call(flaky, attempts=3, sleep=slept.append,
                            desc="flaky") == "ok"
    assert slept == list(jretry.backoff_delays(3, 0.1, 5.0, desc="flaky"))

    def dead():
        raise OSError("down")
    with pytest.raises(OSError, match="down"):
        retry.retry_call(dead, attempts=2, sleep=lambda s: None)


def test_atomic_writes(tmp_path):
    p = str(tmp_path / "sub" / "f.bin")
    ck.atomic_write_bytes(p, b"one")
    ck.atomic_write_text(p, "two")
    assert open(p).read() == "two"
    assert os.listdir(tmp_path / "sub") == ["f.bin"]   # no temp left

    with pytest.raises(TypeError):
        ck.atomic_write_bytes(p, 3)   # a failed write keeps the old file
    assert open(p).read() == "two"
    assert os.listdir(tmp_path / "sub") == ["f.bin"]


# ---------------------------------------------------------------------
def _ckpt_params(d, **kw):
    return dict(BASE, checkpoint_dir=str(d), checkpoint_freq=1, **kw)


def test_retention_keeps_the_last_k(tmp_path):
    X, y = _data()
    lt.train(_ckpt_params(tmp_path, checkpoint_keep=2), lt.Dataset(X, label=y),
             ROUNDS, device="cpu")
    assert sorted(os.listdir(tmp_path)) == [
        f"ckpt_{ROUNDS - 1:08d}", f"ckpt_{ROUNDS:08d}"]
    m = json.load(open(tmp_path / f"ckpt_{ROUNDS:08d}" / "manifest.json"))
    assert m["format"] == ck.CKPT_FORMAT == jck.CKPT_FORMAT
    assert set(m) == {"format", "iteration", "begin_iteration",
                      "num_models", "num_tree_per_iteration",
                      "num_valid_sets", "shrinkage_rate", "score_cache",
                      "config_fingerprint", "data_fingerprint",
                      "eval_history", "files"}
    assert set(m["files"]) == {"model.txt", "state.npz"}


@pytest.mark.parametrize("how", ["torn", "corrupt"])
def test_torn_or_corrupt_checkpoint_falls_back(tmp_path, how):
    X, y = _data()
    ref = lt.train(BASE, lt.Dataset(X, label=y), ROUNDS, device="cpu")
    p = _ckpt_params(tmp_path, checkpoint_keep=5)
    if how == "torn":
        # the 3rd write (iteration 3) is torn after its digests
        p["faults"] = "torn_checkpoint@nth=3"
    lt.train(dict(p), lt.Dataset(X, label=y), 3, device="cpu")
    faults.set_fault_plan(None)
    if how == "corrupt":
        with open(tmp_path / "ckpt_00000003" / "model.txt", "r+b") as fh:
            fh.seek(40)
            fh.write(b"#")
    mgr = ck.CheckpointManager(str(tmp_path))
    assert mgr.validate(str(tmp_path / "ckpt_00000003")) is None
    assert mgr.latest_valid()[0].endswith("ckpt_00000002")
    bst = lt.train(dict(p, faults=""), lt.Dataset(X, label=y), ROUNDS,
                   device="cpu")
    assert bst.resumed_iteration == 2
    assert _trees(bst) == _trees(ref)


def test_param_change_ignores_the_checkpoint(tmp_path):
    X, y = _data()
    lt.train(_ckpt_params(tmp_path), lt.Dataset(X, label=y), 3,
             device="cpu")
    other = dict(_ckpt_params(tmp_path), num_leaves=5)
    bst = lt.train(other, lt.Dataset(X, label=y), ROUNDS, device="cpu")
    fresh = lt.train(dict(BASE, num_leaves=5), lt.Dataset(X, label=y),
                     ROUNDS, device="cpu")
    assert bst.resumed_iteration is None
    assert _trees(bst) == _trees(fresh)


def test_resume_off_starts_fresh(tmp_path):
    X, y = _data()
    lt.train(_ckpt_params(tmp_path), lt.Dataset(X, label=y), 3,
             device="cpu")
    bst = lt.train(_ckpt_params(tmp_path, resume="off"),
                   lt.Dataset(X, label=y), ROUNDS, device="cpu")
    assert bst.resumed_iteration is None and len(bst.models) == ROUNDS


def test_fail_read_is_recovered_by_retry(tmp_path):
    from lightgbm_tpu_torch.observability.telemetry import get_telemetry
    X, y = _data()
    lt.train(_ckpt_params(tmp_path), lt.Dataset(X, label=y), 3,
             device="cpu")
    get_telemetry().ensure_ring()
    faults.set_fault_plan("fail_read@times=2,match=manifest")
    bst = lt.train(_ckpt_params(tmp_path), lt.Dataset(X, label=y),
                   ROUNDS, device="cpu")
    assert bst.resumed_iteration == 3
    c = get_telemetry().counters
    assert c["retry.retries"] == 2 and c["faults.fail_read"] == 2
    assert "retry.giveups" not in c


def test_multi_rank_checkpoint_is_refused(tmp_path, monkeypatch):
    """Refused until Queue 1 item 11.2 brought the coordinated
    checkpoint; what stays refused is a checkpoint from rank 0 alone.
    As rank 0 of 2 whose peer never writes its shard, every version
    waits ``elastic_barrier_s`` for rank 1's receipt and is abandoned:
    no checkpoint is ever committed, and training goes on to the same
    trees."""
    from lightgbm_tpu_torch.parallel.distributed import WorldInfo
    X, y = _data()
    ref = lt.train(dict(BASE), lt.Dataset(X, label=y), 3, device="cpu")
    make = ck.CheckpointManager.from_config.__func__
    monkeypatch.setattr(ck.CheckpointManager, "from_config", classmethod(
        lambda cls, cfg, world=None: make(cls, cfg, world=WorldInfo(0, 2))))
    bst = lt.train(_ckpt_params(tmp_path, elastic_barrier_s=0.2),
                   lt.Dataset(X, label=y), 3, device="cpu")
    assert not [f for f in os.listdir(tmp_path) if f.startswith("ckpt_")]
    tmp = sorted(f for f in os.listdir(tmp_path) if f.startswith(".tmp_"))
    assert len(tmp) == 3, tmp   # every version's rank-0 half, uncommitted
    assert sorted(os.listdir(tmp_path / tmp[0])) == [
        "done_00000.json", "model.txt", "shard_00000.npz"]
    assert ck.CheckpointManager(str(tmp_path)).restore_latest(bst) is None
    trees = lambda b: b.model_to_string().split(  # noqa: E731
        "parameters:")[0]
    assert trees(bst) == trees(ref)


# ---------------------------------------------------------------------
def test_guard_raise(tmp_path):
    X, y = _data()
    with pytest.raises(guards.NonFiniteGradientError) as err:
        lt.train(dict(BASE, guard_policy="raise",
                      faults="nan_grad@iteration=2"),
                 lt.Dataset(X, label=y), ROUNDS, device="cpu")
    assert err.value.iteration == 2 and err.value.policy == "raise"


def test_guard_skip_iter_matches_jax():
    X, y = _data()
    p = dict(BASE, guard_policy="skip_iter",
             faults="nan_grad@iteration=2,value=inf")
    port = lt.train(p, lt.Dataset(X, label=y), ROUNDS, device="cpu")
    ref = lgb.train(p, lgb.Dataset(X, label=y), ROUNDS,
                    verbose_eval=False)
    assert port.models[2].num_leaves == 1 == ref._gbdt.models[2].num_leaves
    assert port.models[2].leaf_value[0] == 0.0
    compare_trees(port.models, ref._gbdt.models)


def test_rollback_without_checkpoint_skips_the_iteration():
    X, y = _data()
    bst = lt.train(dict(BASE, guard_policy="rollback",
                        faults="nan_grad@iteration=1"),
                   lt.Dataset(X, label=y), ROUNDS, device="cpu")
    assert len(bst.models) == ROUNDS and bst.models[1].num_leaves == 1


def test_rollbacks_past_the_bound_are_fatal(tmp_path):
    X, y = _data()
    with pytest.raises(guards.NonFiniteGradientError):
        lt.train(_ckpt_params(tmp_path, guard_policy="rollback",
                              guard_max_rollbacks=1,
                              faults="nan_grad@iteration=3,times=2"),
                 lt.Dataset(X, label=y), ROUNDS, device="cpu")


SPIKE_SEQS = [
    [[("v", "l2", 1.0, False)], [("v", "l2", 0.9, False)],
     [("v", "l2", 9.5, False)], [("v", "l2", 0.8, False)]],
    [[("v", "auc", 0.7, True), ("v", "logloss", 0.6, False)],
     [("v", "auc", 0.1, True), ("v", "logloss", float("nan"), False)],
     [("v", "logloss", 0.5, False), ("t", "logloss", 5.0, False)],
     [("v", "logloss", 0.4, False), ("t", "logloss", 60.0, False)]],
    [[("v", "l1", 0.0, False)], [("v", "l1", 1e-40, False)],
     [("v", "l1", float("inf"), False)], [("v", "l1", 3.0, False)]],
]


@pytest.mark.parametrize("factor", [0.5, 2.0, 10.0])
@pytest.mark.parametrize("seq", range(len(SPIKE_SEQS)))
def test_loss_spike_detector_matches_jax(seq, factor):
    port = guards.LossSpikeDetector(factor)
    ref = jguards.LossSpikeDetector(factor)
    assert port.enabled == ref.enabled
    for i, results in enumerate(SPIKE_SEQS[seq]):
        a, b = port.check(i, results), ref.check(i, results)
        assert (a is None) == (b is None)
        if a is not None:
            assert a[:2] == b[:2]
            np.testing.assert_equal(np.asarray(a[2:], float),
                                    np.asarray(b[2:], float))


def test_loss_spike_raise_in_training(tmp_path):
    X, y = _data()
    Xv, yv = _data(400, seed=1)
    yv[:] = 1.0 - yv          # a valid set the model gets worse on
    ds = lt.Dataset(X, label=y)
    with pytest.raises(guards.LossSpikeError):
        lt.train(dict(BASE, guard_policy="raise", guard_loss_spike=1.01,
                      metric="binary_logloss"), ds, ROUNDS,
                 valid_sets=[ds.create_valid(Xv, label=yv)],
                 verbose_eval=False, device="cpu")


@pytest.mark.parametrize("extra", [{}, {"objective": "multiclass",
                                        "num_class": 3, "max_bin": 63,
                                        "bagging_fraction": 0.5}])
def test_config_fingerprint_matches_jax(extra):
    params = dict(BASE, **extra)
    port = lt.Config.from_params(params)
    ref = lgb.Config.from_params(params)
    pp, rp = port.to_params(), ref.to_params()
    assert set(pp) == set(rp)
    assert {k for k in pp if pp[k] != rp[k]} == {"device_type"}
    assert ck.config_fingerprint(port) != jck.config_fingerprint(ref)
    ref.device_type = port.device_type
    assert ck.config_fingerprint(port) == jck.config_fingerprint(ref)
    assert ck._FINGERPRINT_EXCLUDE == jck._FINGERPRINT_EXCLUDE


def test_each_package_validates_the_others_checkpoint(tmp_path):
    X, y = _data()
    p = dict(BASE, checkpoint_freq=2)
    lt.train(dict(p, checkpoint_dir=str(tmp_path / "port")),
             lt.Dataset(X, label=y), 4, device="cpu")
    lgb.train(dict(p, checkpoint_dir=str(tmp_path / "jax")),
              lgb.Dataset(X, label=y), 4, verbose_eval=False)
    for d in ("port", "jax"):
        path = str(tmp_path / d / "ckpt_00000004")
        pm = ck.CheckpointManager(str(tmp_path / d)).validate(path)
        jm = jck.CheckpointManager(str(tmp_path / d)).validate(path)
        assert pm is not None and jm is not None and pm == jm
        assert pm["iteration"] == 4 and pm["num_models"] == 4


def test_checkpointed_run_equals_the_run_without(tmp_path):
    X, y = _data()
    ds = lambda: lt.Dataset(X, label=y)   # noqa: E731
    plain = lt.train(BASE, ds(), ROUNDS, device="cpu")
    planes = lt.train(_ckpt_params(tmp_path, guard_policy="raise",
                                   guard_loss_spike=10.0), ds(), ROUNDS,
                      device="cpu")
    assert _trees(planes) == _trees(plain)
    assert planes.model_to_string() != plain.model_to_string()


# ---------------------------------------------------------------------
# every option whose host streams a resume must continue
RESUME_OPTIONS = {
    "none": {},
    # resumed between two draws: the sigterm drill preempts after
    # iteration 3 (checkpoint 4), the rollback restores checkpoint 2
    "bagging": {"bagging_fraction": 0.7, "bagging_freq": 3},
    "feature_fraction": {"feature_fraction": 0.6},
    "extra_trees": {"extra_trees": True},
    "bynode": {"feature_fraction_bynode": 0.5},
    "dart": {"boosting": "dart", "drop_rate": 0.3},
    "goss": {"boosting": "goss", "learning_rate": 0.5, "top_rate": 0.3,
             "other_rate": 0.2},
    "multiclass": {"objective": "multiclass", "num_class": 3},
    "rank_xendcg": {"objective": "rank_xendcg"},
    "valid_early_stopping": {},
}
DRILLS = {"sigterm": "sigterm@iteration=3",
          "rollback": "nan_grad@iteration=3"}


def _resume_sets(option):
    X, y = _data(n=1000)
    if option == "multiclass":
        y = np.digitize(X[:, 0] + X[:, 2], [-0.6, 0.6]).astype(float)
    group = None
    if option == "rank_xendcg":
        y = np.clip(np.round(X[:, 0] + 1.5), 0, 3)
        group = [20] * 50
    tr = lt.Dataset(X, label=y, group=group)
    if option != "valid_early_stopping":
        return tr, {}
    Xv, yv = _data(300, seed=2)
    return tr, dict(valid_sets=[tr.create_valid(Xv, label=yv)],
                    early_stopping_rounds=2, verbose_eval=False)


def _text_trees_match(port_text, jax_text, leaf_tol=1e-5):
    """Both models parsed from their texts (a resumed model's first
    trees come from a checkpoint's text, without bin fields): tree by
    tree the same features, thresholds, decision types and children,
    leaf values within ``leaf_tol``, up to the first threshold tie (the
    same feature, gains within 1e-5 relative), which must be one.
    Returns the number of trees compared."""
    a_models = lt.Booster(model_str=port_text, device="cpu").models
    b_models = lt.Booster(model_str=jax_text, device="cpu").models
    assert len(a_models) == len(b_models)
    for i, (a, b) in enumerate(zip(a_models, b_models)):
        nodes = [(int(t.split_feature[s]), float(t.threshold[s]),
                  int(t.decision_type[s]), int(t.left_child[s]),
                  int(t.right_child[s]))
                 for t in (a, b) for s in range(t.num_leaves - 1)]
        na = a.num_leaves - 1
        if a.num_leaves == b.num_leaves and nodes[:na] == nodes[na:]:
            np.testing.assert_allclose(a.leaf_value, b.leaf_value,
                                       rtol=leaf_tol, atol=leaf_tol)
            continue
        s = next(s for s in range(min(na, b.num_leaves - 1))
                 if nodes[s] != nodes[na + s])
        assert nodes[s][0] == nodes[na + s][0], (i, s)
        ga, gb = float(a.split_gain[s]), float(b.split_gain[s])
        assert abs(ga - gb) <= 1e-5 * abs(gb), (i, s, ga, gb)
        return i
    return len(a_models)


_REFERENCE = {}


def _uninterrupted(option, tmp_path_factory):
    """The uninterrupted checkpointed run of an option (its text and
    best iteration), once a module."""
    if option not in _REFERENCE:
        d = tmp_path_factory.mktemp(f"ref_{option}")
        tr, kw = _resume_sets(option)
        p = dict(BASE, **RESUME_OPTIONS[option], checkpoint_dir=str(d),
                 checkpoint_freq=2)
        bst = lt.train(p, tr, 8, **kw, device="cpu")
        _REFERENCE[option] = (_trees(bst), bst.best_iteration)
    return _REFERENCE[option]


@pytest.mark.parametrize("drill", sorted(DRILLS))
@pytest.mark.parametrize("option", list(RESUME_OPTIONS))
def test_resume_is_bitwise_the_uninterrupted_run(option, drill, tmp_path,
                                                 tmp_path_factory):
    ref_text, ref_best = _uninterrupted(option, tmp_path_factory)
    p = dict(BASE, **RESUME_OPTIONS[option], checkpoint_dir=str(tmp_path),
             checkpoint_freq=2, guard_policy="rollback")
    tr, kw = _resume_sets(option)
    first = lt.train(dict(p, faults=DRILLS[drill]), tr, 8, **kw,
                     device="cpu")
    faults.set_fault_plan(None)
    if drill == "sigterm":
        assert first.preempted and first._gbdt.iter == 4
        tr, kw = _resume_sets(option)
        bst = lt.train(p, tr, 8, **kw, device="cpu")
        assert bst.resumed_iteration == 4
    else:
        assert not first.preempted
        bst = first
    assert _trees(bst) == ref_text
    assert bst.best_iteration == ref_best


@pytest.mark.parametrize("option", ["none", "bagging", "feature_fraction"])
def test_resumed_model_matches_jax(option, tmp_path):
    """The port's resumed model against the JAX package's resumed model
    (the same checkpointed drill) at the parity standard."""
    X, y = _data(n=1000)
    p = dict(BASE, **RESUME_OPTIONS[option], checkpoint_freq=2)
    out = {}
    for name, pkg, kw in (("port", lt, {"device": "cpu"}),
                          ("jax", lgb, {"verbose_eval": False})):
        d = str(tmp_path / name)
        pp = dict(p, checkpoint_dir=d)
        first = pkg.train(dict(pp, faults="sigterm@iteration=3"),
                          pkg.Dataset(X, label=y), 8, **kw)
        assert first.preempted
        for mod in (faults, jfaults):
            mod.set_fault_plan(None)
        out[name] = pkg.train(pp, pkg.Dataset(X, label=y), 8, **kw)
        assert out[name].resumed_iteration == 4
    assert _text_trees_match(out["port"].model_to_string(),
                             out["jax"].model_to_string()) == 8
