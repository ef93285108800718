"""The port's user surface against the JAX package's, side by side on
the CPU (ROADMAP.md Queue 3, faults 1-3).

1. Dataset and Booster parameters: the data is binned with the
   booster's parameters under the Dataset's own, and boosting reads the
   booster's alone (JAX ``basic.py:408-416``).
2. ``train`` and ``Dataset`` take the JAX signatures: ``feature_name``
   and ``categorical_feature`` after ``init_model``, ``"auto"`` meaning
   no names, ``free_raw_data``; ``categorical_feature`` given to the
   Dataset, to ``train`` or as the parameter trains the JAX package's
   model (which reads the argument only).
3. The robustness and observability parameters act as the JAX
   package's do (Queue 1 item 11.1); the multi-rank ones (``elastic_*``,
   item 11.2) are read by the port as by the JAX package, over ranks
   only (``tests/test_torch_elastic.py``, the drill in
   ``tests/test_torch_elastic_drill.py``).
4. ``n_devices`` > 1 without a group of that many ranks is refused
   (Queue 3 fault 1).
"""

import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt

torch.set_num_threads(2)


def _data(seed=0, n=2000, f=4):
    """Random binary data, the shape of the fault's report (ROADMAP.md
    Queue 3, fault 1)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = rng.randint(0, 2, n).astype(np.float32)
    return X, y


def _both(params, ds_params, rounds=2):
    X, y = _data()
    port = lt.train(params, lt.Dataset(X, label=y, params=ds_params),
                    rounds, device="cpu")
    ref = lgb.train(params, lgb.Dataset(X, label=y, params=ds_params),
                    num_boost_round=rounds, verbose_eval=False)
    return X, port, ref


def test_dataset_params_win_for_binning():
    X, port, ref = _both({"objective": "binary", "num_leaves": 7,
                          "max_bin": 63, "verbosity": -1},
                         {"max_bin": 15, "verbosity": -1})
    nb = port._gbdt.train_data.num_bins_array()
    assert nb.max() == ref._gbdt.train_data.num_bins_array().max() <= 16
    np.testing.assert_allclose(port.predict(X, raw_score=True),
                               ref.predict(X, raw_score=True), rtol=0,
                               atol=1e-6)


def test_boosting_reads_the_booster_params_alone():
    _, port, ref = _both({"objective": "binary", "verbosity": -1},
                         {"num_leaves": 4, "verbosity": -1})
    for bst in (port, ref):
        assert max(t.num_leaves for t in bst._gbdt.models) == 31
    assert port._gbdt.config.num_leaves == ref._gbdt.config.num_leaves \
        == 31


def test_reset_parameter_reads_the_booster_params_alone():
    X, y = _data()
    p = {"objective": "binary", "verbosity": -1}
    port = lt.Booster(p, lt.Dataset(X, label=y,
                                    params={"num_leaves": 4}),
                      device="cpu")
    ref = lgb.Booster(p, lgb.Dataset(X, label=y,
                                     params={"num_leaves": 4}))
    port.reset_parameter({"learning_rate": 0.05})
    ref.reset_parameter({"learning_rate": 0.05})
    assert port._gbdt.config.num_leaves == ref._gbdt.config.num_leaves
    assert port._gbdt.shrinkage_rate == ref._gbdt.shrinkage_rate


def test_train_takes_feature_name_after_init_model_positionally():
    X, y = _data()
    p = {"objective": "binary", "num_leaves": 7, "verbosity": -1}
    names = ["w", "x", "y", "z"]
    port = lt.train(p, lt.Dataset(X, label=y), 2, None, None, None, None,
                    None, names, device="cpu")
    ref = lgb.train(p, lgb.Dataset(X, label=y), 2, None, None, None, None,
                    None, names, verbose_eval=False)
    assert port.feature_name() == ref.feature_name() == names


def test_auto_feature_name_means_no_names():
    X, y = _data()
    p = {"objective": "binary", "num_leaves": 7, "verbosity": -1}
    port = lt.train(p, lt.Dataset(X, label=y, feature_name="auto"), 2,
                    feature_name="auto", device="cpu")
    ref = lgb.train(p, lgb.Dataset(X, label=y, feature_name="auto"), 2,
                    feature_name="auto", verbose_eval=False)
    assert port.feature_name() == ref.feature_name() \
        == [f"Column_{i}" for i in range(4)]
    assert port.model_to_string() .split("feature_names=")[1] \
        .split("\n")[0] == ref.model_to_string().split(
            "feature_names=")[1].split("\n")[0]


def test_dataset_signature_matches_jax():
    import inspect
    port = inspect.signature(lt.Dataset.__init__).parameters
    ref = inspect.signature(lgb.Dataset.__init__).parameters
    assert list(port) == list(ref)
    assert {k: v.default for k, v in port.items()} \
        == {k: v.default for k, v in ref.items()}
    tport = list(inspect.signature(lt.train).parameters)
    tref = list(inspect.signature(lgb.train).parameters)
    assert tport[:len(tref)] == tref
    assert tport[len(tref):] == ["device", "ops"]


def test_free_raw_data_drops_the_matrix():
    X, y = _data()
    p = {"objective": "binary", "num_leaves": 7, "verbosity": -1}
    ds = lt.Dataset(X, label=y, free_raw_data=True)
    bst = lt.train(p, ds, 2, device="cpu")
    rds = lgb.Dataset(X, label=y, free_raw_data=True)
    ref = lgb.train(p, rds, 2, verbose_eval=False)
    assert ds.data is None and rds.data is None
    # tests/test_torch_train.py's tolerance (float32 against float64
    # histogram sums)
    np.testing.assert_allclose(bst.predict(X, raw_score=True),
                               ref.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("where", ["dataset", "train", "params"])
def test_categorical_features_match_jax(where):
    """Feature 1 as a 12-way category, given in each of the three places,
    against the JAX package given it as the Dataset argument:
    categorical nodes in the trees, predictions within the tolerance of
    tests/test_torch_train.py."""
    X, y = _data()
    rng = np.random.RandomState(1)
    X[:, 1] = rng.randint(0, 12, len(X))
    # a noisy label, so that no split's gain is float rounding alone
    y = ((X[:, 0] + 1.5 * np.isin(X[:, 1], [2, 3, 7])
          + rng.randn(len(X))) > 0.7).astype(np.float32)
    p = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
         "min_data_per_group": 20}
    kw, tkw = {}, {}
    if where == "dataset":
        kw = {"categorical_feature": [1]}
    elif where == "train":
        tkw = {"categorical_feature": [1]}
    else:
        p = dict(p, categorical_feature="1")
    bst = lt.train(p, lt.Dataset(X, label=y, **kw), 2, device="cpu", **tkw)
    ref = lgb.train(p, lgb.Dataset(X, label=y, categorical_feature=[1]), 2,
                    verbose_eval=False)
    assert any(t.decision_type[:t.num_leaves - 1].any() & 1
               for t in bst.models)
    np.testing.assert_allclose(bst.predict(X, raw_score=True),
                               ref.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)


def _plane_effect(param, tmp_path, monkeypatch):
    """What a plane param makes each package do on the same run (a NaN
    gradient at iteration 1 where the param needs one): the files it
    wrote, by name, and the exception it raised, by type."""
    from lightgbm_tpu.observability.telemetry import get_telemetry as jt
    from lightgbm_tpu.robustness.faults import set_fault_plan as jf
    from lightgbm_tpu_torch.observability.telemetry import get_telemetry
    from lightgbm_tpu_torch.observability.tracing import get_tracer
    from lightgbm_tpu_torch.robustness.faults import set_fault_plan
    from lightgbm_tpu.observability import tracing as jtracing
    from lightgbm_tpu_torch.observability import tracing
    # each package's one-shot profiler window, fresh for this test
    for mod in (tracing, jtracing):
        monkeypatch.setattr(mod, "_PROFILE", mod.ProfileWindow())
    X, y = _data()
    out = {}
    for name, pkg, kw in (("jax", lgb, {"verbose_eval": False}),
                          ("port", lt, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        value = {"guard_policy": "raise", "faults": "nan_grad@iteration=1",
                 "telemetry_out": str(d / "tel.jsonl"),
                 "trace_out": str(d / "trace.json"),
                 "profile_dir": str(d / "prof"),
                 "crash_dump": str(d / "crash.json")}[param]
        p = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
             param: value}
        if param in ("guard_policy", "crash_dump"):
            p["faults"] = "nan_grad@iteration=1"
            p.setdefault("guard_policy", "raise")
        err = None
        try:
            bst = pkg.train(p, pkg.Dataset(X, label=y), 3, **kw)
        except Exception as e:   # noqa: BLE001 - the raise policy's
            err, bst = type(e).__name__, None
        for f in (set_fault_plan, jf):
            f(None)
        get_telemetry().reset()
        get_tracer().reset()
        jt().reset()
        out[name] = (sorted(f for f in os.listdir(d) if f != "prof"), err,
                     None if bst is None else bst.num_trees(),
                     os.path.isdir(d / "prof") and bool(os.listdir(
                         d / "prof")))
    return out


@pytest.mark.parametrize("param,value", [
    ("guard_policy", "raise"), ("faults", "nan_grad@iteration=1"),
    ("telemetry_out", "tel.jsonl"), ("trace_out", "trace.json"),
    ("profile_dir", "prof"), ("crash_dump", "crash.json"),
    ("elastic_watchdog", False), ("elastic_heartbeat_ms", 250.0)])
def test_robustness_params_are_refused(param, value, tmp_path,
                                       monkeypatch):
    """Every plane param was refused until its item came (11.1 the
    single-process planes, 11.2 the multi-rank ``elastic_*``); now each
    does what the JAX package's does: the same files written, the same
    exception raised, the same number of trees. The multi-rank params
    act over ranks only, so a single process trains the trees it trains
    without them, in either package."""
    if param.startswith("elastic_"):
        assert getattr(lt.Config.from_params({param: value}), param) \
            == value
        X, y = _data()
        p = {"objective": "binary", "num_leaves": 7, "verbosity": -1}
        texts = {}
        for name, pkg, kw in (("jax", lgb, {"verbose_eval": False}),
                              ("port", lt, {"device": "cpu"})):
            with_p, without = (pkg.train(q, pkg.Dataset(X, label=y), 3, **kw)
                               for q in (dict(p, **{param: value}), p))
            texts[name] = [b.model_to_string().split("parameters:")[0]
                           for b in (with_p, without)]
            assert texts[name][0] == texts[name][1]
        assert texts["port"][0].count("Tree=") \
            == texts["jax"][0].count("Tree=") == 3
        return
    out = _plane_effect(param, tmp_path, monkeypatch)
    assert out["port"] == out["jax"], out
    files, err, _, profiled = out["port"]
    assert profiled == (param == "profile_dir")
    if param in ("guard_policy", "crash_dump"):
        assert err == "NonFiniteGradientError"
    if param in ("telemetry_out", "trace_out", "crash_dump"):
        assert files, out
    lt.Config.from_params({param: value})


def test_checkpoint_dir_writes_in_jax_and_is_refused_in_the_port(tmp_path):
    """Since Queue 1 item 11.1 the port writes a checkpoint directory as
    the JAX package does (the same names), and refuses one only over
    more than one rank (item 11.2; tests/test_torch_robustness.py)."""
    X, y = _data()
    p = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
         "checkpoint_dir": str(tmp_path / "ckpt"), "checkpoint_freq": 1}
    lgb.train(p, lgb.Dataset(X, label=y), 2, verbose_eval=False)
    assert sorted(os.listdir(tmp_path / "ckpt"))[:2] == [
        "ckpt_00000001", "ckpt_00000002"]
    lt.train(dict(p, checkpoint_dir=str(tmp_path / "port")),
             lt.Dataset(X, label=y), 2, device="cpu")
    assert sorted(os.listdir(tmp_path / "port")) \
        == sorted(os.listdir(tmp_path / "ckpt"))
    for it in ("ckpt_00000001", "ckpt_00000002"):
        assert sorted(os.listdir(tmp_path / "port" / it)) \
            == sorted(os.listdir(tmp_path / "ckpt" / it))


def _chain(pkg):
    """The chained calls of ROADMAP Queue 3 fault 1 on ``randn(500, 4)``
    (seed 0), through one package."""
    rng = np.random.RandomState(0)
    X = rng.randn(500, 4)
    y = (X[:, 0] > 0).astype(np.float32)
    ds = pkg.Dataset(X, label=y).construct()
    sub = ds.subset([0, 1, 2, 3, 4])
    relabeled = ds.set_label(1.0 - y)
    return ds, sub, relabeled, y


def test_construct_returns_the_dataset_as_jax():
    port, psub, prel, y = _chain(lt)
    ref, jsub, jrel, _ = _chain(lgb)
    assert isinstance(port, lt.Dataset) and isinstance(ref, lgb.Dataset)
    assert port.num_data() == ref.num_data() == 500
    assert port.num_feature() == ref.num_feature() == 4
    np.testing.assert_array_equal(port.get_label(), ref.get_label())
    assert port.get_feature_name() == ref.get_feature_name()
    assert isinstance(psub, lt.Dataset) and isinstance(jsub, lgb.Dataset)
    assert psub.num_data() == jsub.num_data() == 5
    assert prel is port and jrel is ref
    np.testing.assert_array_equal(port.get_label(), 1.0 - y)
    np.testing.assert_array_equal(port.get_label(), ref.get_label())


def test_compile_cache_dir_sets_the_kernel_build_directory(tmp_path):
    """``compile_cache_dir`` is read (JAX ``models/gbdt.py:282-283``):
    training points the kernel library's build directory there; on the
    CPU nothing is built."""
    from lightgbm_tpu_torch.ops import _native
    X, y = _data(n=300)
    d = tmp_path / "kernels"
    cfg = lt.Config.from_params({"compile_cache_dir": str(d)})
    assert cfg.compile_cache_dir == str(d)
    saved = _native._CACHE_DIR["path"]
    try:
        assert _native.build_dir() != str(d)
        lt.train({"objective": "binary", "num_leaves": 4, "verbosity": -1,
                  "compile_cache_dir": str(d)}, lt.Dataset(X, label=y), 1,
                 device="cpu")
        assert _native.build_dir() == str(d)
        assert os.path.dirname(_native.library_path("nvcc")) == str(d)
        assert not d.exists()
    finally:
        _native._CACHE_DIR["path"] = saved


def test_n_devices_without_a_group_is_refused():
    """ROADMAP Queue 3 fault 1: JAX meshes ``n_devices`` devices of one
    process (the suite's 8 CPU devices, ``tests/conftest.py``) and votes
    over 2 shards; the port's shards are ranks, so without a group of 2
    ranks it refuses instead of training a world of one (whose rows 0-2
    would predict 0.605821, 0.465057, 0.473057); ``n_devices`` 0 and 1
    train that world of one, JAX's mesh of one (``n_devices=1``).
    ``tests/test_torch_distributed.py`` holds a group of 2 ranks with
    ``n_devices=2`` against JAX's mesh of 2."""
    rng = np.random.RandomState(0)
    X = rng.randn(4000, 20)
    y = (X[:, :6].sum(axis=1) + 0.5 * rng.randn(4000) > 0).astype(
        np.float32)
    params = {"objective": "binary", "num_leaves": 15, "top_k": 2,
              "tree_learner": "voting", "n_devices": 2, "verbosity": -1}
    ref = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=3,
                    verbose_eval=False)
    np.testing.assert_allclose(ref.predict(X)[:3],
                               [0.605822, 0.492577, 0.450538], atol=2e-6)
    for learner in ("voting", "data", "feature"):
        with pytest.raises(ValueError, match="the port's shards are ranks, "
                           "one process each") as err:
            lt.train(dict(params, tree_learner=learner),
                     lt.Dataset(X, label=y), 3, device="cpu")
        assert "lt.init_distributed" in str(err.value)
        assert "no torch.distributed group is up" in str(err.value)
    # 0 and 1 keep training as before: a world of one, JAX's mesh of one
    one = lgb.train(dict(params, n_devices=1), lgb.Dataset(X, label=y),
                    num_boost_round=3, verbose_eval=False).predict(X)
    for n in (0, 1):
        bst = lt.train(dict(params, n_devices=n), lt.Dataset(X, label=y),
                       3, device="cpu")
        np.testing.assert_allclose(bst.predict(X), one, atol=2e-6)
