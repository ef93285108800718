"""The port's published predict artifacts (``serving/aot.py``) on the
CPU, against the JAX package's.

The JAX artifact is built from a JAX-trained booster for its model text;
the port's for the same text from a port GBDT that carries the JAX
trees over the JAX bin mappers (``convert.py``, as
``tests/test_torch_model_io.py`` carries them). Both artifacts'
``predict_raw`` must be byte-equal on the same rows (NaN rows too), and
the refusals, the sha binding and the torn-bundle errors match JAX's.
An engine that loads a model text with its artifact serves from the
bundle's stack.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.serving import aot as jaot
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import bin_mappers_from_state, trees_from_state
from lightgbm_tpu_torch.data import Dataset
from lightgbm_tpu_torch.models.variants import create_boosting
from lightgbm_tpu_torch.predictor import stack_trees
from lightgbm_tpu_torch.serving import (ModelLoadError, ServingConfig,
                                        ServingEngine)
from lightgbm_tpu_torch.serving import aot as paot

CPU = torch.device("cpu")


def _toy(seed=0, n=300, d=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = (X[:, 0] + X[:, 1] > 0).astype(np.float64)
    return X, y


def _nan_rows(X):
    Xn = X[:32].copy()
    Xn[::3, 0] = np.nan
    Xn[1::5, 3] = np.nan
    return Xn


def _jax_tree_state(t):
    return dict(num_leaves=t.num_leaves, split_feature=t.split_feature,
                threshold=t.threshold, decision_type=t.decision_type,
                left_child=t.left_child, right_child=t.right_child,
                leaf_value=t.leaf_value, missing_code=t._missing_code,
                threshold_bin=t.threshold_bin,
                split_feature_inner=t.split_feature_inner,
                split_gain=t.split_gain, internal_value=t.internal_value,
                internal_weight=t.internal_weight,
                internal_count=t.internal_count,
                leaf_weight=t.leaf_weight, leaf_count=t.leaf_count,
                leaf_parent=t.leaf_parent, leaf_depth=t.leaf_depth,
                shrinkage=t.shrinkage, cat_threshold=t.cat_threshold)


def _carried(jb, params, X, y):
    """A port GBDT over the JAX model's bin mappers with its trees."""
    jb._gbdt.finalize_trees()
    cfg = Config.from_params(params)
    mappers = bin_mappers_from_state(
        [m.to_dict() for m in jb.train_set._inner.bin_mappers])
    ds = Dataset.from_numpy(X, cfg, label=y, bin_mappers=mappers)
    gbdt = create_boosting(cfg, ds, CPU)
    gbdt.models = trees_from_state(
        [_jax_tree_state(t) for t in jb._gbdt.models])
    return gbdt


CASES = {
    "binary": {"objective": "binary", "num_leaves": 7, "verbosity": -1},
    "multiclass": {"objective": "multiclass", "num_class": 3,
                   "num_leaves": 5, "verbosity": -1},
    "rf": {"objective": "binary", "boosting": "rf", "bagging_freq": 1,
           "bagging_fraction": 0.8, "num_leaves": 7, "verbosity": -1},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_predict_raw_equals_the_jax_artifact(case, tmp_path):
    params = CASES[case]
    X, y = _toy()
    if case == "multiclass":
        y = (np.arange(len(X)) % 3).astype(np.float64)
    jb = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=5)
    text = jb.model_to_string()
    for sub in ("j", "p"):
        (tmp_path / sub).mkdir()
    jart = jaot.load_artifact(jaot.build_artifact(
        jb, text, buckets=(1, 64), out_dir=str(tmp_path / "j"),
        compile=False))
    path = paot.build_artifact(_carried(jb, params, X, y), text,
                               buckets=(1, 64), out_dir=str(tmp_path / "p"),
                               device="cpu")
    art = paot.load_artifact(path, expected_sha=paot.text_sha(text),
                             device="cpu")
    assert art.average_output == jart.average_output == (case == "rf")
    assert art.k == jart.k and art.num_trees == jart.num_trees
    for data in (X, X[:1], X[:37], _nan_rows(X)):
        a, b = art.predict_raw(data), jart.predict_raw(data)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
        np.testing.assert_array_equal(art.leaf_idx(data),
                                      jart.leaf_idx(data))
    assert art.predict_raw(X).tobytes() == lgb.Booster(
        model_str=text).predict(X, raw_score=True).tobytes()
    assert set(art.describe()) == set(jart.describe())
    assert art.describe()["model_sha"] == jart.describe()["model_sha"]
    assert art.warm((1, 8)) == 2


def _refusal(build):
    with pytest.raises(Exception) as ei:
        build()
    return type(ei.value).__name__, str(ei.value)


def test_refusals_match_jax(tmp_path):
    X, y = _toy()
    lin = {"objective": "regression", "linear_tree": True, "num_leaves": 5,
           "verbosity": -1}
    jl = lgb.train(lin, lgb.Dataset(X, label=y), num_boost_round=3)
    pl = lt.train(lin, lt.Dataset(X, label=y), 3, device="cpu")
    base = CASES["binary"]
    jb = lgb.train(base, lgb.Dataset(X, label=y), num_boost_round=4)
    pb = lt.train(base, lt.Dataset(X, label=y), 4, device="cpu")
    jcand = lgb.Booster(model_str=jb.model_to_string()).refit(
        X, y, decay_rate=0.9)
    pcand = lt.Booster(model_str=pb.model_to_string(), device="cpu").refit(
        X, y, decay_rate=0.9)
    jtext = lgb.Booster(model_str=jb.model_to_string())
    ptext = lt.Booster(model_str=pb.model_to_string(), device="cpu")
    out = str(tmp_path)
    for jd, pd, words in ((jl, pl, "linear-leaf"),
                          (jcand, pcand, "binned representation"),
                          (jtext, ptext, "no dataset")):
        j = _refusal(lambda: jaot.build_artifact(
            jd, jd.model_to_string(), out_dir=out, compile=False))
        p = _refusal(lambda: paot.build_artifact(
            pd, pd.model_to_string(), out_dir=out, device="cpu"))
        assert p == j and p[0] == "AotUnavailable" and words in p[1]
        assert paot.maybe_build_artifact(pd, pd.model_to_string(),
                                         buckets=(1,), device="cpu") is None
    assert paot.maybe_build_artifact(None, "x\n", ()) is None
    assert paot.maybe_build_artifact("no donor here", "x\n", ()) is None


def test_sha_binding_and_torn_bundles(tmp_path):
    X, y = _toy()
    p = CASES["binary"]
    jb = lgb.train(p, lgb.Dataset(X, label=y), num_boost_round=4)
    jo = lgb.train(p, lgb.Dataset(X, label=1 - y), num_boost_round=3)
    pb = lt.train(p, lt.Dataset(X, label=y), 4, device="cpu")
    po = lt.train(p, lt.Dataset(X, label=1 - y), 3, device="cpu")
    j = _refusal(lambda: jaot.build_artifact(
        jb, jo.model_to_string(), out_dir=str(tmp_path), compile=False))
    q = _refusal(lambda: paot.build_artifact(
        pb, po.model_to_string(), out_dir=str(tmp_path), device="cpu"))
    assert q == j and q[0] == "ModelLoadError"
    text = pb.model_to_string()
    path = paot.build_artifact(pb, text, out_dir=str(tmp_path),
                               device="cpu")
    (tmp_path / "j").mkdir()
    jpath = jaot.build_artifact(jb, jb.model_to_string(),
                                out_dir=str(tmp_path / "j"), compile=False)
    errs = {}
    for name, load in (
            ("sha", lambda: paot.load_artifact(
                path, expected_sha=paot.text_sha("not the model\n"),
                device="cpu")),
            ("jax_bundle", lambda: paot.load_artifact(jpath,
                                                      device="cpu"))):
        with pytest.raises(ModelLoadError) as ei:
            load()
        errs[name] = ei.value
    with pytest.raises(Exception) as ei:
        jaot.load_artifact(jpath, expected_sha=jaot.text_sha("x\n"))
    assert ei.value.code == errs["sha"].code == "model_load_error"
    assert ei.value.http_status == errs["sha"].http_status == 400
    assert "different model text" in str(errs["sha"])
    assert "format" in str(errs["jax_bundle"])
    with open(path, "wb") as fh:
        fh.write(b"garbage")
    with pytest.raises(ModelLoadError, match="torn or unreadable"):
        paot.load_artifact(path, device="cpu")


def test_engine_serves_from_the_artifact(tmp_path):
    X, y = _toy()
    pb = lt.train(CASES["binary"], lt.Dataset(X, label=y), 6, device="cpu")
    other = lt.train(CASES["binary"], lt.Dataset(X, label=1 - y), 4,
                     device="cpu")
    text = pb.model_to_string()
    path = paot.build_artifact(pb, text, buckets=(1, 64),
                               out_dir=str(tmp_path), device="cpu")
    ref = lt.Booster(model_str=text, device="cpu")
    eng = ServingEngine(config=ServingConfig(buckets=(1, 64)), device="cpu")
    try:
        assert eng.load(text, aot=path) == 1
        mv = eng.registry.current()
        assert mv.aot is not None and mv.stacked is mv.aot.stacked
        # the bundle's stack is the restack of the parsed text's trees
        st = stack_trees(ref._src().models, CPU)
        for key, val in st.items():
            if isinstance(val, torch.Tensor):
                assert torch.equal(mv.stacked[key], val), key
        assert mv.stacked["depth"] == st["depth"]
        for data in (X[:64], X[:1], _nan_rows(X)):
            for kind, kw in (("predict", {}),
                             ("raw_score", {"raw_score": True}),
                             ("pred_leaf", {"pred_leaf": True})):
                assert eng.predict(data, kind=kind).tobytes() \
                    == ref.predict(data, **kw).tobytes()
        assert eng.stats()["aot_attach"] == 1
        # a missing artifact: counted, warned, the text restacked
        assert eng.load(text, aot=str(tmp_path / "missing.npz")) == 2
        mv = eng.registry.current()
        assert mv.aot is None and mv.device_ready
        assert eng.stats()["aot_attach_failures"] == 1
        assert eng.predict(X[:5]).tobytes() == ref.predict(X[:5]).tobytes()
    finally:
        eng.stop()
    opath = paot.build_artifact(other, other.model_to_string(),
                                out_dir=str(tmp_path), device="cpu")
    mv = eng.registry.load(text, pin_device=False)
    with pytest.raises(ModelLoadError, match="does not match model"):
        mv.attach_aot(paot.load_artifact(opath, device="cpu"))
