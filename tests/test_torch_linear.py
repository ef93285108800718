"""Linear leaves in the port against the JAX package, on the CPU (ROADMAP
Queue 1 item 7.5; JAX ``tests/test_linear_tree.py``).

The fit: the port sums ``X~^T H X~`` and ``X~^T g`` per leaf in float64
and solves in float64 (``models/linear.py``), the JAX package sums and
solves in float32, so coefficients and constants agree within float32
rounding of those sums: 2e-6 absolute plus 1e-5 relative on values of
order 1, the ``ok`` flags exactly. A trained model: the same trees as
the JAX serial learner (both fit on the same leaves), coefficients
within 1e-5 absolute plus 1e-4 relative (a later tree fits the
gradients of scores that already differ by the earlier trees'
rounding), and raw predictions within rtol/atol 1e-5 (raw scores up to
~6; the largest gap seen, 1.04e-5, is 2e-6 of its prediction).
The same model (a JAX model carried across) predicts the JAX host
route's bits, both add chains being left-to-right float32, and the port
writes the JAX writer's text.
"""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
import lightgbm_tpu as lgb
from lightgbm_tpu.io import model_text as jtext
from lightgbm_tpu.models.linear import _fit_linear_jit
from lightgbm_tpu.models.linear import \
    leaf_path_features as jax_path_features
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import bin_mappers_from_state, \
    trees_from_state
from lightgbm_tpu_torch.data.dataset import Dataset
from lightgbm_tpu_torch.io import model_text as ptext
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.models.linear import (fit_linear,
                                              leaf_path_features)
from torch_efb_data import same_tree

torch.set_num_threads(2)
BASE = {"objective": "regression", "num_leaves": 7, "verbosity": -1,
        "linear_tree": True}
ROUNDS = 5
ATOL, RTOL = 2e-6, 1e-5


def _data(seed=0, n=2000, f=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.05, 2] = np.nan
    y = (2 * X[:, 0] + X[:, 1] * X[:, 0] + 0.5 * np.nan_to_num(X[:, 2])
         + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def _train_both(extra, rounds=ROUNDS, data=None):
    X, y = data if data is not None else _data()
    p = dict(BASE, **extra)
    port = lt.train(p, lt.Dataset(X, label=y), rounds, device="cpu")
    jb = lgb.train(p, lgb.Dataset(X, label=y), rounds)
    return X, port, jb


# ---- the fit ------------------------------------------------------------------

@pytest.mark.parametrize("lam,l2,bagged", [(0.0, 0.0, False),
                                           (0.5, 0.1, True),
                                           (2.0, 1.0, False)])
def test_fit_matches_jax(lam, l2, bagged):
    """``fit_linear`` against ``_fit_linear_jit`` on the same rows,
    leaves and features: NaN rows left out, leaves with no feature or
    too few rows kept constant (``ok`` False), the rest within the
    module's tolerance."""
    rng = np.random.RandomState(int(lam * 10) + bagged)
    n, f, big_l, c = 4000, 6, 9, 3
    raw = rng.randn(n, f).astype(np.float32)
    raw[rng.rand(n, f) < 0.02] = np.nan
    lid = rng.randint(0, big_l, n).astype(np.int32)
    lid[lid == 8] = 7                   # leaf 8 has no row
    lid[:3] = 6
    lid[lid == 6] = 5
    lid[:3] = 6                         # leaf 6: 3 rows, 3 features
    g = rng.randn(n).astype(np.float32)
    h = (rng.rand(n) * 0.25 + 0.01).astype(np.float32)
    bag = (rng.rand(n) < 0.8).astype(np.float32) if bagged \
        else np.ones(n, np.float32)
    feats = np.full((big_l, c), -1, np.int32)
    for leaf in range(big_l):
        k = leaf % (c + 1)
        feats[leaf, :k] = rng.choice(f, k, replace=False)
    lv = rng.randn(big_l).astype(np.float32)
    # leaf 5's first feature constant over its rows: with linear_lambda
    # 0 its system is singular (collinear with the bias), and the leaf
    # keeps its constant in both packages
    raw[lid == 5, feats[5, 0]] = 0.75
    jc, jk, jo = _fit_linear_jit(
        jnp.asarray(raw), jnp.asarray(lid), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(bag), jnp.asarray(feats), jnp.asarray(lv), lam=lam,
        l2=l2)
    pc, pk, po = fit_linear(
        torch.from_numpy(raw), torch.from_numpy(lid), torch.from_numpy(g),
        torch.from_numpy(h), torch.from_numpy(bag) if bagged else None,
        feats, lv, lam=lam, l2=l2)
    jc, jk, jo = np.asarray(jc), np.asarray(jk), np.asarray(jo)
    rest = np.arange(big_l) != 5
    np.testing.assert_array_equal(po[rest], jo[rest])
    assert po.any() and not po.all()
    np.testing.assert_allclose(pc[rest], jc[rest], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pk[rest], jk[rest], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(pk[~po], lv[~po])
    if lam > 0:
        # ridge-regularized but ill-conditioned: float32 against float64
        # solves part by the condition number times float32 rounding
        assert po[5] and jo[5]
        np.testing.assert_allclose(pc[5], jc[5], rtol=1e-3, atol=2e-5)
        np.testing.assert_allclose(pk[5], jk[5], rtol=1e-3, atol=2e-5)
    else:
        # singular: the port keeps the constant; the JAX package's
        # float32 solve returns a bounded solution and keeps it (ROADMAP
        # Queue 3)
        assert not po[5] and jo[5]


def test_leaf_path_features_match_jax():
    """The numerical features on each leaf's path, deepest first, capped
    and -1 padded: the JAX function's on the same tree, with a
    categorical split skipped."""
    X, y = _data()
    X[:, 5] = np.floor(np.abs(X[:, 5]) * 3)
    port = lt.train(dict(BASE, num_leaves=15, linear_tree=False),
                    lt.Dataset(X, label=y, categorical_feature=[5]), 2,
                    device="cpu")
    numeric = np.ones(6, bool)
    numeric[5] = False
    for t in port.models:
        for cap in (1, 3, 8):
            np.testing.assert_array_equal(
                leaf_path_features(t, numeric, 15, cap),
                jax_path_features(t, numeric, 15, cap))


# ---- training ------------------------------------------------------------------

LINEAR_CASES = {
    "default_255": {},
    "lambda_600": {"linear_lambda": 0.5, "max_bin": 600},
    "bagging": {"bagging_fraction": 0.7, "bagging_freq": 1,
                "linear_max_features": 2},
    "binary": {"objective": "binary"},
}


def _y_for(case, y):
    return (y > 0).astype(np.float32) if case == "binary" else y


@pytest.mark.parametrize("case", list(LINEAR_CASES))
def test_linear_training_matches_jax(case):
    X, y = _data()
    X, port, jb = _train_both(LINEAR_CASES[case], data=(X, _y_for(case, y)))
    lrn = port._gbdt.learner
    assert type(lrn).__name__ == ("SerialTreeLearner" if "600" in case
                                  else "PartitionedTreeLearner")
    for a, b in zip(port.models, jb._gbdt.models):
        assert same_tree(a, b)
        assert a.is_linear and b.is_linear
        np.testing.assert_array_equal(a.leaf_features, b.leaf_features)
        np.testing.assert_array_equal(a.leaf_features_inner,
                                      b.leaf_features_inner)
        np.testing.assert_allclose(a.leaf_coeff, b.leaf_coeff, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(a.leaf_const, b.leaf_const, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(port.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)
    # the train scores are the model's predictions (float32 adds)
    np.testing.assert_allclose(port._gbdt.train_score[:, 0].numpy(),
                               port.predict(X, raw_score=True), rtol=0,
                               atol=2e-6)


def test_linear_valid_scores_are_the_predictions():
    """A valid set keeps its raw values; its scores (the bin walk plus
    the leaf models) are the model's predictions of its rows, and its
    metric the JAX run's."""
    X, y = _data()
    Xv, yv = _data(seed=4, n=700)
    p = dict(BASE, metric="l2")
    ev, jev = {}, {}
    ds = lt.Dataset(X, label=y)
    port = lt.train(p, ds, ROUNDS, valid_sets=[ds.create_valid(Xv,
                                                               label=yv)],
                    valid_names=["v"], evals_result=ev, verbose_eval=False,
                    device="cpu")
    jds = lgb.Dataset(X, label=y)
    lgb.train(p, jds, ROUNDS, valid_sets=[jds.create_valid(Xv, label=yv)],
              valid_names=["v"], evals_result=jev, verbose_eval=False)
    np.testing.assert_allclose(port._gbdt.valid_scores[0][:, 0].numpy(),
                               port.predict(Xv, raw_score=True), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(ev["v"]["l2"], jev["v"]["l2"], rtol=1e-5)


def test_nan_rows_take_the_constant_leaf():
    """A row with a NaN in one of its leaf's features predicts the
    leaf's constant value (float64), the others its model."""
    X, port, _ = _train_both({}, data=(lambda X, y: (
        np.where(np.random.RandomState(3).rand(*X.shape) < 0.05, np.nan,
                 X), y))(*_data()))
    seen = 0
    for t in port.models:
        leaf = t.predict_leaf_index(X)
        feats = t.leaf_features[leaf]
        nan_row = np.array([np.isnan(X[i, feats[i][feats[i] >= 0]]).any()
                            for i in range(len(X))])
        seen += int(nan_row.sum())
        np.testing.assert_array_equal(t.predict(X)[nan_row],
                                      t.leaf_value[leaf][nan_row])
        assert (t.predict(X)[~nan_row] != t.leaf_value[leaf][~nan_row]).any()
    assert seen > 0


# ---- the model: text, carrying across, prediction --------------------------

def _jax_linear_state(t):
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
                shrinkage=t.shrinkage, cat_threshold=t.cat_threshold,
                leaf_const=t.leaf_const, leaf_coeff=t.leaf_coeff,
                leaf_features=t.leaf_features,
                leaf_features_inner=t.leaf_features_inner)


def test_carried_jax_linear_model_predicts_and_writes_like_jax():
    """A JAX-trained linear model carried across (``convert.py``):
    its raw predictions are the JAX predictor's to the bit, its bin-space
    walk scores its training rows like ``predict``, and the port's
    writer gives the JAX writer's text but for the device line."""
    X, y = _data()
    p = dict(BASE, fused_split_kernel="off")
    jb = lgb.train(p, lgb.Dataset(X, label=y), ROUNDS)
    jg = jb._gbdt
    jg.finalize_trees()
    cfg = Config.from_params(p)
    mappers = bin_mappers_from_state(
        [m.to_dict() for m in jb.train_set._inner.bin_mappers])
    ds = Dataset.from_numpy(X, cfg, label=y, bin_mappers=mappers)
    gbdt = GBDT(cfg, ds, torch.device("cpu"))
    gbdt.init_from_models(trees_from_state(
        [_jax_linear_state(t) for t in jg.models]))
    assert all(t.is_linear for t in gbdt.models)
    from lightgbm_tpu_torch.predictor import predict
    Xq = X.copy()
    Xq[::11, 0] = np.nan
    np.testing.assert_array_equal(
        predict(gbdt, Xq, torch.device("cpu"), raw_score=True).numpy(),
        jb.predict(Xq, raw_score=True))
    score = torch.zeros((len(X), 1))
    for t in gbdt.models:
        t.predict_binned_add(score, 0, ds.binned_device("cpu"), None,
                             ds.raw_numeric_device("cpu"))
    np.testing.assert_allclose(score[:, 0].numpy(),
                               jb.predict(X, raw_score=True), atol=2e-6,
                               rtol=0)
    port = ptext.save_model_to_string(gbdt).split("\n")
    ref = jtext.save_model_to_string(jg).split("\n")
    diff = [(a, b) for a, b in zip(port, ref) if a != b]
    assert len(port) == len(ref)
    assert diff == [("[device_type: cuda]", "[device_type: tpu]")], diff[:3]
    assert json.loads(ptext.dump_model_json(gbdt)) \
        == json.loads(jtext.dump_model_json(jg))


def test_port_linear_model_round_trips_and_loads_in_jax(tmp_path):
    """The port's linear model text: byte-equal after a round trip, the
    loaded model predicts the trained one's bits, and the JAX package
    loads it and predicts the same bits."""
    X, port, _ = _train_both({})
    text = port.model_to_string()
    path = str(tmp_path / "linear.txt")
    port.save_model(path)
    loaded = lt.Booster(model_file=path, device="cpu")
    assert loaded.model_to_string() == text
    assert all(t.is_linear for t in loaded.models)
    np.testing.assert_array_equal(loaded.predict(X, raw_score=True),
                                  port.predict(X, raw_score=True))
    jb = lgb.Booster(model_str=text)
    np.testing.assert_array_equal(jb.predict(X, raw_score=True),
                                  port.predict(X, raw_score=True))
    with pytest.raises(ValueError, match="linear"):
        loaded.predict(X[:10], pred_contrib=True)


# ---- where linear leaves fall back -----------------------------------------

def _warned(fn):
    from lightgbm_tpu_torch.utils import log
    msgs = []
    orig = log.log_warning

    def grab(msg, *a, **kw):
        msgs.append(str(msg))
    import lightgbm_tpu_torch.models.gbdt as mg
    mg.log_warning = grab
    try:
        out = fn()
    finally:
        mg.log_warning = orig
    return out, msgs


@pytest.mark.parametrize("case", ["l1_objective", "sparse", "two_round",
                                  "sparse_valid"])
def test_linear_falls_back_to_constant_leaves(tmp_path, case):
    """Where the JAX package falls back to constant leaves with a
    warning, so does the port: a renew-output objective, a dataset
    without its raw values (sparse, two-round) and a valid set without
    them."""
    X, y = _data(n=600)
    X = np.nan_to_num(X)
    p = dict(BASE)
    kw = {}
    if case == "l1_objective":
        p["objective"] = "regression_l1"
        ds = lt.Dataset(X, label=y)
    elif case == "sparse":
        ds = lt.Dataset(sp.csr_matrix(X), label=y)
    elif case == "two_round":
        path = str(tmp_path / "train.csv")
        np.savetxt(path, np.column_stack([y, X]), delimiter=",",
                   fmt="%.17g")
        p["two_round"] = True
        ds = lt.Dataset(path)
    else:
        ds = lt.Dataset(X, label=y)
        kw = dict(valid_sets=[ds.create_valid(sp.csr_matrix(X[:200]),
                                              label=y[:200])],
                  verbose_eval=False)
    bst, msgs = _warned(lambda: lt.train(p, ds, 2, device="cpu", **kw))
    assert not any(t.is_linear for t in bst.models)
    assert any("linear_tree" in m for m in msgs), msgs
