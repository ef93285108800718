"""``Booster.refit``, ``rollback_one_iter`` and ``reset_training_data``
of the port against the JAX package's, on the CPU.

Refit: one model text (trained by the JAX package) is loaded into both
packages and refit on a second draw of rows, at decay 0.0, 0.9 and 1.0,
for binary, regression, 3-class and linear trees (``linear_lambda``
0.5). The tree structure is the text's in both; leaf values agree
within 1e-5 (rtol and atol): the port's per-leaf sums are float64
rounded once (the ``hist_rows`` route), the JAX package's a float32
scatter. Linear leaves' constants and coefficients agree within 1e-4
(rtol and atol): the port solves in float64 from float64 sums, JAX in
float32 (ROADMAP.md Queue 3, the linear-leaf entries). Decay 1.0 leaves
every leaf value, constant and coefficient unchanged, to the bit. The
per-leaf sums themselves (``hist_cuda.leaf_histogram``) equal a float64
``bincount`` in row order, to the bit, on each route: uint8 bins, the
int16 bits of u16 bins, int32 bins past 32,768 leaves, and the sorted
route past 65,536 leaves.

Rollback and reset: train scores within 1e-5 of JAX's, trees within
1e-5 of an equal run's.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import hist_cuda as hc
from lightgbm_tpu_torch.utils.log import LightGBMError

ROUNDS = 5
PARAMS = {
    "binary": {"objective": "binary"},
    "regression": {"objective": "regression"},
    "multiclass": {"objective": "multiclass", "num_class": 3},
    "linear": {"objective": "regression", "linear_tree": True,
               "linear_lambda": 0.5},
}


def _data(objective, seed, n=3000, f=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.05, 3] = np.nan
    z = X[:, 0] - 0.7 * X[:, 1] + 0.5 * X[:, 2] * (X[:, 4] > 0)
    z = z + 0.3 * rng.randn(n)
    if objective == "binary":
        return X, (z > 0).astype(np.float64)
    if objective == "multiclass":
        return X, np.digitize(z, [-0.5, 0.5]).astype(np.float64)
    return X, z


def _params(objective):
    return dict(PARAMS[objective], num_leaves=15, learning_rate=0.2,
                verbosity=-1)


_TEXTS = {}


def _model_text(objective):
    """The JAX package's model of ``objective`` (trained once) as text."""
    if objective not in _TEXTS:
        X, y = _data(objective, 0)
        bst = lgb.train(_params(objective), lgb.Dataset(X, label=y), ROUNDS)
        _TEXTS[objective] = bst.model_to_string()
    return _TEXTS[objective]


def _same_structure(a, b):
    assert a.num_leaves == b.num_leaves
    for key in ("split_feature", "left_child", "right_child",
                "decision_type"):
        assert np.array_equal(getattr(a, key), getattr(b, key)), key
    np.testing.assert_array_equal(a.threshold, b.threshold)


@pytest.mark.parametrize("decay", [0.0, 0.9, 1.0])
@pytest.mark.parametrize("objective", list(PARAMS))
def test_refit_matches_jax(objective, decay):
    text = _model_text(objective)
    X2, y2 = _data(objective, 1)
    port = lt.Booster(model_str=text, device="cpu").refit(X2, y2, decay)
    jax = lgb.Booster(model_str=text).refit(X2, y2, decay)
    pm, jm = port.models, jax._gbdt.models
    assert len(pm) == len(jm) == ROUNDS * (3 if objective == "multiclass"
                                           else 1)
    for a, b in zip(pm, jm):
        _same_structure(a, b)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-5)
        assert a.is_linear == b.is_linear == (objective == "linear")
        if a.is_linear:
            assert np.array_equal(a.leaf_features, b.leaf_features)
            for key in ("leaf_const", "leaf_coeff"):
                np.testing.assert_allclose(getattr(a, key), getattr(b, key),
                                           rtol=1e-4, atol=1e-4)
    # the refit booster predicts its refit trees
    p = port.predict(X2[:200], raw_score=True)
    q = jax.predict(X2[:200], raw_score=True)
    np.testing.assert_allclose(p, q, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("objective", list(PARAMS))
def test_refit_at_decay_one_changes_nothing(objective):
    src = lt.Booster(model_str=_model_text(objective), device="cpu")
    X2, y2 = _data(objective, 2)
    out = src.refit(X2, y2, 1.0)
    for a, b in zip(src.models, out.models):
        assert np.array_equal(a.leaf_value, b.leaf_value)
        if a.is_linear:
            assert np.array_equal(a.leaf_const, b.leaf_const)
            assert np.array_equal(a.leaf_coeff, b.leaf_coeff)
    # the trees' text too (the header's feature ranges are the new rows',
    # the parameters the refit booster's)
    trees = lambda b: b.model_to_string().split(  # noqa: E731
        "Tree=0")[1].split("end of trees")[0]
    assert trees(out) == trees(src)


def test_file_loaded_model_recovers_its_objective(tmp_path):
    """A model file's ``objective`` line (with ``num_class``) becomes the
    refit booster's objective, as in the JAX package."""
    path = str(tmp_path / "model.txt")
    with open(path, "w") as fh:
        fh.write(_model_text("multiclass"))
    X2, y2 = _data("multiclass", 1)
    port = lt.Booster(model_file=path, device="cpu").refit(X2, y2, 0.5)
    jax = lgb.Booster(model_file=path).refit(X2, y2, 0.5)
    assert port.params["objective"] == "multiclass"
    assert int(port.params["num_class"]) == 3
    assert port.num_model_per_iteration() == 3
    for a, b in zip(port.models, jax._gbdt.models):
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-5)


def test_trained_booster_refits_on_its_device_and_ops():
    """A booster trained by the port refits through the same device and
    ops; the refit sums took the hist_rows route, a tree each."""
    X, y = _data("binary", 0)
    bst = lt.train(_params("binary"), lt.Dataset(X, label=y), ROUNDS,
                   device="cpu", ops="plain")
    before = dict(hc.LEAF_SUM_ROUTES)
    X2, y2 = _data("binary", 1)
    out = bst.refit(X2, y2)
    assert out.device == bst.device and out.ops == "plain"
    assert hc.LEAF_SUM_ROUTES["hist_rows"] - before["hist_rows"] == ROUNDS
    assert hc.LEAF_SUM_ROUTES["sorted"] == before["sorted"]
    jax = lgb.Booster(model_str=bst.model_to_string()).refit(X2, y2)
    for a, b in zip(out.models, jax._gbdt.models):
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-5)


def test_linear_refit_without_raw_values_is_refused():
    """A linear model refit on a training set that keeps no raw values,
    with no raw matrix given, raises JAX's ``refit_linear_raw_missing``
    error rather than dropping the coefficients."""
    text = _model_text("linear")
    X2, y2 = _data("linear", 1)
    src = lt.Booster(model_str=text, device="cpu")
    leaf = src.predict(X2, pred_leaf=True)
    bst = lt.Booster({"objective": "regression", "verbosity": -1},
                     lt.Dataset(X2, label=y2), device="cpu")
    bst._gbdt.models = lt.Booster(model_str=text, device="cpu").models
    with pytest.raises(LightGBMError, match="refit_linear_raw_missing"):
        bst._gbdt.refit(leaf)
    jbst = lgb.Booster({"objective": "regression", "verbosity": -1},
                       lgb.Dataset(X2, label=y2))
    jbst._gbdt.models = lgb.Booster(model_str=text)._loaded.models
    with pytest.raises(Exception, match="refit_linear_raw_missing"):
        jbst._gbdt.refit(leaf)


@pytest.mark.parametrize("num_leaves,dtype", [(63, torch.uint8),
                                              (1000, torch.int16),
                                              (1500, torch.int16),
                                              (40000, torch.int32),
                                              (70000, None)])
def test_leaf_histogram_routes(num_leaves, dtype):
    """The per-leaf sums on each route equal float64 ``bincount`` sums
    in row order rounded once, to the bit; empty leaves are zero. The
    ``hist_rows`` route takes up to 65,536 leaves (the kernel's widest
    bins: int32 past 32,768), the sorted route the rest."""
    rng = np.random.RandomState(num_leaves)
    n = 5000
    leaf = rng.randint(0, num_leaves - 7, n)
    g = rng.randn(n).astype(np.float32)
    h = rng.rand(n).astype(np.float32)
    ghc = torch.from_numpy(np.stack([g, h, np.ones(n, np.float32)], 1))
    route = "sorted" if dtype is None else "hist_rows"
    before = hc.LEAF_SUM_ROUTES[route]
    out = hc.leaf_histogram(torch.from_numpy(leaf), ghc, num_leaves)
    assert hc.LEAF_SUM_ROUTES[route] == before + 1
    assert out.dtype == torch.float32 and out.shape == (num_leaves, 3)
    for c, v in enumerate((g, h, np.ones(n, np.float32))):
        want = np.bincount(leaf, weights=v.astype(np.float64),
                           minlength=num_leaves).astype(np.float32)
        assert np.array_equal(out[:, c].numpy(), want), c
    assert not out[num_leaves - 7:].any()
    if dtype is not None:
        plain = hc.leaf_histogram(torch.from_numpy(leaf), ghc, num_leaves,
                                  plain=True)
        assert torch.equal(plain, out)


def _train_scores(port, jax):
    p = port._gbdt.train_score.numpy()
    j = np.asarray(jax._gbdt.train_score)
    return p, j.reshape(p.shape)


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_rollback_one_iter_matches_jax(objective):
    X, y = _data(objective, 0)
    Xv, yv = _data(objective, 5, n=800)
    params = _params(objective)
    ptr = lt.Dataset(X, label=y)
    port = lt.Booster(params, ptr, device="cpu")
    port.add_valid(ptr.create_valid(Xv, label=yv), "valid")
    jtr = lgb.Dataset(X, label=y)
    jax = lgb.Booster(params, jtr)
    jax.add_valid(jtr.create_valid(Xv, label=yv), "valid")
    for _ in range(ROUNDS):
        port.update()
        jax.update()
    port.rollback_one_iter().rollback_one_iter()
    jax.rollback_one_iter().rollback_one_iter()
    k = 3 if objective == "multiclass" else 1
    assert port.current_iteration() == jax.current_iteration() == ROUNDS - 2
    assert port.num_trees() == (ROUNDS - 2) * k
    p, j = _train_scores(port, jax)
    np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-5)
    pv = port._gbdt.valid_scores[0].numpy()
    jv = np.asarray(jax._gbdt.valid_scores[0]).reshape(pv.shape)
    np.testing.assert_allclose(pv, jv, rtol=1e-5, atol=1e-5)
    # the same as a run of ROUNDS - 2 iterations, whose scores it keeps
    short = lt.train(params, lt.Dataset(X, label=y), ROUNDS - 2,
                     device="cpu")
    for a, b in zip(port.models, short.models):
        assert np.array_equal(a.split_feature, b.split_feature)
        assert np.array_equal(a.leaf_value, b.leaf_value)
    np.testing.assert_allclose(p, short._gbdt.train_score.numpy(),
                               rtol=1e-6, atol=1e-6)
    # and boosting goes on from there as it would have
    port.update()
    jax.update()
    np.testing.assert_allclose(*_train_scores(port, jax), rtol=1e-5,
                               atol=1e-5)


def test_reset_training_data_matches_jax():
    """The kept trees seed the new rows' scores and boosting continues
    on them, as in the JAX package; a wrong feature count, a reset after
    ``add_valid`` and a subset without raw rows are refused."""
    X, y = _data("binary", 0)
    X2, y2 = _data("binary", 3)
    params = _params("binary")
    port = lt.Booster(params, lt.Dataset(X, label=y), device="cpu")
    jax = lgb.Booster(params, lgb.Dataset(X, label=y))
    for _ in range(3):
        port.update()
        jax.update()
    port.reset_training_data(lt.Dataset(X2, label=y2))
    jax.reset_training_data(lgb.Dataset(X2, label=y2))
    np.testing.assert_allclose(*_train_scores(port, jax), rtol=1e-5,
                               atol=1e-5)
    for _ in range(3):
        port.update()
        jax.update()
    assert port.num_trees() == jax.num_trees() == 6
    for a, b in zip(port.models, jax._gbdt.models):
        assert np.array_equal(a.split_feature, b.split_feature)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(LightGBMError, match="features"):
        port.reset_training_data(lt.Dataset(X2[:, :4], label=y2))
    full = lt.Dataset(X2, label=y2)
    with pytest.raises(LightGBMError, match="raw feature matrix"):
        port.reset_training_data(full.subset(np.arange(1000)))
    port.add_valid(lt.Dataset(X2[:300], label=y2[:300]), "v")
    with pytest.raises(LightGBMError, match="before adding"):
        port.reset_training_data(lt.Dataset(X2, label=y2))
