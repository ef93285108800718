"""Row sampling in the port against the JAX package, on the CPU: the
threefry draws, the bagging masks, GOSS's weights and DART's drop sets
bit for bit, then whole training with bagging, balanced bagging, GOSS,
DART and RF.

The masks: ``lightgbm_tpu_torch/utils/threefry.py`` computes
``jax.random``'s threefry2x32 bits in integer torch ops, so
``PRNGKey``, ``fold_in`` and ``uniform`` (the partitionable scheme of
jax 0.9) give JAX's keys and floats to the bit, and so do the bagging
mask (JAX ``models/gbdt.py:168 _bag_mask_core``) and GOSS's weights
(JAX ``models/variants.py:37 _goss_weights``: the linear quantile
written out in float32 and the same draw). DART's drop sets come from
the reference's LCG in both packages.

Training: 2000 x 8 (``tests/test_torch_train.py``'s data), 15 leaves,
learning rate 0.1, against the JAX partitioned learner (per-phase,
Pallas kernels in interpret mode), the JAX learner of the port's
partitioned learner. Tree structure is exact up to the first tie (a
node whose two splits' gains agree within 1e-5 relative: float32
against float64 histogram sums, ROADMAP.md Queue 3); leaf values and
raw predictions before it at rtol/atol 1e-5, as in
``tests/test_torch_train.py``. Random forests are not shrunk, so their
leaves are ~2 where a boosted tree's are ~0.3: the JAX serial learner
is up to 1.5e-5 from the JAX partitioned one there, and the port holds
1e-5 against the partitioned one. The serial (leaf_id) learner, at
max_bin 600, is held against the JAX serial learner with bagging on
gradients in multiples of 2**-10 (exact sums: the same trees and leaf
values to float32 rounding), and on the binary objective up to its
first tie (Queue 3: adjacent thresholds of a 600-bin feature whose
gains agree within 4e-6 relative). Both grow loops of the port (the
per-phase loop and the fused step's plain version) grow the same trees
to the bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightgbm_tpu as lgb
from lightgbm_tpu.models.gbdt import _bag_mask_core
from lightgbm_tpu.models.variants import _goss_weights
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.models.gbdt import bag_mask
from lightgbm_tpu_torch.models.variants import goss_weights
from lightgbm_tpu_torch.utils import threefry as tf

torch.set_num_threads(2)
BASE = {"objective": "binary", "num_leaves": 15, "verbosity": -1}


def _data(seed=0, n=2000, f=8):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.1, 2] = np.nan
    X[rng.rand(n) < 0.3, 3] = 0.0
    y = (1.5 * X[:, 0] - X[:, 1] + 0.5 * np.nan_to_num(X[:, 2])
         + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return X, y


def _classes(X, seed=9):
    noise = 0.5 * np.random.RandomState(seed).randn(len(X))
    return np.digitize(X[:, 0] - X[:, 1] + noise,
                       [-0.5, 0.5]).astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# ---- the draws ---------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 12345, 2 ** 31 + 5, -1, -77,
                                  2 ** 40 + 9])
def test_prng_key_matches_jax(seed):
    key = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    assert tuple(int(v) for v in key) == tf.prng_key(seed)


@pytest.mark.parametrize("data", [0, 1, 5, 1000, 2 ** 31 - 1])
def test_fold_in_matches_jax(data):
    k0 = jax.random.PRNGKey(3)
    key = np.asarray(jax.random.key_data(jax.random.fold_in(k0, data)))
    assert tuple(int(v) for v in key) == tf.fold_in(tf.prng_key(3), data)


@pytest.mark.parametrize("n", [1, 2, 7, 1001, 2 ** 24 + 5])
def test_uniform_matches_jax_bitwise(n):
    key = jax.random.fold_in(jax.random.PRNGKey(11), 4)
    ref = np.asarray(jax.random.uniform(key, (n,)))
    out = tf.uniform(tf.fold_in(tf.prng_key(11), 4), n, "cpu").numpy()
    np.testing.assert_array_equal(_bits(out), _bits(ref))


@pytest.mark.parametrize("seed,it,freq,n", [
    (3, 0, 1, 1), (3, 5, 1, 2000), (7, 5, 3, 2001), (0, 9, 4, 777),
    (12345, 1, 2, 65537)])
@pytest.mark.parametrize("balanced", [False, True])
def test_bag_mask_matches_jax_bitwise(seed, it, freq, n, balanced):
    label = (np.random.RandomState(n).rand(n) < 0.3).astype(np.float32)
    fr = dict(frac=0.7, pos_frac=0.5, neg_frac=0.8)
    ref = _bag_mask_core(
        jax.random.PRNGKey(seed), jnp.int32(it),
        jnp.asarray(label) if balanced else None, freq=freq, n=n,
        frac=fr["frac"], pos_frac=fr["pos_frac"], neg_frac=fr["neg_frac"])
    out = bag_mask(tf.prng_key(seed), it, n, "cpu", freq=freq,
                   label=torch.from_numpy(label) if balanced else None,
                   **fr)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))


@pytest.mark.parametrize("n,k", [(2000, 1), (2001, 3), (7, 1),
                                 (100003, 1)])
@pytest.mark.parametrize("rates", [(0.2, 0.1), (0.3, 0.5)])
def test_goss_weights_match_jax_bitwise(n, k, rates):
    rng = np.random.RandomState(n + k)
    g = rng.randn(n, k).astype(np.float32)
    h = rng.rand(n, k).astype(np.float32)
    top, other = rates
    for it in (3, 10):
        ref = _goss_weights(jnp.asarray(g), jnp.asarray(h),
                            jax.random.fold_in(jax.random.PRNGKey(5), it),
                            top_rate=top, other_rate=other)
        out = goss_weights(torch.from_numpy(g), torch.from_numpy(h),
                           tf.fold_in(tf.prng_key(5), it), top_rate=top,
                           other_rate=other)
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))


@pytest.mark.parametrize("extra", [
    {"drop_rate": 0.3},
    {"drop_rate": 0.5, "uniform_drop": True, "xgboost_dart_mode": True},
    {"drop_rate": 0.4, "max_drop": 2, "skip_drop": 0.2}])
def test_dart_drop_sets_match_jax(extra):
    X, y = _data(1, n=600)
    p = dict(BASE, boosting="dart", drop_seed=11, **extra)
    port = lt.Booster(p, lt.Dataset(X, label=y), device="cpu")
    ref = lgb.Booster(dict(p, fused_split_kernel="off"),
                      lgb.Dataset(X, label=y))
    drops = []
    for _ in range(8):
        port.update()
        ref.update()
        assert port._gbdt._drop_index == ref._gbdt._drop_index
        drops.append(list(port._gbdt._drop_index))
    assert any(drops), "no tree was dropped"


# ---- whole training ----------------------------------------------------

def _structure(t):
    return (t.num_leaves, t.split_feature_inner.tolist(),
            t.threshold_bin.tolist(), (t.decision_type & 2).tolist(),
            t.left_child.tolist(), t.right_child.tolist())


def _structure_at(t, s):
    return (int(t.split_feature_inner[s]), int(t.threshold_bin[s]),
            int(t.decision_type[s] & 2), int(t.left_child[s]),
            int(t.right_child[s]))


def _first_tie(port_models, jax_models):
    """The index of the first tree whose structure differs from JAX's,
    None when none does. The difference must be a tie: the first
    differing node's two splits have the same gain within 1e-5
    relative."""
    for i, (a, b) in enumerate(zip(port_models, jax_models)):
        if _structure(a) == _structure(b):
            continue
        s = next(s for s in range(min(a.num_leaves, b.num_leaves) - 1)
                 if _structure_at(a, s) != _structure_at(b, s))
        ga, gb = float(a.split_gain[s]), float(b.split_gain[s])
        assert abs(ga - gb) <= 1e-5 * abs(gb), (i, s, ga, gb)
        return i
    return None


CASES = {
    "bagging": ({"bagging_fraction": 0.7, "bagging_freq": 2,
                 "bagging_seed": 5}, 6, "binary"),
    "balanced": ({"pos_bagging_fraction": 0.5,
                  "neg_bagging_fraction": 0.8, "bagging_freq": 1}, 6,
                 "binary"),
    "goss": ({"boosting": "goss", "top_rate": 0.2, "other_rate": 0.2},
             14, "binary"),
    "dart": ({"boosting": "dart", "drop_rate": 0.3}, 8, "binary"),
    "rf": ({"boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1,
            "feature_fraction": 0.8}, 6, "binary"),
    "goss_multiclass": ({"objective": "multiclass", "num_class": 3,
                         "boosting": "goss", "learning_rate": 0.25}, 6,
                        "multiclass"),
    "dart_multiclass": ({"objective": "multiclass", "num_class": 3,
                         "boosting": "dart", "drop_rate": 0.3}, 6,
                        "multiclass"),
    "bagging_l1": ({"objective": "regression_l1", "bagging_fraction": 0.7,
                    "bagging_freq": 1}, 5, "regression"),
    "rf_l1": ({"objective": "regression_l1", "boosting": "rf",
               "bagging_fraction": 0.7, "bagging_freq": 1}, 5,
              "regression"),
}


def _label(X, y, kind):
    if kind == "multiclass":
        return _classes(X)
    if kind == "regression":
        return (X[:, 0] + 0.1 * X[:, 1]).astype(np.float32)
    return y


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    extra, rounds, kind = CASES[request.param]
    X, y = _data()
    yy = _label(X, y, kind)
    p = dict(BASE, **extra)
    runs = {fused: lt.train(dict(p, fused_split_kernel=fused),
                            lt.Dataset(X, label=yy), rounds, device="cpu")
            for fused in ("off", "on")}
    ref = lgb.train(dict(p, tree_learner="partitioned",
                         fused_split_kernel="off"),
                    lgb.Dataset(X, label=yy), num_boost_round=rounds,
                    verbose_eval=False)
    return X, runs, ref, rounds


def test_sampled_training_matches_jax(case):
    X, runs, ref, rounds = case
    port = runs["off"]
    pm, jm = port.models, ref._gbdt.models
    tie = _first_tie(pm, jm)
    if tie is None:
        assert len(pm) == len(jm) == rounds * port.num_model_per_iteration()
    for a, b in list(zip(pm, jm))[:tie]:
        assert _structure(a) == _structure(b)
        np.testing.assert_array_equal(a.leaf_count, b.leaf_count)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-5)
    if tie is None:
        np.testing.assert_allclose(port.predict(X, raw_score=True),
                                   ref.predict(X, raw_score=True), rtol=0,
                                   atol=1e-5)


def test_sampled_fused_step_grows_the_same_trees(case):
    _, runs, _, _ = case
    assert runs["on"]._gbdt.learner.fused
    assert not runs["off"]._gbdt.learner.fused
    for a, b in zip(runs["off"].models, runs["on"].models):
        assert _structure(a) == _structure(b)
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)
    np.testing.assert_array_equal(runs["off"]._gbdt.train_score.numpy(),
                                  runs["on"]._gbdt.train_score.numpy())


def _exact_fobj(n):
    """Gradients in multiples of 2**-10 (float32 sums exact), fixed per
    row, and a constant hessian."""
    g = (np.random.RandomState(4).randint(-512, 512, n) / 1024.0)

    def fobj(score, data):
        return g + 0.0 * score, np.full(n, 0.25)
    return fobj


@pytest.mark.parametrize("extra", [
    {"bagging_fraction": 0.7, "bagging_freq": 1},
    {"pos_bagging_fraction": 0.6, "neg_bagging_fraction": 0.9,
     "bagging_freq": 2}])
def test_serial_learner_bagging_matches_jax_on_exact_gradients(extra):
    from lightgbm_tpu_torch.learner import SerialTreeLearner
    X, y = _data(2)
    p = dict(BASE, max_bin=600, **extra)
    fobj = _exact_fobj(len(X))
    runs = {fused: lt.train(dict(p, fused_split_kernel=fused),
                            lt.Dataset(X, label=y), 4, fobj=fobj,
                            device="cpu")
            for fused in ("off", "on")}
    ref = lgb.train(dict(p, fused_split_kernel="off"),
                    lgb.Dataset(X, label=y), num_boost_round=4, fobj=fobj,
                    verbose_eval=False)
    assert isinstance(runs["off"]._gbdt.learner, SerialTreeLearner)
    assert len(runs["off"].models) == len(ref._gbdt.models) == 4
    for a, b, c in zip(runs["off"].models, runs["on"].models,
                       ref._gbdt.models):
        assert _structure(a) == _structure(c) == _structure(b)
        np.testing.assert_array_equal(a.leaf_count, c.leaf_count)
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)
        np.testing.assert_allclose(a.leaf_value, c.leaf_value, rtol=1e-6,
                                   atol=1e-7)


def test_serial_learner_bagging_binary_matches_jax_up_to_its_tie():
    X, y = _data()
    p = dict(BASE, max_bin=600, bagging_fraction=0.7, bagging_freq=1)
    port = lt.train(p, lt.Dataset(X, label=y), 3, device="cpu")
    ref = lgb.train(dict(p, fused_split_kernel="off"),
                    lgb.Dataset(X, label=y), num_boost_round=3,
                    verbose_eval=False)
    pm, jm = port.models, ref._gbdt.models
    tie = _first_tie(pm, jm)
    # the tied tree agrees up to its tied node
    a, b = pm[tie or 0], jm[tie or 0]
    s = next((s for s in range(min(a.num_leaves, b.num_leaves) - 1)
              if _structure_at(a, s) != _structure_at(b, s)),
             a.num_leaves - 1)
    for j in range(s):
        assert _structure_at(a, j) == _structure_at(b, j)
    for a, b in list(zip(pm, jm))[:tie]:
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-5)


def test_bagged_rows_keep_their_leaf_ids():
    """Out-of-bag rows are partitioned with the rest: the learner's
    leaf_id is a bin-space walk of the tree for every row, and the
    leaves' counts are the in-bag rows."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data import Dataset
    from lightgbm_tpu_torch.learner import (PartitionedTreeLearner,
                                            SerialTreeLearner)
    X, y = _data(6, n=800)
    w = torch.from_numpy((np.random.RandomState(1).rand(800) < 0.6)
                         .astype(np.float32))
    grad = torch.from_numpy(y - 0.5)
    hess = torch.full((800,), 0.25)
    for cls in (PartitionedTreeLearner, SerialTreeLearner):
        cfg = Config.from_params(dict(BASE, num_leaves=9))
        ds = Dataset.from_numpy(X, cfg, label=y)
        lrn = cls(ds, cfg, torch.device("cpu"))
        tree, leaf_id = lrn.train(grad, hess, bag_weight=w)
        lid = leaf_id.numpy()
        np.testing.assert_array_equal(
            lid, tree.predict_leaf_index_binned(ds.binned))
        inbag = w.numpy() > 0
        np.testing.assert_array_equal(
            tree.leaf_count,
            np.bincount(lid[inbag], minlength=tree.num_leaves))
