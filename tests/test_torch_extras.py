"""The rest of tree growing in the port against the JAX package, on the
CPU: per-node randomness (extra_trees, feature_fraction_bynode), CEGB,
forced splits and the bounded histogram memory (ROADMAP Queue 1 item
7.4; JAX ``tests/test_tree_extras.py``, ``test_cegb.py``,
``test_forced_splits.py``, ``test_training.py:282,359``).

The node draws are ``jax.random``'s to the bit (``learner/node_rand.py``
through ``utils/threefry.py``). Training: 2000 x 8 (NaN and zero-missing
columns), 15 leaves, 5 iterations, against ``lgb.train`` (the JAX CPU
serial learner) on the port's partitioned learner (max_bin 255) and its
serial learner (max_bin 600); tree structure exact up to the first
threshold tie (same feature, gains within 1e-5 relative: float64
against float32 histogram sums, ROADMAP Queue 3) and leaf values within
1e-5 before it (``tests/torch_efb_data.py:compare_trees``). Each run
asserts how many trees it compared; where a tie cuts it short, the
count is the one logged in Queue 3. The bounded histogram memory is
also held against the port's own full cache: an evicted parent's
children are summed, not subtracted, so leaf values agree within 1e-5
relative and 1e-6 absolute (a small leaf's sums are differences of
large ones), not to the bit (the JAX package's own test allows 2e-4
and 2e-6).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data import Dataset as JDataset
from lightgbm_tpu.learner.serial import (build_forced_plan as jax_plan,
                                         bynode_feature_count as jax_count,
                                         make_node_rand)
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data.dataset import Dataset
from lightgbm_tpu_torch.learner.grow_extras import (build_forced_plan,
                                                    hist_pool_slots)
from lightgbm_tpu_torch.learner.node_rand import (NodeRand,
                                                  bynode_feature_count,
                                                  salted_uniform)
from lightgbm_tpu_torch.learner.partitioned import _MISSING_CODE
from lightgbm_tpu_torch.utils.threefry import prng_key
from torch_efb_data import compare_trees, same_tree

torch.set_num_threads(2)
BASE = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
ROUNDS = 5


def _data(seed=0, n=2000, f=8):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.1, 2] = np.nan
    X[rng.rand(n) < 0.3, 3] = 0.0
    y = (1.5 * X[:, 0] - X[:, 1] + 0.5 * np.nan_to_num(X[:, 2])
         + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return X, y


def _train_both(extra, max_bin, rounds=ROUNDS, data=None):
    X, y = data if data is not None else _data()
    p = dict(BASE, max_bin=max_bin, **extra)
    port = lt.train(p, lt.Dataset(X, label=y), rounds, device="cpu")
    jb = lgb.train(p, lgb.Dataset(X, label=y), rounds)
    return port, jb


# ---- the node draws ------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 12345, 2 ** 31 - 2])
def test_salted_uniform_matches_jax(seed):
    u = salted_uniform(prng_key(seed), np.arange(9), 13)
    key = jax.random.PRNGKey(seed)
    ref = np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(key, s), (13,))) for s in range(9)])
    np.testing.assert_array_equal(u.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("f,ff,bynode", [(28, 1.0, 0.5), (28, 0.8, 0.5),
                                         (8, 0.5, 0.1), (3, 1.0, 0.9),
                                         (10, 0.3, 0.01)])
def test_bynode_feature_count_matches_jax(f, ff, bynode):
    assert bynode_feature_count(f, ff, bynode) == jax_count(f, ff, bynode)


class _Cfg:
    extra_seed = 6
    feature_fraction_seed = 2

    def __init__(self, extra_trees, bynode, ff=1.0):
        self.extra_trees = extra_trees
        self.feature_fraction_bynode = bynode
        self.feature_fraction = ff


@pytest.mark.parametrize("extra,bynode,ff", [(True, 1.0, 1.0),
                                             (False, 0.5, 1.0),
                                             (True, 0.4, 0.75),
                                             (False, 0.2, 0.5)])
def test_node_rand_matches_make_node_rand(extra, bynode, ff):
    """Rand bins and node masks of every salt of a tree, bitwise
    ``make_node_rand``'s for the same keys and feature mask."""
    f = 12
    nb = np.random.RandomState(1).randint(2, 300, f).astype(np.int32)
    fmask = np.random.RandomState(2).rand(f) < ff if ff < 1.0 \
        else np.ones(f, bool)
    nr = NodeRand(_Cfg(extra, bynode, ff), nb)
    keys = nr.next_tree_keys()
    rb, nm = nr.tables(keys, fmask, 31)
    # the JAX learner's key pair from the same two streams
    er = np.random.RandomState(6).randint(0, 2 ** 31 - 1)
    br = np.random.RandomState(2).randint(0, 2 ** 31 - 1)
    rk = jnp.stack([jax.random.PRNGKey(er), jax.random.PRNGKey(br)])
    node_rand = make_node_rand(rk, jnp.asarray(fmask), nr.count,
                               jnp.asarray(nb), extra, bynode)
    for s in range(31):
        jrb, jnm = node_rand(jnp.int32(s))
        if extra:
            np.testing.assert_array_equal(rb[s], np.asarray(jrb))
        else:
            assert rb is None and jrb is None
        if bynode < 1.0:
            np.testing.assert_array_equal(nm[s], np.asarray(jnm))
            assert nm[s].sum() == min(nr.count, fmask.sum())
        else:
            assert nm is None and jnm is None


# ---- training with per-node randomness ----------------------------------

NODE_CASES = {
    "extra_trees": {"extra_trees": True},
    "bynode": {"feature_fraction_bynode": 0.5},
    "both_bagging": {"extra_trees": True, "feature_fraction_bynode": 0.6,
                     "feature_fraction": 0.8, "bagging_fraction": 0.7,
                     "bagging_freq": 1},
}
# trees compared before a logged tie (ROADMAP Queue 3): the rest
EXPECTED_COMPARED = {("bynode", 600): 0}


@pytest.mark.parametrize("max_bin", [255, 600])
@pytest.mark.parametrize("case", list(NODE_CASES))
def test_node_randomness_trains_like_jax(case, max_bin):
    port, jb = _train_both(NODE_CASES[case], max_bin)
    lrn = port._gbdt.learner
    assert type(lrn).__name__ == ("PartitionedTreeLearner" if max_bin == 255
                                  else "SerialTreeLearner")
    assert not lrn.fused and lrn.node_rand.on
    first, compared = compare_trees(port.models, jb._gbdt.models)
    assert compared == EXPECTED_COMPARED.get((case, max_bin), ROUNDS)


def test_extra_trees_splits_at_the_rand_bins():
    """Every split of an extra_trees tree sits at its leaf's rand bin:
    the row of the salt the leaf got when it was made (0 for the root,
    2k+1 / 2k+2 for the left / right child of split k = node + 1)."""
    X, y = _data()
    port = lt.train(dict(BASE, extra_trees=True), lt.Dataset(X, label=y),
                    1, device="cpu")
    tree = port.models[0]
    assert tree.num_leaves > 4
    nr = NodeRand(Config.from_params(dict(BASE, extra_trees=True)),
                  port._gbdt.learner.meta.num_bins)
    rb, _ = nr.tables(nr.next_tree_keys(), None, 2 * 15 + 1)
    salt = {0: 0}
    for p in range(tree.num_leaves - 1):
        for side, child in ((1, tree.left_child[p]),
                            (2, tree.right_child[p])):
            if child >= 0:
                salt[int(child)] = 2 * (p + 1) + side
    for s in range(tree.num_leaves - 1):
        f = int(tree.split_feature_inner[s])
        assert int(tree.threshold_bin[s]) == int(rb[salt[s]][f]), s


# ---- CEGB ------------------------------------------------------------------

CEGB_CASES = {
    "split": {"cegb_penalty_split": 0.002},
    "coupled": {"cegb_penalty_split": 0.002,
                "cegb_penalty_feature_coupled": [5, 10, 20, 1, 30, 10, 10,
                                                 10]},
    "coupled_tradeoff": {"cegb_tradeoff": 0.5,
                         "cegb_penalty_feature_coupled": [50, 10, 2, 100, 3,
                                                          10, 1, 1]},
}


# trees compared before a logged tie (ROADMAP Queue 3): the rest
CEGB_COMPARED = {("coupled_tradeoff", 600): 4, ("lazy", 600): 3}


@pytest.mark.parametrize("max_bin", [255, 600])
@pytest.mark.parametrize("case", list(CEGB_CASES))
def test_cegb_trains_like_jax(case, max_bin):
    """The split and coupled penalties: the same trees as the JAX
    serial learner, and the same used-feature set after every tree (it
    persists across trees); the coupled penalty's refunds and upgrades
    happen."""
    X, y = _data()
    p = dict(BASE, max_bin=max_bin, **CEGB_CASES[case])
    port = lt.train(p, lt.Dataset(X, label=y), 1, device="cpu")
    jb = lgb.train(p, lgb.Dataset(X, label=y), 1)
    for _ in range(ROUNDS - 1):
        port.update()
        jb.update()
        np.testing.assert_array_equal(
            port._gbdt.learner.cegb.used,
            np.asarray(jb._gbdt.learner._cegb_used))
    _, compared = compare_trees(port.models, jb._gbdt.models)
    assert compared == CEGB_COMPARED.get((case, max_bin), ROUNDS)
    cegb = port._gbdt.learner.cegb
    assert not port._gbdt.learner.fused
    if "coupled" in case:
        assert cegb.refunds == cegb.used.sum() > 0
        assert cegb.upgrades > 0


@pytest.mark.parametrize("max_bin", [255, 600])
def test_cegb_lazy_pins_the_serial_learner_and_trains_like_jax(max_bin):
    """The lazy penalty (charged once a (row, feature)) pins the serial
    learner at any bin count, as the JAX package's learner choice does;
    with bagging the charges follow the in-bag rows."""
    X, y = _data()
    extra = {"cegb_penalty_feature_lazy": [0.01] * 8,
             "cegb_penalty_split": 0.001, "bagging_fraction": 0.8,
             "bagging_freq": 1}
    port, jb = _train_both(extra, max_bin)
    lrn = port._gbdt.learner
    assert type(lrn).__name__ == "SerialTreeLearner"
    assert lrn.cegb.charged is not None and bool(lrn.cegb.charged.any())
    np.testing.assert_array_equal(
        lrn.cegb.charged.numpy(),
        np.asarray(jb._gbdt.learner._cegb_charged))
    _, compared = compare_trees(port.models, jb._gbdt.models)
    assert compared == CEGB_COMPARED.get(("lazy", max_bin), ROUNDS)


def test_cegb_lazy_dropped_by_the_partitioned_learner():
    """``tree_learner=partitioned`` keeps rows reordered: the lazy
    penalty is dropped with a warning, the split penalty stays."""
    X, y = _data()
    p = dict(BASE, tree_learner="partitioned",
             cegb_penalty_feature_lazy=[0.01] * 8, cegb_penalty_split=0.002)
    port = lt.train(p, lt.Dataset(X, label=y), 2, device="cpu")
    lrn = port._gbdt.learner
    assert type(lrn).__name__ == "PartitionedTreeLearner"
    assert lrn.params.cegb_on and not lrn.params.cegb_lazy_on
    assert lrn.cegb.charged is None
    ref = lt.train(dict(BASE, tree_learner="partitioned",
                        cegb_penalty_split=0.002), lt.Dataset(X, label=y),
                   2, device="cpu")
    assert all(same_tree(a, b) for a, b in zip(port.models, ref.models))


def test_cegb_penalty_length_is_checked():
    X, y = _data()
    with pytest.raises(Exception, match="same size as feature number"):
        lt.train(dict(BASE, cegb_penalty_feature_coupled=[1.0, 2.0]),
                 lt.Dataset(X, label=y), 1, device="cpu")


# ---- forced splits -----------------------------------------------------------

def _forced(tmp_path, plan, name="forced.json"):
    path = str(tmp_path / name)
    with open(path, "w") as fh:
        json.dump(plan, fh)
    return path


PLAN = {"feature": 0, "threshold": 0.1,
        "left": {"feature": 1, "threshold": -0.2,
                 "left": {"feature": 3, "threshold": 0.0}},
        "right": {"feature": 2, "threshold": 0.3,
                  "right": {"feature": 1, "threshold": 0.5}}}


@pytest.mark.parametrize("case", ["full", "unused", "categorical",
                                  "below_all"])
def test_forced_plan_matches_jax(tmp_path, case):
    """``build_forced_plan`` equals the JAX package's, including the
    three aborts: an unused feature, a categorical one and a threshold
    below all data end the plan there."""
    X, y = _data()
    X[:, 5] = 1.0                       # a constant column: unused
    X[:, 6] = np.floor(np.abs(X[:, 6]) * 3)
    plan = json.loads(json.dumps(PLAN))
    stop = {"unused": 5, "categorical": 6, "below_all": 4}.get(case)
    if stop is not None:
        plan["right"]["right"] = {"feature": stop, "threshold":
                                  -100.0 if case == "below_all" else 0.5}
    path = _forced(tmp_path, plan)
    params = dict(BASE, forcedsplits_filename=path)
    cat = [6] if case == "categorical" else ()
    ds = Dataset.from_numpy(X, Config.from_params(params), label=y,
                            categorical_features=cat)
    jds = JDataset.from_numpy(X, JConfig.from_params(params), label=y,
                              categorical_features=cat)
    ours = build_forced_plan(ds, Config.from_params(params), _MISSING_CODE)
    ref = jax_plan(jds, JConfig.from_params(params))
    assert [tuple(s) for s in ours] == [tuple(s) for s in ref]
    assert len(ours) == (5 if case == "full" else 4)


@pytest.mark.parametrize("max_bin", [255, 600])
def test_forced_splits_train_like_jax(tmp_path, max_bin):
    """Every tree starts with the plan's splits, as in the JAX package,
    and the trees are the JAX serial learner's."""
    path = _forced(tmp_path, PLAN)
    port, jb = _train_both({"forcedsplits_filename": path}, max_bin)
    plan = port._gbdt.learner.forced_plan
    assert len(plan) == 5 and not port._gbdt.learner.fused
    for t in port.models:
        np.testing.assert_array_equal(t.split_feature_inner[:5],
                                      [s.feat for s in plan])
        np.testing.assert_array_equal(t.threshold_bin[:5],
                                      [s.thr for s in plan])
    _, compared = compare_trees(port.models, jb._gbdt.models)
    assert compared == ROUNDS


def test_forced_split_with_an_empty_side_ends_the_plan(tmp_path):
    """A forced step whose left side is empty in its leaf (a threshold
    below the leaf's rows, though not below all data) ends the plan,
    in both packages."""
    plan = {"feature": 0, "threshold": 0.0,
            "right": {"feature": 0, "threshold": -1.0,
                      "left": {"feature": 1, "threshold": 0.0}}}
    path = _forced(tmp_path, plan)
    port, jb = _train_both({"forcedsplits_filename": path}, 255)
    t = port.models[0]
    assert int(t.split_feature_inner[0]) == 0
    _, compared = compare_trees(port.models, jb._gbdt.models)
    assert compared == ROUNDS


# ---- the bounded histogram memory --------------------------------------------

def _pool_mb(slots, f=8, b=256):
    return (slots + 0.5) * f * b * 12 / 2 ** 20


@pytest.mark.parametrize("f,b,pool", [(8, 256, -1.0), (8, 256, 0.0),
                                      (8, 256, 0.05), (8, 256, 0.001),
                                      (28, 1024, 2.0), (28, 256, 100.0)])
def test_hist_pool_slots_matches_jax(f, b, pool):
    from lightgbm_tpu.learner.serial import hist_pool_slots as jax_slots
    cfg = Config.from_params(dict(BASE, histogram_pool_size=pool))
    jcfg = JConfig.from_params(dict(BASE, histogram_pool_size=pool))
    assert hist_pool_slots(cfg, 255, f, b) == jax_slots(jcfg, 255, f, b)


@pytest.mark.parametrize("slots", [2, 4, 8])
def test_lru_pool_grows_the_cached_trees(slots):
    """An LRU pool of 2-8 slots on the partitioned learner (JAX
    ``test_histogram_pool_lru_matches_cached``): the full cache's trees,
    leaf values within the module's tolerance; it rebuilds children."""
    X, y = _data()
    p = dict(BASE, num_leaves=31, min_data_in_leaf=5)
    ref = lt.train(p, lt.Dataset(X, label=y), ROUNDS, device="cpu")
    pool = lt.train(dict(p, histogram_pool_size=_pool_mb(slots)),
                    lt.Dataset(X, label=y), ROUNDS, device="cpu")
    lrn = pool._gbdt.learner
    assert lrn.mem.mode == "pool" and lrn.hist_slots == slots
    assert lrn.mem.builds > 0 and lrn.hist is None
    for a, b in zip(pool.models, ref.models):
        assert same_tree(a, b)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("max_bin", [255, 600])
def test_rebuild_mode_trains_like_jax(max_bin):
    """Fewer than 2 slots (partitioned), or no full cache (serial):
    both children built every split; the trees of the JAX serial
    learner's rebuild mode (JAX ``test_histogram_pool_bounded_matches_
    cached``), and of the port's full cache."""
    port, jb = _train_both({"histogram_pool_size": 0.001}, max_bin)
    lrn = port._gbdt.learner
    assert lrn.mem.mode == "rebuild" and not lrn.fused
    assert not jb._gbdt.learner.cache_hists
    _, compared = compare_trees(port.models, jb._gbdt.models)
    assert compared == (ROUNDS if max_bin == 255 else 4)
    X, y = _data()
    ref = lt.train(dict(BASE, max_bin=max_bin), lt.Dataset(X, label=y),
                   ROUNDS, device="cpu")
    for a, b in zip(port.models, ref.models):
        assert same_tree(a, b)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-6)


def test_pool_with_forced_splits(tmp_path):
    """A forced split of an evicted leaf rebuilds its histogram from its
    rows; the trees are the full cache's."""
    path = _forced(tmp_path, PLAN)
    X, y = _data()
    p = dict(BASE, forcedsplits_filename=path)
    ref = lt.train(p, lt.Dataset(X, label=y), 3, device="cpu")
    pool = lt.train(dict(p, histogram_pool_size=_pool_mb(2)),
                    lt.Dataset(X, label=y), 3, device="cpu")
    assert pool._gbdt.learner.mem.mode == "pool"
    for a, b in zip(pool.models, ref.models):
        assert same_tree(a, b)


# ---- the gate: what keeps a tree per-phase ----------------------------------

@pytest.mark.parametrize("extra", [
    {"extra_trees": True}, {"feature_fraction_bynode": 0.5},
    {"cegb_penalty_split": 0.01}, {"histogram_pool_size": 0.05},
    {"forcedsplits_filename": "PLAN"}])
@pytest.mark.parametrize("max_bin", [255, 600])
def test_extras_keep_the_per_phase_loop(tmp_path, extra, max_bin):
    """With ``fused_split_kernel="on"`` (the fused step's plain version
    on the CPU) each option still runs the per-phase loop, as the JAX
    package's gate keeps it off its fused kernels."""
    if "forcedsplits_filename" in extra:
        extra = {"forcedsplits_filename": _forced(tmp_path, PLAN)}
    X, y = _data(n=500)
    on = lt.train(dict(BASE, max_bin=max_bin, fused_split_kernel="on"),
                  lt.Dataset(X, label=y), 1, device="cpu")
    assert on._gbdt.learner.fused
    port = lt.train(dict(BASE, max_bin=max_bin, fused_split_kernel="on",
                         **extra), lt.Dataset(X, label=y), 1, device="cpu")
    assert not port._gbdt.learner.fused
