"""The port's categorical split search against the JAX package's, on the
CPU: ``_pack_bitset``, ``per_feature_categorical`` in both regimes and
``per_feature_splits`` merged with the numerical scan, on the same
random float32 histograms; then the bin-space decisions of categorical
nodes, including the 256-bin edge of the bitset.

Bitsets, left sums and left counts are held equal. Scores are held
within 4 float32 ulp of the largest score of the feature table: with
``lambda_l1`` the JAX package's compiled gain expression rounds once
differently (1 ulp on these inputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.split import FeatureMeta as JMeta
from lightgbm_tpu.ops.split import SplitParams as JParams
from lightgbm_tpu.ops.split import per_feature_splits as j_per_feature_splits
from lightgbm_tpu.ops.split_categorical import _pack_bitset as j_pack
from lightgbm_tpu.ops.split_categorical import \
    per_feature_categorical as j_categorical
from lightgbm_tpu_torch.ops.split import (CAT_TABLE_COLS, O_BITS, O_DLEFT,
                                          O_ISCAT, O_LC, O_LG, O_LH, O_SCORE,
                                          O_THR, FeatureMeta, SplitParams,
                                          assemble_split, kEpsilon,
                                          meta_tensors, per_feature_splits)
from lightgbm_tpu_torch.ops.split_categorical import (_pack_bitset,
                                                      per_feature_categorical)
from lightgbm_tpu_torch.ops.split_scan_cuda import per_feature_numerical_plain

torch.set_num_threads(2)

BASE = dict(lambda_l1=0.0, lambda_l2=1.0, max_delta_step=0.0,
            min_data_in_leaf=5.0, min_sum_hessian_in_leaf=1e-3,
            min_gain_to_split=0.0, max_cat_threshold=32, cat_l2=10.0,
            cat_smooth=10.0, max_cat_to_onehot=4, min_data_per_group=100.0)

# (name, params over BASE, missing code of every feature, constraints)
CASES = [
    ("many_vs_many", {}, 0, None),
    ("onehot", {"max_cat_to_onehot": 64}, 0, None),
    ("nan_bin", {}, 2, None),
    ("max_cat_threshold", {"max_cat_threshold": 4}, 0, None),
    ("min_data_per_group", {"min_data_per_group": 20.0}, 0, None),
    ("small_group_and_smooth", {"min_data_per_group": 5.0,
                                "cat_smooth": 3.0}, 2, None),
    ("cat_l2", {"cat_l2": 1.0, "lambda_l2": 0.0}, 0, None),
    ("l1_and_delta", {"lambda_l1": 0.1, "max_delta_step": 0.7}, 0, None),
    ("constrained", {"min_gain_to_split": 1.0}, 2, (-0.3, 0.4)),
    ("min_data_in_leaf", {"min_data_in_leaf": 60.0}, 0, None),
]


def _hist(seed, f=7, b=40):
    """Random [F, B, 3] float32 histograms; per-feature bin counts
    between 3 and B (feature 0 at 4 bins: one-hot at the default
    max_cat_to_onehot), empty bins past them."""
    rng = np.random.RandomState(seed)
    c = rng.randint(0, 80, (f, b)).astype(np.float32)
    g = (rng.randn(f, b) * c * 0.3).astype(np.float32)
    h = (c * rng.uniform(0.1, 0.3, (f, b))).astype(np.float32)
    hist = np.stack([g, h, c], -1)
    nb = rng.randint(3, b + 1, f).astype(np.int32)
    nb[0], nb[1] = 4, b
    for j in range(f):
        hist[j, nb[j]:] = 0.0
    return hist, nb


def _metas(nb, missing, is_cat):
    f = len(nb)
    miss = np.full(f, missing, np.int32)
    zeros = np.zeros(f, np.int32)
    jm = JMeta(num_bins=jnp.asarray(nb), missing=jnp.asarray(miss),
               default_bin=jnp.asarray(zeros),
               most_freq_bin=jnp.asarray(zeros),
               monotone=jnp.asarray(zeros),
               penalty=jnp.ones(f, jnp.float32),
               is_categorical=jnp.asarray(is_cat))
    tm = FeatureMeta(nb, miss, zeros, zeros, zeros, np.ones(f, np.float32),
                     np.asarray(is_cat, bool))
    return jm, tm


def _members(words):
    return [w * 32 + b for w, word in enumerate(np.asarray(words, np.uint64))
            for b in range(32) if (int(word) >> b) & 1]


def _ulp_close(a, b, ulps=4):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.array_equal(np.isfinite(a), np.isfinite(b)), (a, b)
    fin = np.isfinite(a)
    if fin.any():
        scale = np.spacing(np.abs(b[fin]).max())
        assert np.abs(a[fin] - b[fin]).max() <= ulps * scale, (a, b)


def test_pack_bitset_roundtrip_matches_jax():
    bits = np.zeros((3, 300), bool)
    bits[0, [0, 5, 33, 255]] = True
    bits[1, [63, 200]] = True
    bits[2, [31, 256, 299]] = True          # past 256: dropped
    packed = _pack_bitset(torch.from_numpy(bits)).numpy()
    assert _members(packed[0]) == [0, 5, 33, 255]
    assert _members(packed[1]) == [63, 200]
    assert _members(packed[2]) == [31]
    np.testing.assert_array_equal(
        packed, np.asarray(j_pack(jnp.asarray(bits))).astype(np.int64))
    short = _pack_bitset(torch.from_numpy(bits[:, :40])).numpy()
    assert _members(short[0]) == [0, 5, 33] and short.shape == (3, 8)


@pytest.mark.parametrize("name,over,missing,cons", CASES,
                         ids=[c[0] for c in CASES])
@pytest.mark.parametrize("seed", [0, 1])
def test_per_feature_categorical_matches_jax(name, over, missing, cons,
                                             seed):
    hists = [_hist(seed * 10 + k)[0] for k in range(2)]
    nb = _hist(seed * 10)[1]
    jm, tm = _metas(nb, missing, np.ones(len(nb), bool))
    kw = dict(BASE, **over)
    cmin, cmax = cons if cons is not None else (-np.inf, np.inf)
    leaves = [(h[1, :, 0].sum(), h[1, :, 1].sum(), h[1, :, 2].sum(), cmin,
               cmax) for h in hists]
    # both leaves in one call, as the learners run both children
    got = per_feature_categorical([torch.from_numpy(h) for h in hists],
                                  leaves, meta_tensors(tm, "cpu"),
                                  SplitParams(**kw, has_categorical=True))
    for i, (h, leaf) in enumerate(zip(hists, leaves)):
        ref = j_categorical(jnp.asarray(h), *(jnp.float32(v) for v in leaf[:3]),
                            jm, JParams(**kw, has_categorical=True),
                            jnp.float32(leaf[3]), jnp.float32(leaf[4]))
        np.testing.assert_array_equal(
            got["bitset"][i].numpy(),
            np.asarray(ref["bitset"]).astype(np.int64))
        for key in ("left_g", "left_h", "left_c", "left_output",
                    "right_output"):
            np.testing.assert_array_equal(got[key][i].numpy(),
                                          np.asarray(ref[key]), err_msg=key)
        _ulp_close(got["score"][i].numpy(), np.asarray(ref["score"]))
        assert np.isfinite(np.asarray(ref["score"])).any()


def test_onehot_picks_the_single_category():
    """Four categories, the third with a strongly negative gradient: the
    one-hot regime sends it alone to the left."""
    hist = np.zeros((1, 4, 3), np.float32)
    hist[0, :, 0] = [1.0, 0.5, -8.0, 1.5]
    hist[0, :, 1] = 4.0
    hist[0, :, 2] = 10.0
    _, tm = _metas(np.asarray([4], np.int32), 0, np.ones(1, bool))
    p = SplitParams(**dict(BASE, min_data_in_leaf=1.0), has_categorical=True)
    got = per_feature_categorical([torch.from_numpy(hist)],
                                  [(-5.0, 16.0, 40.0, -np.inf, np.inf)],
                                  meta_tensors(tm, "cpu"), p)
    assert np.isfinite(float(got["score"][0, 0]))
    assert _members(got["bitset"][0, 0].numpy()) == [2]
    assert float(got["left_g"][0, 0]) == -8.0
    assert float(got["left_c"][0, 0]) == 10.0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("missing", [0, 2])
def test_per_feature_splits_merged_matches_jax(seed, missing):
    """Numerical and categorical features in one table: the numerical
    scan's plain version merged with the categorical search against the
    JAX ``per_feature_splits`` (its XLA scan) of the same histogram."""
    hist, nb = _hist(100 + seed)
    is_cat = np.asarray([True, False, True, False, True, False, False])
    jm, tm = _metas(nb, missing, is_cat)
    kw = dict(BASE, min_data_per_group=20.0)
    leaf = (hist[1, :, 0].sum(), hist[1, :, 1].sum(), hist[1, :, 2].sum(),
            -np.inf, np.inf)
    params = SplitParams(**kw, has_categorical=True)
    meta_t = meta_tensors(tm, "cpu")
    ht = torch.from_numpy(hist)
    numerical = per_feature_numerical_plain([ht], [leaf], meta_t, params)
    table = per_feature_splits(numerical, [ht], [leaf], meta_t,
                               params)[0].numpy()
    assert table.shape == (len(nb), CAT_TABLE_COLS)
    ref = j_per_feature_splits(
        jnp.asarray(hist), *(jnp.float32(v) for v in leaf[:3]), jm,
        JParams(**kw, has_categorical=True), jnp.float32(-np.inf),
        jnp.float32(np.inf))
    cat = is_cat
    # the flag and the bitset of every feature, and the categorical
    # features' columns, are the JAX merge's
    np.testing.assert_array_equal(table[:, O_ISCAT] > 0.5,
                                  np.asarray(ref.is_cat))
    np.testing.assert_array_equal(
        np.ascontiguousarray(table[:, O_BITS:]).view(np.uint32),
        np.asarray(ref.cat_bitset))
    np.testing.assert_array_equal(table[cat, O_THR].astype(np.int64),
                                  np.asarray(ref.threshold)[cat])
    assert not (table[cat, O_DLEFT] > 0.5).any()
    assert not np.asarray(ref.default_left)[cat].any()
    np.testing.assert_array_equal(table[cat, O_LG], np.asarray(ref.left_g)[cat])
    np.testing.assert_array_equal(table[cat, O_LC], np.asarray(ref.left_c)[cat])
    np.testing.assert_array_equal(
        table[cat, O_LH] - np.float32(kEpsilon), np.asarray(ref.left_h)[cat])
    # the numerical features' columns pass through from the scan (whose
    # own parity with JAX is tests/test_torch_split_scan.py's)
    np.testing.assert_array_equal(table[~cat, :O_ISCAT],
                                  numerical[0].numpy()[~cat])
    _ulp_close(table[:, O_SCORE], np.asarray(ref.score), ulps=64)
    best = assemble_split(table)
    assert best.feature == int(np.argmax(np.asarray(ref.score)))
    assert best.is_cat == bool(np.asarray(ref.is_cat)[best.feature])
    np.testing.assert_array_equal(best.cat_bitset,
                                  np.asarray(ref.cat_bitset)[best.feature])


def test_wide_categorical_feature_is_never_chosen():
    """The bitset holds 256 bins (MAX_CAT_WORDS words): a categorical
    feature with more bins gets no split in either package, even where
    its split would be the best. So a 300-category column trained at
    max_bin 1023 never splits a node (ROADMAP.md Queue 3)."""
    rng = np.random.RandomState(5)
    b = 300
    c = rng.randint(20, 60, (2, b)).astype(np.float32)
    g = (rng.randn(2, b) * c).astype(np.float32)
    g[:, 250:] -= 40.0 * c[:, 250:]           # the signal past bin 256
    h = (c * 0.25).astype(np.float32)
    hist = np.stack([g, h, c], -1)
    nb = np.asarray([b, 256], np.int32)
    hist[1, 256:] = 0.0
    jm, tm = _metas(nb, 0, np.ones(2, bool))
    leaf = (hist[0, :, 0].sum(), hist[0, :, 1].sum(), hist[0, :, 2].sum())
    kw = dict(BASE, max_cat_to_onehot=4, min_data_per_group=20.0)
    hist[1, :256] = hist[0, :256] * 0.5
    got = per_feature_categorical([torch.from_numpy(hist)],
                                  [leaf + (-np.inf, np.inf)],
                                  meta_tensors(tm, "cpu"),
                                  SplitParams(**kw, has_categorical=True))
    ref = j_categorical(jnp.asarray(hist), *(jnp.float32(v) for v in leaf),
                        jm, JParams(**kw, has_categorical=True),
                        jnp.float32(-np.inf), jnp.float32(np.inf))
    assert np.isneginf(float(got["score"][0, 0]))
    assert np.isneginf(float(np.asarray(ref["score"])[0]))
    assert np.isfinite(float(got["score"][0, 1]))
    _ulp_close(got["score"][0].numpy(), np.asarray(ref["score"]))


def test_bin_walk_and_leaf_update_at_the_256_bin_edge():
    """Where the two bin-space decisions of a categorical node part:
    the leaf-id update (``rows_go_left``, JAX ``ops/partition.py``)
    sends a bin at or above 256 right, while the bin-space tree walk
    (JAX ``models/tree.py:_traverse_binned_idx``) clips the word index,
    so bin b >= 256 follows bin 224 + b % 32. Both packages behave so;
    since a categorical feature of more than 256 bins never splits a
    node, training never reaches it."""
    from lightgbm_tpu.ops.partition import rows_go_left as j_go_left
    from lightgbm_tpu_torch.models.tree import Tree, TreeArrays
    from lightgbm_tpu_torch.ops.partition import rows_go_left
    words = np.zeros(8, np.uint32)
    words[7] = (1 << 3) | (1 << 30)           # bins 227 and 254
    bins = np.asarray([3, 227, 254, 259, 286, 290, 299], np.int64)
    left = rows_go_left(torch.from_numpy(bins), 0, False, 0, 0, 300, True,
                        words).numpy()
    np.testing.assert_array_equal(left, [False, True, True, False, False,
                                         False, False])
    np.testing.assert_array_equal(
        left, np.asarray(j_go_left(jnp.asarray(bins), 0, False, 0, 0, 300,
                                   True, jnp.asarray(words))))
    z = np.zeros(1)
    tree = Tree(TreeArrays(
        num_leaves=2, split_feature=np.zeros(1, np.int32),
        threshold_bin=np.zeros(1, np.int32),
        decision_type=np.ones(1, np.int32),
        left_child=np.asarray([-1], np.int32),
        right_child=np.asarray([-2], np.int32), split_gain=z,
        internal_value=z, internal_weight=z, internal_count=z,
        leaf_value=np.asarray([1.0, 2.0]), leaf_weight=np.zeros(2),
        leaf_count=np.zeros(2), leaf_parent=np.zeros(2, np.int32),
        leaf_depth=np.ones(2, np.int32), cat_bitsets=words[None]))
    tree.num_bin = np.asarray([300], np.int32)
    walk = tree.predict_leaf_index_binned(bins[:, None].astype(np.uint16))
    # 259 = 224 + 3 and 286 = 224 + 30 read bins 227 and 254
    np.testing.assert_array_equal(walk, [1, 0, 0, 0, 0, 1, 1])
    score = torch.zeros((len(bins), 1))
    tree.predict_binned_add(score, 0, torch.from_numpy(
        bins[:, None].astype(np.int16)))
    np.testing.assert_array_equal(score[:, 0].numpy(),
                                  tree.leaf_value[walk].astype(np.float32))
