"""More than 1024 bins a feature (ROADMAP Queue 1 item 4) on the CPU: the
serial (``leaf_id``) learner, its plain histogram and plain scan past
1024, 9,400 (the scan's and the histogram tile's shared-memory widths on
the card) and 32,768 bins (where the device copy of the bins turns from
int16 bits to int32), against the JAX package.

* ``SerialTreeLearner`` against the JAX ``SerialTreeLearner`` at
  ``max_bin`` 2000, 4095, 12,000 and 40,000, gradients in multiples of
  2**-10 (every histogram sum exact in float32, so the JAX float32
  scatter and the port's float64 sums agree): tree structure exact,
  ``leaf_id`` equal, leaf values at rtol 1e-5 / atol 1e-5.
* ``lt.train`` against ``lgb.train`` (the JAX CPU serial learner) on a
  binary objective at the same widths: tree structure exact, leaf
  values at atol 5e-5 (float64 against float32 sums; ROADMAP Queue 3,
  "Serial-learner leaf sums at 600 bins").
* The plain scan (``ops/split.py``) and ``build_histogram`` at 32,767,
  32,768 and 32,769 bins against the JAX functions, and the scan's
  prefix order past 1024 bins (``_cumsum``: windows of 1024 bins with a
  float64 carry) against a numpy model of the kernel's adds, bit for
  bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data import Dataset as JDataset
from lightgbm_tpu.learner.serial import SerialTreeLearner as JSerial
from lightgbm_tpu.ops import histogram as jhist
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data import Dataset
from lightgbm_tpu_torch.learner import SerialTreeLearner
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.histogram import build_histogram
from lightgbm_tpu_torch.ops.split_scan_cuda import node_rows, node_table

torch.set_num_threads(2)
# rows a width: enough distinct values for every bin (min_data_in_bin 1)
WIDTHS = {2000: 8000, 4095: 14000, 12000: 40000, 40000: 90000}
BASE = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
        "min_data_in_bin": 1}


def _data(n, seed=0, f=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.05, 1] = np.nan            # NaN-missing feature
    y = (1.5 * X[:, 0] - np.nan_to_num(X[:, 1]) + 0.5 * X[:, 2]
         + 0.5 * rng.randn(n) > 0).astype(np.float32)
    return X, y


def _fixed_point(x):
    return (np.round(np.asarray(x, np.float64) * 1024) / 1024).astype(
        np.float32)


def _grads(y, tree):
    s = np.random.RandomState(10 + tree).randn(y.shape[0])
    p = 1.0 / (1.0 + np.exp(-s))
    return _fixed_point(p - y), np.maximum(_fixed_point(p * (1 - p)),
                                           np.float32(2.0 ** -10))


def _same_structure(jt, tt, what):
    k = tt.num_leaves
    assert int(jt.num_leaves) == k, what
    for jf, tf in (("split_feature", "split_feature_inner"),
                   ("threshold_bin", "threshold_bin"),
                   ("left_child", "left_child"),
                   ("right_child", "right_child")):
        np.testing.assert_array_equal(np.asarray(getattr(jt, jf))[:k - 1],
                                      getattr(tt, tf)[:k - 1],
                                      err_msg=f"{what} {jf}")
    np.testing.assert_array_equal(
        np.asarray(jt.decision_type)[:k - 1] & 2,
        tt.decision_type[:k - 1] & 2, err_msg=f"{what} default_left")


@pytest.mark.parametrize("max_bin", list(WIDTHS))
def test_learner_matches_jax_serial(max_bin):
    """Both learners on the same fixed-point gradients, 2 trees, against
    the JAX learner's per-phase loop; with ``fused_split_kernel="on"``
    the port still grows per-phase past 1024 bins (the fused leaf
    kernel's cap)."""
    X, y = _data(WIDTHS[max_bin])
    params = dict(BASE, max_bin=max_bin, num_leaves=15)
    jcfg = JConfig.from_params(dict(params, fused_split_kernel="off"))
    jl = JSerial(JDataset.from_numpy(X, jcfg, label=y), jcfg)
    cfg = Config.from_params(dict(params, fused_split_kernel="on"))
    ds = Dataset.from_numpy(X, cfg, label=y)
    tl = SerialTreeLearner(ds, cfg, torch.device("cpu"))
    assert not tl.fused
    assert tl.num_bins_max == jl.num_bins_max == max_bin
    assert tl.binned.dtype == (torch.int32 if max_bin > 32768
                               else torch.int16)
    assert tl.mem.hist.shape == (15, 3, max_bin, 3)
    for tree in range(2):
        g, h = _grads(y, tree)
        jr = jl.train(jnp.asarray(g), jnp.asarray(h))
        tt, lid = tl.train(torch.from_numpy(g), torch.from_numpy(h))
        _same_structure(jr.tree, tt, f"tree {tree}")
        np.testing.assert_allclose(
            tt.leaf_value[:tt.num_leaves],
            np.asarray(jr.tree.leaf_value)[:tt.num_leaves], rtol=1e-5,
            atol=1e-5, err_msg=f"tree {tree} leaf_value")
        np.testing.assert_array_equal(lid.numpy(), np.asarray(jr.leaf_id))
        assert tt.num_leaves == 15
        # past 2**15 bins a threshold above 32,767 is chosen at least once
        if max_bin > 32768 and tree == 0:
            assert (tt.threshold_bin[:14] > 32767).any()


# threshold ties of float64 against float32 sums (ROADMAP Queue 3):
# max_bin -> (tree, node); port 10256 / JAX 10255, gains 753.20416 /
# 753.20325 at 12,000 bins
TIES = {12000: (1, 4)}


@pytest.mark.parametrize("max_bin", list(WIDTHS))
def test_train_matches_jax(max_bin):
    X, y = _data(WIDTHS[max_bin], seed=1)
    params = dict(BASE, max_bin=max_bin)
    port = lt.train(params, lt.Dataset(X, label=y), 3, device="cpu")
    ref = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=3,
                    verbose_eval=False)
    assert len(port.models) == len(ref._gbdt.models) == 3
    tie = TIES.get(max_bin)
    for i, (tt, jt) in enumerate(zip(port.models, ref._gbdt.models)):
        if tie is not None and tie[0] == i:
            # the tied node picks a neighbouring bin at an equal gain;
            # every other node is the same, the leaves below it are not
            node, k = tie[1], tt.num_leaves
            thr_t, thr_j = tt.threshold_bin, np.asarray(jt.threshold_bin)
            assert abs(int(thr_t[node]) - int(thr_j[node])) == 1
            np.testing.assert_allclose(tt.split_gain[node],
                                       np.asarray(jt.split_gain)[node],
                                       rtol=1e-5)
            keep = np.arange(k - 1) != node
            np.testing.assert_array_equal(thr_t[:k - 1][keep],
                                          thr_j[:k - 1][keep])
            np.testing.assert_array_equal(tt.split_feature_inner[:k - 1],
                                          np.asarray(jt.split_feature)[
                                              :k - 1])
            continue
        _same_structure(jt, tt, f"tree {i}")
        np.testing.assert_allclose(tt.leaf_value[:tt.num_leaves],
                                   np.asarray(jt.leaf_value)[:tt.num_leaves],
                                   rtol=0, atol=5e-5,
                                   err_msg=f"tree {i} leaf_value")
    if tie is None:
        np.testing.assert_allclose(port.predict(X, raw_score=True),
                                   ref.predict(X, raw_score=True), rtol=0,
                                   atol=2e-4)


# ---- the int16 edge: 32,767 / 32,768 / 32,769 bins ---------------------

EDGE = [32767, 32768, 32769]


def _edge_case(b, seed=0, f=3, n=20000):
    """Bins spread over [0, b) with the last bin always hit, gradients
    in multiples of 2**-6 (every float32 sum exact at this size)."""
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, b, (n, f)).astype(np.int64)
    binned[:f, np.arange(f)] = b - 1
    signal = ((binned > b // 3) * np.asarray([0.5, -0.5, 0.25])).sum(axis=1)
    g = np.round((rng.randn(n) + signal) * 64) / 64
    h = np.round((0.25 + rng.rand(n)) * 64) / 64
    ghc = np.stack([g, h, np.ones(n)], axis=1).astype(np.float32)
    return binned, ghc


def _device_bins(binned, b):
    """The dtype the port's device copy takes at ``b`` bins."""
    if b <= 32768:
        return torch.from_numpy(binned.astype(np.uint16).view(np.int16))
    return torch.from_numpy(binned.astype(np.int32))


@pytest.mark.parametrize("b", EDGE)
def test_build_histogram_at_the_int16_edge(b):
    binned, ghc = _edge_case(b)
    got = build_histogram(_device_bins(binned, b), torch.from_numpy(ghc), b)
    ref = jhist.build_histogram(jnp.asarray(binned.astype(np.int32)),
                                jnp.asarray(ghc), b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert float(got[:, b - 1, 2].min()) >= 1.0


@pytest.mark.parametrize("b", EDGE)
def test_plain_scan_at_the_int16_edge(b):
    binned, ghc = _edge_case(b, seed=1)
    hist = build_histogram(_device_bins(binned, b), torch.from_numpy(ghc),
                           b).numpy()
    f = hist.shape[0]
    meta = dict(num_bins=np.full(f, b, np.int32),
                missing=np.asarray([0, 2, 1], np.int32),
                default_bin=np.asarray([0, 0, b // 2], np.int32),
                most_freq_bin=np.zeros(f, np.int32),
                monotone=np.zeros(f, np.int32),
                penalty=np.ones(f, np.float32),
                is_categorical=np.zeros(f, bool))
    p = dict(lambda_l1=0.0, lambda_l2=1.0, max_delta_step=0.0,
             min_data_in_leaf=20.0, min_sum_hessian_in_leaf=1e-3,
             min_gain_to_split=0.0)
    sums = hist[0].sum(axis=0)
    ref = jsplit.per_feature_numerical(
        jnp.asarray(hist), jnp.float32(sums[0]), jnp.float32(sums[1]),
        jnp.float32(sums[2]),
        jsplit.FeatureMeta(**{k: jnp.asarray(v) for k, v in meta.items()}),
        jsplit.SplitParams(**p, any_missing=True), jnp.float32(-np.inf),
        jnp.float32(np.inf), jnp.ones(f, bool))
    meta_t = tsplit.meta_tensors(tsplit.FeatureMeta(**meta), "cpu")
    got = tsplit.per_feature_numerical(
        torch.from_numpy(hist), sums[0], sums[1], sums[2], meta_t,
        tsplit.SplitParams(**p, any_missing=True))
    np.testing.assert_array_equal(got.threshold.numpy(),
                                  np.asarray(ref.threshold))
    np.testing.assert_array_equal(got.default_left.numpy(),
                                  np.asarray(ref.default_left))
    assert np.isfinite(np.asarray(ref.score)).all()
    for name in ("score", "left_g", "left_h", "left_c", "left_output",
                 "right_output"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def _kernel_prefix(x):
    """The scan kernel's prefix adds in numpy float64 (scan_core.cuh
    plane_prefix, plane_prefix_carry): windows of 32 lanes x 32 bins,
    each lane's running sum from 0.0, a Kogge-Stone scan of the lane
    totals, the exclusive offset (plus the carry after window 0), one
    rounding a bin."""
    x = np.asarray(x, np.float32)
    b = len(x)
    out = np.zeros(b, np.float32)
    carry = 0.0
    for w0 in range(0, b, 1024):
        seg = np.zeros(1024)
        seg[:min(1024, b - w0)] = x[w0:w0 + 1024]
        seg = seg.reshape(32, 32)
        run = np.zeros((32, 32))
        for lane in range(32):
            acc = 0.0
            for i in range(32):
                acc = acc + seg[lane, i]
                run[lane, i] = acc
        incl = run[:, 31].copy()
        for o in (1, 2, 4, 8, 16):
            incl = np.where(np.arange(32) >= o,
                            incl + np.concatenate([np.zeros(o), incl[:-o]]),
                            incl)
        ex = np.concatenate([[0.0], incl[:31]])
        off = ex if w0 == 0 else carry + ex
        carry = incl[31] if w0 == 0 else carry + incl[31]
        vals = (run + off[:, None]).reshape(-1).astype(np.float32)
        out[w0:w0 + 1024] = vals[:min(1024, b - w0)]
    return out


@pytest.mark.parametrize("b", [1, 31, 33, 1023, 1024, 1025, 2048, 4095,
                               12000, 40000])
def test_prefix_order_is_the_kernels(b):
    x = np.random.RandomState(b).randn(b).astype(np.float32) * 100
    got = tsplit._cumsum(torch.from_numpy(x)[None])[0].numpy()
    np.testing.assert_array_equal(got, _kernel_prefix(x))
    np.testing.assert_allclose(got, np.cumsum(x.astype(np.float64)),
                               rtol=1e-5, atol=1e-3)


def test_node_table_holds_rand_bins_past_2_15():
    """extra_trees' rand bins up to 65,534 (the widest threshold) and -1
    (every threshold) survive the node table's 16-bit field."""
    rb = np.asarray([[-1, 0, 32767], [32768, 40000, 65534]])
    table = node_table(rb, None, 3, "cpu")
    for salt in range(2):
        got, mask = node_rows(table, [salt])[0]
        np.testing.assert_array_equal(got.numpy(), rb[salt])
        assert mask.all()


# ---- binning of wide and pooled samples ---------------------------------

def _loop_counts(dv, cn, upper):
    cnt, i_bin = [0] * len(upper), 0
    for i in range(len(dv)):
        if dv[i] > upper[i_bin]:
            i_bin += 1
        cnt[i_bin] += int(cn[i])
    return cnt


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("max_bin", [3, 63, 255, 4095])
def test_greedy_packing_by_bins_is_the_loop(seed, max_bin):
    """The greedy packing a bin at a time (no big value: continuous
    data, up to millions of distinct values in a pooled sample) cuts the
    bounds of the packing loop, a value at a time; the counts in bins
    likewise."""
    from lightgbm_tpu_torch.data import binning as bn
    rng = np.random.RandomState(seed)
    nd = 20000 + seed * 997
    dv = np.unique(rng.randn(nd) * 10)
    cn = rng.randint(1, 4, len(dv)).astype(np.int64)
    total = int(cn.sum()) + seed
    for min_data in (0, 1, 3):
        mb = max(1, min(max_bin, total // min_data)) if min_data else max_bin
        mean = total / mb
        is_big = cn >= mean
        assert not is_big.any()
        args = (dv, cn, mb, mean, mb, total)
        a_up, a_lo = [np.inf] * mb, [np.inf] * mb
        b_up, b_lo = [np.inf] * mb, [np.inf] * mb
        a_lo[0] = b_lo[0] = float(dv[0])
        na = bn._greedy_pack(dv, cn, is_big, *args[2:], a_up, a_lo)
        nb = bn._greedy_pack_no_big(*args, b_up, b_lo)
        assert na == nb and a_up == b_up and a_lo == b_lo
    bounds = bn.greedy_find_bin(dv, cn, max_bin, total, 3)
    assert bn._count_in_bins(dv, cn, bounds) == _loop_counts(dv, cn, bounds)
    # a walk that skips a bin takes the loop
    gap = [float(dv[10]), float(dv[10]) + 1e-9, float(dv[20]), np.inf]
    assert bn._count_in_bins(dv, cn, gap) == _loop_counts(dv, cn, gap)
