"""Port split scan (plain version, CPU) vs the JAX package: the Pallas
scan kernel in interpret mode and ``ops/split.py:per_feature_numerical``.

Exact: which features have a valid split, their threshold and
default_left. Values (score, left sums, outputs) at rtol 1e-5 (atol
1e-6): the port accumulates prefix sums in float64 and rounds once per
bin, the JAX versions in float32, so they differ by float32 rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu.ops.split_scan_pallas import per_feature_numerical_pallas
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.split_scan_cuda import (
    per_feature_numerical_cuda, scan_meta_tables)

torch.set_num_threads(2)
F, B = 8, 32


def _case(seed, missing, monotone=None):
    rng = np.random.RandomState(seed)
    n = 4000
    nb = rng.randint(3, B + 1, F).astype(np.int32)
    nb[0] = 2
    binned = (rng.rand(n, F) * nb).astype(np.int64)
    # every feature carries signal, so no feature's best gain sits at
    # the float32 noise floor of the gain algebra
    signal = ((binned > nb // 2) * rng.choice([-0.4, 0.4], F)).sum(axis=1)
    g = (rng.randn(n) + signal).astype(np.float32)
    h = (0.05 + rng.rand(n) * 0.2).astype(np.float32)
    hist = np.zeros((F, B, 3), np.float32)
    for j in range(F):
        for ch, v in enumerate((g, h, np.ones(n, np.float32))):
            np.add.at(hist[j, :, ch], binned[:, j], v)
    dbin = np.minimum(rng.randint(0, B, F), nb - 1).astype(np.int32)
    meta = dict(num_bins=nb, missing=np.asarray(missing, np.int32),
                default_bin=dbin, most_freq_bin=np.zeros(F, np.int32),
                monotone=np.zeros(F, np.int32) if monotone is None
                else np.asarray(monotone, np.int32),
                penalty=np.linspace(0.5, 1.5, F).astype(np.float32),
                is_categorical=np.zeros(F, bool))
    sums = hist[0].sum(axis=0)
    return hist, meta, sums


MISS_NONE = [0] * F
MISS_MIX = [0, 2, 1, 2, 1, 0, 2, 1]
CASES = {
    "plain": dict(missing=MISS_NONE, params={}),
    "missing": dict(missing=MISS_MIX, params={}),
    "l1": dict(missing=MISS_MIX, params=dict(lambda_l1=0.7)),
    "max_delta_step": dict(missing=MISS_NONE,
                           params=dict(max_delta_step=0.5)),
    "monotone": dict(missing=MISS_MIX, params=dict(lambda_l2=200.0),
                     monotone=[1, -1, 0, 1, 0, -1, 1, 0],
                     bounds=(-0.9, 1.2)),
    "mask": dict(missing=MISS_MIX, params=dict(min_data_in_leaf=50),
                 mask=[True, False, True, True, False, True, True, True]),
}


def _params(over):
    base = dict(lambda_l1=0.0, lambda_l2=0.0, max_delta_step=0.0,
                min_data_in_leaf=20.0, min_sum_hessian_in_leaf=1e-3,
                min_gain_to_split=0.0)
    base.update(over)
    return base


def _run(name, seed=0):
    c = CASES[name]
    hist, meta, sums = _case(seed, c["missing"], c.get("monotone"))
    any_missing = any(c["missing"])
    p = _params(c["params"])
    cmin, cmax = c.get("bounds", (-np.inf, np.inf))
    mask = np.asarray(c.get("mask", [True] * F))
    jmeta = jsplit.FeatureMeta(**{k: jnp.asarray(v)
                                  for k, v in meta.items()})
    jp = jsplit.SplitParams(**p, any_missing=any_missing)
    args = (jnp.asarray(hist), jnp.float32(sums[0]), jnp.float32(sums[1]),
            jnp.float32(sums[2]), jmeta, jp, jnp.float32(cmin),
            jnp.float32(cmax), jnp.asarray(mask))
    ref_xla = jsplit.per_feature_numerical(*args)
    ref_pallas = per_feature_numerical_pallas(*args, interpret=True)
    tmeta = tsplit.FeatureMeta(**meta)
    meta_t = tsplit.meta_tensors(tmeta, "cpu", mask)
    tp = tsplit.SplitParams(**p, any_missing=any_missing)
    got = tsplit.per_feature_numerical(
        torch.from_numpy(hist), sums[0], sums[1], sums[2], meta_t, tp,
        np.float32(cmin), np.float32(cmax))
    return got, ref_xla, ref_pallas, (hist, meta_t, tp, sums, cmin, cmax)


FIELDS = ("score", "left_g", "left_h", "left_c", "left_output",
          "right_output")


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("ref_name", ["xla", "pallas"])
def test_matches_jax(name, ref_name):
    got, ref_xla, ref_pallas, _ = _run(name)
    ref = ref_xla if ref_name == "xla" else ref_pallas
    fin = np.isfinite(np.asarray(ref.score))
    assert fin.any()
    np.testing.assert_array_equal(np.isfinite(got.score.numpy()), fin)
    np.testing.assert_array_equal(got.threshold.numpy()[fin],
                                  np.asarray(ref.threshold)[fin])
    np.testing.assert_array_equal(got.default_left.numpy()[fin],
                                  np.asarray(ref.default_left)[fin])
    for field in FIELDS:
        np.testing.assert_allclose(
            getattr(got, field).numpy()[fin],
            np.asarray(getattr(ref, field))[fin], rtol=1e-5, atol=1e-6,
            err_msg=field)


@pytest.mark.parametrize("name", ["missing", "monotone"])
def test_best_split_matches_jax(name):
    _, _, _, (hist, meta_t, tp, sums, cmin, cmax) = _run(name)
    c = CASES[name]
    _, meta, _ = _case(0, c["missing"], c.get("monotone"))
    jmeta = jsplit.FeatureMeta(**{k: jnp.asarray(v)
                                  for k, v in meta.items()})
    ref = jsplit.best_split_numerical(
        jnp.asarray(hist), jnp.float32(sums[0]), jnp.float32(sums[1]),
        jnp.float32(sums[2]), jmeta,
        jsplit.SplitParams(**_params(c["params"]), any_missing=True),
        jnp.float32(cmin), jnp.float32(cmax))
    got = tsplit.best_split_numerical(torch.from_numpy(hist), *sums,
                                      meta_t, tp, cmin, cmax)
    assert got.feature == int(ref.feature)
    assert got.threshold == int(ref.threshold)
    assert got.default_left == bool(ref.default_left)
    np.testing.assert_allclose(
        [got.gain, got.left_g, got.left_h, got.left_output,
         got.right_output],
        np.asarray([ref.gain, ref.left_g, ref.left_h, ref.left_output,
                    ref.right_output]), rtol=1e-5, atol=1e-6)


def test_batched_wrapper_stacks_both_children():
    got_a, *_, (hist, meta_t, tp, sums, cmin, cmax) = _run("missing")
    hist_b = np.ascontiguousarray(hist[:, ::-1])   # a different leaf
    sums_b = hist_b[0].sum(axis=0)
    table = per_feature_numerical_cuda(
        [torch.from_numpy(hist), torch.from_numpy(hist_b)],
        [(*sums, cmin, cmax), (*sums_b, cmin, cmax)], meta_t, tp,
        scan_meta_tables(meta_t))
    assert table.shape == (2, F, 8)
    again = tsplit.scan_table(got_a)
    np.testing.assert_array_equal(table[0].numpy(), again.numpy())
    one = tsplit.scan_table(tsplit.per_feature_numerical(
        torch.from_numpy(hist_b), *sums_b, meta_t, tp, cmin, cmax))
    np.testing.assert_array_equal(table[1].numpy(), one.numpy())


@pytest.mark.parametrize("missing", ["none", "mix"])
@pytest.mark.parametrize("ref_name", ["xla", "pallas"])
def test_matches_jax_at_1024_bins(missing, ref_name):
    """The plain scan at B = 1024 (the serial learner's widest bins, the
    scan kernel's new capacity) against both JAX scans."""
    b = 1024
    rng = np.random.RandomState(7)
    n = 20000
    nb = np.full(F, b, np.int32)
    nb[1] = 700
    binned = (rng.rand(n, F) * nb).astype(np.int64)
    signal = ((binned > nb // 2) * rng.choice([-0.4, 0.4], F)).sum(axis=1)
    g = (rng.randn(n) + signal).astype(np.float32)
    h = (0.05 + rng.rand(n) * 0.2).astype(np.float32)
    hist = np.zeros((F, b, 3), np.float32)
    for j in range(F):
        for ch, v in enumerate((g, h, np.ones(n, np.float32))):
            np.add.at(hist[j, :, ch], binned[:, j], v)
    miss = MISS_NONE if missing == "none" else MISS_MIX
    meta = dict(num_bins=nb, missing=np.asarray(miss, np.int32),
                default_bin=np.full(F, 300, np.int32),
                most_freq_bin=np.zeros(F, np.int32),
                monotone=np.zeros(F, np.int32),
                penalty=np.ones(F, np.float32),
                is_categorical=np.zeros(F, bool))
    sums = hist[0].sum(axis=0)
    p = _params({})
    jmeta = jsplit.FeatureMeta(**{k: jnp.asarray(v)
                                  for k, v in meta.items()})
    jp = jsplit.SplitParams(**p, any_missing=missing != "none")
    args = (jnp.asarray(hist), jnp.float32(sums[0]), jnp.float32(sums[1]),
            jnp.float32(sums[2]), jmeta, jp, jnp.float32(-np.inf),
            jnp.float32(np.inf), jnp.ones((F,), bool))
    ref = jsplit.per_feature_numerical(*args) if ref_name == "xla" \
        else per_feature_numerical_pallas(*args, interpret=True)
    meta_t = tsplit.meta_tensors(tsplit.FeatureMeta(**meta), "cpu")
    got = tsplit.per_feature_numerical(
        torch.from_numpy(hist), sums[0], sums[1], sums[2], meta_t,
        tsplit.SplitParams(**p, any_missing=missing != "none"))
    fin = np.isfinite(np.asarray(ref.score))
    assert fin.all()
    np.testing.assert_array_equal(np.isfinite(got.score.numpy()), fin)
    np.testing.assert_array_equal(got.threshold.numpy(),
                                  np.asarray(ref.threshold))
    np.testing.assert_array_equal(got.default_left.numpy(),
                                  np.asarray(ref.default_left))
    for field in FIELDS:
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(ref, field)),
                                   rtol=1e-5, atol=1e-5, err_msg=field)
    # the wrapper takes 1024 bins (on the CPU, the plain version)
    table = per_feature_numerical_cuda([torch.from_numpy(hist)],
                                       [(*sums, -np.inf, np.inf)], meta_t,
                                       tsplit.SplitParams(
                                           **p, any_missing=missing != "none"))
    np.testing.assert_array_equal(table[0].numpy(),
                                  tsplit.scan_table(got).numpy())


def test_argmax_tie_rules():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0], [-np.inf] * 4])
    assert tsplit._argmax_first(x, 1).tolist() == [1, 0]
    assert tsplit._argmax_last(x, 1).tolist() == [2, 3]
    jx = jnp.asarray(x.numpy())
    assert np.asarray(jsplit._argmax_last(jx, 1)).tolist() == [2, 3]


def _blocked_prefix_reference(x: np.ndarray) -> np.ndarray:
    """The kernel's prefix order (``csrc/scan_core.cuh:plane_prefix``)
    written bin by bin: float64, 32-bin segments each summed in bin
    order from 0.0, a Kogge-Stone scan over the segment totals (step o =
    1, 2, 4, 8, 16: lane i adds lane i - o's value from before the
    step), then each bin's running sum plus its segment's exclusive
    offset, rounded once to float32."""
    b = len(x)
    nseg = -(-b // 32)
    run, tot = [], []
    for s in range(nseg):
        acc = 0.0
        for i in range(32):
            acc += float(x[s * 32 + i]) if s * 32 + i < b else 0.0
            run.append(acc)
        tot.append(acc)
    lanes = tot + [0.0] * (32 - nseg)
    for o in (1, 2, 4, 8, 16):
        prev = list(lanes)
        for i in range(o, 32):
            lanes[i] = prev[i] + prev[i - o]
    out = [run[s * 32 + i] + (lanes[s - 1] if s else 0.0)
           for s in range(nseg) for i in range(32)]
    return np.asarray(out[:b], np.float64).astype(np.float32)


@pytest.mark.parametrize("b", [1, 31, 32, 33, 255, 256, 1023, 1024])
def test_plain_prefix_sums_follow_the_kernel_order(b):
    """``_cumsum`` (the plain version's prefix sums) adds in the scan
    kernel's fixed block order, bit for bit, over leading batch axes;
    against a sequential float64 cumsum rounded once it differs by at
    most one float32 rounding."""
    rng = np.random.RandomState(b)
    x = (rng.randn(2, 3, b) * np.exp(rng.randn(2, 3, b) * 4)).astype(
        np.float32)
    got = tsplit._cumsum(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    for i in range(2):
        for j in range(3):
            ref = _blocked_prefix_reference(x[i, j])
            assert got[i, j].tobytes() == ref.tobytes()
    seq = np.cumsum(x.astype(np.float64), axis=-1).astype(np.float32)
    np.testing.assert_allclose(got, seq, rtol=2 ** -23, atol=0)


def _cand_key(score: np.float32, t: int, minus: bool) -> int:
    """``csrc/scan_core.cuh:cand_key``: the score's bits made monotone
    above, the direction and threshold below."""
    u = int(np.float32(score).view(np.uint32))
    hi = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    lo = (0x800 | t) if minus else (0x3FF - t)
    return (hi << 32) | lo


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("b", [1, 2, 7, 64, 1024])
def test_one_key_argmax_follows_the_tie_rules(seed, b):
    """The scan kernel reduces both directions' candidates to one
    winner by the largest ``cand_key``; that is the plain version's
    rule: the right-to-left scan's last argmax, the left-to-right
    scan's first, and right-to-left on equal scores (all -inf
    included). Scores come from a few values, so ties are common."""
    rng = np.random.RandomState(seed * 1031 + b)
    vals = np.asarray([-np.inf, 0.25, 0.5, 3.0], np.float32)
    sm = vals[rng.randint(0, len(vals), b)]
    sp = vals[rng.randint(0, len(vals), b)]
    if seed == 0:
        sm[:] = sp[:] = -np.inf
    keys = [_cand_key(sm[t], t, True) for t in range(b)] \
        + [_cand_key(sp[t], t, False) for t in range(b)]
    win = max(keys)
    minus = bool(win & 0x800)
    t = (win & 0x3FF) if minus else 0x3FF - (win & 0xFFF)
    tm = tsplit._argmax_last(torch.from_numpy(sm)[None], 1).item()
    tp = tsplit._argmax_first(torch.from_numpy(sp)[None], 1).item()
    use_m = sm[tm] >= sp[tp]
    assert minus == use_m
    assert t == (tm if use_m else tp)
    score = np.uint32((win >> 32) & 0x7FFFFFFF) if win >> 63 \
        else np.uint32(~(win >> 32) & 0xFFFFFFFF)
    assert score.view(np.float32) == (sm[tm] if use_m else sp[tp])
