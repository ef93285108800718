"""The port's serial (leaf_id) learner (``lightgbm_tpu_torch/learner/
serial.py``) and the ops it runs, against the JAX package on the CPU.

* ``SerialTreeLearner`` against the JAX ``SerialTreeLearner`` on both
  grow loops (``LGBM_TPU_FUSED_SPLIT_KERNEL=0``: the per-phase loop;
  ``=1``: the fused step, its plain version here and the JAX interpret
  twin there) at 255 bins (u8) and ~600 bins (u16): tree structure
  exact, leaf values at rtol 1e-5 / atol 1e-5, ``leaf_id`` equal. The
  gradients are multiples of 2**-10, so every histogram sum is exact in
  float32 in any order: the JAX scatter sums in float32, the port in
  float64, and with inexact sums a threshold next to a bin that is empty
  in the leaf ties with its neighbour up to rounding noise, which the two
  break differently (ROADMAP Queue 3).
* The slice as a whole: ``lt.train`` at ``max_bin=600`` (which
  ``create_tree_learner`` gives to the serial learner) against the JAX
  package's serial training, both grow loops, on binary gradients.
* ``split_leaf``, ``make_ghc`` and ``build_histogram`` against the JAX
  functions; ``create_tree_learner`` against the JAX accelerator rule.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data import Dataset as JDataset
from lightgbm_tpu.learner.serial import SerialTreeLearner as JSerial
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data import Dataset
from lightgbm_tpu_torch.learner import (PartitionedTreeLearner,
                                        SerialTreeLearner)

torch.set_num_threads(2)
BASE = {"objective": "binary", "num_leaves": 15, "verbosity": -1}


def _data(seed=0, n=3000, f=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.1, 2] = np.nan            # NaN-missing feature
    X[rng.rand(n) < 0.3, 3] = 0.0               # zero-heavy feature
    y = (1.5 * X[:, 0] - X[:, 1] + 0.5 * np.nan_to_num(X[:, 2])
         + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return X, y


def _fixed_point(x):
    """Multiples of 2**-10: sums of a few thousand stay exact in f32."""
    return (np.round(np.asarray(x, np.float64) * 1024) / 1024).astype(
        np.float32)


def _grads(y, tree):
    """Binary gradients of a seeded score, one set per tree."""
    s = np.random.RandomState(10 + tree).randn(y.shape[0])
    p = 1.0 / (1.0 + np.exp(-s))
    return _fixed_point(p - y), np.maximum(_fixed_point(p * (1 - p)),
                                           np.float32(2.0 ** -10))


def _tree_matches(jt, tt, what):
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
    np.testing.assert_allclose(tt.leaf_value[:k],
                               np.asarray(jt.leaf_value)[:k], rtol=1e-5,
                               atol=1e-5, err_msg=f"{what} leaf_value")


@pytest.mark.parametrize("fused", ["0", "1"], ids=["per_phase", "fused"])
@pytest.mark.parametrize("max_bin", [255, 600])
def test_learner_matches_jax_serial(monkeypatch, max_bin, fused):
    monkeypatch.setenv("LGBM_TPU_FUSED_SPLIT_KERNEL", fused)
    X, y = _data()
    params = dict(BASE, max_bin=max_bin)
    jcfg = JConfig.from_params(params)
    jl = JSerial(JDataset.from_numpy(X, jcfg, label=y), jcfg)
    cfg = Config.from_params(params)
    ds = Dataset.from_numpy(X, cfg, label=y)
    tl = SerialTreeLearner(ds, cfg, torch.device("cpu"))
    assert tl.fused == (fused == "1")
    assert tl.num_bins_max == jl.num_bins_max
    assert ds.binned.dtype == (np.uint8 if max_bin <= 255 else np.uint16)
    for tree in range(3):
        g, h = _grads(y, tree)
        jr = jl.train(jnp.asarray(g), jnp.asarray(h))
        tt, lid = tl.train(torch.from_numpy(g), torch.from_numpy(h))
        _tree_matches(jr.tree, tt, f"tree {tree}")
        np.testing.assert_array_equal(lid.numpy(), np.asarray(jr.leaf_id))
        assert tt.num_leaves > 8


@pytest.mark.parametrize("fused", ["0", "1"], ids=["per_phase", "fused"])
def test_plain_ops_match_jax_serial_past_256_bins(monkeypatch, fused):
    """``ops="plain"`` (the plain versions the card's parity run uses:
    ``build_histogram`` for the root and the per-phase children) at 600
    bins, both grow loops, against the JAX ``SerialTreeLearner``; no
    kernel is counted."""
    from lightgbm_tpu_torch.ops import _native
    monkeypatch.setenv("LGBM_TPU_FUSED_SPLIT_KERNEL", fused)
    X, y = _data(5)
    params = dict(BASE, max_bin=600)
    jcfg = JConfig.from_params(params)
    jl = JSerial(JDataset.from_numpy(X, jcfg, label=y), jcfg)
    cfg = Config.from_params(params)
    tl = SerialTreeLearner(Dataset.from_numpy(X, cfg, label=y), cfg,
                           torch.device("cpu"), ops="plain")
    assert tl.plain and tl._partial is None
    assert tl.fused == (fused == "1")
    before = dict(_native.LAUNCHES)
    for tree in range(3):
        g, h = _grads(y, tree)
        jr = jl.train(jnp.asarray(g), jnp.asarray(h))
        tt, lid = tl.train(torch.from_numpy(g), torch.from_numpy(h))
        _tree_matches(jr.tree, tt, f"tree {tree}")
        np.testing.assert_array_equal(lid.numpy(), np.asarray(jr.leaf_id))
        assert tt.num_leaves > 8
    assert dict(_native.LAUNCHES) == before


def test_per_phase_row_ids_grow_the_masked_bytes():
    """The per-phase loop's card route for the smaller child (its row
    ids in row order through ``histogram_rows``, here its plain version)
    grows the same bytes as the masked-ghc ``build_histogram``."""
    from lightgbm_tpu_torch.ops.hist_cuda import rows_partial
    X, y = _data(6)
    cfg = Config.from_params(dict(BASE, max_bin=600,
                                  fused_split_kernel="off"))
    ds = Dataset.from_numpy(X, cfg, label=y)
    grown = []
    for ids in (False, True):
        lrn = SerialTreeLearner(ds, cfg, torch.device("cpu"))
        assert not lrn.fused and lrn._partial is None
        if ids:
            lrn._partial = rows_partial(lrn.binned, lrn.num_bins_max)
        out = []
        for tree in range(2):
            g, h = _grads(y, tree)
            t, lid = lrn.train(torch.from_numpy(g), torch.from_numpy(h))
            out.append((t, lid.clone()))
        grown.append(out)
    for (ta, la), (tb, lb) in zip(*grown):
        assert _structure(ta) == _structure(tb)
        assert ta.leaf_value.tobytes() == tb.leaf_value.tobytes()
        assert ta.internal_value.tobytes() == tb.internal_value.tobytes()
        assert la.numpy().tobytes() == lb.numpy().tobytes()


def _structure(t):
    return (t.num_leaves, t.split_feature_inner.tolist(),
            t.threshold_bin.tolist(), (t.decision_type & 2).tolist(),
            t.left_child.tolist(), t.right_child.tolist())


@pytest.mark.parametrize("mode", ["off", "on"])
def test_training_past_256_bins_matches_jax(mode):
    """The slice as a whole on binary gradients (data whose splits carry
    no threshold ties; see the module note)."""
    X, y = _data(1)
    params = dict(BASE, max_bin=600, fused_split_kernel=mode)
    port = lt.train(params, lt.Dataset(X, label=y), 4, device="cpu")
    lrn = port._gbdt.learner
    assert isinstance(lrn, SerialTreeLearner) and lrn.num_bins_max == 600
    assert lrn.fused == (mode == "on")
    jb = lgb.train(dict(params, tree_learner="serial"),
                   lgb.Dataset(X, label=y), num_boost_round=4,
                   verbose_eval=False)
    assert len(port.models) == len(jb._gbdt.models) == 4
    for a, b in zip(jb._gbdt.models, port.models):
        assert _structure(b) == _structure(a)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(port.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)


def test_fused_on_is_byte_identical_to_off():
    """The plain fused step is the per-phase loop's bookkeeping with the
    same ops, so the two grow the same bytes, leaf_id included."""
    X, y = _data(2)
    out = {}
    for mode in ("on", "off"):
        cfg = Config.from_params(dict(BASE, max_bin=600,
                                      fused_split_kernel=mode))
        lrn = SerialTreeLearner(Dataset.from_numpy(X, cfg, label=y), cfg,
                                torch.device("cpu"))
        assert lrn.fused == (mode == "on")
        out[mode] = []
        for tree in range(2):
            g, h = _grads(y, tree)
            t, lid = lrn.train(torch.from_numpy(g), torch.from_numpy(h))
            out[mode].append((t, lid.clone()))
    fields = ("num_leaves", "split_feature_inner", "threshold_bin",
              "decision_type", "left_child", "right_child", "split_gain",
              "internal_value", "internal_weight", "internal_count",
              "leaf_value", "leaf_weight", "leaf_count", "leaf_parent",
              "leaf_depth")
    for (ta, la), (tb, lb) in zip(out["on"], out["off"]):
        for fld in fields:
            assert np.asarray(getattr(ta, fld)).tobytes() \
                == np.asarray(getattr(tb, fld)).tobytes(), fld
        assert la.numpy().tobytes() == lb.numpy().tobytes()


@pytest.mark.parametrize("miss,dbin,nbin", [(0, 0, 40), (1, 7, 40),
                                            (2, 0, 40)])
@pytest.mark.parametrize("dleft", [False, True])
def test_split_leaf_matches_jax(miss, dbin, nbin, dleft):
    from lightgbm_tpu.ops.partition import split_leaf as jsplit_leaf
    from lightgbm_tpu.ops.split import MAX_CAT_WORDS
    from lightgbm_tpu_torch.ops.partition import split_leaf
    rng = np.random.RandomState(miss + 3 * dleft)
    n = 1000
    lid = rng.randint(0, 4, n).astype(np.int32)
    bins = rng.randint(0, nbin, n).astype(np.uint16)
    want = jsplit_leaf(jnp.asarray(lid), jnp.asarray(bins), 2, 5, 17,
                       dleft, miss, dbin, nbin, False,
                       jnp.zeros((MAX_CAT_WORDS,), jnp.uint32))
    got = split_leaf(torch.from_numpy(lid),
                     torch.from_numpy(bins.view(np.int16)), 2, 5, 17, dleft,
                     miss, dbin, nbin)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("b,dtype", [(255, np.uint8), (1023, np.uint16)])
@pytest.mark.parametrize("masked", [False, True])
def test_histogram_matches_jax(b, dtype, masked):
    """make_ghc + build_histogram against the JAX scatter histogram:
    counts exact, sums within float32 rounding (the port rounds a
    float64 sum once, the JAX scatter sums in float32)."""
    from lightgbm_tpu.ops import histogram as jh
    from lightgbm_tpu_torch.ops import histogram as th
    rng = np.random.RandomState(b)
    n, f = 4000, 5
    bins = rng.randint(0, b, (n, f)).astype(dtype)
    g = rng.randn(n).astype(np.float32)
    h = rng.rand(n).astype(np.float32)
    w = (rng.rand(n) < 0.6).astype(np.float32) if masked else None
    jghc = jh.make_ghc(jnp.asarray(g), jnp.asarray(h),
                       None if w is None else jnp.asarray(w))
    tghc = th.make_ghc(torch.from_numpy(g), torch.from_numpy(h),
                       None if w is None else torch.from_numpy(w))
    np.testing.assert_array_equal(tghc.numpy(), np.asarray(jghc))
    held = torch.from_numpy(bins.view(np.int16) if dtype == np.uint16
                            else bins)
    got = th.build_histogram(held, tghc, b).numpy()
    want = np.asarray(jh.build_histogram(jnp.asarray(bins), jghc, b,
                                         method="scatter"))
    assert got.shape == want.shape == (f, b, 3)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    scale = th.build_histogram(held, tghc.abs(), b).numpy()
    assert (np.abs(got - want) <= 1e-6 * scale + 1e-7).all()


@pytest.mark.parametrize("max_bin,learner_type", [
    (255, "serial"), (255, "partitioned"), (600, "serial")])
def test_create_tree_learner_follows_the_jax_accelerator_rule(
        max_bin, learner_type):
    """The JAX package on an accelerator (learners.py:655): bins that fit
    a byte go to the partitioned learner, wider ones to the serial
    learner; ``partitioned`` always gives the partitioned learner."""
    from lightgbm_tpu_torch.parallel import create_tree_learner
    X, y = _data(3, n=2000)
    cfg = Config.from_params(dict(BASE, max_bin=max_bin,
                                  tree_learner=learner_type))
    ds = Dataset.from_numpy(X, cfg, label=y)
    fits_u8 = int(ds.num_bins_array().max()) <= 256
    lrn = create_tree_learner(learner_type, ds, cfg, torch.device("cpu"))
    want = PartitionedTreeLearner if (
        learner_type == "partitioned" or fits_u8) else SerialTreeLearner
    assert type(lrn) is want
    assert fits_u8 == (max_bin <= 255)


def test_partitioned_learner_past_256_bins_is_refused():
    """Past 256 bins the partitioned learner raises the JAX package's
    ValueError (``lightgbm_tpu/learner/partitioned.py:141-145``): its
    matrix packs bins as uint8."""
    from lightgbm_tpu.learner.partitioned import \
        PartitionedTreeLearner as JPartitioned
    X, y = _data(4)
    params = dict(BASE, max_bin=600, tree_learner="partitioned")
    cfg = Config.from_params(params)
    with pytest.raises(ValueError, match="packs bins as uint8") as port:
        lt.train(params, lt.Dataset(X, label=y), 1, device="cpu")
    jcfg = JConfig.from_params(params)
    with pytest.raises(ValueError, match="packs bins as uint8") as ref:
        JPartitioned(JDataset.from_numpy(X, jcfg, label=y), jcfg)
    assert str(port.value).split(" packs")[1] \
        == str(ref.value).split(" packs")[1]
    assert cfg.tree_learner == "partitioned"
