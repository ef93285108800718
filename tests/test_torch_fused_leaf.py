"""The fused split step of the serial learner on the leaf_id layout
(``lightgbm_tpu_torch/ops/split_step_cuda.py:fused_split_step_leaf``) on
the CPU, against the JAX package's fused step
(``lightgbm_tpu/ops/split_step_pallas.py:fused_split_step_leaf``, run
through its interpret twin ``_leaf_kernel_ref`` as
``tests/test_split_megakernel.py`` runs it).

One JAX root state, carried across by ``convert.grow_state_from_jax``
(``S``, ``T``, ``leaf_id``, the histogram cache), is stepped in both
packages until both trees are done, and twice more: those launches
fail the grow loop's condition and must change nothing. After every
step: ``k`` and ``leaf_id`` equal, the int rows of ``S``/``T`` exact,
the float rows at rtol 1e-5 / atol 1e-5, the cache within 1e-5 x the
bin's sum of |values| over all rows with counts exact. The gradients
are multiples of 2**-10, so the twin's float32 scatter and the port's
float64 histogram sums are both exact and no near tie can flip.

A split's gain (``bs_gain`` in ``S``, ``split_gain_arr`` in ``T``) is
the difference of two gains of the leaf's own size (the split's and the
parent's ``gain_shift``, about g**2 / h): XLA and PyTorch round those
by an ulp or two apart, so it is held to 1e-5 x that size, not to its
own (on this data: 2.13320 against 2.13330, a difference of two ulps
of a gain near 400).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data import Dataset as JDataset
from lightgbm_tpu.learner.serial import SerialTreeLearner as JSerial
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import grow_state_from_jax
from lightgbm_tpu_torch.data import Dataset
from lightgbm_tpu_torch.learner import SerialTreeLearner
from lightgbm_tpu_torch.ops import split_step_cuda as ssc
from lightgbm_tpu_torch.ops.histogram import build_histogram, make_ghc

torch.set_num_threads(2)
L = 15
BASE = {"objective": "binary", "num_leaves": L, "verbosity": -1}
CONFIGS = {
    "u8": {"max_bin": 255},
    "u16": {"max_bin": 600},
    "constrained": {"max_bin": 600,
                    "monotone_constraints": [1, -1, 0, 0, 0, 0],
                    "max_depth": 4, "lambda_l1": 0.2, "lambda_l2": 1.0,
                    "max_delta_step": 2.0, "min_data_in_leaf": 30},
}


def _data(seed=0, n=3000, f=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.1, 2] = np.nan            # NaN-missing feature
    X[rng.rand(n) < 0.3, 3] = 0.0               # zero-heavy feature
    y = (1.5 * X[:, 0] - X[:, 1] + 0.5 * np.nan_to_num(X[:, 2])
         + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return X, y


def _grads(y):
    """Binary gradients of a seeded score in [0.05, 0.95], so that no
    row's gradient is near 0 (a bin of such rows moves a split's gain by
    less than the gain's rounding, ROADMAP Queue 3), as multiples of
    2**-10."""
    p = np.random.RandomState(5).uniform(0.05, 0.95, y.shape[0])
    q = lambda x: (np.round(x * 1024) / 1024).astype(np.float32)  # noqa
    return q(p - y), q(p * (1 - p))


def _jax_root(jl, grad, hess):
    """The JAX serial grow loop's state after its root (JAX
    learner/serial.py:804-1025, serial comm, scatter histograms)."""
    from lightgbm_tpu.learner.comm import SERIAL_COMM
    from lightgbm_tpu.learner.split_step import (make_grow_pack,
                                                 make_scan_leaf)
    from lightgbm_tpu.ops.histogram import build_histogram as jbuild
    from lightgbm_tpu.ops.histogram import make_ghc as jmake_ghc
    from lightgbm_tpu.ops.split import leaf_output_no_constraint
    n, f, b = jl.dataset.num_data, jl.dataset.num_features, jl.num_bins_max
    ghc = jmake_ghc(jnp.asarray(grad), jnp.asarray(hess))
    root = jbuild(jl.binned, ghc, b, method="scatter")
    g, h, c = ghc.sum(axis=0)
    scan = make_scan_leaf(SERIAL_COMM, jl.meta, jl.params,
                          jnp.ones((f,), bool), lambda salt: (None, None),
                          False, jl.max_depth)
    inf = jnp.float32(jnp.inf)
    rs = scan(root, g, h, c, jnp.int32(0), -inf, inf, jnp.int32(0))
    p = jl.params
    root_out = leaf_output_no_constraint(g, h + 2e-15, p.lambda_l1,
                                         p.lambda_l2, p.max_delta_step)
    f32, i32 = jnp.float32, jnp.int32

    def at0(fill, val, dtype, size=L):
        return jnp.full((size,), fill, dtype).at[0].set(val)

    m = L - 1
    fields = dict(
        leaf_g=at0(0.0, g, f32), leaf_h=at0(0.0, h, f32),
        leaf_c=at0(0.0, c, f32), bs_gain=at0(-jnp.inf, rs.gain, f32),
        bs_feat=at0(0, rs.feature, i32), bs_thr=at0(0, rs.threshold, i32),
        bs_dleft=at0(False, rs.default_left, bool),
        bs_lg=at0(0.0, rs.left_g, f32), bs_lh=at0(0.0, rs.left_h, f32),
        bs_lc=at0(0.0, rs.left_c, f32),
        bs_lout=at0(0.0, rs.left_output, f32),
        bs_rout=at0(0.0, rs.right_output, f32),
        bs_iscat=jnp.zeros((L,), bool), ref_node=jnp.full((L,), -1, i32),
        ref_side=jnp.zeros((L,), i32),
        leaf_cmin=jnp.full((L,), -jnp.inf, f32),
        leaf_cmax=jnp.full((L,), jnp.inf, f32),
        leaf_value=at0(0.0, root_out, f32),
        leaf_weight=at0(0.0, h, f32), leaf_count=at0(0.0, c, f32),
        leaf_parent=jnp.full((L,), -1, i32), leaf_depth=jnp.zeros((L,), i32),
        split_feature=jnp.zeros((m,), i32),
        threshold_bin=jnp.zeros((m,), i32),
        decision_type=jnp.zeros((m,), i32), left_child=jnp.zeros((m,), i32),
        right_child=jnp.zeros((m,), i32),
        split_gain_arr=jnp.zeros((m,), f32),
        internal_value=jnp.zeros((m,), f32),
        internal_weight=jnp.zeros((m,), f32),
        internal_count=jnp.zeros((m,), f32))
    pack = make_grow_pack((), merged=True, has_cat=False,
                          has_monotone=jl.has_monotone, big_l=L)
    st = pack.pack(fields)
    hist = jnp.zeros((L, f, b, 3), jnp.float32).at[0].set(root)
    return dict(k=1, S=st["S"], T=st["T"], lid=jnp.zeros((n,), jnp.int32),
                hist=hist, ghc=ghc)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request):
    """Both packages' learners on the same data, the JAX root state, and
    the port's inputs."""
    X, y = _data()
    params = dict(BASE, **CONFIGS[request.param])
    jcfg = JConfig.from_params(params)
    jl = JSerial(JDataset.from_numpy(X, jcfg, label=y), jcfg)
    cfg = Config.from_params(params)
    tl = SerialTreeLearner(Dataset.from_numpy(X, cfg, label=y), cfg,
                           torch.device("cpu"))
    grad, hess = _grads(y)
    js = _jax_root(jl, grad, hess)
    ghc = make_ghc(torch.from_numpy(grad), torch.from_numpy(hess))
    return request.param, jl, tl, ghc, js


def _port_state(js):
    st = grow_state_from_jax(np.asarray(js["S"]), np.asarray(js["T"]),
                             np.asarray(js["hist"]),
                             leaf_id=np.asarray(js["lid"]))
    st["k"] = torch.tensor([js["k"]], dtype=torch.int32)
    return st


def _port_step(tl, st, ghc, imeta, fmeta):
    ssc.fused_split_step_leaf(
        st["k"], st["S"], st["T"], st["lid"], st["hist"], tl.binned, ghc,
        imeta, fmeta, params=tl.params, big_l=L, max_depth=tl.max_depth,
        b=tl.num_bins_max, has_monotone=tl.has_monotone)


def _assert_packed_close(port, jax_mat, n_float, what, gain_row,
                         gain_size):
    """Int rows exact, float rows at rtol/atol 1e-5, the gain row at
    1e-5 x (|gain| + gain_size) (see the module note)."""
    a = port.numpy()
    b = np.asarray(jax_mat)
    assert a[n_float:].view(np.int32).tolist() \
        == b[n_float:].view(np.int32).tolist(), what
    rows = [r for r in range(n_float) if r != gain_row]
    np.testing.assert_allclose(a[rows], b[rows], rtol=1e-5, atol=1e-5,
                               err_msg=what)
    ga, gb = a[gain_row], b[gain_row]
    assert np.array_equal(np.isfinite(ga), np.isfinite(gb)), what
    fin = np.isfinite(gb)
    np.testing.assert_array_equal(ga[~fin], gb[~fin], err_msg=what)
    assert (np.abs(ga[fin] - gb[fin])
            <= 1e-5 * (np.abs(gb[fin]) + gain_size[fin]) + 1e-5).all(), what


SPLIT_FIELDS = ("bs_lg", "bs_lh", "bs_lc", "bs_lout", "bs_rout")


def _defined_split_fields(pack, jS):
    """The JAX state's split fields as the port stores them: a leaf
    without a valid split (bs_gain -inf) keeps the twin's value where it
    is finite and 0 where the twin's is not (an output of 0/0 or x/0 at
    an invalid threshold; ``learner/split_step.py``
    ``defined_split_fields``)."""
    jS = np.array(jS)
    dead = np.isneginf(jS[pack.sf_idx["bs_gain"]])
    for name in SPLIT_FIELDS:
        row = jS[pack.sf_idx[name]]
        row[dead & ~np.isfinite(row)] = 0.0
    return jS


def _assert_state_close(pack, S, T, jS, jT, what):
    """``S`` and ``T`` of both packages; the gain sizes g**2 / h come
    from the JAX state (T: internal_value**2 x internal_weight). The
    split fields of a leaf without a valid split are finite in the port
    (``_defined_split_fields``)."""
    jS, jT = _defined_split_fields(pack, jS), np.asarray(jT)
    for name in SPLIT_FIELDS:
        assert np.isfinite(S[pack.sf_idx[name]].numpy()).all(), (what, name)
    g = jS[pack.sf_idx["leaf_g"]]
    h = np.maximum(jS[pack.sf_idx["leaf_h"]], 1e-3)
    _assert_packed_close(S, jS, len(pack.sf_fields), f"S {what}",
                         pack.sf_idx["bs_gain"], g * g / h)
    v = jT[pack.tf_idx["internal_value"]]
    w = jT[pack.tf_idx["internal_weight"]]
    _assert_packed_close(T, jT, len(pack.tf_fields), f"T {what}",
                         pack.tf_idx["split_gain_arr"], v * v * np.abs(w))


def test_inputs_and_root_state_carry_across(setup):
    """The binned matrix, ghc and the port's own root state agree with
    the JAX package's."""
    from lightgbm_tpu_torch.learner.split_step import root_state
    from lightgbm_tpu_torch.ops.split_scan_cuda import \
        per_feature_numerical_plain
    _, jl, tl, ghc, js = setup
    np.testing.assert_array_equal(tl.binned.numpy(), np.asarray(jl.binned))
    np.testing.assert_array_equal(ghc.numpy(), np.asarray(js["ghc"]))
    root = build_histogram(tl.binned, ghc, tl.num_bins_max)
    sums = root[0].sum(dim=0).numpy()
    inf = np.float32(np.inf)
    table = per_feature_numerical_plain(
        [root], [tuple(sums) + (-inf, inf)], tl._meta_all, tl.params)[0]
    st = root_state(tl.pack, table, *sums, tl.num_data, tl.params, L)
    _assert_state_close(tl.pack, st["S"], st["T"], js["S"], js["T"],
                        "of the root")
    assert st["S"].shape[0] == ssc.state_rows(tl.has_monotone, "leaf")


def test_steps_match_jax_twin(setup):
    from lightgbm_tpu.ops.split_step_pallas import (fused_split_step_leaf,
                                                    pack_meta_tables)
    name, jl, tl, ghc, js = setup
    st = _port_state(js)
    imeta, fmeta = ssc.pack_meta_tables(tl.meta, None, "cpu")
    jim, jfm = pack_meta_tables(jl.meta, jnp.ones((tl.num_features,), bool))
    np.testing.assert_array_equal(imeta.numpy(), np.asarray(jim))
    np.testing.assert_array_equal(fmeta.numpy(), np.asarray(jfm))
    b = tl.num_bins_max
    scale = build_histogram(tl.binned, ghc.abs(), b).numpy()
    # copies: the JAX step donates its buffers, and the fixture's state
    # serves the other tests
    jk = js["k"]
    S, T, lid, hist = (jnp.array(js[x]) for x in ("S", "T", "lid", "hist"))
    binned, jghc = jnp.asarray(jl.binned), js["ghc"]
    splits = failed = 0
    for _ in range(L + 1):
        gains = np.asarray(S[tl.pack.sf_idx["bs_gain"]])
        # the JAX grow loop's condition (the twin itself does not check)
        open_ok = jk < L and np.where(np.arange(L) < jk, gains,
                                      -np.inf).max() > 0.0
        _port_step(tl, st, ghc, imeta, fmeta)
        if open_ok:
            S, T, lid, hist = fused_split_step_leaf(
                jnp.int32(jk), S, T, lid, hist, binned, jghc, jim, jfm,
                params=jl.params, si_prefix=(), big_l=L,
                max_depth=jl.max_depth, b=b, bundled=False,
                has_monotone=jl.has_monotone, hist_method="scatter",
                interpret=True)
            jk += 1
            splits += 1
        else:
            failed += 1
        assert int(st["k"][0]) == jk
        _assert_state_close(tl.pack, st["S"], st["T"], S, T,
                            f"after split {jk - 1}")
        np.testing.assert_array_equal(st["lid"].numpy(), np.asarray(lid))
        h_port, h_jax = st["hist"].numpy(), np.asarray(hist)
        assert np.array_equal(h_port[..., 2], h_jax[..., 2])
        assert (np.abs(h_port - h_jax) <= 1e-5 * scale + 1e-7).all()
    assert splits >= 8 and failed >= 2, (splits, failed)


@pytest.mark.parametrize("case", ["k_at_L", "gain_zero", "gain_negative"])
def test_failed_condition_changes_nothing(setup, case):
    _, _, tl, ghc, js = setup
    st = _port_state(js)
    row = tl.pack.sf_idx["bs_gain"]
    if case == "k_at_L":
        st["k"][0] = L
    else:
        st["S"][row, 0] = 0.0 if case == "gain_zero" else -1.0
    before = {key: v.clone() for key, v in st.items()}
    imeta, fmeta = ssc.pack_meta_tables(tl.meta, None, "cpu")
    _port_step(tl, st, ghc, imeta, fmeta)
    for key, v in before.items():   # bytes: int rows may be NaN patterns
        assert v.numpy().tobytes() == st[key].numpy().tobytes(), key


def test_leaf_step_refuses_what_the_kernel_does_not_take():
    """The wrapper's checks that need no card: bin dtypes, and the
    leaf-layout gate's scope (u16 bins up to 1024 on the card)."""
    from lightgbm_tpu_torch.ops.split import SplitParams
    assert ssc.leaf_bin_bytes(torch.zeros((2, 2), dtype=torch.uint8)) == 1
    assert ssc.leaf_bin_bytes(torch.zeros((2, 2), dtype=torch.int16)) == 2
    assert ssc.leaf_bin_bytes(torch.zeros((2, 2), dtype=torch.int32)) == 4
    with pytest.raises(TypeError):
        ssc.leaf_bin_bytes(torch.zeros((2, 2), dtype=torch.int64))
    p = SplitParams(0.0, 1.0, 0.0, 20.0, 1e-3, 0.0)
    assert ssc.fused_compiled_ok(p, bundled=False, num_bins_max=1024,
                                 layout="leaf")
    assert not ssc.fused_compiled_ok(p, bundled=False, num_bins_max=1025,
                                     layout="leaf")
    assert not ssc.fused_compiled_ok(p, bundled=False, num_bins_max=1024)
    assert ssc.learner_fused_kernel_on(
        "auto", eligible=True, device=torch.device("cuda"), params=p,
        num_bins_max=1000, layout="leaf")
    assert not ssc.learner_fused_kernel_on(
        "auto", eligible=True, device=torch.device("cpu"), params=p,
        num_bins_max=1000, layout="leaf")
    assert ssc.leaf_feat_tile(28, 1024) == 4
    assert ssc.leaf_feat_tile(28, 256) == 16
    # explicit bin widths: u16 bins at 1023, u8 at 255, u16 at 256
    assert ssc.leaf_feat_tile(28, 1023, 2) == 4
    assert ssc.leaf_feat_tile(28, 255, 1) == 16
    assert ssc.leaf_feat_tile(28, 256, 2) == 14
    assert ssc.leaf_feat_tile(3, 16) == 3


def test_prepared_leaf_launch_runs_on_cuda_only(setup):
    """``LeafStep`` (the serial learner's prepared launch) takes CUDA
    tensors only: on the CPU it raises, and the public step runs the
    plain version instead."""
    _, _, tl, ghc, js = setup
    st = _port_state(js)
    imeta, fmeta = ssc.pack_meta_tables(tl.meta, None, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ssc.LeafStep(st["k"], st["S"], st["T"], st["lid"], st["hist"],
                     tl.binned, ghc, imeta, fmeta, params=tl.params,
                     big_l=L, max_depth=tl.max_depth, b=tl.num_bins_max,
                     has_monotone=tl.has_monotone)


@pytest.mark.parametrize("max_bin", [255, 600])
def test_children_without_a_valid_split(max_bin):
    """The root split leaves two children that cannot split again
    (min_data_in_leaf is just under half the rows), so their scans find
    no valid threshold: bs_gain -inf, and the split fields hold the
    scan's values at an invalid threshold, where the twin's right output
    is 0/0 (NaN, lambda_l2 = 0). The port's plain step stores the
    twin's value where it is finite and 0 where it is not, as the
    kernels do (``csrc/split_state.cuh`` ``write_child``)."""
    from lightgbm_tpu.ops.split_step_pallas import (fused_split_step_leaf,
                                                    pack_meta_tables)
    X, y = _data(7)
    params = dict(BASE, max_bin=max_bin, min_data_in_leaf=1400)
    jcfg = JConfig.from_params(params)
    jl = JSerial(JDataset.from_numpy(X, jcfg, label=y), jcfg)
    cfg = Config.from_params(params)
    tl = SerialTreeLearner(Dataset.from_numpy(X, cfg, label=y), cfg,
                           torch.device("cpu"))
    grad, hess = _grads(y)
    js = _jax_root(jl, grad, hess)
    ghc = make_ghc(torch.from_numpy(grad), torch.from_numpy(hess))
    st = _port_state(js)
    imeta, fmeta = ssc.pack_meta_tables(tl.meta, None, "cpu")
    jim, jfm = pack_meta_tables(jl.meta, jnp.ones((tl.num_features,), bool))
    _port_step(tl, st, ghc, imeta, fmeta)
    S, T, _, _ = fused_split_step_leaf(
        jnp.int32(1), jnp.array(js["S"]), jnp.array(js["T"]),
        jnp.array(js["lid"]), jnp.array(js["hist"]),
        jnp.asarray(jl.binned), js["ghc"], jim, jfm, params=jl.params,
        si_prefix=(), big_l=L, max_depth=jl.max_depth, b=tl.num_bins_max,
        bundled=False, has_monotone=jl.has_monotone, hist_method="scatter",
        interpret=True)
    assert int(st["k"][0]) == 2
    pack = tl.pack
    jS, pS = np.asarray(S), st["S"].numpy()
    gain = pS[pack.sf_idx["bs_gain"], :2]
    assert np.isneginf(gain).all()
    assert np.isneginf(jS[pack.sf_idx["bs_gain"], :2]).all()
    # the twin's right outputs are undefined there, its sums are not
    assert np.isnan(jS[pack.sf_idx["bs_rout"], :2]).all()
    np.testing.assert_array_equal(pS[pack.sf_idx["bs_rout"], :2], 0.0)
    for name in ("bs_lg", "bs_lh", "bs_lc", "bs_lout"):
        assert np.isfinite(jS[pack.sf_idx[name], :2]).all(), name
        np.testing.assert_allclose(pS[pack.sf_idx[name], :2],
                                   jS[pack.sf_idx[name], :2], rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # the scan's sums at the invalid threshold are the leaf's own
    np.testing.assert_array_equal(pS[pack.sf_idx["bs_lc"], :2],
                                  pS[pack.sf_idx["leaf_c"], :2])
    _assert_state_close(pack, st["S"], st["T"], S, T, "after the root")
