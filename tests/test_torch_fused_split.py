"""The fused split step of the partitioned learner
(``lightgbm_tpu_torch/ops/split_step_cuda.py``) on the CPU, against the
JAX package's fused step (``lightgbm_tpu/ops/split_step_pallas.py``,
segment layout, run through its interpret twin as
``tests/test_split_megakernel.py`` runs it).

* One state, carried across by ``convert.py``, is stepped L - 1 times in
  both packages. Int rows of ``S``/``T`` are exact, float rows agree at
  rtol 1e-5 / atol 1e-5 (the twin's histogram sums bf16 hi/lo payload
  pairs), the training matrix is byte-identical, and the histogram cache
  agrees within 1e-5 x the bin's sum of |values| over all rows, counts
  exact. The gradients are rounded to 8 mantissa bits, so the hi/lo
  pairs hold them exactly and a near tie cannot flip between the two.
* Training with ``fused_split_kernel="on"`` agrees with the JAX
  package's fused training (tree structure exact, leaf values at rtol
  1e-5 / atol 1e-5) and is byte-identical to the port's per-phase loop.
* A step whose grow-loop condition fails changes nothing.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data import Dataset as JDataset
from lightgbm_tpu.learner.partitioned import \
    PartitionedTreeLearner as JPartitionedTreeLearner
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import grow_state_from_jax, matrix_from_jax
from lightgbm_tpu_torch.data import Dataset
from lightgbm_tpu_torch.learner import PartitionedTreeLearner
from lightgbm_tpu_torch.ops import split_step_cuda as ssc
from lightgbm_tpu_torch.ops.hist_cuda import histogram_segment_plain

torch.set_num_threads(2)
L = 15
BASE = {"objective": "binary", "num_leaves": L, "verbosity": -1}
CONFIGS = {
    "default": {},
    "constrained": {"monotone_constraints": [1, -1, 0, 0, 0, 0, 0, 0],
                    "max_depth": 4, "lambda_l1": 0.2, "lambda_l2": 1.0,
                    "max_delta_step": 2.0, "min_data_in_leaf": 30},
}


def _data(seed=0, n=2000, f=8):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.1, 2] = np.nan            # NaN-missing feature
    X[rng.rand(n) < 0.3, 3] = 0.0               # zero-heavy feature
    y = (1.5 * X[:, 0] - X[:, 1] + 0.5 * np.nan_to_num(X[:, 2])
         + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return X, y


def _bf16_exact(x):
    return (np.asarray(x, np.float32).view(np.uint32)
            & np.uint32(0xFFFF0000)).view(np.float32)


def _grads(y, config):
    """First-iteration binary gradients, or ones from a seeded score."""
    if config == "default":
        return y - np.float32(0.5), np.full(y.shape, 0.25, np.float32)
    s = np.random.RandomState(5).randn(y.shape[0]).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-s))
    return _bf16_exact(p - y), _bf16_exact(p * (1.0 - p))


def _jax_root(jl, grad, hess):
    """The JAX partitioned grow loop's state after its root (JAX
    learner/partitioned.py:452-542, serial comm, interpret kernels)."""
    from lightgbm_tpu.learner.comm import SERIAL_COMM
    from lightgbm_tpu.learner.partitioned import HIST_BLK
    from lightgbm_tpu.learner.split_step import (make_grow_pack,
                                                 make_scan_leaf)
    from lightgbm_tpu.ops.hist_pallas import histogram_segment, pack_gh
    from lightgbm_tpu.ops.split import leaf_output_no_constraint
    n, f, b = jl.num_data, jl.num_groups, jl.num_bins_max
    mat = pack_gh(jl.mat, f, jnp.asarray(grad), jnp.asarray(hess),
                  jnp.ones((n,), jnp.float32))
    root = histogram_segment(mat, jnp.int32(0), jnp.int32(n), b, f,
                             blk=HIST_BLK, interpret=True)
    g, h, c = root[0].sum(axis=0)
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
        leaf_begin=jnp.zeros((L,), i32), leaf_cnt=at0(0, n, i32),
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
    pack = make_grow_pack(("leaf_begin", "leaf_cnt"), merged=True,
                          has_cat=False, has_monotone=jl.has_monotone,
                          big_l=L)
    st = pack.pack(fields)
    hist = jnp.zeros((L, f, b, 3), jnp.float32).at[0].set(root)
    return dict(k=1, S=st["S"], T=st["T"], mat=mat, ws=jnp.zeros_like(mat),
                hist=hist)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request):
    """Both packages' learners on the same data, the JAX root state, and
    the same state carried into the port."""
    X, y = _data()
    params = dict(BASE, **CONFIGS[request.param])
    jcfg = JConfig.from_params(params)
    jl = JPartitionedTreeLearner(JDataset.from_numpy(X, jcfg, label=y),
                                 jcfg, interpret=True)
    cfg = Config.from_params(params)
    tl = PartitionedTreeLearner(Dataset.from_numpy(X, cfg, label=y), cfg,
                                torch.device("cpu"))
    grad, hess = _grads(y, request.param)
    js = _jax_root(jl, grad, hess)
    return request.param, jl, tl, grad, hess, js


def _port_state(tl, js):
    st = grow_state_from_jax(np.asarray(js["S"]), np.asarray(js["T"]),
                             np.asarray(js["hist"]))
    st["mat"] = matrix_from_jax(np.asarray(js["mat"]), tl.num_features,
                                tl.num_data)
    st["ws"] = torch.empty_like(st["mat"])
    st["k"] = torch.tensor([js["k"]], dtype=torch.int32)
    return st


def _port_step(tl, st, imeta, fmeta):
    ssc.fused_split_step_segment(
        st["k"], st["S"], st["T"], st["mat"], st["ws"], st["hist"], imeta,
        fmeta, params=tl.params, big_l=L, max_depth=tl.max_depth,
        b=tl.num_bins_max, f=tl.num_features, has_monotone=tl.has_monotone)


SPLIT_FIELDS = ("bs_lg", "bs_lh", "bs_lc", "bs_lout", "bs_rout")


def _assert_packed_close(port, jax_mat, n_float, what, pack=None):
    """Int rows exact, float rows at rtol/atol 1e-5. With ``pack`` (S):
    the split fields of a leaf without a valid split (bs_gain -inf) are
    finite in the port, the twin's value where it is finite and 0 where
    it is not (an output of 0/0 or x/0 at an invalid threshold;
    ``learner/split_step.py`` ``defined_split_fields``)."""
    a = port.numpy()
    b = np.array(jax_mat)
    if pack is not None:
        dead = np.isneginf(b[pack.sf_idx["bs_gain"]])
        for name in SPLIT_FIELDS:
            row = b[pack.sf_idx[name]]
            row[dead & ~np.isfinite(row)] = 0.0
            assert np.isfinite(a[pack.sf_idx[name]]).all(), (what, name)
    assert a[n_float:].view(np.int32).tolist() \
        == b[n_float:].view(np.int32).tolist(), what
    np.testing.assert_allclose(a[:n_float], b[:n_float], rtol=1e-5,
                               atol=1e-5, err_msg=what)


def test_matrix_and_root_state_carry_across(setup):
    """convert.matrix_from_jax gives the matrix the port builds itself
    (bins, payload, row ids), and the port's own root state agrees with
    the JAX package's."""
    from lightgbm_tpu_torch.learner.split_step import root_state
    from lightgbm_tpu_torch.ops.hist_cuda import (histogram_segment_plain,
                                                  pack_gh)
    from lightgbm_tpu_torch.ops.split_scan_cuda import \
        per_feature_numerical_plain
    _, _, tl, grad, hess, js = setup
    n, f = tl.num_data, tl.num_features
    mat = tl.mat.clone()
    pack_gh(mat, f, torch.from_numpy(grad), torch.from_numpy(hess),
            torch.ones(n))
    assert torch.equal(mat, matrix_from_jax(np.asarray(js["mat"]), f, n))
    root = histogram_segment_plain(mat, 0, n, tl.num_bins_max, f)
    sums = root[0].sum(dim=0).numpy()
    inf = np.float32(np.inf)
    table = per_feature_numerical_plain(
        [root], [tuple(sums) + (-inf, inf)], tl._meta_all, tl.params)[0]
    st = root_state(tl.pack, table, *sums, n, tl.params, L)
    nf = len(tl.pack.sf_fields)
    _assert_packed_close(st["S"], js["S"], nf, "S", tl.pack)
    _assert_packed_close(st["T"], js["T"], len(tl.pack.tf_fields), "T")


def test_steps_match_jax_twin(setup):
    from lightgbm_tpu.learner.partitioned import HIST_BLK
    from lightgbm_tpu.ops.split_step_pallas import (fused_split_step_segment,
                                                    pack_meta_tables)
    name, jl, tl, _, _, js = setup
    st = _port_state(tl, js)
    imeta, fmeta = ssc.pack_meta_tables(tl.meta, None, "cpu")
    jim, jfm = pack_meta_tables(jl.meta, jnp.ones((jl.num_groups,), bool))
    np.testing.assert_array_equal(imeta.numpy(), np.asarray(jim))
    np.testing.assert_array_equal(fmeta.numpy(), np.asarray(jfm))
    nf, nt = len(tl.pack.sf_fields), len(tl.pack.tf_fields)
    # the tolerance scale: a leaf's bin sums a subset of the root's rows
    # of that bin, so the root's sum of |values| bounds it
    n, f, b = tl.num_data, tl.num_features, tl.num_bins_max
    scale = histogram_segment_plain(st["mat"], 0, n, b, f,
                                    absolute=True).numpy()
    # copies: the JAX step donates its buffers, and the fixture's state
    # serves the other tests
    jk = js["k"]
    S, T, mat, ws, hist = (jnp.array(js[x]) for x in
                           ("S", "T", "mat", "ws", "hist"))
    splits = 0
    for _ in range(L - 1):
        gains = np.asarray(S[tl.pack.sf_idx["bs_gain"]])
        # the JAX grow loop's condition (the twin itself does not check)
        open_ok = jk < L and np.where(np.arange(L) < jk, gains,
                                      -np.inf).max() > 0.0
        _port_step(tl, st, imeta, fmeta)
        if open_ok:
            S, T, mat, ws, hist = fused_split_step_segment(
                jnp.int32(jk), S, T, mat, ws, hist, jim, jfm,
                params=jl.params, si_prefix=("leaf_begin", "leaf_cnt"),
                big_l=L, max_depth=jl.max_depth, b=jl.num_bins_max,
                f=jl.num_groups, n=jl.num_data, bundled=False,
                has_monotone=jl.has_monotone, blk=HIST_BLK, interpret=True)
            jk += 1
            splits += 1
        assert int(st["k"][0]) == jk
        _assert_packed_close(st["S"], S, nf, f"S after split {jk - 1}",
                             tl.pack)
        _assert_packed_close(st["T"], T, nt, f"T after split {jk - 1}")
        assert torch.equal(st["mat"], matrix_from_jax(
            np.asarray(mat), tl.num_features, tl.num_data))
        h_port, h_jax = st["hist"].numpy(), np.asarray(hist)
        assert np.array_equal(h_port[..., 2], h_jax[..., 2])
        assert (np.abs(h_port - h_jax) <= 1e-5 * scale + 1e-7).all()
    assert splits >= 8, splits


@pytest.mark.parametrize("case", ["k_at_L", "gain_zero", "gain_negative"])
def test_failed_condition_changes_nothing(setup, case):
    _, _, tl, _, _, js = setup
    st = _port_state(tl, js)
    row = tl.pack.sf_idx["bs_gain"]
    if case == "k_at_L":
        st["k"][0] = L
    else:
        st["S"][row, 0] = 0.0 if case == "gain_zero" else -1.0
    before = {key: v.clone() for key, v in st.items() if key != "ws"}
    imeta, fmeta = ssc.pack_meta_tables(tl.meta, None, "cpu")
    _port_step(tl, st, imeta, fmeta)
    for key, v in before.items():   # bytes: int rows may be NaN patterns
        assert v.numpy().tobytes() == st[key].numpy().tobytes(), key


def _structure(t):
    return (t.num_leaves, t.split_feature_inner.tolist(),
            t.threshold_bin.tolist(), (t.decision_type & 2).tolist(),
            t.left_child.tolist(), t.right_child.tolist())


def test_fused_training_matches_jax_fused_training(setup):
    name = setup[0]
    X, y = _data()
    params = dict(BASE, **CONFIGS[name])
    port = lt.train(dict(params, fused_split_kernel="on"),
                    lt.Dataset(X, label=y), 3, device="cpu")
    assert port._gbdt.learner.fused
    jb = lgb.train(dict(params, tree_learner="partitioned",
                        fused_split_kernel="on"), lgb.Dataset(X, label=y),
                   num_boost_round=3, verbose_eval=False)
    assert len(port.models) == len(jb._gbdt.models) == 3
    for a, b in zip(jb._gbdt.models, port.models):
        assert _structure(b) == _structure(a)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-5)


_TREE_FIELDS = ("num_leaves", "split_feature_inner", "threshold_bin",
                "decision_type", "left_child", "right_child", "split_gain",
                "internal_value", "internal_weight", "internal_count",
                "leaf_value", "leaf_weight", "leaf_count", "leaf_parent",
                "leaf_depth")


def test_fused_on_is_byte_identical_to_off(setup):
    name = setup[0]
    X, y = _data()
    out = {}
    for mode in ("on", "off"):
        cfg = Config.from_params(dict(BASE, **CONFIGS[name],
                                      fused_split_kernel=mode))
        lrn = PartitionedTreeLearner(Dataset.from_numpy(X, cfg, label=y),
                                     cfg, torch.device("cpu"))
        assert lrn.fused == (mode == "on")
        grad = torch.from_numpy(y - 0.5)
        hess = torch.full((len(y),), 0.25)
        trees = []
        for _ in range(3):   # later trees start from a permuted matrix
            tree, leaf_id = lrn.train(grad, hess)
            trees.append((tree, leaf_id))
            grad = grad * 0.5 + 0.1
        out[mode] = trees
    for (ta, la), (tb, lb) in zip(out["on"], out["off"]):
        for fld in _TREE_FIELDS:
            assert np.asarray(getattr(ta, fld)).tobytes() \
                == np.asarray(getattr(tb, fld)).tobytes(), fld
        assert la.numpy().tobytes() == lb.numpy().tobytes()
