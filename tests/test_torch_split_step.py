"""The port's packed grow state and per-split bookkeeping
(``lightgbm_tpu_torch/learner/split_step.py``) against the JAX
package's (``lightgbm_tpu/learner/split_step.py``), on the CPU.

The layout must be the JAX package's merged ``StatePack`` field for
field, so ``S``/``T`` from both packages compare value for value: the
same field order, the same dropped and derived rows, int rows bit-cast.
Writes (``set_state_cols``, ``set_tree_col``, ``set_bitsets``) are held
bitwise. The bookkeeping is pure float32 arithmetic in the same
expression order, so the port's host version must give the JAX values
bit for bit, for numerical and categorical splits. Also the fused-step
gate: the mode resolution with its environment override, static
eligibility, "auto" being off on the CPU and a categorical dataset
always taking the per-phase loop.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbm_tpu.learner import split_step as jss
from lightgbm_tpu_torch.learner import split_step as tss

L = 15
PREFIX = ("leaf_begin", "leaf_cnt")


def _packs(has_monotone):
    jp = jss.make_grow_pack(PREFIX, merged=True, has_cat=False,
                            has_monotone=has_monotone, big_l=L)
    tp = tss.make_grow_pack(PREFIX, has_monotone=has_monotone, big_l=L)
    return jp, tp


def _fields(seed):
    """Seeded per-field values of every grow-state field."""
    rng = np.random.RandomState(seed)
    out = {}
    for name in tss.StatePack.GROW_SF:
        out[name] = rng.randn(L).astype(np.float32) * 10
    for name in PREFIX + tss.StatePack.GROW_SI:
        out[name] = rng.randint(-3, 2000, L).astype(np.int32)
    for name in ("bs_dleft", "bs_iscat"):
        out[name] = out[name] % 2
    for name in tss.StatePack.GROW_TF:
        out[name] = rng.randn(L - 1).astype(np.float32)
    for name in tss.StatePack.GROW_TI:
        out[name] = rng.randint(-L, L, L - 1).astype(np.int32)
    # the derived rows are what view() synthesizes
    out["leaf_weight"] = out["leaf_h"]
    out["leaf_count"] = out["leaf_c"]
    out["leaf_parent"] = out["ref_node"]
    return out


def _jax_pack(jp, fields):
    st = jp.pack({k: jnp.asarray(v) for k, v in fields.items()})
    return np.asarray(st["S"]), np.asarray(st["T"])


def _port_pack(tp, fields):
    st = tp.pack({k: torch.from_numpy(np.array(v))
                  for k, v in fields.items()})
    return st["S"], st["T"]


@pytest.mark.parametrize("has_monotone", [False, True])
def test_layout_matches_jax(has_monotone):
    jp, tp = _packs(has_monotone)
    assert tp.sf_fields == jp.sf_fields
    assert tp.si_fields == jp.si_fields
    assert tp.tf_fields == jp.tf_fields
    assert tp.ti_fields == jp.ti_fields
    # both derive the categorical bitsets of a numerical-only dataset
    assert set(tp.derived) == set(jp.derived)
    assert set(tp.derived) >= {"leaf_weight", "leaf_count", "leaf_parent"}
    assert ("leaf_cmin" in tp.derived) == (not has_monotone)


@pytest.mark.parametrize("has_monotone", [False, True])
def test_pack_and_view_match_jax_bitwise(has_monotone):
    jp, tp = _packs(has_monotone)
    fields = _fields(0)
    js, jt = _jax_pack(jp, fields)
    ts, tt = _port_pack(tp, fields)
    assert ts.numpy().tobytes() == js.tobytes()
    assert tt.numpy().tobytes() == jt.tobytes()
    jv = jp.view({"S": jnp.asarray(js), "T": jnp.asarray(jt)})
    tv = tp.view({"S": ts, "T": tt})
    for name, val in tv.items():
        np.testing.assert_array_equal(val.numpy(), np.asarray(jv[name]),
                                      err_msg=name)
    site_h = tp.read_site({"S": ts, "T": tt}, 3)
    site_j = jp.read_site({"S": jnp.asarray(js)}, 3)
    for name in site_j:
        assert site_h[name] == site_j[name].item(), name


@pytest.mark.parametrize("has_monotone", [False, True])
def test_set_state_cols_matches_jax_bitwise(has_monotone):
    jp, tp = _packs(has_monotone)
    fields = _fields(1)
    js, jt = _jax_pack(jp, fields)
    ts, tt = _port_pack(tp, fields)
    rng = np.random.RandomState(2)
    cols = []
    for _ in range(2):
        fv = {k: np.float32(rng.randn() * 5) for k in tss.StatePack.GROW_SF}
        iv = {k: np.int32(rng.randint(-5, 500))
              for k in PREFIX + tss.StatePack.GROW_SI}
        iv["bs_dleft"] = np.int32(1)
        cols.append((fv, iv))
    (fa, ia), (fb, ib) = cols
    out_j = jp.set_state_cols({"S": jnp.asarray(js)}, 7, 2, fa, fb, ia, ib)
    st = {"S": ts, "T": tt}
    tp.set_state_cols(st, 7, 2, fa, fb, ia, ib)
    assert st["S"].numpy().tobytes() == np.asarray(out_j["S"]).tobytes()


@pytest.mark.parametrize("upd,pside", [(True, 0), (True, 1), (False, 1)])
def test_set_tree_col_matches_jax_bitwise(upd, pside):
    jp, tp = _packs(False)
    fields = _fields(3)
    js, jt = _jax_pack(jp, fields)
    ts, tt = _port_pack(tp, fields)
    tf = {k: np.float32(v) for k, v in zip(tss.StatePack.GROW_TF,
                                           (3.5, -0.25, 17.0, 40.0))}
    ti = {k: np.int32(v) for k, v in zip(tss.StatePack.GROW_TI,
                                         (4, 120, 2, -6, -9))}
    s, pnode = 8, 3
    out_j = jp.set_tree_col({"T": jnp.asarray(jt)}, s, tf, ti,
                            jnp.int32(pnode), jnp.bool_(upd),
                            jnp.int32(pside))
    st = {"S": ts, "T": tt}
    tp.set_tree_col(st, s, tf, ti, pnode, upd, pside)
    assert st["T"].numpy().tobytes() == np.asarray(out_j["T"]).tobytes()


def test_categorical_layout_matches_jax():
    """With categorical features the bitsets ride beside S and T
    (``make_grow_pack(has_cat=True)``); without, ``view()`` synthesizes
    zero bitsets of the JAX shapes."""
    from lightgbm_tpu.ops.split import MAX_CAT_WORDS
    for has_cat in (False, True):
        jp = jss.make_grow_pack(PREFIX, merged=True, has_cat=has_cat,
                                has_monotone=False, big_l=L)
        tp = tss.make_grow_pack(PREFIX, has_monotone=False, big_l=L,
                                has_cat=has_cat)
        assert ("bs_bitset" in jp.derived) == ("bs_bitset" in tp.derived) \
            == (not has_cat)
        fields = _fields(6)
        if has_cat:
            fields["bs_bitset"] = np.arange(L * MAX_CAT_WORDS, dtype=np.int32
                                            ).reshape(L, MAX_CAT_WORDS)
            fields["cat_bitsets"] = -fields["bs_bitset"][1:]
        st = tp.pack({k: torch.from_numpy(np.array(v))
                      for k, v in fields.items()})
        v = tp.view(st)
        for name, rows in (("bs_bitset", L), ("cat_bitsets", L - 1)):
            assert tuple(v[name].shape) == (rows, MAX_CAT_WORDS)
            want = fields[name] if has_cat else 0
            assert (v[name].numpy() == want).all()


def test_set_bitsets_matches_jax_bitwise():
    from lightgbm_tpu.ops.split import MAX_CAT_WORDS
    jp = jss.make_grow_pack(PREFIX, merged=True, has_cat=True,
                            has_monotone=False, big_l=L)
    tp = tss.make_grow_pack(PREFIX, has_monotone=False, big_l=L,
                            has_cat=True)
    rng = np.random.RandomState(8)
    bs = rng.randint(0, 2 ** 32, (L, MAX_CAT_WORDS), dtype=np.uint64) \
        .astype(np.uint32)
    cb = rng.randint(0, 2 ** 32, (L - 1, MAX_CAT_WORDS), dtype=np.uint64) \
        .astype(np.uint32)
    words = rng.randint(0, 2 ** 32, (3, MAX_CAT_WORDS), dtype=np.uint64) \
        .astype(np.uint32)
    out_j = jss.set_bitsets(jp, {"bs_bitset": jnp.asarray(bs),
                                 "cat_bitsets": jnp.asarray(cb)},
                            jnp.int32(4), jnp.int32(11),
                            jnp.asarray(words[0]), jnp.asarray(words[1]),
                            jnp.int32(10), jnp.asarray(words[2]))
    st = {"bs_bitset": torch.from_numpy(bs.view(np.int32).copy()),
          "cat_bitsets": torch.from_numpy(cb.view(np.int32).copy())}
    tp.set_bitsets(st, 4, 11, words[0], words[1], 10, words[2])
    for name in ("bs_bitset", "cat_bitsets"):
        assert st[name].numpy().view(np.uint32).tobytes() \
            == np.asarray(out_j[name]).tobytes()


def _scalars(seed):
    rng = np.random.RandomState(seed)
    v = rng.randn(8).astype(np.float32) * np.float32(3)
    return dict(lg=v[0], lh=abs(v[1]), lc=np.float32(37), rg=v[2],
                rh=abs(v[3]), rc=np.float32(55), lout=v[4], rout=v[5],
                pcmin=np.float32(-0.4), pcmax=np.float32(0.35))


@pytest.mark.parametrize("is_cat", [False, True])
@pytest.mark.parametrize("mono", [-1, 0, 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_child_constraints_match_jax(mono, seed, is_cat):
    d = _scalars(seed)
    args = (d["lout"], d["rout"], d["pcmin"], d["pcmax"])
    want = [np.asarray(x) for x in jss.child_constraints_mono(
        jnp.int32(mono), jnp.bool_(is_cat), *map(jnp.float32, args))]
    host = tss.child_constraints(mono, is_cat, *args, has_monotone=True)
    for w, h in zip(want, host):
        assert w.tobytes() == np.float32(h).tobytes()


@pytest.mark.parametrize("a_is_left", [True, False])
def test_order_child_pair_matches_jax(a_is_left):
    d = _scalars(4)
    names = ("lg", "lh", "lc", "rg", "rh", "rc", "lout", "rout")
    cons = (np.float32(-1), np.float32(1), np.float32(-2), np.float32(2))
    k = 6
    vals = [d[n] for n in names] + list(cons)
    want = jss.order_child_pair(jnp.bool_(a_is_left), jnp.int32(k),
                                *map(jnp.float32, vals))
    host = tss.order_child_pair(a_is_left, k, *vals)
    assert set(host) == set(want)
    for key, w in want.items():
        assert np.asarray(w).item() == host[key], key


@pytest.mark.parametrize("is_cat", [False, True])
@pytest.mark.parametrize("ref_node,dleft", [(-1, True), (4, False)])
def test_split_node_updates_match_jax(ref_node, dleft, is_cat):
    from lightgbm_tpu.ops.split import SplitParams as JParams
    from lightgbm_tpu_torch.ops.split import SplitParams
    p = dict(lambda_l1=0.3, lambda_l2=1.5, max_delta_step=0.6,
             min_data_in_leaf=20.0, min_sum_hessian_in_leaf=1e-3,
             min_gain_to_split=0.0)
    jp_, tp_ = JParams(**p), SplitParams(**p, any_missing=True)
    pg, ph, pc = np.float32(-7.25), np.float32(3.125), np.float32(90.0)
    gain, feat, thr, leaf, new = np.float32(12.5), 3, 77, 2, 9
    want = jss.split_node_updates(
        jp_, jnp.float32(gain), jnp.int32(feat), jnp.int32(thr),
        jnp.bool_(dleft), jnp.bool_(is_cat), jnp.float32(pg),
        jnp.float32(ph), jnp.float32(pc), jnp.int32(ref_node),
        jnp.int32(leaf), jnp.int32(new))
    host = tss.split_node_updates(tp_, gain, feat, thr, dleft, is_cat, pg,
                                  ph, pc, np.int32(ref_node), leaf, new)
    for i in (0, 1):
        for key, w in want[i].items():
            w = np.asarray(w)
            h = host[i][key]
            assert w.item() == np.asarray(h).item(), key
            if w.dtype == np.float32:
                assert w.tobytes() == np.float32(h).tobytes(), key
    for i in (2, 3):
        assert np.asarray(want[i]).item() == int(host[i])


@pytest.mark.parametrize("env,config,want", [
    ("", "auto", "auto"), ("", "on", "on"), ("", "off", "off"),
    ("0", "on", "off"), ("off", "auto", "off"), ("1", "off", "on"),
    ("force", "auto", "on"), ("auto", "on", "auto"), ("junk", "on", "on"),
])
def test_fused_mode_matches_jax(monkeypatch, env, config, want):
    monkeypatch.setenv("LGBM_TPU_FUSED_SPLIT_KERNEL", env)
    assert tss.fused_split_kernel_mode(config) == want \
        == jss.fused_split_kernel_mode(config)


@pytest.mark.parametrize("kw", [
    dict(cache_hists=True, merged=True, extra_trees=False, ff_bynode=1.0,
         num_leaves=15),
    dict(cache_hists=False, merged=True, extra_trees=False, ff_bynode=1.0,
         num_leaves=15),
    dict(cache_hists=True, merged=False, extra_trees=False, ff_bynode=1.0,
         num_leaves=15),
    dict(cache_hists=True, merged=True, extra_trees=True, ff_bynode=1.0,
         num_leaves=15),
    dict(cache_hists=True, merged=True, extra_trees=False, ff_bynode=0.5,
         num_leaves=15),
    dict(cache_hists=True, merged=True, extra_trees=False, ff_bynode=1.0,
         num_leaves=1),
], ids=["eligible", "no_cache", "unmerged", "extra_trees", "bynode",
        "one_leaf"])
def test_fused_eligible_matches_jax(kw):
    from lightgbm_tpu.ops.split import SplitParams as JParams
    jp_ = JParams(0.0, 1.0, 0.0, 20.0, 1e-3, 0.0)
    assert tss.fused_split_eligible(jp_, **kw) \
        == jss.fused_split_eligible(jp_, **kw)


@pytest.mark.parametrize("env,config,want", [
    ("", "auto", False), ("", "on", True), ("", "off", False),
    ("1", "auto", True), ("0", "on", False),
])
def test_learner_gate_on_the_cpu(monkeypatch, env, config, want):
    """"auto" is off on the CPU (the fused kernel is the card's); "on"
    runs the fused step's plain version."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data import Dataset
    from lightgbm_tpu_torch.learner import PartitionedTreeLearner
    monkeypatch.setenv("LGBM_TPU_FUSED_SPLIT_KERNEL", env)
    rng = np.random.RandomState(0)
    X = rng.randn(300, 4)
    cfg = Config.from_params({"objective": "binary", "num_leaves": 7,
                              "verbosity": -1, "fused_split_kernel": config})
    ds = Dataset.from_numpy(X, cfg, label=(X[:, 0] > 0).astype(np.float32))
    assert PartitionedTreeLearner(ds, cfg, torch.device("cpu")).fused == want


@pytest.mark.parametrize("has_monotone", [False, True])
def test_leaf_layout_matches_jax(has_monotone):
    """The serial learner's pack (no segment prefix) is the JAX
    package's ``make_grow_pack(())`` field for field, and its rows are
    what the leaf kernel is given (``state_rows``)."""
    from lightgbm_tpu_torch.ops.split_step_cuda import state_rows
    jp = jss.make_grow_pack((), merged=True, has_cat=False,
                            has_monotone=has_monotone, big_l=L)
    tp = tss.make_grow_pack((), has_monotone=has_monotone, big_l=L)
    assert tp.sf_fields == jp.sf_fields and tp.si_fields == jp.si_fields
    assert tp.tf_fields == jp.tf_fields and tp.ti_fields == jp.ti_fields
    assert "leaf_begin" not in tp.si_idx
    fields = {k: v for k, v in _fields(1).items() if k not in PREFIX}
    js, jt = _jax_pack(jp, fields)
    ts, tt = _port_pack(tp, fields)
    assert ts.numpy().tobytes() == js.tobytes()
    assert tt.numpy().tobytes() == jt.tobytes()
    assert ts.shape[0] == state_rows(has_monotone, "leaf") \
        == state_rows(has_monotone) - len(PREFIX)


@pytest.mark.parametrize("env,config,want", [
    ("", "auto", False), ("", "on", True), ("", "off", False),
    ("1", "auto", True), ("0", "on", False),
])
def test_serial_learner_gate_on_the_cpu(monkeypatch, env, config, want):
    """The serial learner's gate as the partitioned one's: "auto" is off
    on the CPU, "on" runs the leaf step's plain version."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data import Dataset
    from lightgbm_tpu_torch.learner import SerialTreeLearner
    monkeypatch.setenv("LGBM_TPU_FUSED_SPLIT_KERNEL", env)
    rng = np.random.RandomState(0)
    X = rng.randn(2000, 4)
    cfg = Config.from_params({"objective": "binary", "num_leaves": 7,
                              "verbosity": -1, "max_bin": 500,
                              "fused_split_kernel": config})
    ds = Dataset.from_numpy(X, cfg, label=(X[:, 0] > 0).astype(np.float32))
    lrn = SerialTreeLearner(ds, cfg, torch.device("cpu"))
    assert lrn.fused == want and lrn.num_bins_max > 256


@pytest.mark.parametrize("config", ["on", "auto"])
@pytest.mark.parametrize("max_bin", [255, 600])
def test_categorical_dataset_takes_the_per_phase_loop(config, max_bin):
    """The fused kernels refuse categorical data (as the JAX package's
    compiled fused bodies do), so a dataset with a categorical feature
    keeps the per-phase loop on both learners, even with "on"."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data import Dataset
    from lightgbm_tpu_torch.parallel.learners import create_tree_learner
    rng = np.random.RandomState(1)
    X = np.column_stack([rng.randint(0, 9, 3000), rng.randn(3000)])
    cfg = Config.from_params({"objective": "binary", "num_leaves": 7,
                              "verbosity": -1, "max_bin": max_bin,
                              "fused_split_kernel": config})
    ds = Dataset.from_numpy(X, cfg, label=(X[:, 1] > 0).astype(np.float32),
                            categorical_features=[0])
    lrn = create_tree_learner("serial", ds, cfg, torch.device("cpu"))
    assert lrn.params.has_categorical and not lrn.fused
