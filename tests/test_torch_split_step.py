"""The port's packed grow state and per-split bookkeeping
(``lightgbm_tpu_torch/learner/split_step.py``) against the JAX
package's (``lightgbm_tpu/learner/split_step.py``), on the CPU.

The layout must be the JAX package's merged ``StatePack`` field for
field, so ``S``/``T`` from both packages compare value for value: the
same field order, the same dropped and derived rows, int rows bit-cast.
Writes (``set_state_cols``, ``set_tree_col``) are held bitwise, from host
scalars and from 0-dim tensors. The bookkeeping is pure float32
arithmetic in the same expression order, so both of the port's versions
(host numpy scalars and 0-dim tensors) must give the JAX values bit for
bit. Also the fused-step gate: the mode resolution with its environment
override, static eligibility, and "auto" being off on the CPU.
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
    # the JAX pack also derives the categorical bitsets, which the port
    # (numerical splits only) never carries
    assert set(tp.derived) == set(jp.derived) - {"bs_bitset",
                                                 "cat_bitsets"}
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
    site_t = tp.read_site({"S": ts, "T": tt}, torch.tensor(3))
    site_h = tp.read_site_host({"S": ts, "T": tt}, 3)
    site_j = jp.read_site({"S": jnp.asarray(js)}, 3)
    for name in site_j:
        assert site_t[name].item() == site_h[name] == site_j[name].item(), \
            name


def _as(kind, v, dtype):
    if kind == "tensor":
        return torch.as_tensor(np.asarray(v)).to(dtype)
    return v


@pytest.mark.parametrize("kind", ["host", "tensor"])
@pytest.mark.parametrize("has_monotone", [False, True])
def test_set_state_cols_matches_jax_bitwise(kind, has_monotone):
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
    conv = {"host": lambda d, dt: d,
            "tensor": lambda d, dt: {k: _as("tensor", v, dt)
                                     for k, v in d.items()}}[kind]
    st = {"S": ts, "T": tt}
    tp.set_state_cols(st, _as(kind, 7, torch.int64),
                      _as(kind, 2, torch.int64),
                      conv(fa, torch.float32), conv(fb, torch.float32),
                      conv(ia, torch.int32), conv(ib, torch.int32))
    assert st["S"].numpy().tobytes() == np.asarray(out_j["S"]).tobytes()


@pytest.mark.parametrize("kind", ["host", "tensor"])
@pytest.mark.parametrize("upd,pside", [(True, 0), (True, 1), (False, 1)])
def test_set_tree_col_matches_jax_bitwise(kind, upd, pside):
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
    if kind == "host":
        tp.set_tree_col(st, s, tf, ti, pnode, upd, pside)
    else:
        tp.set_tree_col(
            st, torch.tensor(s), {k: torch.tensor(v) for k, v in tf.items()},
            {k: torch.tensor(v) for k, v in ti.items()},
            torch.tensor(pnode, dtype=torch.int32), torch.tensor(upd),
            torch.tensor(pside, dtype=torch.int32))
    assert st["T"].numpy().tobytes() == np.asarray(out_j["T"]).tobytes()


def _scalars(seed):
    rng = np.random.RandomState(seed)
    v = rng.randn(8).astype(np.float32) * np.float32(3)
    return dict(lg=v[0], lh=abs(v[1]), lc=np.float32(37), rg=v[2],
                rh=abs(v[3]), rc=np.float32(55), lout=v[4], rout=v[5],
                pcmin=np.float32(-0.4), pcmax=np.float32(0.35))


@pytest.mark.parametrize("mono", [-1, 0, 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_child_constraints_match_jax(mono, seed):
    d = _scalars(seed)
    args = (d["lout"], d["rout"], d["pcmin"], d["pcmax"])
    want = [np.asarray(x) for x in jss.child_constraints_mono(
        jnp.int32(mono), jnp.bool_(False), *map(jnp.float32, args))]
    host = tss.child_constraints_mono(mono, False, *args)
    tens = tss.child_constraints_mono_t(
        torch.tensor(mono, dtype=torch.int32), False,
        *(torch.tensor(a) for a in args))
    for w, h, t in zip(want, host, tens):
        assert w.tobytes() == np.float32(h).tobytes() \
            == t.numpy().tobytes()


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
    tens = tss.order_child_pair_t(torch.tensor(a_is_left), torch.tensor(k),
                                  *(torch.tensor(v) for v in vals))
    assert set(host) == set(tens) == set(want)
    for key, w in want.items():
        assert np.asarray(w).item() == host[key] == tens[key].item(), key


@pytest.mark.parametrize("ref_node,dleft", [(-1, True), (4, False)])
def test_split_node_updates_match_jax(ref_node, dleft):
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
        jnp.bool_(dleft), jnp.bool_(False), jnp.float32(pg),
        jnp.float32(ph), jnp.float32(pc), jnp.int32(ref_node),
        jnp.int32(leaf), jnp.int32(new))
    host = tss.split_node_updates(tp_, gain, feat, thr, dleft, False, pg,
                                  ph, pc, np.int32(ref_node), leaf, new)
    t = torch.tensor
    tens = tss.split_node_updates_t(
        tp_, t(gain), t(feat), t(thr), t(dleft), False, t(pg), t(ph),
        t(pc), t(ref_node, dtype=torch.int32), t(leaf), t(new))
    for i in (0, 1):
        for key, w in want[i].items():
            w = np.asarray(w)
            h, v = host[i][key], tens[i][key]
            assert w.item() == v.item() == np.asarray(h).item(), key
            if w.dtype == np.float32:
                assert w.tobytes() == np.float32(h).tobytes() \
                    == v.numpy().tobytes(), key
    for i in (2, 3):
        assert np.asarray(want[i]).item() == int(host[i]) \
            == tens[i].item()


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
