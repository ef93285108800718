"""Multi-val EFB groups in the port against the JAX package, on the CPU:
the JAX test's Bosch-shaped matrix (``tests/test_multival.py``) plans
multi-val alike with the same slot matrix; the multi-val histogram's
plain version, over the slots' compact layout (``MultivalLayout``),
against JAX ``multival_hist``; training against ``lgb.train`` and
against the same data unbundled; bagging on multi-val.

Tolerances: plans and slots exactly; histograms within 1e-5 of the
bin's sum of absolute values, plus 1e-6 (float64 sums rounded once
here, float32 scatter sums in JAX; the padding bin (0, 0) sums
thousands of rows); the layout exactly; on exactly representable ghc
(multiples of 1/64 whose sums stay within float32's 24 bits) the
chunked plain version equals JAX ``multival_hist`` and one flat
``np.add.at`` bit for bit; trees exact up to a logged threshold tie,
leaf values within 1e-5 (``torch_efb_data.compare_trees``).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.dataset import Dataset as JDataset
from lightgbm_tpu.ops.histogram import multival_hist as jmultival
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data.dataset import Dataset
from lightgbm_tpu_torch.ops import hist_multival_cuda as hm

from torch_efb_data import bosch_like, compare_trees, same_tree

torch.set_num_threads(2)
PARAMS = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
          "verbosity": -1}


@pytest.mark.parametrize("form", ["dense", "csr"])
def test_bosch_plans_multival_like_jax(form):
    X, y = bosch_like()
    data = X if form == "dense" else sp.csr_matrix(X)
    ctor = "from_numpy" if form == "dense" else "from_scipy"
    tds = getattr(Dataset, ctor)(data, Config.from_params(PARAMS), label=y)
    jds = getattr(JDataset, ctor)(data, JConfig.from_params(PARAMS),
                                  label=y)
    assert tds.has_multival and tds.num_groups > tds.num_dense_groups
    assert tds.mv_slots.shape[1] < X.shape[1] // 4
    assert tds.mv_group_start == jds.mv_group_start
    for key in ("feature_group", "feature_offset", "group_num_bins",
                "binned", "mv_slots"):
        a, b = getattr(tds, key), getattr(jds, key)
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("b", [16, 256, 300])
@pytest.mark.parametrize("rows", ["all", "list"])
def test_multival_hist_plain_matches_jax(b, rows):
    X, y = bosch_like()
    tds = Dataset.from_numpy(X, Config.from_params(PARAMS), label=y)
    g_mv = tds.num_groups - tds.num_dense_groups
    rng = np.random.RandomState(1)
    ghc = np.stack([rng.randn(len(X)), rng.rand(len(X)),
                    np.ones(len(X))], 1).astype(np.float32)
    slots = tds.mv_slots
    ids = None if rows == "all" else np.sort(rng.choice(
        len(X), len(X) // 3, replace=False)).astype(np.int32)
    layout = hm.MultivalLayout(torch.from_numpy(slots), g_mv)
    tids = None if ids is None else torch.from_numpy(ids)
    out = hm.hist_multival(layout, torch.from_numpy(ghc), b, tids).numpy()
    sel = slice(None) if ids is None else ids
    ref = np.asarray(jmultival(jnp.asarray(slots[sel]),
                               jnp.asarray(ghc[sel]), g_mv, b))
    assert out.shape == ref.shape == (g_mv, b, 3)
    scale = hm.hist_multival_plain(layout, torch.from_numpy(np.abs(ghc)), b,
                                   tids).numpy()
    assert (np.abs(out - ref) <= 1e-5 * scale + 1e-6).all()


def test_multival_chunks_sum_in_chunk_order():
    """Past one chunk (``MV_CHUNK_ROWS`` rows) the plain version sums
    each chunk and then the chunks; on exactly representable ghc that is
    the one-chunk sum bit for bit, and the padding lands in bin (0, 0)."""
    rng = np.random.RandomState(2)
    k, g_mv = 5, 3
    n = 3 * hm.MV_CHUNK_ROWS + 17
    slots = rng.randint(0, g_mv * 256, (n, k)).astype(np.int32)
    slots[::4, -1] = 0
    ghc = (rng.randint(-512, 512, (n, 3)) / 1024.0).astype(np.float32)
    assert hm.child_chunks(n, g_mv) == 4
    out = hm.hist_multival_plain(
        hm.MultivalLayout(torch.from_numpy(slots), g_mv),
        torch.from_numpy(ghc), 256)
    flat = np.zeros((g_mv * 256, 3))
    np.add.at(flat, slots.reshape(-1), np.repeat(ghc, k, axis=0))
    np.testing.assert_array_equal(out.numpy(),
                                  flat.astype(np.float32).reshape(
                                      g_mv, 256, 3))


def _random_slots(n, k, g_mv, seed):
    """Slots as ``build_mv_slots`` lays them out: each row's real values
    (pseudo-group p, in-group value 1-255: ``p * 256 + offset + bin -
    1``) first, then 0-padding to K; a row may hold none."""
    rng = np.random.RandomState(seed)
    slots = np.zeros((n, k), np.int32)
    real = rng.randint(0, k + 1, n)
    vals = rng.randint(0, g_mv, (n, k)) * 256 + rng.randint(1, 256, (n, k))
    mask = np.arange(k)[None, :] < real[:, None]
    slots[mask] = vals[mask]
    return slots


def _bosch_slots():
    X, y = bosch_like()
    tds = Dataset.from_numpy(X, Config.from_params(PARAMS), label=y)
    return tds.mv_slots, tds.num_groups - tds.num_dense_groups


@pytest.mark.parametrize("case", ["bosch", "one_group", "many_windows"])
def test_multival_layout_from_slots(case):
    """The compact layout holds each row's real slots, window by window
    in slot order, as window-local bins behind int64 offsets, and each
    row's padding count; nothing else."""
    if case == "bosch":
        slots, g_mv = _bosch_slots()
    elif case == "one_group":
        slots, g_mv = _random_slots(700, 2, 1, 5), 1
    else:
        slots, g_mv = _random_slots(900, 40, 70, 6), 70
    n, k = slots.shape
    lay = hm.MultivalLayout(torch.from_numpy(slots), g_mv)
    assert lay.windows == -(-g_mv // hm.MV_WINDOW_GROUPS)
    assert lay.off.dtype == torch.int64 and lay.ent.dtype == torch.int16
    assert lay.off.shape == (lay.windows * n + 1,)
    np.testing.assert_array_equal(lay.npad.numpy(), (slots == 0).sum(1))
    off, ent = lay.off.numpy(), lay.ent.numpy().astype(np.int64)
    assert off[0] == 0 and off[-1] == len(ent) == (slots != 0).sum()
    span = hm.MV_WINDOW_GROUPS * 256
    for r in range(n):
        real = slots[r][slots[r] != 0]
        want = real[np.argsort(real // span, kind="stable")]
        got = np.concatenate([
            ent[off[w * n + r]:off[w * n + r + 1]] + w * span
            for w in range(lay.windows)])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["bosch_all", "bosch_list",
                                  "chunks_list", "many_windows",
                                  "one_group_padding"])
def test_multival_plain_equals_jax_exactly(case):
    """On exactly representable ghc the plain version over the layout is
    JAX ``multival_hist`` to the bit: over all rows and row lists, several
    chunks, pseudo-groups in five windows, rows of padding alone."""
    if case.startswith("bosch"):
        slots, g_mv = _bosch_slots()
    elif case == "chunks_list":
        slots, g_mv = _random_slots(3 * hm.MV_CHUNK_ROWS + 300, 6, 9, 7), 9
    elif case == "many_windows":
        slots, g_mv = _random_slots(1500, 30, 70, 8), 70
    else:
        slots, g_mv = _random_slots(3000, 2, 1, 9), 1
    n = len(slots)
    rng = np.random.RandomState(10)
    ghc = np.stack([rng.randint(-32, 32, n) / 64.0,
                    rng.randint(0, 32, n) / 64.0,
                    rng.randint(0, 2, n)], 1).astype(np.float32)
    ids = None
    if case.endswith("list"):
        ids = np.sort(rng.choice(n, 2 * n // 3, replace=False)) \
            .astype(np.int32)
        if case == "chunks_list":
            assert hm.child_chunks(len(ids), g_mv) > 1
    lay = hm.MultivalLayout(torch.from_numpy(slots), g_mv)
    out = hm.hist_multival(lay, torch.from_numpy(ghc), 256,
                           None if ids is None else torch.from_numpy(ids))
    sel = slice(None) if ids is None else ids
    ref = np.asarray(jmultival(jnp.asarray(slots[sel]),
                               jnp.asarray(ghc[sel]), g_mv, 256))
    np.testing.assert_array_equal(out.numpy(), ref)


def _pair(X, y, params, rounds, Xv=None, yv=None):
    ds, jds = lt.Dataset(X, label=y), lgb.Dataset(X, label=y)
    pe, je = {}, {}
    kp = dict(valid_sets=[ds.create_valid(Xv, label=yv)], evals_result=pe,
              verbose_eval=False) if Xv is not None else {}
    kj = dict(valid_sets=[jds.create_valid(Xv, label=yv)], evals_result=je,
              verbose_eval=False) if Xv is not None else {}
    port = lt.train(params, ds, rounds, device="cpu", **kp)
    jb = lgb.train(dict(params, fused_split_kernel="off"), jds,
                   num_boost_round=rounds, **kj)
    return port, jb, pe, je


def test_train_matches_jax_with_a_valid_set():
    X, y = bosch_like()
    Xv, yv = bosch_like(n=1000, seed=8)
    port, jb, pe, je = _pair(X, y, dict(PARAMS, metric="binary_logloss"),
                             8, Xv, yv)
    lrn = port._gbdt.learner
    assert type(lrn).__name__ == "SerialTreeLearner"
    assert lrn.mv_groups > 0 and not lrn.fused
    vd = port._gbdt.valid_sets[0]
    assert vd.has_multival and vd.mv_slots.shape[0] == len(Xv)
    upto, _ = compare_trees(port.models, jb._gbdt.models)
    it = 8 if upto is None else upto
    assert it >= 3
    np.testing.assert_allclose(pe["valid_0"]["binary_logloss"][:it],
                               je["valid_0"]["binary_logloss"][:it],
                               rtol=0, atol=1e-6)
    # the valid walk (slots decoded) equals raw-feature prediction
    np.testing.assert_allclose(port._gbdt.valid_scores[0].numpy()[:, 0],
                               port.predict(Xv, raw_score=True), rtol=0,
                               atol=1e-5)
    mv = {j for j in range(X.shape[1])
          if port._gbdt.train_data.feature_group[j] >= vd.mv_group_start}
    assert any(int(f) in mv for t in port.models
               for f in t.split_feature_inner[:t.num_leaves - 1])


def test_multival_matches_dense_training():
    """The same data multi-val and unbundled: the histograms are the same
    sums, so the trees are the same (JAX ``test_multival.py:39``)."""
    X, y = bosch_like()
    mv = lt.train(PARAMS, lt.Dataset(X, label=y), 6, device="cpu")
    dense = lt.train(dict(PARAMS, enable_bundle=False),
                     lt.Dataset(X, label=y), 6, device="cpu")
    assert mv._gbdt.train_data.has_multival
    assert not dense._gbdt.train_data.is_bundled
    for a, b in zip(mv.models, dense.models):
        assert same_tree(a, b)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("learner", ["serial", "partitioned"])
def test_multival_learner_choice(learner):
    X, y = bosch_like()
    params = dict(PARAMS, tree_learner=learner)
    if learner == "partitioned":
        with pytest.raises(ValueError, match="multi-val"):
            lt.train(params, lt.Dataset(X, label=y), 1, device="cpu")
        return
    bst = lt.train(params, lt.Dataset(X, label=y), 1, device="cpu")
    assert type(bst._gbdt.learner).__name__ == "SerialTreeLearner"


def test_bagging_on_multival_matches_jax():
    X, y = bosch_like()
    params = dict(PARAMS, bagging_fraction=0.7, bagging_freq=1,
                  bagging_seed=5)
    port, jb, _, _ = _pair(X, y, params, 6)
    upto, _ = compare_trees(port.models, jb._gbdt.models)
    assert upto is None or upto >= 2
