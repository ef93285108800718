"""The port's Dataset API against the JAX package's, on the CPU: the
row ``subset`` (binned rows, multi-val slots, raw values, metadata) of
a dense, a bundled, a multi-val and a linear-tree dataset against the
JAX inner ``subset``; the lazy ``lt.Dataset.subset`` with whole
queries; ``save_binary`` written by one package and loaded by the other
(and by ``lt.Dataset(path)``), with the layout check against a
reference; ``add_features_from`` against JAX's, dense and bundled, and
its multi-val refusal; the setters and getters.

Tolerances: every matrix, map and metadata array exactly (the same
numpy operations on the same bins). One logged difference (ROADMAP.md
Queue 3): the JAX inner ``subset`` keeps the parent's whole
``raw_numeric``; the port cuts it to the subset's rows, so the test
holds the port's rows against JAX's ``raw_numeric[indices]``.
"""

import json

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.dataset import Dataset as JDataset
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data.dataset import Dataset
from lightgbm_tpu_torch.utils.log import LightGBMError

from torch_efb_data import bosch_like, sparse_problem


def _dense(n=3000, f=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.1, 2] = np.nan
    X[:, 5] = np.round(X[:, 5])
    y = (X[:, 0] - X[:, 1] + rng.randn(n) * 0.5 > 0).astype(np.float32)
    return X, y


def _problem(kind):
    """(X, label, params) of one dataset shape."""
    if kind == "dense":
        X, y = _dense()
        return X, y, {}
    if kind == "bundled":
        X, y = sparse_problem(3000, 40)
        return X, y, {}
    if kind == "multival":
        X, y = bosch_like()
        return X, y, {}
    X, y = _dense()
    return X, y, {"linear_tree": True}


def _pair(kind, **meta):
    X, y, params = _problem(kind)
    port = Dataset.from_numpy(X, Config.from_params(params), label=y,
                              **meta)
    jax = JDataset.from_numpy(X, JConfig.from_params(params), label=y,
                              **meta)
    return X, port, jax


def _same_layout(a, b):
    assert np.array_equal(a.binned, b.binned)
    assert a.binned.dtype == b.binned.dtype
    for key in ("used_feature_map", "real_feature_idx", "num_total_features",
                "feature_names", "mv_group_start", "num_data"):
        assert list(np.atleast_1d(getattr(a, key))) \
            == list(np.atleast_1d(getattr(b, key))), key
    for key in ("feature_group", "feature_offset", "group_num_bins",
                "mv_slots"):
        x, z = getattr(a, key), getattr(b, key)
        assert (x is None) == (z is None), key
        if x is not None:
            assert np.array_equal(x, z), key
    # as text: a NaN upper bound (the missing bin) equals itself there
    assert json.dumps([m.to_dict() for m in a.bin_mappers]) \
        == json.dumps([m.to_dict() for m in b.bin_mappers])


def _same_metadata(a, b):
    for key in ("label", "weights", "init_score", "query_boundaries",
                "query_weights"):
        x, z = getattr(a, key), getattr(b, key)
        assert (x is None) == (z is None), key
        if x is not None:
            assert np.array_equal(x, z), key


@pytest.mark.parametrize("kind", ["dense", "bundled", "multival", "linear"])
def test_subset_matches_jax(kind):
    n = 3000 if kind != "multival" else 2500
    rng = np.random.RandomState(1)
    weight = rng.rand(n) + 0.5
    init = rng.randn(n)
    X, port, jax = _pair(kind, weight=weight, init_score=init)
    if kind == "bundled":
        assert port.is_bundled and not port.has_multival
    if kind == "multival":
        assert port.has_multival
    idx = np.sort(rng.choice(n, n * 2 // 3, replace=False))
    ps, js = port.subset(idx), jax.subset(idx)
    _same_layout(ps, js)
    _same_metadata(ps.metadata, js.metadata)
    if kind == "linear":
        assert np.array_equal(ps.raw_numeric, jax.raw_numeric[idx],
                              equal_nan=True)
    else:
        assert ps.raw_numeric is None
    # the parent is untouched and the subset owns its rows
    assert port.num_data == n and ps.num_data == len(idx)


def test_subset_keeps_the_class_major_init_score():
    """A 3-class init score [k, N] keeps each class's block."""
    X, y = _dense()
    n = len(y)
    init = np.random.RandomState(2).randn(3 * n)
    port = Dataset.from_numpy(X, Config.from_params({}), label=y,
                              init_score=init)
    jax = JDataset.from_numpy(X, JConfig.from_params({}), label=y,
                              init_score=init)
    idx = np.arange(0, n, 7)
    ps = port.subset(idx)
    assert np.array_equal(ps.metadata.init_score,
                          jax.subset(idx).metadata.init_score)
    assert np.array_equal(ps.metadata.init_score,
                          init.reshape(3, n)[:, idx].ravel())


@pytest.mark.parametrize("own_group", [False, True])
def test_lazy_subset_keeps_whole_queries(own_group):
    """``lt.Dataset.subset`` of a ranking set rebuilds whole queries from
    the parent's query ids (or takes a group of its own), as
    ``lgb.Dataset.subset`` does."""
    rng = np.random.RandomState(3)
    sizes = rng.randint(5, 20, 100)
    n = int(sizes.sum())
    X, _ = _dense(n)
    y = rng.randint(0, 4, n).astype(np.float64)
    qid = np.repeat(np.arange(len(sizes)), sizes)
    keep = np.nonzero(np.isin(qid, np.arange(0, len(sizes), 3)))[0]
    group = np.bincount(qid[keep])[::3] if own_group else None
    params = {"objective": "lambdarank"}
    pt = lt.Dataset(X, label=y, group=sizes, params=params)
    jt = lgb.Dataset(X, label=y, group=sizes, params=params)
    ps = pt.subset(keep[::-1])
    js = jt.subset(keep[::-1])
    if own_group:
        ps.set_group(group)
        js.set_group(group)
    assert np.array_equal(ps.used_indices, keep)
    ps.construct()
    js.construct()
    assert np.array_equal(ps.get_group(), js.get_group())
    assert ps.get_group().sum() == len(keep)
    _same_layout(ps._binned, js._inner)
    _same_metadata(ps._binned.metadata, js._inner.metadata)
    assert ps.num_data() == len(keep)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", ["dense", "bundled", "multival"])
def test_save_binary_cross_loads(tmp_path, kind, direction):
    """A file written by one package loads in the other: the same bins,
    slots, maps, mappers, metadata and layout fingerprint."""
    X, port, jax = _pair(kind, weight=np.linspace(0.5, 1.5, len(_problem(
        kind)[1])))
    path = str(tmp_path / "train.bin")
    if direction == "jax_to_port":
        jax.save_binary(path)
        assert Dataset.is_binary_file(path)
        loaded, ref = Dataset.load_binary(path), jax
    else:
        port.save_binary(path)
        assert JDataset.is_binary_file(path)
        loaded, ref = JDataset.load_binary(path), port
    _same_layout(loaded, ref)
    _same_metadata(loaded.metadata, ref.metadata)
    assert loaded.bin_layout_fingerprint() == ref.bin_layout_fingerprint()
    assert port.bin_layout_fingerprint() == jax.bin_layout_fingerprint()


def test_binary_file_trains_as_the_text_data(tmp_path):
    """``lt.Dataset(path)`` of a saved file: the bins, label and query
    of the in-memory dataset (the file's label filled in), the same
    trees, and a label given beside the file overrides it."""
    X, y = _dense()
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
    mem = lt.Dataset(X, label=y, params=params)
    path = str(tmp_path / "train.bin")
    mem.save_binary(path)
    disk = lt.Dataset(path, params=params)
    assert np.array_equal(disk._construct().binned, mem._construct().binned)
    assert np.array_equal(disk.get_label(), y)
    a = lt.train(params, mem, 3, device="cpu")
    b = lt.train(params, disk, 3, device="cpu")
    assert a.model_to_string() == b.model_to_string()
    flipped = lt.Dataset(path, label=1 - y, params=params)
    assert np.array_equal(flipped._construct().metadata.label, 1 - y)
    # what JAX makes of the same file
    j = lgb.Dataset(path, params=params).construct()
    assert np.array_equal(j._inner.binned, disk._construct().binned)


def test_binary_file_layout_must_match_its_reference(tmp_path):
    """A valid set loaded from a file saved with other bins than its
    reference's is refused (the reference's ``CheckAlign``), as in the
    JAX package; one saved with the reference's bins loads."""
    X, y = _dense()
    train = lt.Dataset(X, label=y)
    other = lt.Dataset(X * 3 + 1, label=y)
    bad = str(tmp_path / "bad.bin")
    other.save_binary(bad)
    with pytest.raises(LightGBMError, match="different bin layout"):
        lt.Dataset(bad, reference=train).construct()
    good = str(tmp_path / "good.bin")
    train.create_valid(X[:500], label=y[:500]).save_binary(good)
    valid = lt.Dataset(good, reference=train)
    assert valid.num_data() == 500
    jtrain = lgb.Dataset(X, label=y).construct()
    with pytest.raises(Exception, match="different bin layout"):
        lgb.Dataset(bad, reference=jtrain).construct()


def test_is_binary_file_needs_the_members(tmp_path):
    """A file that merely starts with ``PK`` is text, not a dataset."""
    path = tmp_path / "pk.csv"
    path.write_text("PK,1,2\n1,2,3\n")
    assert not Dataset.is_binary_file(str(path))
    assert not JDataset.is_binary_file(str(path))
    assert not Dataset.is_binary_file(str(tmp_path / "missing.bin"))


@pytest.mark.parametrize("kind", ["dense", "bundled"])
def test_add_features_from_matches_jax(kind):
    """Columns split in two and joined again: the port's join equals
    JAX's, map for map; with dense columns it is also the whole
    matrix's binning."""
    X, y, _ = _problem(kind)
    half = X.shape[1] // 2
    cfg, jcfg = Config.from_params({}), JConfig.from_params({})
    a = Dataset.from_numpy(X[:, :half], cfg, label=y)
    b = Dataset.from_numpy(X[:, half:], cfg)
    ja = JDataset.from_numpy(X[:, :half], jcfg, label=y)
    jb = JDataset.from_numpy(X[:, half:], jcfg)
    if kind == "bundled":
        assert b.is_bundled
    a.add_features_from(b)
    ja.add_features_from(jb)
    _same_layout(a, ja)
    _same_metadata(a.metadata, ja.metadata)
    for key in ("monotone_types", "feature_penalty"):
        assert list(getattr(a, key)) == list(getattr(ja, key))
    if kind == "dense":
        whole = Dataset.from_numpy(X, cfg, label=y)
        assert np.array_equal(a.binned, whole.binned)


def test_add_features_from_wrapper_trains():
    """``lt.Dataset.add_features_from`` joins two binned datasets in
    place; training on the join equals training on the whole matrix."""
    X, y = _dense()
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
    left = lt.Dataset(X[:, :4], label=y, params=params)
    left.add_features_from(lt.Dataset(X[:, 4:], params=params))
    assert left.num_feature() == X.shape[1]
    a = lt.train(params, left, 3, device="cpu")
    b = lt.train(params, lt.Dataset(X, label=y, params=params), 3,
                 device="cpu")
    assert [t.num_leaves for t in a.models] == [t.num_leaves
                                                for t in b.models]
    for ta, tb in zip(a.models, b.models):
        assert np.array_equal(ta.split_feature, tb.split_feature)
        assert np.array_equal(ta.leaf_value, tb.leaf_value)


@pytest.mark.parametrize("which", ["self", "other", "rows"])
def test_add_features_from_refusals(which):
    """Multi-val on either side and a row count mismatch raise
    ``LightGBMError``, as in the JAX package."""
    X, y = bosch_like()
    mv = Dataset.from_numpy(X, Config.from_params({}), label=y)
    dense = Dataset.from_numpy(_dense(len(y))[0], Config.from_params({}))
    a, b = {"self": (mv, dense), "other": (dense, mv),
            "rows": (dense, Dataset.from_numpy(_dense(100)[0],
                                               Config.from_params({})))
            }[which]
    with pytest.raises(LightGBMError):
        a.add_features_from(b)


def test_setters_and_getters_match_jax():
    X, y = _dense(600)
    w = np.linspace(0.5, 2.0, 600)
    init = np.full(600, 0.25)
    out = []
    for pkg in (lt, lgb):
        ds = pkg.Dataset(X, label=y, feature_name=[f"f{i}" for i in
                                                   range(8)])
        ds.construct()
        ds.set_label(1 - y).set_weight(w).set_init_score(init)
        ds.set_group([300, 300])
        ref = pkg.Dataset(X)
        assert ds.set_reference(ref) is ds
        out.append((ds.get_label(), ds.get_weight(), ds.get_init_score(),
                    ds.get_group(), ds.num_data(), ds.num_feature(),
                    ds.get_feature_name(), ds.get_data() is X,
                    len(ds.get_ref_chain()), ref in ds.get_ref_chain()))
    p, j = out
    for a, b in zip(p, j):
        if isinstance(a, np.ndarray):
            assert np.array_equal(np.asarray(a, np.float64),
                                  np.asarray(b, np.float64))
        else:
            assert a == b
    assert p[6] == [f"f{i}" for i in range(8)] and p[8] == 2
