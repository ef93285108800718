"""Two-round file loading in the port (``two_round=true``: pass 1 draws
the bin sample and reads the label columns, pass 2 bins chunk by chunk),
on the CPU, against in-memory loading of the same file and against the
JAX package's two-round loader: the bin mappers, the (bundled) matrix,
the slots and the metadata byte for byte, with row sampling, header
weight and query columns, LibSVM, an aligned valid set, and the same
trees. Small chunks force several chunks a pass. Every comparison here
is exact."""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.dataset import Dataset as JDataset
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data import file_loader

from torch_efb_data import bosch_like, sparse_problem

torch.set_num_threads(2)
PARAMS = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
          "min_data_in_leaf": 5}


def _write_csv(path, X, y, header=None):
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.17g",
               header=header or "", comments="")


def _write_libsvm(path, X, y):
    with open(path, "w") as fh:
        for i in range(len(X)):
            nz = np.flatnonzero(X[i])
            fh.write(" ".join([f"{y[i]:.17g}"] + [f"{j}:{X[i, j]:.17g}"
                                                  for j in nz]) + "\n")


def _loads(path, params, monkeypatch, chunk=97):
    monkeypatch.setattr(file_loader, "TWO_ROUND_CHUNK_ROWS", chunk)
    one = lt.Dataset(path)._construct(Config.from_params(params))
    two = lt.Dataset(path)._construct(Config.from_params(
        dict(params, two_round=True)))
    return one, two


def _same(a, b):
    for m1, m2 in zip(a.bin_mappers, b.bin_mappers):
        assert m1.to_dict() == m2.to_dict()
    assert a.real_feature_idx == b.real_feature_idx
    for key in ("binned", "feature_group", "feature_offset", "mv_slots"):
        x, y = getattr(a, key), getattr(b, key)
        assert (x is None) == (y is None), key
        if x is not None:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y, err_msg=key)
    for key in ("label", "weights", "query_boundaries", "init_score"):
        x, y = getattr(a.metadata, key), getattr(b.metadata, key)
        assert (x is None) == (y is None), key
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=key)


@pytest.mark.parametrize("shape", ["one_hot", "bosch"])
@pytest.mark.parametrize("sample", [200000, 500])
def test_two_round_equals_in_memory_and_jax(tmp_path, monkeypatch, shape,
                                            sample):
    X, y = sparse_problem(n=1500, f=40) if shape == "one_hot" \
        else bosch_like(n=1500)
    X[::17, 1] = np.nan
    path = str(tmp_path / "train.csv")
    _write_csv(path, X, y)
    params = dict(PARAMS, bin_construct_sample_cnt=sample)
    one, two = _loads(path, params, monkeypatch)
    assert two.is_bundled
    assert two.has_multival == (shape == "bosch")
    _same(one, two)
    monkeypatch.setenv("LGBM_TPU_TWO_ROUND_CHUNK_ROWS", "97")
    jds = JDataset.from_file_two_round(path, JConfig.from_params(
        dict(params, two_round=True)))
    _same(two, jds)


def test_header_weight_and_query_columns(tmp_path, monkeypatch):
    rng = np.random.RandomState(3)
    n = 400
    X, _ = sparse_problem(n=n, f=20)
    y = (X[:, 0] > 0).astype(np.float64)
    w = rng.rand(n) + 0.5
    qid = np.repeat(np.arange(20), 20).astype(np.float64)
    path = str(tmp_path / "h.csv")
    header = "label,w,q," + ",".join(f"f{i}" for i in range(20))
    np.savetxt(path, np.column_stack([y, w, qid, X]), delimiter=",",
               fmt="%.17g", header=header, comments="")
    params = dict(PARAMS, header=True, label_column="name:label",
                  weight_column="name:w", group_column="name:q")
    one, two = _loads(path, params, monkeypatch, chunk=64)
    _same(one, two)
    assert two.metadata.query_boundaries is not None
    assert two.feature_names == [f"f{i}" for i in range(20)]
    ds = lt.Dataset(path)
    ds._construct(Config.from_params(dict(params, two_round=True)))
    assert ds.feature_name == [f"f{i}" for i in range(20)]


def test_libsvm(tmp_path, monkeypatch):
    X, y = sparse_problem(n=900, f=40)
    path = str(tmp_path / "train.svm")
    _write_libsvm(path, X, y)
    one, two = _loads(path, PARAMS, monkeypatch, chunk=128)
    assert two.binned.shape[1] < 40
    _same(one, two)


def test_aligned_valid_set_and_the_same_trees(tmp_path, monkeypatch):
    X, y = sparse_problem(n=1500, f=40)
    Xv, yv = sparse_problem(n=500, f=40, seed=9)
    tr, va = str(tmp_path / "t.csv"), str(tmp_path / "v.csv")
    _write_csv(tr, X, y)
    _write_csv(va, Xv, yv)
    monkeypatch.setattr(file_loader, "TWO_ROUND_CHUNK_ROWS", 128)
    out = []
    for two_round in (False, True):
        params = dict(PARAMS, two_round=two_round)
        ds = lt.Dataset(tr)
        ev = {}
        bst = lt.train(params, ds, 5, valid_sets=[lt.Dataset(va,
                                                             reference=ds)],
                       evals_result=ev, verbose_eval=False, device="cpu")
        vb = bst._gbdt.valid_sets[0]
        out.append((bst.model_to_string().split("parameters:")[0], ev,
                    vb.binned))
    assert out[0][0] == out[1][0]
    assert out[0][1] == out[1][1]
    np.testing.assert_array_equal(out[0][2], out[1][2])
