"""Scipy sparse input in the port (``Dataset.from_scipy``: binned from
the CSC nonzeros, never densified), on the CPU, against the dense path
and the JAX package: the bins, the EFB plan and the slots byte for byte
(CSR, CSC and COO; wide one-hot and Bosch-shaped data; NaN entries),
summed duplicate entries with the caller's matrix left as it was, an
aligned valid set, and training equal to the dense matrix's. Every
comparison here is exact."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.dataset import Dataset as JDataset
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data.dataset import Dataset

from torch_efb_data import bosch_like, sparse_problem

torch.set_num_threads(2)
PARAMS = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
          "min_data_in_leaf": 5}
KEYS = ("binned", "feature_group", "feature_offset", "group_num_bins",
        "mv_slots")


def _same(a, b):
    assert a.real_feature_idx == b.real_feature_idx
    for m1, m2 in zip(a.bin_mappers, b.bin_mappers):
        assert m1.to_dict() == m2.to_dict()
    for key in KEYS:
        x, y = getattr(a, key), getattr(b, key)
        assert (x is None) == (y is None), key
        if x is not None:
            assert x.dtype == y.dtype, key
            np.testing.assert_array_equal(x, y, err_msg=key)
    assert a.mv_group_start == b.mv_group_start


@pytest.mark.parametrize("shape", ["one_hot", "bosch"])
@pytest.mark.parametrize("form", ["csr", "csc", "coo"])
@pytest.mark.parametrize("sample", [200000, 700])
def test_from_scipy_bins_equal_from_numpy_and_jax(shape, form, sample):
    X, y = sparse_problem(n=3000) if shape == "one_hot" else bosch_like()
    params = dict(PARAMS, bin_construct_sample_cnt=sample)
    cfg = Config.from_params(params)
    M = getattr(sp, f"{form}_matrix")(X)
    dense = Dataset.from_numpy(X, cfg, label=y)
    sparse = Dataset.from_scipy(M, cfg, label=y)
    assert sparse.is_bundled
    _same(sparse, dense)
    _same(sparse, JDataset.from_scipy(M, JConfig.from_params(params),
                                      label=y))


def test_nan_entries_bin_as_dense():
    X, y = sparse_problem(n=2000, f=30)
    X[::11, 2] = np.nan           # a dense column
    X[::13, 10] = np.nan          # a bundled-eligible sparse column
    cfg = Config.from_params(PARAMS)
    _same(Dataset.from_scipy(sp.csr_matrix(X), cfg),
          Dataset.from_numpy(X, cfg))
    _same(Dataset.from_scipy(sp.csr_matrix(X), cfg),
          JDataset.from_scipy(sp.csr_matrix(X), JConfig.from_params(PARAMS)))


def test_duplicate_entries_sum_and_the_callers_matrix_is_unchanged():
    rng = np.random.RandomState(4)
    n, f = 600, 8
    rows = rng.randint(0, n, 3000)
    cols = rng.randint(0, f, 3000)
    vals = rng.randint(1, 5, 3000).astype(np.float64)
    dense = np.zeros((n, f))
    np.add.at(dense, (rows, cols), vals)
    order = np.lexsort((rows, cols))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(cols,
                                                        minlength=f))])
    coo = sp.coo_matrix((vals, (rows, cols)), shape=(n, f))
    csc = sp.csc_matrix((vals[order], rows[order], indptr), shape=(n, f))
    assert not csc.has_canonical_format
    cfg = Config.from_params(PARAMS)
    for M, arrays in ((coo, ("data", "row", "col")),
                      (csc, ("data", "indices", "indptr"))):
        before = [getattr(M, a).copy() for a in arrays]
        _same(Dataset.from_scipy(M, cfg), Dataset.from_numpy(dense, cfg))
        for a, b in zip(arrays, before):
            np.testing.assert_array_equal(getattr(M, a), b)


def test_aligned_valid_set():
    X, y = sparse_problem(n=3000)
    Xv, yv = sparse_problem(n=800, seed=9)
    cfg = Config.from_params(PARAMS)
    for train in (X, sp.csr_matrix(X)):
        tr = lt.Dataset(train, label=y)
        va_sparse = tr.create_valid(sp.csr_matrix(Xv), label=yv)
        va_dense = tr.create_valid(Xv, label=yv)
        tr._construct(cfg)
        _same(va_sparse._construct(cfg), va_dense._construct(cfg))
        assert va_sparse._construct(cfg).binned.shape[1] \
            == tr._construct(cfg).binned.shape[1]


@pytest.mark.parametrize("shape,max_bin", [("one_hot", 255),
                                           ("one_hot", 600),
                                           ("bosch", 255)])
def test_training_equals_dense(shape, max_bin):
    X, y = sparse_problem(n=3000) if shape == "one_hot" else bosch_like()
    params = dict(PARAMS, max_bin=max_bin)
    Xv, _ = sparse_problem(n=500, seed=9) if shape == "one_hot" \
        else bosch_like(n=500, seed=9)
    a = lt.train(params, lt.Dataset(sp.csr_matrix(X), label=y), 6,
                 device="cpu")
    b = lt.train(params, lt.Dataset(X, label=y), 6, device="cpu")
    assert a.model_to_string() == b.model_to_string()
    np.testing.assert_array_equal(a.predict(sp.csr_matrix(Xv)),
                                  b.predict(Xv))
