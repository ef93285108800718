"""Port data layer vs the JAX package: same bin mappers and the same
binned matrix from the same arrays (exact), including NaN, zero-heavy,
constant and categorical columns; the EFB check and the slice's
rejections."""

import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data import Dataset as JDataset
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import bin_mappers_from_state
from lightgbm_tpu_torch.data import Dataset

torch.set_num_threads(2)


def _matrix(seed=0, n=3000):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 7)
    X[rng.rand(n) < 0.15, 1] = np.nan                 # NaN-missing
    X[rng.rand(n) < 0.6, 2] = 0.0                     # zero-heavy
    X[:, 3] = np.round(X[:, 3] * 3)                   # few distinct
    X[:, 4] = 1.0                                     # constant: dropped
    X[:, 5] = np.exp(X[:, 5])                         # skewed positive
    X[rng.rand(n) < 0.05, 6] = np.nan
    y = (X[:, 0] > 0).astype(np.float32)
    return X, y


@pytest.mark.parametrize("params", [
    {"max_bin": 255},
    {"max_bin": 63, "min_data_in_bin": 5},
    {"max_bin": 255, "zero_as_missing": True},
    {"max_bin": 255, "use_missing": False},
    {"max_bin": 15, "bin_construct_sample_cnt": 1000},
    {"max_bin": 1023},     # uint16 bins; on the device as int16 bits
])
def test_bins_and_matrix_equal_jax(params):
    X, y = _matrix()
    p = dict(params, objective="binary", verbosity=-1)
    jds = JDataset.from_numpy(X, JConfig.from_params(p), label=y)
    tds = Dataset.from_numpy(X, Config.from_params(p), label=y)
    assert tds.real_feature_idx == jds.real_feature_idx
    assert tds.used_feature_map == jds.used_feature_map
    for a, b in zip(jds.bin_mappers, tds.bin_mappers):
        da, db = a.to_dict(), b.to_dict()
        ub_a, ub_b = da.pop("bin_upper_bound"), db.pop("bin_upper_bound")
        np.testing.assert_array_equal(np.asarray(ub_a), np.asarray(ub_b))
        assert da == db
    assert jds.binned.dtype == tds.binned.dtype
    np.testing.assert_array_equal(jds.binned, tds.binned)
    np.testing.assert_array_equal(
        tds.binned_device("cpu").numpy(), jds.binned)


def test_carried_mappers_bin_identically():
    """convert.bin_mappers_from_state: the JAX dataset's mapper state
    (numpy/plain values) bins a NEW matrix exactly as JAX does."""
    X, y = _matrix(1)
    X2, _ = _matrix(2, n=500)
    p = {"objective": "binary", "verbosity": -1}
    jds = JDataset.from_numpy(X, JConfig.from_params(p), label=y)
    jvalid = jds.create_valid(X2)
    mappers = bin_mappers_from_state([m.to_dict() for m in jds.bin_mappers])
    tds = Dataset.from_numpy(X2, Config.from_params(p),
                             bin_mappers=mappers)
    np.testing.assert_array_equal(tds.binned, jvalid.binned)


def test_dense_matrix_forms_no_bundle():
    X, y = _matrix(3)
    tds = Dataset.from_numpy(X, Config.from_params({"verbosity": -1}),
                             label=y)
    assert tds.binned.shape == (X.shape[0], tds.num_features)


def test_sparse_matrix_that_would_bundle_is_rejected():
    """Mutually exclusive sparse columns, once refused, now bundle (EFB,
    ROADMAP.md Queue 1 item 7.3) into the JAX package's columns;
    ``enable_bundle=false`` keeps one column a feature."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.data.dataset import Dataset as JDataset
    rng = np.random.RandomState(4)
    n = 2000
    X = np.zeros((n, 6))
    for j in range(6):   # mutually exclusive sparse columns
        rows = np.arange(j, n, 6)
        X[rows, j] = rng.rand(len(rows)) + 1.0
    cfg = Config.from_params({"verbosity": -1})
    tds = Dataset.from_numpy(X, cfg)
    jds = JDataset.from_numpy(X, JConfig.from_params({"verbosity": -1}))
    assert tds.is_bundled and tds.binned.shape[1] < 6
    np.testing.assert_array_equal(tds.binned, jds.binned)
    np.testing.assert_array_equal(tds.feature_offset, jds.feature_offset)
    off = Config.from_params({"verbosity": -1, "enable_bundle": False})
    assert Dataset.from_numpy(X, off).num_features == 6
    assert Dataset.from_numpy(X, off).binned.shape == (n, 6)


@pytest.mark.parametrize("max_bin", [255, 15])
def test_categorical_mappers_match_jax(max_bin):
    """Categorical columns (a few distinct values; a skewed 60-way
    column with negative values, which become NaN, cut at 99% of the
    sample or at max_bin) bin as the JAX package bins them: the same
    mappers and the same matrix, a valid set through the same bins."""
    X, y = _matrix(5)
    rng = np.random.RandomState(6)
    X[:, 6] = np.minimum(rng.zipf(1.3, len(X)), 60) - 3.0
    p = {"verbosity": -1, "max_bin": max_bin}
    cats = [3, 6]
    tds = Dataset.from_numpy(X, Config.from_params(p), label=y,
                             categorical_features=cats)
    jds = JDataset.from_numpy(X, JConfig.from_params(p), label=y,
                              categorical_features=cats)
    assert [m.to_dict() for m in tds.bin_mappers] \
        == [m.to_dict() for m in jds.bin_mappers]
    assert tds.feature_mapper(tds.used_feature_map[6]).bin_type \
        == "categorical"
    np.testing.assert_array_equal(tds.binned, np.asarray(jds.binned))
    Xv, _ = _matrix(7, n=500)
    Xv[:, 6] = np.arange(500) % 70 - 3.0          # unseen categories too
    vt = Dataset.from_numpy(Xv, Config.from_params(p), reference=tds)
    vj = JDataset.from_numpy(Xv, JConfig.from_params(p), reference=jds)
    np.testing.assert_array_equal(vt.binned, np.asarray(vj.binned))
