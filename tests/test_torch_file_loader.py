"""The port's text data files and forced bins on the CPU, against the
JAX package.

* ``data/file_loader.load_file`` on CSV / TSV / LibSVM files: a header,
  ``name:`` columns, ignored columns, ``.weight`` / ``.query`` /
  ``.init`` sidecars, CRLF line ends and junk tokens. Every array equals
  the JAX ``load_file``'s to the bit (NaN-equal), the names too; on
  random tokens the port's parser equals the JAX package's native one.
* ``Dataset(path)`` trains the trees the same arrays train.
* A forced-bins JSON gives the JAX package's bin mappers (``to_dict``
  equal) and binned matrix.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.file_loader import load_file as jax_load_file
from lightgbm_tpu.native import parse_dense_file, parse_libsvm_file
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data.file_loader import atof, load_file

torch.set_num_threads(2)
PARAMS = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
JUNK = ["na", "?", "abc", "", "1e400", "1e-400", "+-2", "nan", "-inf", "1.",
        ".5", "+3", " 4 "]


def _data(seed=0, n=600, f=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.1, 1] = np.nan
    X[rng.rand(n) < 0.3, 2] = 0.0
    y = (X[:, 0] - X[:, 3] + 0.3 * rng.randn(n) > 0).astype(np.float64)
    return X, y


def _write_dense(path, cols, sep, header=None, junk=False, crlf=False):
    """Columns (float arrays) as text, %.17g; with ``junk``, some cells
    of the last column replaced by the junk tokens."""
    n = len(cols[0])
    cells = [[repr(float(v)) if np.isfinite(v) else
              ("nan" if np.isnan(v) else repr(float(v)))
              for v in col] for col in cols]
    if junk:
        for i, tok in enumerate(JUNK):
            cells[-1][3 * i] = tok
    end = "\r\n" if crlf else "\n"
    with open(path, "w", newline="") as f:
        if header:
            f.write(sep.join(header) + end)
        for r in range(n):
            f.write(sep.join(c[r] for c in cells) + end)
            if r == 5:
                f.write(end)                          # a blank line


def _write_libsvm(path, X, y, junk=False):
    with open(path, "w") as f:
        for r in range(len(y)):
            toks = [repr(float(y[r]))] + [
                f"{j}:{float(X[r, j])!r}" for j in range(X.shape[1])
                if X[r, j] != 0]
            if junk and r < len(JUNK):
                toks.append(f"{X.shape[1]}:{JUNK[r]}")
            if r % 7 == 3:
                toks.append("qid:3")                  # skipped token
            f.write(" ".join(toks) + "\n")


def _assert_same(port, ref):
    assert len(port) == len(ref) == 6
    for a, b in zip(port[:5], ref[:5]):
        if b is None:
            assert a is None
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        assert (np.signbit(a) == np.signbit(b))[~np.isnan(b)].all()
    assert port[5] == ref[5]


CASES = {
    "csv": dict(sep=",", params={}),
    "csv_junk_crlf": dict(sep=",", params={}, junk=True, crlf=True),
    "tsv_header": dict(sep="\t", params={"header": True}, header=True),
    "csv_named_columns": dict(
        sep=",", header=True, junk=True,
        params={"header": True, "label_column": "name:target",
                "weight_column": "name:w", "ignore_column": "name:skip"}),
    "csv_index_columns": dict(
        sep=",", params={"label_column": "2", "weight_column": "0",
                         "ignore_column": "4,5", "group_column": "1"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_file_loads_as_in_jax(tmp_path, case):
    spec = CASES[case]
    X, y = _data()
    rng = np.random.RandomState(1)
    w = rng.rand(len(y)) + 0.5
    qid = np.repeat(np.arange(60), 10).astype(np.float64)
    if case == "csv_index_columns":
        cols = [w, qid, y] + [X[:, j] for j in range(5)]
    else:
        cols = [y, w] + [X[:, j] for j in range(5)]
    names = ["target", "w", "f0", "skip", "f2", "f3", "f4"]
    path = str(tmp_path / f"{case}.txt")
    _write_dense(path, cols, spec["sep"],
                 header=names if spec.get("header") else None,
                 junk=spec.get("junk", False), crlf=spec.get("crlf", False))
    port = load_file(path, Config.from_params(spec["params"]))
    ref = jax_load_file(path, JConfig.from_params(spec["params"]))
    _assert_same(port, ref)


def test_libsvm_file_and_sidecars_load_as_in_jax(tmp_path):
    X, y = _data(2)
    path = str(tmp_path / "train.svm")
    _write_libsvm(path, np.nan_to_num(X), y, junk=True)
    rng = np.random.RandomState(3)
    np.savetxt(path + ".weight", rng.rand(len(y)) + 0.5, fmt="%.17g")
    np.savetxt(path + ".query", np.full(60, 10), fmt="%d")
    with open(path + ".init", "w") as f:
        f.write("init\n" + "\n".join(repr(float(v))
                                      for v in rng.randn(len(y))))
    port = load_file(path, Config.from_params({}))
    ref = jax_load_file(path, JConfig.from_params({}))
    _assert_same(port, ref)
    assert port[3].sum() == len(y) and port[1].shape == (len(y),)


@pytest.mark.parametrize("seed", range(4))
def test_random_tokens_parse_as_the_native_parser(tmp_path, seed):
    """Random tokens of number-like characters, junk and edge values:
    the port's parser against the JAX package's native one (no tab in a
    CSV row, which the format sniffer would take for TSV)."""
    alpha = list("0123456789.eE+-nNaAiIfFtTyY ") + [
        "nan", "inf", "1e-400", "1e400", "1.5", "-0", "\r", "_", "x", "(",
        ")", "Infinity", "1e-320", "2e-324", "é"]
    rng = random.Random(seed)

    def tok():
        return "".join(rng.choice(alpha) for _ in range(rng.randint(0, 6)))
    dense = str(tmp_path / "f.csv")
    with open(dense, "w", newline="") as f:
        f.write("\n".join(",".join(tok() for _ in range(6))
                          for _ in range(40)) + "\n")
    ref = parse_dense_file(dense, ",")
    assert ref is not None
    got = load_file(dense, Config.from_params({"label_column": "0"}))
    np.testing.assert_array_equal(got[1], ref[:, 0])
    np.testing.assert_array_equal(got[0], ref[:, 1:])
    svm = str(tmp_path / "f.svm")
    alpha += ["\t", ":", "3:", "qid:", "#"]
    with open(svm, "w", newline="") as f:
        f.write("1 1:2 3:4\n0 2:1.5\n")        # LibSVM to the sniffer
        for _ in range(40):
            toks = [rng.choice(["1", "0", tok()])] + [
                rng.choice([f"{rng.randint(0, 9)}:{tok()}", tok()])
                for _ in range(rng.randint(0, 6))]
            f.write(rng.choice([" ", "\t"]).join(toks) + "\n")
    labels, rowptr, cols, vals, max_idx = parse_libsvm_file(svm)
    X = np.zeros((len(labels), max_idx + 1))
    X[np.repeat(np.arange(len(labels)), np.diff(rowptr)), cols] = vals
    gX, gy = load_file(svm, Config.from_params({}))[:2]
    np.testing.assert_array_equal(gy, labels)
    np.testing.assert_array_equal(gX, X)


@pytest.mark.parametrize("token,value", [
    ("1.5", 1.5), (" 2\t", 2.0), ("+3", 3.0), ("+-4", -4.0), ("++5", None),
    ("1e400", None), ("1e-400", None), ("0e-400", 0.0), ("-0", -0.0),
    ("1e-320", 1e-320), ("Infinity", np.inf), ("-inf", -np.inf),
    ("nan(12)", None), ("1_0", None), ("0x10", None), ("1.", 1.0),
    (".5", 0.5), ("", None), ("na", None), ("1e", None)])
def test_token_rules(token, value):
    v = atof(token)
    if value is None:
        assert np.isnan(v)
    else:
        assert v == value and np.signbit(v) == np.signbit(value)


def test_unreadable_files_raise(tmp_path):
    ragged = str(tmp_path / "ragged.csv")
    with open(ragged, "w") as f:
        f.write("1,2,3\n4,5\n")
    quoted = str(tmp_path / "quoted.csv")
    with open(quoted, "w") as f:
        f.write('1,"2",3\n4,5,6\n')
    for path in (ragged, quoted, str(tmp_path / "missing.csv")):
        with pytest.raises(lt.utils.log.LightGBMError):
            load_file(path, Config.from_params({}))


@pytest.mark.parametrize("fmt", ["csv", "libsvm"])
def test_training_from_a_file_grows_the_arrays_trees(tmp_path, fmt):
    X, y = _data(4, n=1500)
    if fmt == "libsvm":
        X = np.nan_to_num(X)
        path = str(tmp_path / "train.svm")
        _write_libsvm(path, X, y)
        params = PARAMS
    else:
        path = str(tmp_path / "train.csv")
        _write_dense(path, [y] + [X[:, j] for j in range(5)], ",",
                     header=["y"] + [f"x{j}" for j in range(5)])
        params = dict(PARAMS, header=True)
    from_file = lt.train(params, lt.Dataset(path), 3, device="cpu")
    from_arrays = lt.train(params, lt.Dataset(X, label=y), 3, device="cpu")
    assert len(from_file.models) == len(from_arrays.models) == 3
    for a, b in zip(from_file.models, from_arrays.models):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold, b.threshold)
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)
    names = from_file.feature_name()
    assert names == ([f"x{j}" for j in range(5)] if fmt == "csv"
                     else [f"Column_{j}" for j in range(5)])
    # continued training re-reads the file's rows for its seed scores
    more = lt.train(params, lt.Dataset(path), 1, init_model=from_file,
                    device="cpu")
    assert len(more.models) == 4


def test_forced_bins_match_jax(tmp_path):
    X, y = _data(5, n=2000)
    path = str(tmp_path / "forced.json")
    with open(path, "w") as f:
        json.dump([{"feature": 0, "bin_upper_bound": [-1.0, 0.0, 0.5]},
                   {"feature": 2, "bin_upper_bound": [0.25, 1.5]},
                   {"feature": 4, "bin_upper_bound": [-0.3]}], f)
    params = dict(PARAMS, forcedbins_filename=path, max_bin=31)
    jds = lgb.Dataset(X, label=y, params=params).construct()._inner
    pds = lt.Dataset(X, label=y)._construct(Config.from_params(params))
    assert [m.to_dict() for m in pds.bin_mappers] \
        == [m.to_dict() for m in jds.bin_mappers]
    np.testing.assert_array_equal(pds.binned, np.asarray(jds.binned))
    plain = lt.Dataset(X, label=y)._construct(
        Config.from_params(dict(PARAMS, max_bin=31)))
    assert [m.to_dict() for m in plain.bin_mappers] \
        != [m.to_dict() for m in pds.bin_mappers]
    ub = pds.bin_mappers[0].bin_upper_bound
    assert {-1.0, 0.5} <= set(ub)


def test_file_and_model_path_import_no_pandas_and_no_jax(tmp_path):
    """The port reads text files and models with numpy and the standard
    library: neither pandas nor JAX is imported on the way."""
    import subprocess
    import sys
    X, y = _data(6, n=300)
    path = str(tmp_path / "train.csv")
    _write_dense(path, [y] + [X[:, j] for j in range(5)], ",")
    code = (
        "import sys\n"
        "import lightgbm_tpu_torch as lt\n"
        f"b = lt.train({PARAMS!r}, lt.Dataset({path!r}), 2, device='cpu')\n"
        "lt.Booster(model_str=b.model_to_string(), device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('pandas', 'jax', 'jaxlib', 'lightgbm_tpu')]\n"
        "assert not bad, bad\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo,
                   env=dict(os.environ, PYTHONPATH=repo), timeout=120)
