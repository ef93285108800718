"""``task=convert_model`` in the port (``lightgbm_tpu_torch/io/codegen.py``)
against the JAX package's (``lightgbm_tpu/io/codegen.py``), on the CPU.

For the same model text the generated C++ is byte-equal to JAX's: every
golden model the reference CLI wrote (binary, multiclass, categorical,
monotone, rank, regression_l1, sparse EFB, tweedie, weighted), a
tree of 1,200 leaves over a staircase (under a recursion limit of 600)
and linear leaves; the CLI task writes JAX's file. Compiled with
``g++ -O2 -shared -fPIC`` (skipped without ``g++``, as
``tests/test_codegen.py``), the code predicts the port's
``Booster.predict`` within 1e-12 raw and 1e-10 converted (1e-4 for
linear leaves, whose port walk adds in float32), with NaN and zero
inputs routed as the trees route them.
"""

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu import cli as jcli
from lightgbm_tpu.io import codegen as jcodegen
from lightgbm_tpu.io import model_text as jtext
from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.io import model_text as ptext
from lightgbm_tpu_torch.io.codegen import model_to_if_else

from golden_common import DATASETS

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
GOLDEN = ["binary", "multiclass", "categorical", "monotone", "rank",
          "regression_l1", "sparse_efb", "tweedie", "weighted"]
HAVE_GXX = shutil.which("g++") is not None
needs_gxx = pytest.mark.skipif(not HAVE_GXX, reason="g++ not available")


def _golden_text(name):
    with open(os.path.join(FIXDIR, f"model_{name}.txt")) as fh:
        return fh.read()


@pytest.fixture(scope="module")
def deep_text():
    """1,200 leaves over a monotone staircase."""
    n = 4000
    X = np.arange(n, dtype=np.float64).reshape(-1, 1)
    bst = lt.train({"objective": "regression", "num_leaves": 1200,
                    "min_data_in_leaf": 1, "min_sum_hessian_in_leaf": 0,
                    "max_depth": -1, "max_bin": 4000, "verbosity": -1},
                   lt.Dataset(X, label=X[:, 0].copy()), 1, device="cpu")
    return bst.model_to_string(), X


@pytest.fixture(scope="module")
def linear_text():
    rng = np.random.RandomState(4)
    X = rng.randn(400, 5)
    y = 2.0 * X[:, 0] - X[:, 1] + 0.05 * rng.randn(400)
    bst = lt.train({"objective": "regression", "num_leaves": 7,
                    "linear_tree": True, "linear_lambda": 0.01,
                    "verbosity": -1}, lt.Dataset(X, label=y), 4,
                   device="cpu")
    return bst.model_to_string(), X


def _both(text):
    return (model_to_if_else(ptext.load_model_from_string(text)),
            jcodegen.model_to_if_else(jtext.load_model_from_string(text)))


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_source_byte_equal_to_jax(name):
    port, jax = _both(_golden_text(name))
    assert port == jax
    assert "PredictTree0" in port and "LGBM_EXPORT" in port


def test_deep_tree_source_byte_equal_to_jax(deep_text):
    text, _ = deep_text
    booster = ptext.load_model_from_string(text)
    assert booster.models[0].num_leaves == 1200
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(600)     # the emitter keeps its own stack
    try:
        port = model_to_if_else(booster)
    finally:
        sys.setrecursionlimit(old)
    assert port == jcodegen.model_to_if_else(
        jtext.load_model_from_string(text))


def test_linear_source_byte_equal_to_jax(linear_text):
    port, jax = _both(linear_text[0])
    assert port == jax
    assert "std::isnan(a[" in port


def test_cli_convert_model_writes_jax_file(tmp_path):
    model = os.path.join(FIXDIR, "model_categorical.txt")
    outs = []
    for name, mod, extra in (("port", cli, ["device_type=cpu"]),
                             ("jax", jcli, [])):
        out = str(tmp_path / f"{name}.cpp")
        mod.main(["task=convert_model", f"input_model={model}",
                  f"convert_model={out}", "convert_model_language=cpp"]
                 + extra)
        with open(out, "rb") as fh:
            outs.append(fh.read())
    assert outs[0] == outs[1]
    with pytest.raises(lt.LightGBMError, match="only cpp"):
        cli.main(["task=convert_model", f"input_model={model}",
                  "convert_model_language=java"])


# ---- the compiled code against the port's Booster.predict ---------------

def _compile(source, tmp_path):
    src, lib = tmp_path / "model.cpp", tmp_path / "model.so"
    src.write_text(source)
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(lib),
                    str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    for fn in (dll.GetNumClasses, dll.GetNumTrees, dll.GetNumFeatures):
        fn.restype = ctypes.c_int
        fn.argtypes = []
    for fn in (dll.PredictRaw, dll.Predict):
        fn.restype = None
        fn.argtypes = [ctypes.POINTER(ctypes.c_double),
                       ctypes.POINTER(ctypes.c_double)]
    return dll


def _predict(dll, X, raw=True):
    k, nf = dll.GetNumClasses(), dll.GetNumFeatures()
    out = np.zeros((len(X), k))
    row = np.zeros(max(nf, X.shape[1]))
    buf = (ctypes.c_double * k)()
    fn = dll.PredictRaw if raw else dll.Predict
    for i in range(len(X)):
        row[:X.shape[1]] = X[i]
        fn(row.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), buf)
        out[i] = np.asarray(buf[:])
    return out[:, 0] if k == 1 else out


def _adversarial(X):
    """Rows as they come, then NaN and zero rows the decisions route."""
    Xn = X[:60].copy()
    Xn[::3] = 0.0
    Xn[1::3, ::2] = np.nan
    return np.concatenate([X, Xn])


@needs_gxx
@pytest.mark.parametrize("name", ["binary", "multiclass", "categorical"])
def test_compiled_golden_predicts_the_booster(name, tmp_path):
    text = _golden_text(name)
    X = _adversarial(DATASETS[name]["make"]()[2])
    dll = _compile(model_to_if_else(ptext.load_model_from_string(text)),
                   tmp_path)
    bst = lt.Booster(model_str=text, device="cpu")
    assert dll.GetNumClasses() == bst.num_model_per_iteration()
    assert dll.GetNumTrees() == bst.num_trees()
    np.testing.assert_allclose(_predict(dll, X, raw=True),
                               bst.predict(X, raw_score=True),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_predict(dll, X, raw=False), bst.predict(X),
                               rtol=1e-10, atol=1e-12)


@needs_gxx
def test_compiled_deep_tree_predicts_the_booster(deep_text, tmp_path):
    text, X = deep_text
    dll = _compile(model_to_if_else(ptext.load_model_from_string(text)),
                   tmp_path)
    Xs = X[::37]
    np.testing.assert_allclose(
        _predict(dll, Xs), lt.Booster(model_str=text, device="cpu").predict(
            Xs, raw_score=True), rtol=1e-12, atol=1e-12)


@needs_gxx
def test_compiled_linear_predicts_the_booster(linear_text, tmp_path):
    text, X = linear_text
    dll = _compile(model_to_if_else(ptext.load_model_from_string(text)),
                   tmp_path)
    Xte = np.concatenate([X[:40], np.full((3, 5), np.nan)])
    got = _predict(dll, Xte)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, lt.Booster(model_str=text, device="cpu").predict(
            Xte, raw_score=True), rtol=1e-4, atol=1e-4)
