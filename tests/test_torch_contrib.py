"""SHAP contributions (``Booster.predict(pred_contrib=True)``) in the
port against the JAX package, on the CPU.

* The plain version (``predictor.tree_shap_plain``: the reference's
  recursive TreeSHAP, walked once a tree for all rows) is within 1e-9
  relative (atol 1e-12) of JAX ``predictor.py:503 _predict_contrib``
  (the native TreeSHAP) on the nine golden models the reference CLI
  wrote (categorical and multiclass among them) and on a 63-leaf binary
  and a 3-class model trained by the port; layout ``[N, k (F + 1)]``,
  each class's expected value last.
* Local accuracy: each row's contributions sum to its raw score within
  1e-9 relative.
* The kernel's path formulation (``ops/tree_shap_cuda.py:shap_paths``:
  root-to-leaf paths, a feature's repeated nodes merged into one
  element) evaluated here by a numpy model of the kernel's arithmetic
  (``kernel_model``: extend element by element, each element's unwound
  sum; ``tests/torch_shap_model.py``) equals the plain version within
  1e-9 relative, on the golden models and on a deep chain that repeats
  one feature on every node and on a chain of 40 distinct features
  (paths longer than a warp).
* The bin kernel's layout (``pack_bins``: the short paths first-fit
  decreasing into 32-lane bins; ``bin_lanes``: each lane's interval
  test, reciprocals, the slots' lowest lanes) evaluated by a numpy model
  of its lanes (``bins_model``) equals JAX ``_predict_contrib`` within
  1e-9 relative on the golden and trained models and the chains; the
  packing puts every path in exactly one bin, at most 32 lanes a bin,
  and gives the same bins every time.

The kernel itself is held against the plain version on the card by
``tests/test_torch_kernels_cuda.py`` (``cuda``-marked, no JAX).
"""

import os
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.io import model_text as jtext
from lightgbm_tpu.predictor import _predict_contrib
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops.tree_shap_cuda import (bin_lanes, pack_bins,
                                                   shap_paths)
from lightgbm_tpu_torch.predictor import tree_shap_plain

sys.path.insert(0, os.path.dirname(__file__))
from golden_common import DATASETS  # noqa: E402
from torch_shap_model import (bins_model, chain_rows,  # noqa: E402
                              chain_tree, kernel_model)

torch.set_num_threads(2)
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
GOLDEN = sorted(DATASETS)
ROWS = 150


def _dense(X):
    X = X.todense() if hasattr(X, "todense") else X
    return np.asarray(X, np.float64)


def _golden(name):
    with open(os.path.join(FIXDIR, f"model_{name}.txt")) as f:
        text = f.read()
    _, _, Xte, _ = DATASETS[name]["make"]()
    return text, _dense(Xte[:ROWS])


def _close(out, ref):
    np.testing.assert_allclose(out, ref, rtol=1e-9, atol=1e-12)


def _local_accuracy(bst, X, out):
    k = bst.num_model_per_iteration()
    raw = bst.predict(X, raw_score=True).reshape(len(X), k)
    sums = out.reshape(len(X), k, -1).sum(axis=2)
    np.testing.assert_allclose(sums, raw, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_contrib_matches_jax(name):
    text, X = _golden(name)
    jb = jtext.load_model_from_string(text)
    ref = _predict_contrib(jb.models, X, jb.num_tree_per_iteration)
    bst = lt.Booster(model_str=text, device="cpu")
    out = bst.predict(X, pred_contrib=True)
    k = jb.num_tree_per_iteration
    assert out.dtype == np.float64
    assert out.shape == (len(X), k * (X.shape[1] + 1)) == ref.shape
    _close(out, ref)
    _local_accuracy(bst, X, out)


def _trained(objective, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(3000, 8)
    X[rng.rand(3000) < 0.1, 2] = np.nan
    X[rng.rand(3000) < 0.3, 3] = 0.0
    z = X[:, 0] - 0.8 * X[:, 1] + 0.5 * np.nan_to_num(X[:, 2]) \
        + 0.4 * rng.randn(3000)
    if objective == "binary":
        y = (z > 0).astype(np.float32)
        p = {"objective": "binary"}
    else:
        y = np.digitize(z, [-0.7, 0.7]).astype(np.float32)
        p = {"objective": "multiclass", "num_class": 3}
    p.update(num_leaves=63, min_data_in_leaf=5, verbosity=-1)
    return X, lt.train(p, lt.Dataset(X, label=y), 4, device="cpu")


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_trained_63_leaf_contrib_matches_jax(objective):
    X, bst = _trained(objective, 1)
    Xq = X[:ROWS]
    k = bst.num_model_per_iteration()
    assert max(t.num_leaves for t in bst.models) == 63
    jb = jtext.load_model_from_string(bst.model_to_string())
    ref = _predict_contrib(jb.models, Xq, k)
    out = bst.predict(Xq, pred_contrib=True)
    _close(out, ref)
    _local_accuracy(bst, Xq, out)


def test_contrib_of_iterations_and_a_jax_trained_booster():
    """``num_iteration`` / ``start_iteration`` select the trees, as
    ``predict`` does; a model the JAX package trained predicts the JAX
    package's contributions through its text."""
    X, bst = _trained("binary", 2)
    Xq = X[:60]
    full = bst.predict(Xq, pred_contrib=True)
    part = bst.predict(Xq, pred_contrib=True, num_iteration=2)
    jb = jtext.load_model_from_string(bst.model_to_string())
    _close(part, _predict_contrib(jb.models[:2], Xq, 1))
    assert not np.allclose(full, part)
    rng = np.random.RandomState(3)
    Xj = rng.randn(1000, 5)
    yj = (Xj[:, 0] + Xj[:, 1] > 0).astype(np.float32)
    jbst = lgb.train({"objective": "binary", "num_leaves": 15,
                      "verbosity": -1}, lgb.Dataset(Xj, label=yj), 3,
                     verbose_eval=False)
    port = lt.Booster(model_str=jbst.model_to_string(), device="cpu")
    _close(port.predict(Xj[:50], pred_contrib=True),
           jbst.predict(Xj[:50], pred_contrib=True))


# ---- the kernel's path formulation -----------------------------------

@pytest.mark.parametrize("name", ["binary", "categorical", "multiclass",
                                  "monotone"])
def test_path_formulation_matches_the_recursion(name):
    text, X = _golden(name)
    bst = lt.Booster(model_str=text, device="cpu")
    X = X[:20]
    k = bst.num_model_per_iteration()
    ref = bst.predict(X, pred_contrib=True).reshape(len(X), -1)
    _close(kernel_model(bst.models, X, k), ref)


def test_a_path_that_repeats_one_feature():
    """36 nodes on feature 0 at rising thresholds, then 4 others: each
    path has at most 5 unique elements, whatever its depth."""
    feats = [0] * 36 + [1, 2, 3, 0]
    thr = list(np.linspace(-1.5, 1.5, 36)) + [0.1, -0.2, 0.3, 1.8]
    tree = chain_tree(feats, thr)
    p = shap_paths([tree], 1)
    assert p["max_len"] == 5
    x = chain_rows(4)
    ref = tree_shap_plain([tree], torch.from_numpy(x), 1).numpy()
    _close(kernel_model([tree], x, 1), ref)
    raw = tree.leaf_value[tree.predict_leaf_index(x)]
    np.testing.assert_allclose(ref.sum(axis=1), raw, rtol=1e-9, atol=1e-12)
    jt = jtext.load_model_from_string(
        lt.Booster.from_trees([tree], {"objective": "regression"},
                              device="cpu").model_to_string())
    _close(ref, _predict_contrib(jt.models, x, 1))


def test_a_path_longer_than_a_warp():
    """40 distinct features on one chain: paths of up to 41 elements
    take the kernel's long-path layout."""
    f = 40
    tree = chain_tree(list(range(f)), list(0.05 * np.arange(f) - 1.0),
                      seed=2)
    assert shap_paths([tree], 1)["max_len"] == 41
    x = chain_rows(f)
    ref = tree_shap_plain([tree], torch.from_numpy(x), 1).numpy()
    _close(kernel_model([tree], x, 1), ref)
    jt = jtext.load_model_from_string(
        lt.Booster.from_trees([tree], {"objective": "regression"},
                              device="cpu").model_to_string())
    _close(ref, _predict_contrib(jt.models, x, 1))


# ---- the bin kernel's packing and lanes --------------------------------

def _bin_cases():
    return [("golden", n) for n in GOLDEN] + [
        ("trained", "binary"), ("trained", "multiclass"),
        ("chain", "repeat"), ("chain", "long")]


def _case_models(kind, name):
    """(models, rows, k, model text) of a golden model, a port-trained
    63-leaf one, or a hand-built chain."""
    if kind == "golden":
        text, X = _golden(name)
        bst = lt.Booster(model_str=text, device="cpu")
        return bst.models, X[:40], bst.num_model_per_iteration(), text
    if kind == "trained":
        X, bst = _trained(name, 1)
        return (bst.models, X[:60], bst.num_model_per_iteration(),
                bst.model_to_string())
    if name == "repeat":
        tree = chain_tree([0] * 36 + [1, 2, 3, 0],
                          list(np.linspace(-1.5, 1.5, 36))
                          + [0.1, -0.2, 0.3, 1.8])
        x = chain_rows(4)
    else:
        tree = chain_tree(list(range(40)), list(0.05 * np.arange(40) - 1.0),
                          seed=2)
        x = chain_rows(40)
    text = lt.Booster.from_trees([tree], {"objective": "regression"},
                                 device="cpu").model_to_string()
    return [tree], x, 1, text


@pytest.mark.parametrize("kind,name", _bin_cases())
def test_pack_bins_places_every_path_once(kind, name):
    models, _, k, _ = _case_models(kind, name)
    p = shap_paths(models, k)
    lens = p["lens"]
    short = np.nonzero(lens <= 32)[0]
    bins = pack_bins(lens, short)
    placed = sorted(q for b in bins for q in b)
    assert placed == sorted(short.tolist())
    assert all(sum(int(lens[q]) for q in b) <= 32 for b in bins)
    assert bins == pack_bins(lens, short[::-1].copy())
    # first fit decreasing: longest first, each path in the lowest bin
    # with room for it when it was placed
    where = {q: b for b, members in enumerate(bins) for q in members}
    room = []
    for q in sorted(short.tolist(), key=lambda q: (-int(lens[q]), q)):
        b = where[q]
        assert all(r < lens[q] for r in room[:b])
        if b == len(room):
            room.append(32)
        room[b] -= int(lens[q])
    lint, _, blen = bin_lanes(p, bins)
    assert lint.shape == (len(bins), 32, 8)
    used = (lint[:, :, 0] >> 16) & 255
    for b, members in enumerate(bins):
        assert int((used[b] > 0).sum()) == sum(int(lens[q]) for q in members)
        assert blen[b] == max(int(lens[q]) for q in members)


@pytest.mark.parametrize("kind,name", _bin_cases())
def test_bin_layout_matches_jax(kind, name):
    models, X, k, text = _case_models(kind, name)
    ref = _predict_contrib(jtext.load_model_from_string(text).models, X, k)
    _close(bins_model(models, X, k), ref)


def test_linear_leaves_are_refused_like_jax():
    text, X = _golden("binary")
    bst = lt.Booster(model_str=text, device="cpu")
    bst.models[0].is_linear = True
    try:
        with pytest.raises(ValueError, match="linear-leaf"):
            bst.predict(X[:5], pred_contrib=True)
    finally:
        del bst.models[0].is_linear
