"""Raw-feature prediction over stacked trees, in plain PyTorch (port of
``lightgbm_tpu/predictor.py``'s host loop; reference
``GBDT::PredictRaw`` / ``Predictor``, src/boosting/gbdt_prediction.cpp:
13-91, src/application/predictor.hpp:39-131).

No TPU kernel lies on the JAX package's predict path (its device route
is an XLA scan), so there is no hand-written kernel here: the trees'
node arrays are stacked into [T, S] tensors (categorical bitsets into
[T, S, W] words, W the widest categorical node of the model) and every
row walks every tree in float64 on the device, one node level a step,
with NumericalDecision / CategoricalDecision semantics (tree.h:250-300).
Tree ``i`` adds to output column ``i % k`` in tree order, as the JAX
host loop adds, so raw scores equal JAX's to the bit.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .models.tree import kCategoricalMask, kDefaultLeftMask
from .objective.output import convert_output

# node-state cells ([T, rows] per tensor) a chunk of rows may hold
CHUNK_CELLS = 1 << 23


def stack_trees(models: List, device) -> dict:
    """Pad every tree's node arrays to the widest tree: [T, S] tensors
    (S = max internal nodes), [T, L] leaf values and, when any node is
    categorical, its left categories as [T, S, W] 32-bit words held in
    int64 (bit c of word w: category 32 w + c goes left)."""
    t = len(models)
    s = max([max(m.num_leaves - 1, 1) for m in models], default=1)
    ll = max([m.num_leaves for m in models], default=1)
    cats = [(i, j, np.asarray(m.cat_threshold[j], np.int64))
            for i, m in enumerate(models) for j in range(m.num_leaves - 1)
            if m.decision_type[j] & kCategoricalMask]
    w = max([int(c.max(initial=0)) // 32 + 1 for _, _, c in cats],
            default=1)
    feat = np.zeros((t, s), np.int64)
    thr = np.zeros((t, s), np.float64)
    dleft = np.zeros((t, s), bool)
    is_cat = np.zeros((t, s), bool)
    miss = np.zeros((t, s), np.int64)
    left = np.full((t, s), -1, np.int64)
    right = np.full((t, s), -1, np.int64)
    leaf = np.zeros((t, ll), np.float64)
    single = np.zeros(t, bool)
    words = np.zeros((t, s, w), np.int64)
    for i, m in enumerate(models):
        leaf[i, :m.num_leaves] = m.leaf_value
        if m.num_leaves <= 1:
            single[i] = True
            continue
        k = m.num_leaves - 1
        feat[i, :k] = m.split_feature[:k]
        thr[i, :k] = m.threshold[:k]
        dleft[i, :k] = (m.decision_type[:k] & kDefaultLeftMask) != 0
        is_cat[i, :k] = (m.decision_type[:k] & kCategoricalMask) != 0
        miss[i, :k] = m.missing_code[:k]
        left[i, :k] = m.left_child[:k]
        right[i, :k] = m.right_child[:k]
    for i, j, c in cats:
        np.bitwise_or.at(words[i, j], c // 32, np.left_shift(1, c % 32))
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    out = dict(feat=as_t(feat), thr=as_t(thr), dleft=as_t(dleft),
               miss=as_t(miss), left=as_t(left), right=as_t(right),
               leaf=as_t(leaf), single=as_t(single), depth=ll,
               words=None)
    if cats:
        out.update(is_cat=as_t(is_cat), words=as_t(words))
    return out


def predict_leaf_index(stacked: dict, x: torch.Tensor) -> torch.Tensor:
    """[N, F] float64 rows -> [T, N] leaf index per tree."""
    t = stacked["feat"].shape[0]
    n = x.shape[0]
    dev = x.device
    node = torch.zeros((t, n), dtype=torch.int64, device=dev)
    out = torch.zeros((t, n), dtype=torch.int64, device=dev)
    done = stacked["single"][:, None].expand(t, n).clone()
    rows = torch.arange(n, device=dev)[None, :].expand(t, n)
    words = stacked["words"]
    for _ in range(stacked["depth"]):
        if bool(done.all()):
            break
        nd = torch.where(done, torch.zeros_like(node), node)

        def at(name):
            return torch.gather(stacked[name], 1, nd)
        fval = x[rows, at("feat")]
        miss = at("miss")
        nan = torch.isnan(fval)
        fval = torch.where(nan & (miss != 2), torch.zeros_like(fval), fval)
        is_missing = torch.where(miss == 1, fval.abs() <= 1e-35,
                                 (miss == 2) & nan)
        go_left = torch.where(is_missing, at("dleft"), fval <= at("thr"))
        if words is not None:
            go_left = torch.where(at("is_cat"),
                                  _category_left(words, nd, fval), go_left)
        child = torch.where(go_left, at("left"), at("right"))
        is_leaf = child < 0
        out = torch.where(~done & is_leaf, ~child, out)
        node = torch.where(~done & ~is_leaf, child, node)
        done = done | is_leaf
    return out


def _category_left(words: torch.Tensor, nd: torch.Tensor,
                   fval: torch.Tensor) -> torch.Tensor:
    """CategoricalDecision: the category is ``int(fval)`` (truncated);
    NaN, a negative category or one past the node's words goes right."""
    t, s, w = words.shape
    cat = torch.trunc(fval)
    ok = ~torch.isnan(fval) & (cat >= 0) & (cat < 32 * w)
    c = torch.where(ok, cat, torch.zeros_like(cat)).to(torch.int64)
    word = torch.gather(words.reshape(t, s * w), 1, nd * w + c // 32)
    return ok & (((word >> (c % 32)) & 1) == 1)


def used_models(src, num_iteration=None, start_iteration: int = 0) -> List:
    """The trees of iterations ``[start_iteration, start_iteration +
    num_iteration)`` (all from ``start_iteration`` when
    ``num_iteration`` is None or <= 0), ``k`` trees an iteration."""
    k = src.num_tree_per_iteration
    models = list(src.models)
    start = min(max(int(start_iteration), 0), len(models) // k) * k
    end = len(models)
    if num_iteration is not None and num_iteration > 0:
        end = min(start + int(num_iteration) * k, end)
    return models[start:end]


def predict_raw(models: List, data, device, k: int = 1) -> torch.Tensor:
    """Raw score per row and output column, float64 [N, k]: tree ``i``
    adds to column ``i % k``, in tree order."""
    x = torch.as_tensor(np.asarray(data, np.float64), device=device)
    n = x.shape[0]
    raw = torch.zeros((n, k), dtype=torch.float64, device=device)
    if not models:
        return raw
    stacked = stack_trees(models, device)
    for lo, hi in _row_chunks(n, len(models)):
        vals = torch.gather(stacked["leaf"], 1,
                            predict_leaf_index(stacked, x[lo:hi]))
        acc = raw[lo:hi]
        for i in range(vals.shape[0]):
            acc[:, i % k] += vals[i]
    return raw


def predict_leaf(models: List, data, device) -> torch.Tensor:
    """Leaf index per row and tree, int32 [N, T]."""
    x = torch.as_tensor(np.asarray(data, np.float64), device=device)
    out = torch.zeros((x.shape[0], len(models)), dtype=torch.int32,
                      device=device)
    if not models:
        return out
    stacked = stack_trees(models, device)
    for lo, hi in _row_chunks(x.shape[0], len(models)):
        out[lo:hi] = predict_leaf_index(stacked, x[lo:hi]).T.to(torch.int32)
    return out


def _row_chunks(n: int, t: int):
    step = max(CHUNK_CELLS // max(t, 1), 1)
    return [(lo, min(lo + step, n)) for lo in range(0, n, step)]


def predict(src, data, device, num_iteration=None, start_iteration: int = 0,
            raw_score: bool = False, pred_leaf: bool = False
            ) -> torch.Tensor:
    """Booster.predict for a trained GBDT or a loaded model: leaf
    indices [N, T], or scores [N] (one tree an iteration) / [N, k],
    raw or converted by the model's objective; ``average_output``
    models divide by the iterations used."""
    models = used_models(src, num_iteration, start_iteration)
    if any(m.is_linear for m in models):
        raise NotImplementedError(
            "linear-leaf trees are not predicted by the port yet "
            "(ROADMAP.md Queue 1 item 7.5)")
    if pred_leaf:
        return predict_leaf(models, data, device)
    k = src.num_tree_per_iteration
    raw = predict_raw(models, data, device, k)
    if getattr(src, "average_output", False) and models:
        raw /= max(len(models) // k, 1)
    if k == 1:
        raw = raw[:, 0]
    return raw if raw_score else convert_output(src, raw)
