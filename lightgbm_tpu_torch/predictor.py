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

A linear-leaf tree's output is its leaf model over the row's raw
features (``models/linear.py``: the JAX host route's float32 add chain,
widened to float64 before the tree's add).

Prediction early stopping (``pred_early_stop``, JAX
``predictor.py:140 _predict_raw_early_stop``) keeps the live rows'
index on the device and reads one count a period of ``freq * k``
trees. SHAP contributions (``pred_contrib``, JAX ``predictor.py:503
_predict_contrib``) go to the TreeSHAP kernel
(``ops/tree_shap_cuda.py``, ``csrc/tree_shap.cu``) on the card;
``tree_shap_plain`` below is its plain version: the reference's
recursive TreeSHAP (src/io/tree.cpp:631-737, JAX ``_tree_shap``),
walked once over a tree with every row's fractions and path weights as
``[N, depth]`` float64 tensors.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .models.tree import kCategoricalMask, kDefaultLeftMask
from .objective.output import convert_output
from .utils.log import log_warning

# node-state cells ([T, rows] per tensor) a chunk of rows may hold
CHUNK_CELLS = 1 << 23


def bucket_rows(n: int) -> int:
    """Smallest power of two >= n: the row bucket a serving request
    pads to (JAX ``predictor.py:60``)."""
    b = 1
    while b < n:
        b <<= 1
    return b


def stack_trees(models: List, device) -> dict:
    """Pad every tree's node arrays to the widest tree: [T, S] tensors
    (S = max internal nodes), [T, L] leaf values and, when any node is
    categorical, its left categories as [T, S, W] 32-bit words held in
    int64 (bit c of word w: category 32 w + c goes left). ``depth`` is
    the deepest leaf's level over the trees: the walk takes exactly that
    many levels, with no host read between them, so a CUDA graph can
    hold it (``serving/programs.py``). A linear tree's leaf models go up
    with the nodes (``linear``: tree index -> ``tree_linear_args``)."""
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
               leaf=as_t(leaf), single=as_t(single),
               depth=max([deepest_leaf(m) for m in models], default=0),
               words=None, linear={})
    if any(m.is_linear for m in models):
        from .models.linear import tree_linear_args
        out["linear"] = {i: tree_linear_args(m, device, inner=False)
                         for i, m in enumerate(models) if m.is_linear}
    if cats:
        out.update(is_cat=as_t(is_cat), words=as_t(words))
    return out


def deepest_leaf(tree) -> int:
    """The level of the tree's deepest leaf (0 for a one-leaf tree).
    Children have larger node indices than their parent (creation
    order), so one forward pass over the child arrays suffices."""
    k = tree.num_leaves - 1
    node_depth = np.zeros(max(k, 1), np.int64)
    deepest = 0
    for s in range(k):
        for child in (int(tree.left_child[s]), int(tree.right_child[s])):
            if child >= 0:
                node_depth[child] = node_depth[s] + 1
            else:
                deepest = max(deepest, int(node_depth[s]) + 1)
    return deepest


def numerical_left(fval: torch.Tensor, thr, dleft: torch.Tensor,
                   miss: torch.Tensor):
    """NumericalDecision (tree.h:250-300) of float64 values: NaN counts
    as 0 unless the missing type (``miss``: 0 none, 1 zero, 2 NaN) is
    NaN; a missing value goes to ``dleft``'s side, others left when
    ``value <= thr``. Returns the decision and the values with NaN made
    0 (what a categorical node reads)."""
    nan = torch.isnan(fval)
    fval = torch.where(nan & (miss != 2), torch.zeros_like(fval), fval)
    is_missing = torch.where(miss == 1, fval.abs() <= 1e-35,
                             (miss == 2) & nan)
    return torch.where(is_missing, dleft, fval <= thr), fval


def predict_leaf_index(stacked: dict, x: torch.Tensor) -> torch.Tensor:
    """[N, F] float64 rows -> [T, N] leaf index per tree: ``depth``
    levels, each decided for every row and tree; a row that reached its
    leaf keeps it, so the levels past it change nothing."""
    t = stacked["feat"].shape[0]
    n = x.shape[0]
    dev = x.device
    node = torch.zeros((t, n), dtype=torch.int64, device=dev)
    out = torch.zeros((t, n), dtype=torch.int64, device=dev)
    done = stacked["single"][:, None].expand(t, n).clone()
    rows = torch.arange(n, device=dev)[None, :].expand(t, n)
    words = stacked["words"]
    for _ in range(stacked["depth"]):
        nd = torch.where(done, torch.zeros_like(node), node)

        def at(name):
            return torch.gather(stacked[name], 1, nd)
        go_left, fval = numerical_left(x[rows, at("feat")], at("thr"),
                                       at("dleft"), at("miss"))
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


def used_range(src, num_iteration=None, start_iteration: int = 0):
    """The tree indices ``[start, end)`` of iterations
    ``[start_iteration, start_iteration + num_iteration)`` (all from
    ``start_iteration`` when ``num_iteration`` is None or <= 0), ``k``
    trees an iteration."""
    k = src.num_tree_per_iteration
    total = len(src.models)
    start = min(max(int(start_iteration), 0), total // k) * k
    end = total
    if num_iteration is not None and num_iteration > 0:
        end = min(start + int(num_iteration) * k, end)
    return start, end


def used_models(src, num_iteration=None, start_iteration: int = 0) -> List:
    """The trees of ``used_range``."""
    start, end = used_range(src, num_iteration, start_iteration)
    return list(src.models)[start:end]


def add_trees(raw: torch.Tensor, vals: torch.Tensor, k: int) -> None:
    """Tree ``i``'s values ``vals[i]`` onto column ``i % k`` of the
    float64 ``raw`` [N, k], in tree order (one add a tree: the JAX host
    loop's order, so the sums equal its bits)."""
    for i in range(vals.shape[0]):
        raw[:, i % k] += vals[i]


def predict_raw(models: List, data, device, k: int = 1,
                stacked=None) -> torch.Tensor:
    """Raw score per row and output column, float64 [N, k]: tree ``i``
    adds to column ``i % k``, in tree order. ``stacked`` is the models'
    stack when the caller holds one (a serving version's pinned stack),
    else they are stacked here."""
    x = torch.as_tensor(np.asarray(data, np.float64), device=device)
    n = x.shape[0]
    raw = torch.zeros((n, k), dtype=torch.float64, device=device)
    if not models:
        return raw
    if stacked is None:
        stacked = stack_trees(models, device)
    for lo, hi in _row_chunks(n, len(models)):
        add_trees(raw[lo:hi], leaf_values(stacked, x[lo:hi]), k)
    return raw


def leaf_values(stacked: dict, x: torch.Tensor) -> torch.Tensor:
    """[T, N] float64: each tree's output for the float64 rows ``x``,
    its leaf's value or, for a linear tree, its leaf model's float32
    ``const + w . x`` (``models/linear.py:linear_values``, the JAX host
    route's add chain) widened to float64."""
    idx = predict_leaf_index(stacked, x)
    vals = torch.gather(stacked["leaf"], 1, idx)
    if stacked["linear"]:
        from .models.linear import linear_values
        for i, args in stacked["linear"].items():
            vals[i] = linear_values(idx[i], x, *args)
    return vals


def predict_leaf(models: List, data, device, stacked=None) -> torch.Tensor:
    """Leaf index per row and tree, int32 [N, T]."""
    x = torch.as_tensor(np.asarray(data, np.float64), device=device)
    out = torch.zeros((x.shape[0], len(models)), dtype=torch.int32,
                      device=device)
    if not models:
        return out
    if stacked is None:
        stacked = stack_trees(models, device)
    for lo, hi in _row_chunks(x.shape[0], len(models)):
        out[lo:hi] = predict_leaf_index(stacked, x[lo:hi]).T.to(torch.int32)
    return out


def serve_rows(src, stacked: dict, x: torch.Tensor, kind: str
               ) -> torch.Tensor:
    """One serving request's device route over every tree of ``src``
    for the float64 rows ``x`` [N, F] already on the stack's device, in
    one chunk: ``pred_leaf`` int32 [N, T], ``raw_score`` or ``predict``
    float64 [N] / [N, k]. The same operations, in the same order, as
    ``predict`` of the rows, with no host read and no upload, so a CUDA
    graph can hold it (``serving/programs.py``)."""
    if kind == "pred_leaf":
        return predict_leaf_index(stacked, x).T.to(torch.int32)
    k = src.num_tree_per_iteration
    raw = torch.zeros((x.shape[0], k), dtype=torch.float64,
                      device=x.device)
    t = stacked["feat"].shape[0]
    if t:
        add_trees(raw, leaf_values(stacked, x), k)
        if getattr(src, "average_output", False):
            raw /= max(t // k, 1)
    if k == 1:
        raw = raw[:, 0]
    return raw if kind == "raw_score" else convert_output(src, raw)


def _row_chunks(n: int, t: int):
    step = max(CHUNK_CELLS // max(t, 1), 1)
    return [(lo, min(lo + step, n)) for lo in range(0, n, step)]


def _slice_stacked(stacked: dict, lo: int, hi: int) -> dict:
    """Trees ``[lo, hi)`` of a stack (a view, no copy)."""
    out = dict(stacked)
    for key, val in stacked.items():
        if isinstance(val, torch.Tensor):
            out[key] = val[lo:hi]
    out["linear"] = {i - lo: v for i, v in stacked["linear"].items()
                     if lo <= i < hi}
    return out


def _objective_name(src) -> str:
    obj = getattr(src, "objective", None)
    if obj is not None and not isinstance(obj, str):
        try:
            return obj.name().split(" ")[0]
        except NotImplementedError:
            return ""
    return getattr(src, "objective_str", "").split(" ")[0]


def predict_raw_early_stop(src, models: List, data, device, k: int,
                           freq: int, margin: float, stacked=None):
    """Raw scores with margin-based prediction early stopping (JAX
    ``predictor.py:140``; reference prediction_early_stop.cpp:13-88):
    after every ``freq * k`` trees (but the last), a row whose margin
    (binary: ``2 |score|``; multiclass: top1 - top2) reaches ``margin``
    takes no more trees. Float64 [N, k] in tree order, as
    ``predict_raw``; None (with a warning) for other objectives and
    for ``average_output`` models, which predict normally."""
    binary_like = k == 1 and _objective_name(src) in (
        "binary", "cross_entropy", "cross_entropy_lambda")
    if not binary_like and k < 2:
        log_warning("pred_early_stop is only supported for binary and "
                    "multiclass objectives; predicting normally")
        return None
    if getattr(src, "average_output", False):
        log_warning("pred_early_stop is not supported with "
                    "average_output (random forest); predicting "
                    "normally")
        return None
    x = torch.as_tensor(np.asarray(data, np.float64), device=device)
    n = x.shape[0]
    raw = torch.zeros((n, k), dtype=torch.float64, device=device)
    if not models or n == 0:
        return raw
    if stacked is None:
        stacked = stack_trees(models, device)
    period = max(int(freq), 1) * k
    live = None            # the live rows' ids; None: every row
    for lo in range(0, len(models), period):
        hi = min(lo + period, len(models))
        rows = x if live is None else x[live]
        sub = _slice_stacked(stacked, lo, hi)
        acc = raw if live is None else raw[live]
        for clo, chi in _row_chunks(rows.shape[0], hi - lo):
            # a period starts at a multiple of k: its tree i adds to
            # column (lo + i) % k = i % k
            add_trees(acc[clo:chi], leaf_values(sub, rows[clo:chi]), k)
        if hi >= len(models):
            if live is not None:
                raw[live] = acc
            break
        if k == 1:
            m = 2.0 * acc[:, 0].abs()
        else:
            top2 = torch.topk(acc, 2, dim=1).values
            m = top2[:, 0] - top2[:, 1]
        keep = m < margin
        if live is None:
            live = torch.arange(n, device=device)
        else:
            raw[live] = acc
        live = live[keep]
        if live.numel() == 0:     # the period's one host read
            break
    return raw


def predict_contrib(models: List, data, device, k: int) -> torch.Tensor:
    """SHAP contributions, float64 [N, k * (F + 1)] ([N, F + 1] for one
    tree an iteration): class ``c``'s features in columns
    ``c * (F + 1) + f`` and its expected value in the last of them
    (Tree::PredictContrib, tree.h:512-527). The TreeSHAP kernel on the
    card, its plain version on the CPU."""
    from .ops.tree_shap_cuda import tree_shap
    if any(getattr(t, "is_linear", False) for t in models):
        raise ValueError(
            "pred_contrib (TreeSHAP) is not supported for linear-leaf "
            "trees; predict with linear_tree=false or drop the leaf "
            "linear models first")
    x = torch.as_tensor(np.ascontiguousarray(data, np.float64),
                        device=device)
    out = tree_shap(models, x, k)
    return out if k > 1 else out.reshape(x.shape[0], -1)


def expected_value(tree) -> float:
    """Tree::ExpectedValue (tree.cpp:740-748)."""
    if tree.num_leaves == 1:
        return float(tree.leaf_value[0])
    total = float(tree.internal_count[0])
    return float((tree.leaf_count / total * tree.leaf_value).sum())


def node_go_left(tree, j: int, col: torch.Tensor) -> torch.Tensor:
    """NumericalDecision / CategoricalDecision of node ``j`` for the
    float64 values ``col``, as ``predict_leaf_index`` decides."""
    dev = col.device
    left, f = numerical_left(
        col, float(tree.threshold[j]),
        torch.tensor(bool(tree.decision_type[j] & kDefaultLeftMask),
                     device=dev),
        torch.tensor(int(tree.missing_code[j]), device=dev))
    if not tree.decision_type[j] & kCategoricalMask:
        return left
    cats = torch.as_tensor(np.asarray(tree.cat_threshold[j], np.int64),
                           device=dev)
    nan = torch.isnan(f)
    c = torch.trunc(torch.where(nan, torch.zeros_like(f), f))
    return ~nan & (c >= 0) & torch.isin(c.to(torch.int64), cats)


def _node_count(tree, node: int) -> float:
    return float(tree.leaf_count[~node]) if node < 0 \
        else float(tree.internal_count[node])


def _extend(feat, zero, one, pw, zero_f, one_f, fidx):
    """ExtendPath (tree.cpp:631-643) for every row: the path's features
    and zero fractions are the tree's (lists), its one fractions and
    path weights the rows' ([N, depth] tensors)."""
    depth = len(feat)
    n = one_f.shape[0]
    new = torch.zeros((n, depth + 1), dtype=torch.float64,
                      device=one_f.device)
    if depth == 0:
        new[:, 0] = 1.0
    else:
        i = torch.arange(depth, dtype=torch.float64, device=one_f.device)
        new[:, :depth] = zero_f * pw * (depth - i) / (depth + 1)
        new[:, 1:] += one_f[:, None] * pw * (i + 1) / (depth + 1)
    return (feat + [fidx], zero + [zero_f],
            torch.cat([one, one_f[:, None]], dim=1), new)


def _unwind(feat, zero, one, pw, pidx):
    """UnwindPath (tree.cpp:645-668): take element ``pidx`` out; the
    path weights are recomputed in place of the first ``depth``."""
    depth = len(feat) - 1
    zero_f = zero[pidx]
    one_f = one[:, pidx]
    nz = one_f != 0
    safe = torch.where(nz, one_f, torch.ones_like(one_f))
    pw = pw.clone()
    next_one = pw[:, depth]
    for i in range(depth - 1, -1, -1):
        tmp = pw[:, i]
        a = next_one * (depth + 1) / ((i + 1) * safe)
        b = pw[:, i] * (depth + 1) / (zero_f * (depth - i))
        new_i = torch.where(nz, a, b)
        next_one = torch.where(
            nz, tmp - new_i * zero_f * (depth - i) / (depth + 1), next_one)
        pw[:, i] = new_i
    keep = [j for j in range(depth + 1) if j != pidx]
    return ([feat[j] for j in keep], [zero[j] for j in keep],
            one[:, keep], pw[:, :depth])


def _unwound_sums(zero, one, pw):
    """UnwoundPathSum (tree.cpp:670-688) of every element of the path
    at once: [N, depth + 1]."""
    depth = pw.shape[1] - 1
    z = torch.as_tensor(zero, dtype=torch.float64, device=pw.device)
    nz = one != 0
    safe = torch.where(nz, one, torch.ones_like(one))
    next_one = pw[:, depth:depth + 1].expand_as(one)
    total = torch.zeros_like(one)
    for i in range(depth - 1, -1, -1):
        pwi = pw[:, i:i + 1]
        tmp = next_one * (depth + 1) / ((i + 1) * safe)
        total = total + torch.where(
            nz, tmp, (pwi / z) / ((depth - i) / (depth + 1)))
        next_one = torch.where(nz, pwi - tmp * z * (depth - i)
                               / (depth + 1), next_one)
    return total


def tree_shap_plain(models: List, x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of the TreeSHAP kernel: float64 [N, k * (F + 1)]
    for the float64 rows ``x`` [N, F]. Each tree's recursion (JAX
    ``predictor.py:593 _tree_shap``) runs once for all rows: a node's
    both children are visited, the row's own child with the parent's
    one fraction and the other with 0, as the reference's hot and cold
    branches."""
    n, f = x.shape
    out = torch.zeros((n, k, f + 1), dtype=torch.float64, device=x.device)
    for t, tree in enumerate(models):
        cls = t % k
        out[:, cls, f] += expected_value(tree)
        if tree.num_leaves <= 1:
            continue
        phi = out[:, cls]
        ones = torch.ones(n, dtype=torch.float64, device=x.device)
        empty = torch.zeros((n, 0), dtype=torch.float64, device=x.device)

        def recurse(node, path, zero_f, one_f, fidx):
            feat, zero, one, pw = _extend(*path, zero_f, one_f, fidx)
            if node < 0:
                sums = _unwound_sums(zero, one, pw)
                lv = float(tree.leaf_value[~node])
                for i in range(1, len(feat)):
                    phi[:, feat[i]] += sums[:, i] * (one[:, i] - zero[i]) \
                        * lv
                return
            fnode = int(tree.split_feature[node])
            inc_zero, inc_one = 1.0, ones
            if fnode in feat:
                pidx = feat.index(fnode)
                inc_zero, inc_one = zero[pidx], one[:, pidx]
                feat, zero, one, pw = _unwind(feat, zero, one, pw, pidx)
            left = node_go_left(tree, node, x[:, fnode])
            w = _node_count(tree, node)
            for child, goes in ((int(tree.left_child[node]), left),
                                (int(tree.right_child[node]), ~left)):
                recurse(child, (feat, zero, one, pw),
                        _node_count(tree, child) / w * inc_zero,
                        torch.where(goes, inc_one,
                                    torch.zeros_like(inc_one)), fnode)

        recurse(0, ([], [], empty, empty), 1.0, ones, -1)
    return out.reshape(n, k * (f + 1))


def predict(src, data, device, num_iteration=None, start_iteration: int = 0,
            raw_score: bool = False, pred_leaf: bool = False,
            pred_contrib: bool = False, pred_early_stop: bool = False,
            pred_early_stop_freq: int = 10,
            pred_early_stop_margin: float = 10.0,
            stacked=None) -> torch.Tensor:
    """Booster.predict for a trained GBDT or a loaded model: leaf
    indices [N, T], SHAP contributions, or scores [N] (one tree an
    iteration) / [N, k], raw or converted by the model's objective;
    ``average_output`` models divide by the iterations used.
    ``stacked`` is ``stack_trees`` of all of ``src``'s trees on
    ``device``, pinned once by the caller (a serving version, JAX
    ``predictor.py:82-91``): the iterations used are a view of it, not
    a new stack and upload."""
    start, end = used_range(src, num_iteration, start_iteration)
    models = list(src.models)[start:end]
    if stacked is not None:
        stacked = _slice_stacked(stacked, start, end)
    if pred_contrib:
        return predict_contrib(models, data, device,
                               src.num_tree_per_iteration)
    if pred_leaf:
        return predict_leaf(models, data, device, stacked)
    k = src.num_tree_per_iteration
    raw = None
    if pred_early_stop:
        raw = predict_raw_early_stop(src, models, data, device, k,
                                     pred_early_stop_freq,
                                     pred_early_stop_margin, stacked)
    if raw is None:
        raw = predict_raw(models, data, device, k, stacked)
    if getattr(src, "average_output", False) and models:
        raw /= max(len(models) // k, 1)
    if k == 1:
        raw = raw[:, 0]
    return raw if raw_score else convert_output(src, raw)
