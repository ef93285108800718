"""Decision-tree model (port of ``lightgbm_tpu/models/tree.py``;
reference ``class Tree``, include/LightGBM/tree.h:25-564).

Same flat-array representation and node numbering as the JAX package,
so trees carry across in both directions (``convert.py``) and through
the model text (``io/model_text.py``):

  * internal node ``s`` is created by the ``s``-th split (0-based);
  * child pointers >= 0 reference internal nodes, negative values
    ``~leaf`` reference leaves;
  * ``decision_type`` bit0 = categorical, bit1 = default_left (bits 2-3,
    the missing type, are kept apart in ``missing_code`` and joined only
    in the model text).

The port's grow loop keeps the per-split state on the host, so a tree is
born as numpy ``TreeArrays`` and becomes a host ``Tree``. Traversals
(raw values and bins) are vectorized numpy here; the batched device
predictor lives in ``predictor.py``. A categorical node holds its left
set twice: as raw categories (``cat_threshold``, what raw-value
prediction and the model text read) and, in a tree the port trained or
carried over with its bins, as a bin bitset (``cat_bitsets``, what the
bin-space walks read, as the JAX package's ``_traverse_binned_idx``
does: the word index is clipped to the bitset, so a bin at or above
256 reads word 7).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from ..data.binning import (BIN_TYPE_CATEGORICAL, MISSING_NAN, MISSING_NONE,
                            MISSING_ZERO)
from ..ops.partition import MAX_CAT_WORDS

kCategoricalMask = 1
kDefaultLeftMask = 2

_MISSING_TYPE_CODE = {MISSING_NONE: 0, MISSING_ZERO: 1, MISSING_NAN: 2}
_MISSING_TYPE_NAME = {v: k for k, v in _MISSING_TYPE_CODE.items()}


class TreeArrays(NamedTuple):
    """Tree arrays as the grow loop leaves them. L = max leaves."""
    num_leaves: int
    split_feature: np.ndarray     # i32 [L-1] inner feature index
    threshold_bin: np.ndarray     # i32 [L-1]
    decision_type: np.ndarray     # i32 [L-1]
    left_child: np.ndarray        # i32 [L-1]
    right_child: np.ndarray       # i32 [L-1]
    split_gain: np.ndarray        # f32 [L-1]
    internal_value: np.ndarray    # f32 [L-1]
    internal_weight: np.ndarray   # f32 [L-1]
    internal_count: np.ndarray    # f32 [L-1]
    leaf_value: np.ndarray        # f32 [L]
    leaf_weight: np.ndarray       # f32 [L]
    leaf_count: np.ndarray        # f32 [L]
    leaf_parent: np.ndarray       # i32 [L]
    leaf_depth: np.ndarray        # i32 [L]
    cat_bitsets: Optional[np.ndarray] = None   # u32 [L-1, MAX_CAT_WORDS]


class Tree:
    """Host-side tree (numpy arrays): raw-value and bin-space
    traversal, shrinkage and bias."""

    # piecewise-linear leaf models (models/linear.py): ``leaf_const``
    # [L], ``leaf_coeff`` [L, C] float64, ``leaf_features`` [L, C] raw
    # feature columns and, for a tree that knows its dataset,
    # ``leaf_features_inner`` (-1 padded)
    is_linear = False
    leaf_const = leaf_coeff = leaf_features = leaf_features_inner = None
    # grown on a dataset's bins (or carried over with its bin
    # thresholds), not parsed from model text: what a serving AOT
    # artifact is built from (serving/aot.py)
    has_bins = False

    def __init__(self, arrays: TreeArrays, dataset=None,
                 shrinkage: float = 1.0):
        a = arrays
        self.num_leaves = int(a.num_leaves)
        n = max(self.num_leaves - 1, 1)
        self.split_feature_inner = np.asarray(a.split_feature, np.int32)[:n]
        self.threshold_bin = np.asarray(a.threshold_bin, np.int32)[:n]
        self.decision_type = np.asarray(a.decision_type, np.int32)[:n]
        self.left_child = np.asarray(a.left_child, np.int32)[:n]
        self.right_child = np.asarray(a.right_child, np.int32)[:n]
        self.split_gain = np.asarray(a.split_gain, np.float32)[:n]
        self.internal_value = np.asarray(a.internal_value, np.float64)[:n]
        self.internal_weight = np.asarray(a.internal_weight, np.float64)[:n]
        self.internal_count = np.asarray(
            a.internal_count, np.float64)[:n].astype(np.int64)
        ll = self.num_leaves
        self.leaf_value = np.asarray(a.leaf_value, np.float64)[:ll]
        self.leaf_weight = np.asarray(a.leaf_weight, np.float64)[:ll]
        self.leaf_count = np.asarray(
            a.leaf_count, np.float64)[:ll].astype(np.int64)
        self.leaf_parent = np.asarray(a.leaf_parent, np.int32)[:ll]
        self.leaf_depth = np.asarray(a.leaf_depth, np.int32)[:ll]
        self.cat_bitsets = np.zeros((n, MAX_CAT_WORDS), np.uint32) \
            if a.cat_bitsets is None \
            else np.asarray(a.cat_bitsets, np.uint32)[:n]
        self.shrinkage = float(shrinkage)
        self.has_bins = dataset is not None
        self.cat_threshold: List[np.ndarray] = [
            np.zeros(0, np.int64) for _ in range(n)]
        if self.num_leaves > 1 and dataset is not None:
            sfi = self.split_feature_inner
            self.split_feature = np.asarray(
                [dataset.real_feature_idx[f] for f in sfi], np.int32)
            mappers = [dataset.feature_mapper(int(f)) for f in sfi]
            self.threshold = np.asarray(
                [_bin_threshold_to_value(m, t)
                 for m, t in zip(mappers, self.threshold_bin)], np.float64)
            self.missing_code = np.asarray(
                [_MISSING_TYPE_CODE[m.missing_type] for m in mappers],
                np.int32)
            self.num_bin = np.asarray([m.num_bin for m in mappers], np.int32)
            self.default_bin = np.asarray([m.default_bin for m in mappers],
                                          np.int32)
            # EFB: each node's physical column (its feature's group; a
            # multi-val pseudo-group at or past the matrix's width) and
            # value offset (0 = raw bins)
            grp, off, _ = dataset.bundle_maps()
            self.col = np.asarray(grp, np.int32)[sfi]
            self.offset = np.asarray(off, np.int32)[sfi]
            # categorical: raw category values on the left side
            for i, m in enumerate(mappers):
                if self.decision_type[i] & kCategoricalMask:
                    self.cat_threshold[i] = _bitset_to_cats(
                        self.cat_bitsets[i], m)
        else:
            self.split_feature = self.split_feature_inner.copy()
            self.threshold = np.zeros(len(self.split_feature), np.float64)
            self.missing_code = np.zeros(len(self.split_feature), np.int32)
            self.num_bin = np.zeros(len(self.split_feature), np.int32)
            self.default_bin = np.zeros(len(self.split_feature), np.int32)
            self.col = self.split_feature_inner.copy()
            self.offset = np.zeros(len(self.split_feature), np.int32)

    # ------------------------------------------------------------------
    def set_linear(self, feats_inner: np.ndarray, coeff: np.ndarray,
                   const: np.ndarray, dataset=None) -> None:
        """Attach per-leaf linear models (``models/linear.py``'s fit):
        ``feats_inner`` [L, C] -1-padded inner features, trimmed to the
        widest leaf; a leaf without a model has coeff 0 and its constant
        as ``const``."""
        feats_inner = np.asarray(feats_inner, np.int32)
        cmax = max(int((feats_inner >= 0).sum(axis=1).max(initial=0)), 1)
        self.leaf_features_inner = np.ascontiguousarray(
            feats_inner[:, :cmax])
        self.leaf_coeff = np.asarray(coeff, np.float64)[:, :cmax].copy()
        self.leaf_const = np.asarray(const, np.float64).copy()
        lf = self.leaf_features_inner
        if dataset is not None:
            real = np.asarray(dataset.real_feature_idx, np.int64)
            self.leaf_features = np.where(
                lf >= 0, real[np.clip(lf, 0, max(len(real) - 1, 0))],
                -1).astype(np.int32)
        else:
            self.leaf_features = lf.copy()
        self.is_linear = True

    def clear_linear(self) -> None:
        """Back to constant leaves."""
        self.is_linear = False
        self.leaf_const = self.leaf_coeff = None
        self.leaf_features = self.leaf_features_inner = None

    def shrink(self, rate: float) -> None:
        """Tree::Shrinkage (tree.h:164-172)."""
        self.leaf_value *= rate
        self.internal_value *= rate
        self.shrinkage *= rate
        if self.is_linear:
            self.leaf_coeff = self.leaf_coeff * rate
            self.leaf_const = self.leaf_const * rate

    def add_bias(self, val: float) -> None:
        """Tree::AddBias (tree.h:180-189)."""
        self.leaf_value = self.leaf_value + val
        self.internal_value = self.internal_value + val
        if self.is_linear:
            self.leaf_const = self.leaf_const + val
        self.shrinkage = 1.0

    def default_left(self, node: int) -> bool:
        return bool(self.decision_type[node] & kDefaultLeftMask)

    def is_categorical(self, node: int) -> bool:
        return bool(self.decision_type[node] & kCategoricalMask)

    def missing_type(self, node: int) -> str:
        return _MISSING_TYPE_NAME[int(self.missing_code[node])]

    def leaf_depth_of(self, leaf: int) -> int:
        return int(self.leaf_depth[leaf])

    def ensure_leaf_depth(self) -> None:
        """Rebuild ``leaf_depth`` / ``leaf_parent`` from the child arrays
        when the source did not carry them (the model text does not).
        Children have larger node indices than their parent (creation
        order), so one forward pass suffices."""
        if self.num_leaves <= 1 or self.leaf_depth.max(initial=0) > 0:
            return
        node_depth = np.zeros(len(self.left_child), np.int32)
        for s in range(len(self.left_child)):
            for child in (int(self.left_child[s]),
                          int(self.right_child[s])):
                if child >= 0:
                    node_depth[child] = node_depth[s] + 1
                else:
                    self.leaf_depth[~child] = node_depth[s] + 1
                    self.leaf_parent[~child] = s

    # ------------------------------------------------------------------
    def predict(self, data: np.ndarray) -> np.ndarray:
        """Batch raw-feature prediction (Tree::Predict, tree.h:476); a
        linear tree's leaves evaluate their models (float64 of the
        float32 chain)."""
        idx = self.predict_leaf_index(data)
        if not self.is_linear:
            return self.leaf_value[idx]
        import torch
        from .linear import linear_leaf_values
        vals = linear_leaf_values(
            self, torch.as_tensor(idx), torch.as_tensor(
                np.asarray(data, np.float64)), inner=False)
        return vals.numpy()

    def predict_leaf_index(self, data: np.ndarray) -> np.ndarray:
        return self._walk(data.shape[0], lambda idx, nd: self._decide(
            data[idx, self.split_feature[nd]], nd))

    def _decide(self, fval, nodes) -> np.ndarray:
        """NumericalDecision / CategoricalDecision (tree.h:250-300)."""
        numeric = decide_raw(fval, self.threshold[nodes],
                             self.decision_type[nodes],
                             self.missing_code[nodes])
        is_cat = (self.decision_type[nodes] & kCategoricalMask) != 0
        if not is_cat.any():
            return numeric
        fval = np.asarray(fval, np.float64)
        fval = np.where(np.isnan(fval) & (self.missing_code[nodes] != 2),
                        0.0, fval)
        cat = np.zeros(len(nodes), bool)
        for i in np.nonzero(is_cat)[0]:
            v = fval[i]
            cat[i] = not np.isnan(v) and int(v) >= 0 \
                and int(v) in set(self.cat_threshold[nodes[i]].tolist())
        return np.where(is_cat, cat, numeric)

    def _check_mv(self, g_dense: int, mv_slots) -> None:
        if mv_slots is None and (self.col >= g_dense).any():
            raise ValueError("the tree splits on multi-val pseudo-groups; "
                             "a bin-space walk needs the dataset's "
                             "mv_slots matrix")

    def predict_leaf_index_binned(self, binned: np.ndarray,
                                  mv_slots: Optional[np.ndarray] = None
                                  ) -> np.ndarray:
        """Leaf index per row of a train-aligned BINNED matrix (its EFB
        group columns, and ``mv_slots`` for multi-val features; JAX
        ``predict_leaf_index_binned``)."""
        from ..data.bundling import MV_SLOT_STRIDE, decode_feature_bin
        g_dense = binned.shape[1]
        if self.num_leaves > 1:
            self._check_mv(g_dense, mv_slots)

        def decide(idx, nd):
            col = self.col[nd]
            b = decode_feature_bin(
                binned[idx, np.clip(col, 0, g_dense - 1)].astype(np.int64),
                self.offset[nd], self.num_bin[nd])
            if mv_slots is not None and (col >= g_dense).any():
                base = ((col.astype(np.int64) - g_dense) * MV_SLOT_STRIDE
                        + self.offset[nd])[:, None]
                sl = mv_slots[idx]
                inr = (sl >= base) & (sl < base + self.num_bin[nd][:, None]
                                      - 1)
                b = np.where(col >= g_dense,
                             np.where(inr, sl - base + 1, 0).sum(axis=1), b)
            miss = self.missing_code[nd]
            dleft = (self.decision_type[nd] & kDefaultLeftMask) != 0
            is_missing = np.where(
                miss == 1, b == self.default_bin[nd],
                np.where(miss == 2, b == self.num_bin[nd] - 1, False))
            go_left = np.where(is_missing, dleft, b <= self.threshold_bin[nd])
            is_cat = (self.decision_type[nd] & kCategoricalMask) != 0
            word = np.clip(b // 32, 0, MAX_CAT_WORDS - 1)
            bit = (self.cat_bitsets[nd, word].astype(np.int64) >> (b % 32)) & 1
            return np.where(is_cat, bit == 1, go_left)
        return self._walk(binned.shape[0], decide)

    def predict_binned_add(self, score, tid: int, binned,
                           mv_slots=None, raw=None) -> None:
        """``score[:, tid] += `` each row's float32 leaf value, for a
        train-aligned binned matrix on the device ([N, G] uint8, or the
        int16 bits of uint16 bins; with EFB the group columns, and
        ``mv_slots`` [N, K] int32 for multi-val features): the bin-space
        walk of ``predict_leaf_index_binned`` (the JAX package's
        ``_traverse_binned_add_jax``) for exactly the tree's depth in
        steps, known on the host, so the device is never read. A linear
        tree adds its leaf models over ``raw`` (the dataset's
        ``raw_numeric_device``)."""
        import torch
        from ..data.bundling import decode_feature_bin
        from ..ops.histogram import multival_node_bins
        vals = torch.as_tensor(self.leaf_value.astype(np.float32),
                               device=score.device)
        if self.num_leaves <= 1:
            score[:, tid] += vals[0]
            return
        self.ensure_leaf_depth()
        n, g_dense = binned.shape
        self._check_mv(g_dense, mv_slots)
        nodes = np.stack([
            self.col, self.offset, self.threshold_bin,
            (self.decision_type & kDefaultLeftMask) != 0, self.left_child,
            self.right_child, self.missing_code, self.default_bin,
            self.num_bin,
            self.decision_type & kCategoricalMask]).astype(np.int64)
        col, off, thr, dleft, left, right, miss, dbin, nbin, iscat = \
            torch.as_tensor(nodes, device=score.device)
        has_cat = bool((self.decision_type & kCategoricalMask).any())
        bundled = bool((self.offset > 0).any())
        has_mv = bool((self.col >= g_dense).any())
        words = torch.as_tensor(self.cat_bitsets.astype(np.int64),
                                device=score.device) if has_cat else None
        flat = binned.reshape(-1)
        base = torch.arange(n, device=score.device) * g_dense
        node = torch.zeros(n, dtype=torch.int64, device=score.device)
        for _ in range(int(self.leaf_depth.max())):
            internal = node >= 0
            nd = torch.where(internal, node, torch.zeros_like(node))
            c = col[nd]
            b = flat[base + c.clamp(max=g_dense - 1)].to(torch.int64)
            if bundled:
                b = decode_feature_bin(b, off[nd], nbin[nd])
            if has_mv:
                b = torch.where(c >= g_dense, multival_node_bins(
                    mv_slots, c, off[nd], nbin[nd], g_dense), b)
            m = miss[nd]
            is_missing = torch.where(m == 1, b == dbin[nd],
                                     (m == 2) & (b == nbin[nd] - 1))
            go_left = torch.where(is_missing, dleft[nd] != 0, b <= thr[nd])
            if has_cat:
                word = torch.clamp(b // 32, 0, MAX_CAT_WORDS - 1)
                bit = (words[nd, word] >> (b % 32)) & 1
                go_left = torch.where(iscat[nd] != 0, bit == 1, go_left)
            child = torch.where(go_left, left[nd], right[nd])
            node = torch.where(internal, child, node)
        if self.is_linear:
            if raw is None:
                raise ValueError("a linear-leaf tree's bin-space walk "
                                 "needs the dataset's raw values")
            from .linear import linear_leaf_values
            score[:, tid] += linear_leaf_values(self, ~node, raw)
            return
        score[:, tid] += vals[~node]

    def _walk(self, n: int, decide) -> np.ndarray:
        if self.num_leaves <= 1:
            return np.zeros(n, np.int32)
        node = np.zeros(n, np.int32)
        out = np.full(n, -1, np.int32)
        active = np.ones(n, bool)
        for _ in range(self.num_leaves):  # depth bound
            if not active.any():
                break
            idx = np.nonzero(active)[0]
            nd = node[idx]
            go_left = decide(idx, nd)
            child = np.where(go_left, self.left_child[nd],
                             self.right_child[nd])
            is_leaf = child < 0
            out[idx[is_leaf]] = ~child[is_leaf]
            node[idx[~is_leaf]] = child[~is_leaf]
            active[idx[is_leaf]] = False
        return out


def decide_raw(fval, threshold, decision_type, missing_code) -> np.ndarray:
    """NumericalDecision (tree.h:250-300) on raw values: NaN counts as 0
    unless the feature's missing type is NaN; missing values follow
    default_left; others go left when ``value <= threshold``."""
    fval = np.asarray(fval, np.float64)
    dleft = (decision_type & kDefaultLeftMask) != 0
    nan_mask = np.isnan(fval)
    fval = np.where(nan_mask & (missing_code != 2), 0.0, fval)
    is_missing = np.where(missing_code == 1, np.abs(fval) <= 1e-35,
                          np.where(missing_code == 2, nan_mask, False))
    return np.where(is_missing, dleft, fval <= threshold)


def _bin_threshold_to_value(mapper, threshold_bin: int) -> float:
    """Bin threshold -> raw-value threshold: the bin's upper bound
    (Tree::Split stores RealThreshold via BinToValue, tree.cpp); a
    categorical node keeps its bin."""
    if mapper.bin_type == BIN_TYPE_CATEGORICAL:
        return float(threshold_bin)
    return float(mapper.bin_upper_bound[int(threshold_bin)])


def _bitset_to_cats(bitset: np.ndarray, mapper) -> np.ndarray:
    """Bin-space bitset -> the raw categories of its set bins."""
    cats = []
    for b in range(min(mapper.num_bin, 32 * MAX_CAT_WORDS)):
        if (int(bitset[b // 32]) >> (b % 32)) & 1:
            if b < len(mapper.bin_2_categorical):
                cats.append(int(mapper.bin_2_categorical[b]))
    return np.asarray(cats, np.int64)


def constant_tree(output: float) -> Tree:
    """A one-leaf tree with value ``output`` (gbdt.cpp:407-415)."""
    z = np.zeros(1)
    return Tree(TreeArrays(
        num_leaves=1, split_feature=z.astype(np.int32),
        threshold_bin=z.astype(np.int32), decision_type=z.astype(np.int32),
        left_child=z.astype(np.int32), right_child=z.astype(np.int32),
        split_gain=z, internal_value=z, internal_weight=z, internal_count=z,
        leaf_value=np.asarray([output]), leaf_weight=z, leaf_count=z,
        leaf_parent=np.full(1, -1, np.int32),
        leaf_depth=z.astype(np.int32)))


def tree_from_arrays(num_leaves: int, split_feature, threshold,
                     decision_type, left_child, right_child, leaf_value,
                     missing_code, threshold_bin=None,
                     split_feature_inner=None, split_gain=None,
                     internal_value=None, internal_weight=None,
                     internal_count=None, leaf_weight=None, leaf_count=None,
                     leaf_parent=None, leaf_depth=None, shrinkage=1.0,
                     cat_threshold=None, cat_bitsets=None, num_bin=None,
                     default_bin=None) -> Tree:
    """A Tree from plain node arrays (raw-feature split index and
    threshold per node). ``convert.py`` builds trees carried over from
    the JAX package with this; a field not given is zero (the leaf
    parents -1, the shrinkage 1)."""
    nl = int(num_leaves)
    k = max(nl - 1, 1)
    sf = np.asarray(split_feature, np.int32)[:k]

    def node(a, dtype):
        return np.zeros(k, dtype) if a is None else np.asarray(a, dtype)[:k]

    def leaf(a, dtype, fill=0):
        return np.full(nl, fill, dtype) if a is None \
            else np.asarray(a, dtype)[:nl]
    tree = Tree(TreeArrays(
        num_leaves=nl,
        split_feature=sf if split_feature_inner is None
        else np.asarray(split_feature_inner, np.int32)[:k],
        threshold_bin=node(threshold_bin, np.int32),
        decision_type=np.asarray(decision_type, np.int32)[:k],
        left_child=np.asarray(left_child, np.int32)[:k],
        right_child=np.asarray(right_child, np.int32)[:k],
        split_gain=node(split_gain, np.float32),
        internal_value=node(internal_value, np.float64),
        internal_weight=node(internal_weight, np.float64),
        internal_count=node(internal_count, np.float64),
        leaf_value=np.asarray(leaf_value, np.float64),
        leaf_weight=leaf(leaf_weight, np.float64),
        leaf_count=leaf(leaf_count, np.float64),
        leaf_parent=leaf(leaf_parent, np.int32, -1),
        leaf_depth=leaf(leaf_depth, np.int32),
        cat_bitsets=None if cat_bitsets is None
        else np.asarray(cat_bitsets, np.uint32)[:k]), shrinkage=shrinkage)
    tree.split_feature = sf
    tree.has_bins = threshold_bin is not None
    tree.threshold = np.asarray(threshold, np.float64)[:k]
    tree.missing_code = np.asarray(missing_code, np.int32)[:k]
    if cat_threshold is not None:
        tree.cat_threshold = [np.asarray(c, np.int64)
                              for c in list(cat_threshold)[:k]]
    if num_bin is not None:
        tree.num_bin = np.asarray(num_bin, np.int32)[:k]
    if default_bin is not None:
        tree.default_bin = np.asarray(default_bin, np.int32)[:k]
    return tree
