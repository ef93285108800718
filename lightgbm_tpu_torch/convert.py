"""Carry state from the JAX package into the port.

The port never imports the JAX package; a caller extracts the JAX
objects' state as numpy arrays and plain values, and these functions
turn it into the port's objects:

  * ``bin_mappers_from_state`` — each feature's bin upper bounds,
    missing type, default bin (and the rest of ``BinMapper.to_dict``),
    so ``Dataset.from_numpy(..., bin_mappers=...)`` bins a matrix
    exactly as the JAX dataset did;
  * ``trees_from_state`` — trained trees as node arrays (split feature,
    raw threshold, threshold bin, decision type, children, leaf values,
    per-node missing type, and optionally every other field the model
    text holds: gains, internal and leaf weights and counts, leaf
    parents and depths, shrinkage, categorical thresholds and bin
    bitsets, linear leaf models), so the port's predictor runs a
    JAX-trained model, the port's writer writes its text and its
    bin-space walk scores a valid set;
  * ``bundles_from_state`` — an EFB dataset's bundle plan
    (``feature_group``, ``feature_offset``, ``group_num_bins``,
    ``mv_group_start``) applied to a port dataset binned unbundled with
    the same mappers, which then holds the JAX dataset's group matrix
    and multi-val slots byte for byte;
  * ``matrix_from_jax`` and ``grow_state_from_jax`` — the partitioned
    grow loop's training matrix and its packed state (``S``, ``T``, the
    per-leaf histogram cache, over the EFB groups for a bundled dataset,
    and, with categorical features, the bin bitsets), or the serial grow
    loop's (``S``, ``T``, ``leaf_id``, the cache), so one state can be
    stepped in both packages.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .data.binning import BinMapper
from .models.tree import Tree, tree_from_arrays
from .ops.hist_cuda import GH_COLS, matrix_cols, payload_offset


def bin_mappers_from_state(states: Sequence[Dict]) -> List[BinMapper]:
    """One ``BinMapper`` per original feature from its state dict
    (the keys of ``BinMapper.to_dict``: num_bin, missing_type,
    is_trivial, sparse_rate, bin_type, bin_upper_bound,
    bin_2_categorical, min_val, max_val, default_bin, most_freq_bin)."""
    out = []
    for st in states:
        st = dict(st)
        st["bin_upper_bound"] = [float(v) for v in
                                 np.asarray(st["bin_upper_bound"],
                                            np.float64)]
        st["bin_2_categorical"] = [int(v) for v in
                                   st.get("bin_2_categorical", [])]
        out.append(BinMapper.from_dict(st))
    return out


_TREE_KEYS = ("num_leaves", "split_feature", "threshold", "decision_type",
              "left_child", "right_child", "leaf_value", "missing_code")
_OPTIONAL_TREE_KEYS = ("threshold_bin", "split_feature_inner", "split_gain",
                       "internal_value", "internal_weight",
                       "internal_count", "leaf_weight", "leaf_count",
                       "leaf_parent", "leaf_depth", "shrinkage",
                       "cat_threshold", "cat_bitsets", "num_bin",
                       "default_bin")


def trees_from_state(states: Sequence[Dict]) -> List[Tree]:
    """Trees from per-tree dicts of numpy node arrays. Required keys:
    num_leaves, split_feature (original feature index), threshold (raw
    value), decision_type, left_child, right_child, leaf_value,
    missing_code (0 none / 1 zero / 2 nan); optional: the keys of
    ``_OPTIONAL_TREE_KEYS`` (``cat_threshold`` a list of category
    arrays, one a node; ``cat_bitsets`` [nodes, 8] uint32 bin bitsets;
    ``num_bin`` and ``default_bin`` of each node's feature, which with
    the bins give the bin-space walk), zero (leaf parents -1, shrinkage
    1) when absent. A linear-leaf tree adds ``leaf_const`` [L],
    ``leaf_coeff`` [L, C] and ``leaf_features`` [L, C] (raw columns, -1
    padded) and optionally ``leaf_features_inner`` (the inner features,
    for the bin-space walk's linear scoring)."""
    trees = []
    for st in states:
        missing = [k for k in _TREE_KEYS if k not in st]
        if missing:
            raise KeyError(f"tree state lacks {missing}")
        tree = tree_from_arrays(
            *(st[k] for k in _TREE_KEYS),
            **{k: st[k] for k in _OPTIONAL_TREE_KEYS if k in st})
        if st.get("leaf_coeff") is not None:
            tree.leaf_const = np.asarray(st["leaf_const"], np.float64)
            tree.leaf_coeff = np.asarray(st["leaf_coeff"], np.float64)
            tree.leaf_features = np.asarray(st["leaf_features"], np.int32)
            inner = st.get("leaf_features_inner")
            tree.leaf_features_inner = None if inner is None \
                else np.asarray(inner, np.int32)
            tree.is_linear = True
        trees.append(tree)
    return trees


def bundles_from_state(dataset, feature_group, feature_offset,
                       group_num_bins, mv_group_start=None):
    """Give ``dataset`` (a port ``Dataset`` binned with the JAX
    dataset's mappers and ``enable_bundle=false``, so its matrix is the
    unbundled ``[N, F]``) the JAX dataset's EFB plan: its matrix becomes
    the plan's group columns (``bundle_matrix``) and, with multi-val
    groups, ``mv_slots`` the slot matrix (``build_mv_slots``), as the
    JAX dataset built them. Returns the dataset."""
    from .data.bundling import (BundlePlan, build_mv_slots, bundle_matrix,
                                dense_feature_bins)
    if dataset.is_bundled:
        raise ValueError("the dataset is bundled already")
    group_num_bins = np.asarray(group_num_bins, np.int32)
    plan = BundlePlan(np.asarray(feature_group, np.int32),
                      np.asarray(feature_offset, np.int32),
                      len(group_num_bins), group_num_bins, mv_group_start)
    raw = dataset.binned
    dataset.binned = bundle_matrix(raw, plan)
    if plan.has_multival:
        dataset.mv_slots = build_mv_slots(plan, raw.shape[0],
                                          dense_feature_bins(raw))
        dataset.mv_group_start = plan.mv_group_start
    dataset.feature_group = plan.feature_group
    dataset.feature_offset = plan.feature_offset
    dataset.group_num_bins = plan.group_num_bins
    dataset._device_copies = {}
    return dataset


def matrix_from_jax(mat: np.ndarray, num_features: int,
                    n: int) -> torch.Tensor:
    """The JAX package's training matrix (u8 ``[matrix_rows, round_up(F
    + 13, 128)]``: bins, then the 13 payload bytes at column F) -> the
    port's ``[n, matrix_cols(F)]`` (payload at ``round_up(F, 4)``). Both
    payloads hold grad f32, hess f32, the count byte and the row id, in
    that order, so bins, payload and row ids carry across byte for byte;
    the JAX padding rows are dropped."""
    mat = np.asarray(mat, np.uint8)
    f = num_features
    out = np.zeros((n, matrix_cols(f)), np.uint8)
    out[:, :f] = mat[:n, :f]
    p = payload_offset(f)
    out[:, p:p + GH_COLS] = mat[:n, f:f + GH_COLS]
    return torch.from_numpy(out)


def grow_state_from_jax(S: np.ndarray, T: np.ndarray, hist: np.ndarray,
                        channels_major: bool = False,
                        leaf_id: np.ndarray | None = None,
                        bs_bitset: np.ndarray | None = None,
                        cat_bitsets: np.ndarray | None = None
                        ) -> Dict[str, torch.Tensor]:
    """The JAX package's packed grow state -> the port's. ``S`` and ``T``
    share one layout (the merged ``StatePack``, int rows as float32 bit
    patterns) and are copied bit for bit. ``hist`` is the per-leaf cache,
    ``[L, F, B, 3]`` as the interpret path keeps it (F the EFB groups of
    a bundled dataset: the cache holds group histograms), or ``[L, 3, F, B]``
    with ``channels_major`` (the compiled Mosaic path's layout).
    ``leaf_id`` ([N] int32, the serial grow loop's row membership; a
    padded compiled-path vector is cut to N by the caller) comes across
    as ``"lid"`` when given. ``bs_bitset`` [L, 8] and ``cat_bitsets``
    [L-1, 8] (uint32; the JAX state carries them beside ``S`` and ``T``
    on a dataset with categorical features) come across under their
    names as int32 bit patterns, the port's layout. Every result is a
    fresh copy: the port updates its state in place, and a numpy view
    of a JAX array may share the array's buffer."""
    hist = np.array(hist, np.float32)
    if channels_major:
        hist = np.moveaxis(hist, 1, -1)
    out = {"S": torch.from_numpy(np.array(S, np.float32)),
           "T": torch.from_numpy(np.array(T, np.float32)),
           "hist": torch.from_numpy(np.ascontiguousarray(hist))}
    if leaf_id is not None:
        out["lid"] = torch.from_numpy(np.array(leaf_id, np.int32))
    for name, bits in (("bs_bitset", bs_bitset),
                       ("cat_bitsets", cat_bitsets)):
        if bits is not None:
            out[name] = torch.from_numpy(
                np.array(bits, np.uint32).view(np.int32))
    return out
