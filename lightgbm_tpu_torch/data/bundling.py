"""Exclusive Feature Bundling (EFB): the planner and the bundled layout.

Copy of ``lightgbm_tpu/data/bundling.py`` (``FindGroups`` /
``FastFeatureBundling``, src/io/dataset.cpp:41-314 of the reference;
``FeatureGroup`` offsets, include/LightGBM/feature_group.h:32-50).
Mutually (nearly) exclusive features share one physical column, so the
training matrix shrinks from ``[N, F]`` to ``[N, G]``.

Layout of a multi-feature group: value 0 = every member at its default
bin; member ``i`` with ``num_bin_i`` bins owns the values
``[offset_i, offset_i + num_bin_i - 2]`` (its bins 1..num_bin_i-1), with
``offset_{i+1} = offset_i + num_bin_i - 1`` and a group total
``1 + sum(num_bin_i - 1) <= 256``. A singleton group keeps raw bins
(offset 0), so a dense matrix passes through unchanged. Per-feature
histograms are rebuilt at scan time (``ops/histogram.py:debundle_hist``),
bin 0 from the leaf totals (the reference's ``FixHistogram``).

Multi-val pseudo-groups (the second round, dataset.cpp:186-231) have no
column: each row's values ride a padded ``[N, K]`` int32 slot matrix
(``build_mv_slots``), ``pseudo_local * MV_SLOT_STRIDE + offset + bin -
1``, 0-padded.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

MAX_BIN_PER_GROUP = 256
MAX_SEARCH_GROUP = 100
_HEAD = 2048       # conflict-count rows read before the early cut
# multi-val slot encoding stride: slot = pseudo_local * MV_SLOT_STRIDE
# + offset + bin - 1 (build_mv_slots); every decoder uses this
MV_SLOT_STRIDE = MAX_BIN_PER_GROUP


def decode_feature_bin(col, off, nbf):
    """Group-column value -> this feature's bin (0 = default bin).
    ``off == 0`` means raw passthrough. Arithmetic only, so the same
    helper serves numpy arrays and torch tensors."""
    in_range = (col >= off) & (col < off + nbf - 1)
    fb = (col - off + 1) * in_range
    return fb * (off > 0) + col * (off == 0)


def encode_feature_bin(out_col: np.ndarray, bins: np.ndarray,
                       off: int) -> None:
    """Write a feature's non-default bins into its group column in place
    (FeatureGroup::PushData semantics)."""
    nz = bins != 0
    out_col[nz] = (bins[nz].astype(np.int64) + off - 1).astype(
        out_col.dtype)


class BundlePlan:
    """Result of bundling: per-inner-feature column/offset maps. Group
    ids at and above ``mv_group_start`` are multi-val pseudo-groups with
    no matrix column."""

    def __init__(self, feature_group: np.ndarray,
                 feature_offset: np.ndarray, num_groups: int,
                 group_num_bins: np.ndarray,
                 mv_group_start: Optional[int] = None):
        self.feature_group = feature_group    # [F] i32 matrix column
        self.feature_offset = feature_offset  # [F] i32, 0 = raw bins
        self.num_groups = num_groups          # incl. mv pseudo-groups
        self.group_num_bins = group_num_bins  # [G] i32
        self.mv_group_start = (num_groups if mv_group_start is None
                               else mv_group_start)

    @property
    def num_dense_groups(self) -> int:
        return self.mv_group_start

    @property
    def has_multival(self) -> bool:
        return self.mv_group_start < self.num_groups

    @property
    def is_identity(self) -> bool:
        return self.num_groups == len(self.feature_group) \
            and (self.feature_offset == 0).all() \
            and not self.has_multival


def _find_groups(nz_idx: List[Optional[np.ndarray]], nbins: np.ndarray,
                 order: np.ndarray, total: int, max_conflict: int,
                 seed: int):
    """One greedy pass (FindGroups, dataset.cpp:97-185) plus the
    second-round multi-val split; see the JAX package for the notes."""
    rng = np.random.RandomState(seed)
    groups: List[List[int]] = []
    marks: List[np.ndarray] = []
    used_cnt: List[int] = []
    total_cnt: List[int] = []
    nbin: List[int] = []

    singletons: List[List[int]] = []
    for f in order:
        f = int(f)
        if nz_idx[f] is None:
            singletons.append([f])
            continue
        idx = nz_idx[f]
        nnz = len(idx)
        add_bins = int(nbins[f]) - 1
        available = [g for g in range(len(groups))
                     if total_cnt[g] + nnz <= total + max_conflict
                     and nbin[g] + add_bins <= MAX_BIN_PER_GROUP]
        search: List[int] = []
        if available:
            search.append(available[-1])  # newest first
            rest = available[:-1]
            if len(rest) > MAX_SEARCH_GROUP - 1:
                pick = rng.choice(len(rest), MAX_SEARCH_GROUP - 1,
                                  replace=False)
                rest = [rest[i] for i in pick]
            search.extend(rest)
        best = -1
        best_cnt = -1
        for g in search:
            # the JAX loop's test, cnt <= rest_max and cnt <= nnz // 2,
            # with the count cut short once a head of idx already breaks
            # it: the same groups, far fewer reads on conflicting data
            limit = min(max_conflict - total_cnt[g] + used_cnt[g],
                        nnz // 2)
            cnt = int(marks[g][idx[:_HEAD]].sum())
            if cnt > limit:
                continue
            if nnz > _HEAD:
                cnt += int(marks[g][idx[_HEAD:]].sum())
            if cnt <= limit:
                best = g
                best_cnt = cnt
                break
        if best >= 0:
            groups[best].append(f)
            total_cnt[best] += nnz
            used_cnt[best] += nnz - best_cnt
            marks[best][idx] = True
            nbin[best] += add_bins
        else:
            groups.append([f])
            mark = np.zeros(total, bool)
            mark[idx] = True
            marks.append(mark)
            total_cnt.append(nnz)
            used_cnt.append(nnz)
            nbin.append(1 + add_bins)
    dense_threshold = 0.4
    kept: List[List[int]] = []
    second: List[int] = []
    second_nnz = 0
    for g, feats in enumerate(groups):
        if used_cnt[g] >= dense_threshold * total:
            kept.append(feats)
        else:
            second.extend(feats)
            second_nnz += total_cnt[g]
    multival: List[int] = []
    if second:
        row_cnt = np.zeros(total, np.int64)
        for fidx in second:
            np.add.at(row_cnt, nz_idx[fidx], 1)
        conflicts = second_nnz - int((row_cnt > 0).sum())
        bins2 = 1 + sum(int(nbins[fidx]) - 1 for fidx in second)
        k_est = int(row_cnt.max(initial=0))
        if conflicts <= max_conflict and bins2 <= MAX_BIN_PER_GROUP:
            kept.append(sorted(second))
        elif 4 * k_est < len(second):
            multival = sorted(second)
        else:
            kept.extend([fidx] for fidx in sorted(second))
    return kept + singletons, multival


def plan_bundles(binned: np.ndarray, num_bins: np.ndarray,
                 eligible: np.ndarray, sample_cnt: int = 100_000,
                 seed: int = 0) -> BundlePlan:
    """Greedy two-pass bundling over the binned matrix
    (FastFeatureBundling, dataset.cpp:238-302)."""
    n, f = binned.shape
    if f == 0:
        return BundlePlan(np.zeros(0, np.int32), np.zeros(0, np.int32),
                          0, np.zeros(0, np.int32))
    take = min(n, sample_cnt)
    if take < n:
        rows = np.sort(np.random.RandomState(seed).choice(
            n, take, replace=False))
        sample = binned[rows]
    else:
        sample = binned
    total = sample.shape[0]
    nz_idx: List[Optional[np.ndarray]] = [
        np.nonzero(sample[:, j])[0] if eligible[j] else None
        for j in range(f)]
    return plan_bundles_from_nonzeros(nz_idx, num_bins, total, seed)


def plan_bundles_from_nonzeros(nz_idx: List[Optional[np.ndarray]],
                               num_bins: np.ndarray, total: int,
                               seed: int = 0) -> BundlePlan:
    """Plan from per-feature non-default row-index lists."""
    f = len(nz_idx)
    nnz = np.asarray([0 if ix is None else len(ix) for ix in nz_idx],
                     np.int64)
    max_conflict = total // 10000

    natural = np.arange(f)
    by_cnt = np.argsort(-nnz, kind="stable")
    g1, mv1 = _find_groups(nz_idx, num_bins, natural, total, max_conflict,
                           seed)
    g2, mv2 = _find_groups(nz_idx, num_bins, by_cnt, total, max_conflict,
                           seed)
    if len(g2) + (1 if mv2 else 0) < len(g1) + (1 if mv1 else 0):
        groups, multival = g2, mv2
    else:
        groups, multival = g1, mv1

    mv_groups: List[List[int]] = []
    mv_bins: List[int] = []
    for fidx in multival:
        add = int(num_bins[fidx]) - 1
        for gi in range(len(mv_groups)):
            if mv_bins[gi] + add <= MAX_BIN_PER_GROUP:
                mv_groups[gi].append(fidx)
                mv_bins[gi] += add
                break
        else:
            mv_groups.append([fidx])
            mv_bins.append(1 + add)
    groups = groups + mv_groups
    mv_group_start = len(groups) - len(mv_groups)

    feature_group = np.zeros(f, np.int32)
    feature_offset = np.zeros(f, np.int32)
    group_num_bins = np.zeros(len(groups), np.int32)
    for gid, feats in enumerate(groups):
        if len(feats) == 1 and gid < mv_group_start:
            feature_group[feats[0]] = gid
            feature_offset[feats[0]] = 0
            group_num_bins[gid] = num_bins[feats[0]]
        else:
            off = 1
            for fidx in feats:
                feature_group[fidx] = gid
                feature_offset[fidx] = off
                off += int(num_bins[fidx]) - 1
            group_num_bins[gid] = off
    if mv_groups and mv_group_start == 0:
        feature_group += 1
        group_num_bins = np.concatenate(
            [np.asarray([2], np.int32), group_num_bins])
        mv_group_start = 1
        groups = [[]] + groups
    return BundlePlan(feature_group, feature_offset, len(groups),
                      group_num_bins, mv_group_start)


def bundle_matrix(binned: np.ndarray, plan: BundlePlan) -> np.ndarray:
    """[N, F] raw bins -> [N, G_dense] bundled columns (FeatureGroup::
    PushData semantics: non-default values land at their offset, ties
    resolved by feature order, bounded by the conflict budget).
    Multi-val pseudo-groups get no column (``build_mv_slots``)."""
    n, f = binned.shape
    g_dense = plan.num_dense_groups
    max_b = int(plan.group_num_bins[:g_dense].max(initial=2))
    dtype = np.uint8 if max_b <= 256 else np.uint16
    out = np.zeros((n, max(g_dense, 1)), dtype)
    for j in range(f):
        g = plan.feature_group[j]
        if g >= g_dense:
            continue
        off = plan.feature_offset[j]
        col = binned[:, j]
        if off == 0:
            out[:, g] = col.astype(dtype)
        else:
            encode_feature_bin(out[:, g], col, int(off))
    return out


def dense_feature_bins(raw: np.ndarray):
    """``feature_bins`` callback of ``build_mv_slots`` over a dense raw
    bin matrix: (nonzero rows, their bins) of column j."""
    def feature_bins(j):
        col = raw[:, j]
        rows = np.nonzero(col)[0]
        return rows, col[rows]
    return feature_bins


def build_mv_slots(plan: BundlePlan, n: int, feature_bins) -> np.ndarray:
    """Row-wise padded slot matrix of the multi-val pseudo-groups
    (MultiValSparseBin analog, multi_val_sparse_bin.hpp:26): slot value
    ``pseudo_local * 256 + offset + bin - 1``, 0-padded, a row's values
    in feature order. Bin 0 of a pseudo-group is never encoded (offsets
    start at 1), so padding lands where the debundle never reads.
    ``feature_bins(j)`` -> (row ids, bins > 0) of feature j's non-default
    rows, each row at most once. The JAX package's fill, with a feature's
    rows advanced by one plain fancy-index add (its rows are distinct)
    in place of ``np.add.at``."""
    encoded = []
    counts = np.zeros(n, np.int64)
    for j in range(len(plan.feature_group)):
        g = plan.feature_group[j]
        if g < plan.mv_group_start:
            continue
        rows, bins = feature_bins(j)
        rows = np.asarray(rows, np.int64)
        encoded.append((rows, (g - plan.mv_group_start) * MV_SLOT_STRIDE
                        + plan.feature_offset[j]
                        + np.asarray(bins, np.int64) - 1))
        counts += np.bincount(rows, minlength=n)
    slots = np.zeros((n, max(int(counts.max(initial=0)), 1)), np.int32)
    fill = np.zeros(n, np.int64)
    for rows, enc in encoded:
        slots[rows, fill[rows]] = enc
        fill[rows] += 1
    return slots
