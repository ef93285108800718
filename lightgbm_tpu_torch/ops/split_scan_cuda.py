"""Numerical best-split scan of one or two leaves in one launch (port of
``lightgbm_tpu/ops/split_scan_pallas.py``).

``per_feature_numerical_cuda`` launches ``csrc/split_scan.cu`` for CUDA
histograms and runs the plain version (``ops/split.py:
per_feature_numerical``) per leaf for CPU ones. The JAX package vmaps
its scan over both fresh children (learner/split_step.py
``scan_children``); here the children are the kernel's first grid axis.
The result is the ``[K, F, 8]`` table of ``ops/split.py`` (score,
threshold, left g/h(+kEpsilon)/c, default_left, left and right output).
The kernel takes 1 to 65,536 bins: the partitioned learner's u8 bins and
the serial learner's u16 bins; past 1024 bins it walks the bins in
windows of 1024 (``csrc/scan_core.cuh`` ``scan_feature_wide``), and the
plain version's ``_cumsum`` repeats the windows' order.

With extra_trees or by-node feature sampling the scan takes the tree's
node table (``node_table``) and each leaf's salt (0 at the root,
``2k+1`` / ``2k+2`` for the children of split ``k``): the kernel reads
the leaf's row, the plain version the same row decoded
(``node_rows``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import _native
from .split import SplitParams, per_feature_numerical, scan_table

# bins per feature the kernel takes (csrc/scan_core.cuh kMaxWideBins); the
# TPU kernel takes B from the histogram's shape
MAX_SCAN_BINS = 65536
# the rand-bin field of a node-table entry that means "every threshold"
# (a rand bin is a threshold, at most 65,534)
ALL_THRESHOLDS = 0xFFFF


def node_table(rand_bins, mask, f: int, device) -> torch.Tensor:
    """One tree's per-node randomness as the kernel reads it, a row per
    salt: int32 [S, F] on ``device``, bits 0-15 the rand bin as a uint16
    (``ALL_THRESHOLDS`` for -1, every threshold; ``rand_bins`` int
    [S, F], or None without extra_trees) and bit 16 the node mask (``mask`` bool [S, F], or
    None without by-node sampling: every feature). Uploaded once a
    tree."""
    s = (rand_bins if rand_bins is not None else mask).shape[0]
    rb = torch.full((s, f), -1, dtype=torch.int64) if rand_bins is None \
        else torch.as_tensor(rand_bins, dtype=torch.int64)
    nm = torch.ones((s, f), dtype=torch.int64) if mask is None \
        else torch.as_tensor(mask, dtype=torch.int64)
    return ((rb & 0xFFFF) | (nm << 16)).to(torch.int32).to(device)


def node_rows(node: Optional[torch.Tensor], salts):
    """The rows ``salts`` of a node table, decoded: per leaf (rand_bins
    [F] int64, -1 for every threshold; node_mask [F] bool), or
    (None, None) a leaf without a table."""
    if node is None:
        return [(None, None)] * len(salts)
    rows = node[[int(x) for x in salts]].long()
    rb = rows & 0xFFFF
    rb = torch.where(rb == ALL_THRESHOLDS, torch.full_like(rb, -1), rb)
    nm = ((rows >> 16) & 1) == 1
    return list(zip(rb, nm))


def scan_meta_tables(meta_t: dict):
    """[F, 4] i32 (num_bins, missing, default_bin, monotone) and [F, 2]
    f32 (penalty, fmask) tables the kernel reads."""
    imeta = torch.stack([meta_t["num_bins"], meta_t["missing"],
                         meta_t["default_bin"], meta_t["monotone"]],
                        dim=1).to(torch.int32).contiguous()
    fmeta = torch.stack([meta_t["penalty"], meta_t["fmask"]],
                        dim=1).to(torch.float32).contiguous()
    return imeta, fmeta


def per_feature_numerical_plain(hists: Sequence[torch.Tensor],
                                leaves: Sequence[tuple], meta_t: dict,
                                params: SplitParams,
                                node: Optional[torch.Tensor] = None,
                                salts: Sequence[int] = (0, 0)
                                ) -> torch.Tensor:
    """Plain version: one ``per_feature_numerical`` per leaf, stacked
    into the [K, F, 8] table; with ``node`` (``node_table``), leaf ``i``
    takes the rand bins and node mask of row ``salts[i]``."""
    return torch.stack([
        scan_table(per_feature_numerical(h, *leaf[:3], meta_t, params,
                                         leaf[3], leaf[4], rb, nm))
        for h, leaf, (rb, nm) in zip(hists, leaves,
                                     node_rows(node, salts))])


def _leaf_count(hists, leaves) -> int:
    if len(hists) not in (1, 2) or len(leaves) != len(hists):
        raise ValueError("scan takes 1 or 2 leaves")
    return len(hists)


def _scan_args(hists, leaves, meta_t, params, tables):
    """Checks the inputs and returns (out, the kernel's arguments up to
    ``out``) for the scan's C entry points."""
    k = _leaf_count(hists, leaves)
    dev = hists[0].device
    f, b, _ = hists[0].shape
    if not 1 <= b <= MAX_SCAN_BINS:
        raise ValueError(f"num_bins must be in [1, {MAX_SCAN_BINS}], "
                         f"got {b}")
    for i, h in enumerate(hists):
        _native.require(h, device=dev, dtype=torch.float32, shape=(f, b, 3),
                        name=f"hist[{i}]")
    imeta, fmeta = tables if tables is not None else scan_meta_tables(meta_t)
    _native.require(imeta, device=dev, dtype=torch.int32, shape=(f, 4),
                    name="imeta")
    _native.require(fmeta, device=dev, dtype=torch.float32, shape=(f, 2),
                    name="fmeta")
    out = torch.empty((k, f, 8), dtype=torch.float32, device=dev)
    l0 = [float(v) for v in leaves[0]]
    l1 = [float(v) for v in leaves[-1]]
    p = params
    return out, (k, f, b, hists[0].data_ptr(), hists[-1].data_ptr(), *l0,
                 *l1, imeta.data_ptr(), fmeta.data_ptr(), p.lambda_l1,
                 p.lambda_l2, p.max_delta_step, p.min_data_in_leaf,
                 p.min_sum_hessian_in_leaf, p.min_gain_to_split)


def per_feature_numerical_cuda(hists: Sequence[torch.Tensor],
                               leaves: Sequence[tuple], meta_t: dict,
                               params: SplitParams, tables=None,
                               node: Optional[torch.Tensor] = None,
                               salts: Sequence[int] = (0, 0)
                               ) -> torch.Tensor:
    """Best threshold per feature of K = len(hists) leaves (1 or 2).

    ``hists``: [F, B, 3] f32 each; ``leaves``: per leaf
    ``(parent_g, parent_h, parent_c, cmin, cmax)`` float32 scalars (host
    values, passed to the kernel by value). ``tables`` optionally
    supplies ``scan_meta_tables(meta_t)`` built once by the caller.
    ``node`` (``node_table``) and ``salts`` (a salt a leaf) select each
    leaf's row of the tree's node table."""
    k = _leaf_count(hists, leaves)
    dev = hists[0].device
    if dev.type == "cpu":
        return per_feature_numerical_plain(hists, leaves, meta_t, params,
                                           node, salts)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out, args = _scan_args(hists, leaves, meta_t, params, tables)
    rows = (0, 0)
    if node is not None:
        f = hists[0].shape[0]
        _native.require(node, device=dev, dtype=torch.int32, name="node")
        if node.dim() != 2 or node.shape[1] != f \
                or not all(0 <= int(s) < node.shape[0] for s in salts[:k]):
            raise ValueError("node table rows do not fit the scan")
        rows = tuple(node.data_ptr() + int(salts[min(i, k - 1)]) * f * 4
                     for i in range(2))
    err = _native.library().ltt_split_scan(*args, *rows, out.data_ptr(),
                                           _native.stream_of(hists[0]))
    _native.LAUNCHES["split_scan"] += 1
    _native.check(err, "split_scan")
    return out


def per_feature_numerical_profile(hists: Sequence[torch.Tensor],
                                  leaves: Sequence[tuple], meta_t: dict,
                                  params: SplitParams, tables=None,
                                  threads: int = 0,
                                  times: torch.Tensor | None = None
                                  ) -> torch.Tensor:
    """For profiling only (``chip_profile.py --scan-phases``, the card
    tests): ``per_feature_numerical_cuda``'s table from CUDA histograms
    at ``threads`` a block (a multiple of 32 in [32, 512]; 0: the
    kernel's own choice) and, with ``times`` (int64 [K, F, 5], on the
    card), from the timed build, which writes each block's five
    ``clock64`` reads of ``scan_feature`` there."""
    dev = hists[0].device
    if dev.type != "cuda":
        raise ValueError(f"the profiled scan runs on the card, not {dev}")
    out, args = _scan_args(hists, leaves, meta_t, params, tables)
    if times is not None:
        _native.require(times, device=dev, dtype=torch.int64,
                        shape=(*out.shape[:2], 5), name="times")
    err = _native.library().ltt_split_scan_profile(
        *args, int(threads), out.data_ptr(),
        0 if times is None else times.data_ptr(),
        _native.stream_of(hists[0]))
    _native.LAUNCHES["split_scan"] += 1
    _native.check(err, "split_scan")
    return out
