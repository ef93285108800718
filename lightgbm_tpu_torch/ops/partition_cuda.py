"""Stable in-place segment partition (port of
``lightgbm_tpu/ops/partition_pallas.py``).

``partition_segment`` launches ``csrc/partition_segment.cu`` (two
kernels: a stable compaction into the workspace with decoupled
look-back, lefts from the front and rights from the back in reverse,
then the copy back) for a CUDA matrix and runs
``partition_segment_plain`` for a CPU one. Both reorder
rows [begin, begin+count) so the left rows come first, each side in its
original order, and return the child segments as an int32 [4] tensor
``(begin, NL, begin + NL, count - NL)`` on the matrix's device (the NL
of the JAX kernel is element 1).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.bundling import decode_feature_bin
from . import _native
from .partition import rows_go_left
from .split import (IM_DEFBIN, IM_GROUP, IM_MISS, IM_NBINS, IM_OFFSET,
                    MISSING_NAN_CODE, MISSING_ZERO_CODE)

# rows a tile of the segment fused step's workspace partition
# (csrc/partition_core.cuh kPartRows, one row a thread)
PART_THREADS = 256

# rows a tile of the compaction takes: kTileRows of
# csrc/partition_segment.cu (kThreads x kItems)
TILE_ROWS = 1024

# per device: [the u64 scratch (word 0 the tile counter, then one state a
# tile), the epoch of its last call]
_SCRATCH: dict = {}


def _scratch(device, count: int):
    """The device's partition scratch, grown to ``count`` rows' tiles,
    and the next call's epoch (1 .. 2^30 - 1; a tile's state carries
    its call's epoch, so the states need no reset between calls)."""
    tiles = max(1, -(-count // TILE_ROWS))
    entry = _SCRATCH.get(device)
    if entry is None or entry[0].numel() < 1 + tiles:
        entry = [torch.zeros((1 + tiles,), dtype=torch.int64,
                             device=device), 0]
        _SCRATCH[device] = entry
    entry[1] = entry[1] % ((1 << 30) - 1) + 1
    return entry[0], entry[1]


def bitset_to_lut(cat_bitset) -> torch.Tensor:
    """[W] uint32 bin bitset -> [1, 256] f32 membership LUT."""
    bits = np.asarray(cat_bitset, np.uint32)
    w = bits.shape[0]
    bins = np.arange(min(w * 32, 256))
    lut = np.zeros((1, 256), np.float32)
    lut[0, bins] = (bits[bins // 32] >> (bins % 32).astype(np.uint32)) & 1
    return torch.from_numpy(lut)


def partition_decision_lut(imeta: np.ndarray, feat: int, thr: int,
                           dleft: bool, is_cat: bool, bitset,
                           bundled: bool):
    """(column, use_lut, lut) of one split's physical partition (JAX
    ``partition_decision_lut``, learner/partitioned.py:63-92): the
    256-entry "column value -> goes left" table ([1, 256] f32 on the
    host) that decodes a bundled numerical split's group column and its
    missing rule in feature-bin space, or a categorical split's bin
    bitset; a raw (offset 0) numerical split reads its column through
    the threshold route (``use_lut`` False, ``lut`` None). ``imeta`` is
    the host [F, 8] metadata table (``pack_meta_tables``)."""
    col = int(imeta[feat, IM_GROUP]) if bundled else int(feat)
    off = int(imeta[feat, IM_OFFSET]) if bundled else 0
    if is_cat:
        return col, True, bitset_to_lut(bitset)
    if off == 0:
        return col, False, None
    nbf = int(imeta[feat, IM_NBINS])
    fbin = decode_feature_bin(np.arange(256, dtype=np.int64), off, nbf)
    mcode = int(imeta[feat, IM_MISS])
    if mcode == MISSING_ZERO_CODE:
        is_miss = fbin == int(imeta[feat, IM_DEFBIN])
    elif mcode == MISSING_NAN_CODE:
        is_miss = fbin == nbf - 1
    else:
        is_miss = np.zeros(256, bool)
    go_left = np.where(is_miss, bool(dleft), fbin <= int(thr))
    return col, True, torch.from_numpy(
        go_left.astype(np.float32).reshape(1, 256))


def _decide(mat, begin, count, feat, thr, default_left, missing_code,
            default_bin, num_bins_f, is_cat, cat_lut) -> torch.Tensor:
    bins = mat[begin:begin + count, int(feat)].long()
    if is_cat:
        return cat_lut.reshape(-1).to(mat.device)[bins] > 0.5
    return rows_go_left(bins, thr, default_left, int(missing_code),
                        default_bin, num_bins_f)


def partition_segment_plain(mat, ws, begin: int, count: int, feat, thr,
                            default_left, missing_code, default_bin,
                            num_bins_f, is_cat, cat_lut) -> torch.Tensor:
    """Plain version: boolean-mask compaction of the segment."""
    del ws
    left = _decide(mat, begin, count, feat, thr, default_left,
                   missing_code, default_bin, num_bins_f, is_cat, cat_lut)
    rows = mat[begin:begin + count]
    mat[begin:begin + count] = torch.cat([rows[left], rows[~left]])
    nl = int(left.sum())
    return torch.tensor([begin, nl, begin + nl, count - nl],
                        dtype=torch.int32, device=mat.device)


def partition_segment(mat: torch.Tensor, ws: torch.Tensor, begin: int,
                      count: int, feat: int, thr: int, default_left,
                      missing_code: int, default_bin: int, num_bins_f: int,
                      is_cat, cat_lut=None) -> torch.Tensor:
    """Stable-partition rows [begin, begin+count) of the training matrix
    by the split decision, in place. ``feat`` is the matrix column;
    ``cat_lut`` ([1, 256] f32, from ``bitset_to_lut``) decides when
    ``is_cat``. ``ws`` is a scratch matrix of ``mat``'s shape. Returns
    the int32 [4] child-segment tensor."""
    begin, count = int(begin), int(count)
    if mat.device.type == "cpu":
        return partition_segment_plain(
            mat, ws, begin, count, feat, thr, default_left, missing_code,
            default_bin, num_bins_f, is_cat, cat_lut)
    if mat.device.type != "cuda":
        raise ValueError(f"unsupported device {mat.device}")
    seg, args = _partition_args(mat, ws, begin, count, feat, thr,
                                default_left, missing_code, default_bin,
                                num_bins_f, is_cat, cat_lut)
    err = _native.library().ltt_partition_segment(
        *args, seg.data_ptr(), _native.stream_of(mat))
    _native.LAUNCHES["partition_segment"] += 1
    if bool(is_cat):
        _native.ROUTE_LAUNCHES["partition_segment_lut"] += 1
    _native.check(err, "partition_segment")
    return seg


def partition_segment_profile(mat, ws, begin, count, feat, thr,
                              default_left, missing_code, default_bin,
                              num_bins_f, is_cat, cat_lut=None, *,
                              vpr: int) -> torch.Tensor:
    """For profiling only (``chip_profile.py --partition``):
    ``partition_segment`` on a CUDA matrix with the compaction's
    instantiation picked by the caller: ``vpr`` = row bytes / 16 (2 to
    4: rows held in registers over the look-back) or 0 (rows loaded
    after it, any width)."""
    if mat.device.type != "cuda":
        raise ValueError(f"the profiled partition runs on the card, not "
                         f"{mat.device}")
    seg, args = _partition_args(mat, ws, int(begin), int(count), feat, thr,
                                default_left, missing_code, default_bin,
                                num_bins_f, is_cat, cat_lut)
    err = _native.library().ltt_partition_segment_profile(
        *args, seg.data_ptr(), int(vpr), _native.stream_of(mat))
    _native.LAUNCHES["partition_segment"] += 1
    _native.check(err, "partition_segment")
    return seg


def _partition_args(mat, ws, begin, count, feat, thr, default_left,
                    missing_code, default_bin, num_bins_f, is_cat, cat_lut):
    """Checks a CUDA call's inputs; returns the segment tensor it fills
    and the C entry points' arguments up to ``seg_out``."""
    n, cols = mat.shape
    _native.require(mat, device=mat.device, dtype=torch.uint8, name="mat")
    _native.require(ws, device=mat.device, dtype=torch.uint8,
                    shape=mat.shape, name="ws")
    if cols % 16 or mat.data_ptr() % 16 or ws.data_ptr() % 16:
        raise ValueError("training matrix rows must be 16-byte aligned")
    if not (0 <= begin and begin + count <= n and 0 <= int(feat) < cols):
        raise ValueError("segment or feature column out of range")
    if bool(is_cat):
        if cat_lut is None:
            raise ValueError("a categorical split needs cat_lut")
        lut = cat_lut.reshape(-1)
        _native.require(lut, device=mat.device, dtype=torch.float32,
                        shape=(256,), name="cat_lut")
    else:
        lut = mat  # never read
    scratch, epoch = _scratch(mat.device, count)
    seg = torch.empty((4,), dtype=torch.int32, device=mat.device)
    return seg, (mat.data_ptr(), ws.data_ptr(), cols, begin, count,
                 int(feat), int(thr), int(bool(default_left)),
                 int(missing_code), int(default_bin), int(num_bins_f),
                 int(bool(is_cat)), lut.data_ptr(), scratch.data_ptr(),
                 epoch)
