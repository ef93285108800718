"""Training-matrix layout and the segment histogram (port of
``lightgbm_tpu/ops/hist_pallas.py``).

**Training matrix.** Everything a tree build touches rides in ONE
row-major uint8 matrix, as in the JAX package, so the partition kernel
moves whole rows once and the histogram kernel streams one segment::

    cols [0, F)        feature bins (u8)
    P = round_up(F, 4)
    cols P+0..3        grad f32 bytes (little-endian)
    cols P+4..7        hess f32 bytes
    col  P+8           bagging/count indicator (0/1)
    cols P+9..12       row id (i32 bytes; partition bookkeeping)
    C = round_up(P + 13, 16)

The GPU stride is chosen for the card, not copied: the TPU's
``C = round_up(F + 13, 128)`` and the ``matrix_rows`` slack exist for
Mosaic DMA windows. Here the payload starts 4-aligned so grad/hess load
as one float each, and rows are a multiple of 16 bytes so the partition
kernel moves them as 16-byte vectors. F=28 gives C=48 (the TPU layout
used 128). The matrix has exactly N rows.

``histogram_segment`` launches ``csrc/hist_segment.cu`` for a CUDA
tensor and runs ``histogram_segment_plain`` for a CPU tensor; all three
TPU variant names (grouped, perfeat, perbin) compute the same function
and go to the one kernel.

**Full-range histogram** (``histogram_pallas``, the JAX package's
``build_histogram(method="pallas")``). ``histogram_rows`` launches
``csrc/hist_rows.cu`` for CUDA tensors and runs ``histogram_rows_plain``
(``ops/histogram.py:build_histogram``) for CPU ones: the [F, B, 3]
histogram of a row-major [N, F] bin matrix (u8, the int16 bits of u16
bins, or past 32,768 bins int32) with ghc [N, 3], over all rows or over
a list of row ids in row order, up to 65,536 bins (past the bins whose
one-feature tile fits a block, each block takes a window of the bins).
No training matrix is built. The kernel shares the leaf fused step's
row loop and chunk rule (``csrc/hist_ids.cuh``; mirrored below as
``LEAF_*``), so the serial learner's per-phase child histograms equal
the fused step's bit for bit. ``histogram_rows_batched`` takes all rows
for M models' ghc [M, N, 3] in one launch (the multiboost learner's
roots), each model's ``histogram_rows``' bit for bit;
``histogram_rows_batched_plain`` loops ``build_histogram`` over them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _native
from .histogram import build_histogram

GH_COLS = 13       # payload columns after the (aligned) features
G_OFF, H_OFF, CNT_OFF, RID_OFF = 0, 4, 8, 9
VARIANTS = ("grouped", "perfeat", "perbin")

# The chunk rule (csrc/hist_tile.cuh child_chunks), shared by the
# histogram kernel and the fused split step: features go in tiles of
# TILE_FEATURES (one a warp), and a segment of `count` rows is cut into
# contiguous chunks of about CHUNK_ROWS rows, at most max_chunks(F) of
# them (chunks x feature tiles <= CHUNK_SLOTS; the leading dimension of
# both kernels' partial buffers).
CHUNK_ROWS = 256             # csrc/hist_tile.cuh kChunkRows
CHUNK_SLOTS = 264            # csrc/hist_tile.cuh kChunkSlots
STEP_ROWS = 256              # csrc/hist_tile.cuh kStepRows
TILE_FEATURES = 8            # csrc/hist_tile.cuh kTileFeatures


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def payload_offset(num_features: int) -> int:
    return _round_up(num_features, 4)


def matrix_cols(num_features: int) -> int:
    return _round_up(payload_offset(num_features) + GH_COLS, 16)


def build_matrix(binned: torch.Tensor) -> torch.Tensor:
    """[N, F] bins -> training matrix [N, C] u8 with row ids (payload
    grad/hess/count zero until ``pack_gh``)."""
    n, f = binned.shape
    p = payload_offset(f)
    mat = torch.zeros((n, matrix_cols(f)), dtype=torch.uint8,
                      device=binned.device)
    mat[:, :f] = binned.to(torch.uint8)
    rid = torch.arange(n, dtype=torch.int32, device=binned.device)
    mat[:, p + RID_OFF:p + RID_OFF + 4] = rid.view(torch.uint8).view(n, 4)
    return mat


def pack_gh(mat: torch.Tensor, num_features: int, grad, hess,
            cnt) -> torch.Tensor:
    """Write the gh payload columns of rows [0, len(grad)) in place."""
    n = grad.shape[0]
    p = payload_offset(num_features)
    for off, v in ((G_OFF, grad), (H_OFF, hess)):
        mat[:n, p + off:p + off + 4] = v.to(torch.float32).contiguous() \
            .view(torch.uint8).view(n, 4)
    mat[:n, p + CNT_OFF] = (cnt > 0).to(torch.uint8)
    return mat


def _payload_f32(seg_rows: torch.Tensor, col: int) -> torch.Tensor:
    return seg_rows[:, col:col + 4].contiguous().view(torch.float32)[:, 0]


def extract_row_ids(mat: torch.Tensor, num_features: int,
                    n: int) -> torch.Tensor:
    """Recover i32 row ids from the payload columns (rows [0, n))."""
    p = payload_offset(num_features) + RID_OFF
    return mat[:n, p:p + 4].contiguous().view(torch.int32)[:, 0]


def decode_payload(seg_rows: torch.Tensor, num_features: int):
    """(grad, hess, count) f32 of the given matrix rows."""
    p = payload_offset(num_features)
    return (_payload_f32(seg_rows, p + G_OFF),
            _payload_f32(seg_rows, p + H_OFF),
            seg_rows[:, p + CNT_OFF].to(torch.float32))


def histogram_segment_plain(mat: torch.Tensor, begin: int, count: int,
                            num_bins: int, num_features: int,
                            absolute: bool = False,
                            float64: bool = False) -> torch.Tensor:
    """Plain version: [F, B, 3] histogram of rows [begin, begin+count),
    accumulated in float64 and rounded once to float32 (``float64``:
    not rounded). ``absolute`` sums |grad|, |hess| instead (the
    tolerance scale the checks use)."""
    f, b = num_features, num_bins
    rows = mat[begin:begin + count]
    g, h, c = decode_payload(rows, f)
    vals = torch.stack([g, h, c], dim=1).double()
    if absolute:
        vals = vals.abs()
    out = torch.zeros((f, b, 3), dtype=torch.float64, device=mat.device)
    bins = rows[:, :f].long()
    for j in range(f):
        out[j].index_add_(0, bins[:, j], vals)
    return out if float64 else out.float()


def max_chunks(num_features: int) -> int:
    """The most row chunks of a segment (``csrc/hist_tile.cuh``
    ``max_chunks``): the leading dimension of the partial buffers."""
    return max(1, CHUNK_SLOTS // -(-num_features // TILE_FEATURES))


def child_chunks(count: int, num_features: int) -> int:
    """Row chunks of a segment of ``count`` rows (``csrc/hist_tile.cuh``
    ``child_chunks``): the chunks, and with them the summation order of
    its histogram, depend on the row and feature counts alone."""
    return max(1, min(max_chunks(num_features),
                      -(-int(count) // CHUNK_ROWS)))


def hist_smem_bytes(num_bins: int) -> int:
    """Shared bytes of one histogram block (``hist_smem_bytes``): the
    float64 bins of its feature tile and one staged step of rows."""
    return TILE_FEATURES * num_bins * 24 + 3 * STEP_ROWS * 4 \
        + TILE_FEATURES * STEP_ROWS


def histogram_segment(mat: torch.Tensor, begin, count, num_bins: int,
                      num_features: int, variant: str | None = None,
                      max_count: int | None = None,
                      float64: bool = False) -> torch.Tensor:
    """Histogram of rows [begin, begin+count) -> [F, B, 3] f32.

    ``begin``/``count`` are ints, or ``begin`` is a device int32 [2]
    tensor (begin, count) — a segment the partition kernel produced —
    with ``count=None`` and ``max_count`` an upper bound on its size
    known to the host: the grid and the partials are sized from it (so a
    split never waits for the device to learn a child's size), and the
    kernel reads the segment's own count for its chunks (``child_chunks``),
    so the sums do not depend on the bound. With int bounds,
    ``max_count`` (default ``count``) sizes the launch the same way.
    ``variant`` accepts the JAX package's names; all are the same
    function here. ``float64`` returns the float64 sums unrounded (the
    data-parallel learners reduce them across ranks, then round once)."""
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"unknown histogram variant {variant!r}")
    seg_t = begin if isinstance(begin, torch.Tensor) else None
    if mat.device.type == "cpu":
        if seg_t is not None:
            begin, count = (int(v) for v in seg_t.tolist())
        return histogram_segment_plain(mat, int(begin), int(count),
                                       num_bins, num_features,
                                       float64=float64)
    if mat.device.type != "cuda":
        raise ValueError(f"unsupported device {mat.device}")
    if not 1 <= num_bins <= 256:
        raise ValueError(f"num_bins must be in [1, 256], got {num_bins}")
    n, cols = mat.shape
    _native.require(mat, device=mat.device, dtype=torch.uint8, name="mat")
    if cols != matrix_cols(num_features) or mat.data_ptr() % 16:
        raise ValueError(f"mat is not a {num_features}-feature training "
                         "matrix (stride or alignment)")
    if seg_t is None:
        if not (0 <= int(begin) and int(begin) + int(count) <= n):
            raise ValueError("segment out of range")
        if max_count is None:
            max_count = int(count)
        elif int(max_count) < int(count):
            raise ValueError("max_count is below the segment's count")
        seg_t = torch.tensor([int(begin), int(count)], dtype=torch.int32,
                             device=mat.device)
    else:
        _native.require(seg_t, device=mat.device, dtype=torch.int32,
                        shape=(2,), name="seg")
        if max_count is None:
            raise ValueError("a device segment needs max_count")
    lib = _native.library()
    nblk = child_chunks(int(max_count), num_features)
    out = torch.empty((num_features, num_bins, 3),
                      dtype=torch.float64 if float64 else torch.float32,
                      device=mat.device)
    partial = torch.empty((nblk, num_features, num_bins, 3),
                          dtype=torch.float64, device=mat.device) \
        if nblk > 1 else out
    err = lib.ltt_hist_segment(
        mat.data_ptr(), cols, payload_offset(num_features),
        seg_t.data_ptr(), num_features, num_bins, nblk,
        partial.data_ptr(), 0 if float64 else out.data_ptr(),
        out.data_ptr() if float64 else 0, _native.stream_of(mat))
    _native.LAUNCHES["hist_segment"] += 1
    _native.check(err, "hist_segment")
    return out


# ---- the row-list histogram (csrc/hist_ids.cuh) -----------------------

# The leaf layout's histogram tile and chunk rule, shared by the leaf
# fused step (csrc/split_step_leaf.cu) and the full-range histogram
# (csrc/hist_rows.cu): features go in tiles of ``leaf_feat_tile`` (the
# tile's bins and the staged rows fit LEAF_SMEM_BYTES, two blocks an
# SM), and a list of ``count`` rows is cut into contiguous chunks of
# about LEAF_CHUNK_ROWS rows, at most ``leaf_max_chunks`` of them
# (chunks x feature tiles <= LEAF_MAX_VBLOCKS; the leading dimension of
# the partial buffers).
LEAF_SMEM_BYTES = 110 * 1024
LEAF_STAGE_ROWS = 512        # csrc/hist_ids.cuh kStageRows
LEAF_MAX_TILE = 16           # csrc/hist_ids.cuh kMaxTile
LEAF_CHUNK_ROWS = 512        # csrc/hist_ids.cuh kChunkRows
LEAF_MAX_VBLOCKS = 256       # csrc/hist_ids.cuh kMaxVBlocks
LEAF_BIN_BYTES = 24          # csrc/hist_ids.cuh kBinBytes
LEAF_STAGE_ROW_BYTES = 8     # csrc/hist_ids.cuh kStageRowBytes


def leaf_feat_tile(num_features: int, num_bins: int,
                   bin_bytes: Optional[int] = None) -> int:
    """Features per histogram tile of the leaf layout (``bin_bytes``
    defaults to the narrowest type that holds ``num_bins``). The tile
    sets the chunk cap (``leaf_max_chunks``), and with it the order of
    every sum, so its rule is fixed: 24 bytes a bin, 12 bytes and the
    tile's bins a staged row, within LEAF_SMEM_BYTES. The kernel's tile
    (``leaf_tile_smem_bytes``) takes no more than that."""
    if bin_bytes is None:
        bin_bytes = 1 if num_bins <= 256 else 2
    fit = (LEAF_SMEM_BYTES - 12 * LEAF_STAGE_ROWS) \
        // (num_bins * 3 * 8 + LEAF_STAGE_ROWS * bin_bytes)
    return max(1, min(num_features, fit, LEAF_MAX_TILE))


def leaf_tile_smem_bytes(feat_tile: int, num_bins: int,
                         bin_bytes: int) -> int:
    """Shared bytes of one block's tile (``tile_smem_bytes``): the bins'
    (g, h) float64 pairs and (peer word, count) integer pairs, and one
    staged step: the rows' (g, h) float32 pairs, a word of count bits a
    32-row group, and the tile's bins."""
    return feat_tile * num_bins * LEAF_BIN_BYTES \
        + LEAF_STAGE_ROWS * LEAF_STAGE_ROW_BYTES + LEAF_STAGE_ROWS // 32 * 4 \
        + feat_tile * LEAF_STAGE_ROWS * bin_bytes


def leaf_max_chunks(num_features: int, feat_tile: int) -> int:
    """The most chunks of a row list (``max_chunks_of``)."""
    tiles = -(-num_features // feat_tile)
    return max(1, LEAF_MAX_VBLOCKS // tiles)


def leaf_child_chunks(count: int, num_features: int, feat_tile: int) -> int:
    """Chunks of a list of ``count`` rows (``child_chunks``): from the
    row count, the feature count and the tile alone."""
    return max(1, min(leaf_max_chunks(num_features, feat_tile),
                      -(-int(count) // LEAF_CHUNK_ROWS)))


# the most bins each width of the bin matrix holds (int16: the bits of
# u16 bins below 2**15, so every reader's value is the bin)
BIN_BYTES_MAX_BINS = {1: 256, 2: 32768, 4: 65536}


def leaf_bin_bytes(binned: torch.Tensor) -> int:
    """1 for u8 bins, 2 for u16 bins held as int16 bit patterns, 4 for
    int32 bins (more than 32,768 bins)."""
    if binned.dtype == torch.uint8:
        return 1
    if binned.dtype == torch.int16:
        return 2
    if binned.dtype == torch.int32:
        return 4
    raise TypeError(f"binned has dtype {binned.dtype}, expected uint8, "
                    "int16 (the bits of uint16 bins) or int32")


def rows_window(bin_bytes: int, num_bins: int, feat_tile: int) -> int:
    """The bins one block of the kernel takes (``ltt_hist_rows_window``):
    all of them while the tile fits a block's shared memory."""
    return int(_native.library().ltt_hist_rows_window(bin_bytes, num_bins,
                                                       feat_tile))


def rows_partial(binned: torch.Tensor, num_bins: int) -> torch.Tensor:
    """The kernel's float64 partials [leaf_max_chunks, F, B, 3] for a bin
    matrix, allocated once by a caller that launches many histograms."""
    f = binned.shape[1]
    tile = leaf_feat_tile(f, num_bins, leaf_bin_bytes(binned))
    return torch.empty((leaf_max_chunks(f, tile), f, num_bins, 3),
                       dtype=torch.float64, device=binned.device)


def histogram_rows_plain(binned: torch.Tensor, ghc: torch.Tensor,
                         num_bins: int,
                         ids: Optional[torch.Tensor] = None,
                         float64: bool = False) -> torch.Tensor:
    """Plain version: ``build_histogram`` of all rows, or of the rows
    ``ids`` (float64 sums rounded once; ``float64``: not rounded)."""
    if ids is not None:
        ids = ids.long()
        binned, ghc = binned.index_select(0, ids), ghc.index_select(0, ids)
    return build_histogram(binned, ghc, num_bins, float64=float64)


def histogram_rows(binned: torch.Tensor, ghc: torch.Tensor, num_bins: int,
                   ids: Optional[torch.Tensor] = None,
                   partial: Optional[torch.Tensor] = None,
                   times: Optional[torch.Tensor] = None,
                   float64: bool = False) -> torch.Tensor:
    """[F, B, 3] f32 histogram of all rows of ``binned`` [N, F] (uint8,
    B <= 256; the int16 bits of uint16 bins, B <= 32,768; int32, B <=
    65,536) with ``ghc`` [N, 3] f32, or of the rows ``ids`` (int32 in
    [0, N), in row order: the order fixes the sums' order, as in the
    fused step). On a CUDA
    tensor it launches ``csrc/hist_rows.cu``; ``partial`` is the float64
    scratch (``rows_partial``, or the leaf fused step's
    ``LeafScratch.partial``), allocated here when not given. On a CPU
    tensor it runs ``histogram_rows_plain``.

    The count channel of ``ghc`` must be a 0/1 indicator, as every
    caller makes it (``make_ghc``): the kernel counts the rows whose
    count is not 0, in integers, where the plain version sums the column
    in float64. On a 0/1 column the two are the same number.

    ``times`` (for ``chip_profile.py``; not counted in ``LAUNCHES``):
    int64 [blocks, 4] on the card, a row for each (chunk, feature tile)
    block of the launch; the launch goes through the kernel's timed
    instantiation, whose every block writes its cycles of first fetch,
    stores, accumulation and write-out there. ``float64`` returns the
    float64 sums unrounded (the data-parallel learners reduce them
    across ranks before their one rounding)."""
    dev = binned.device
    if dev.type == "cpu":
        return histogram_rows_plain(binned, ghc, num_bins, ids,
                                    float64=float64)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    bin_bytes = leaf_bin_bytes(binned)
    if not 1 <= num_bins <= BIN_BYTES_MAX_BINS[bin_bytes]:
        raise ValueError(f"num_bins {num_bins} out of range for "
                         f"{8 * bin_bytes}-bit bins")
    n, f = binned.shape
    req = _native.require
    req(binned, device=dev, dtype=binned.dtype, name="binned")
    req(ghc, device=dev, dtype=torch.float32, shape=(n, 3), name="ghc")
    if ids is None:
        count, ids_ptr = n, None
    else:
        req(ids, device=dev, dtype=torch.int32, name="ids")
        if ids.dim() != 1:
            raise ValueError("ids must be one-dimensional")
        # an empty list may have no storage: rows [0, 0) then
        count, ids_ptr = ids.numel(), ids.data_ptr() or None
    tile = leaf_feat_tile(f, num_bins, bin_bytes)
    max_chunks = leaf_max_chunks(f, tile)
    if partial is None:
        partial = rows_partial(binned, num_bins)
    req(partial, device=dev, dtype=torch.float64, name="partial")
    if tuple(partial.shape) != (max_chunks, f, num_bins, 3):
        raise ValueError("partial does not fit this histogram")
    out = torch.empty((f, num_bins, 3), dtype=torch.float32, device=dev)
    args = (bin_bytes, binned.data_ptr(), ghc.data_ptr(), ids_ptr, count, f,
            num_bins, tile, max_chunks, partial.data_ptr(), out.data_ptr())
    if times is not None:
        blocks = leaf_child_chunks(count, f, tile) * -(-f // tile) \
            * -(-num_bins // rows_window(bin_bytes, num_bins, tile))
        req(times, device=dev, dtype=torch.int64, shape=(blocks, 4),
            name="times")
        _native.check(_native.library().ltt_hist_rows_timed(
            *args, times.data_ptr(), _native.stream_of(binned)),
            "hist_rows (timed)")
        return out
    out64 = torch.empty((f, num_bins, 3), dtype=torch.float64,
                        device=dev) if float64 else None
    err = _native.library().ltt_hist_rows(
        *args, None if out64 is None else out64.data_ptr(),
        _native.stream_of(binned))
    _native.LAUNCHES["hist_rows"] += 1
    _native.check(err, "hist_rows")
    return out if out64 is None else out64


# ---- the model-batched root histograms -----------------------------------

def rows_partial_batched(binned: torch.Tensor, num_bins: int,
                         models: int) -> torch.Tensor:
    """The batched kernel's float64 partials [models, leaf_max_chunks, F,
    B, 3] (the model-batched leaf step takes the same buffer)."""
    f = binned.shape[1]
    tile = leaf_feat_tile(f, num_bins, leaf_bin_bytes(binned))
    return torch.empty((models, leaf_max_chunks(f, tile), f, num_bins, 3),
                       dtype=torch.float64, device=binned.device)


# The batched histogram's block (csrc/hist_rows.cu batched_shape): a
# block takes a sub-tile of features and a group of models of one chunk,
# walks its rows in steps of BATCHED_STEP_ROWS (one a thread) and holds,
# in shared memory: each model's double2 sums and missing counts a bin
# (20 B), each feature's row counts a bin (4 B), each warp's peer words
# (4 B a bin), each feature's leader slots (8 B a step row), each
# model's staged (g, h) (8 B a step row) and count words, and the staged
# bins; at most BATCHED_SMEM_BYTES (two blocks an H100 SM: 228 KB, 1 KB
# reserved a block).
BATCHED_STEP_ROWS = 256      # csrc/hist_rows.cu kBStep
BATCHED_MAX_MODELS = 8       # kBMaxModels
BATCHED_MAX_TILE = 8         # kBMaxTile
BATCHED_WARPS = 8            # kBWarps
BATCHED_SMEM_BYTES = 113 * 1024   # kBatchedSmem
BATCHED_MODEL_BIN_BYTES = 20      # kBModelBinBytes
BATCHED_FEATURE_BIN_BYTES = 4     # kBFeatureBinBytes
BATCHED_WARP_BIN_BYTES = 4        # kBWarpBinBytes
BATCHED_LEADER_BYTES = 8          # kBLeaderBytes
BATCHED_STAGE_ROW_BYTES = 8       # kBStageRowBytes


def rows_batched_smem(bin_bytes: int, num_bins: int, features: int,
                      models: int) -> int:
    """Shared bytes of a batched block of ``features`` x ``models``
    (``batched_smem``)."""
    groups = BATCHED_STEP_ROWS // 32
    return models * features * num_bins * BATCHED_MODEL_BIN_BYTES \
        + features * num_bins * BATCHED_FEATURE_BIN_BYTES \
        + BATCHED_WARPS * num_bins * BATCHED_WARP_BIN_BYTES \
        + features * BATCHED_STEP_ROWS * BATCHED_LEADER_BYTES \
        + models * (BATCHED_STEP_ROWS * BATCHED_STAGE_ROW_BYTES + groups * 4) \
        + features * BATCHED_STEP_ROWS * bin_bytes


def rows_batched_block(bin_bytes: int, num_bins: int, feat_tile: int,
                       models: int) -> tuple:
    """(features, models) of a batched block, the Python mirror of
    ``batched_shape``: the models spread evenly over the fewest groups
    of at most BATCHED_MAX_MODELS, then the widest sub-tile (at most the
    leaf tile and BATCHED_MAX_TILE) that fits BATCHED_SMEM_BYTES; more
    groups while not one feature fits. (1, 0) when nothing fits."""
    cap = min(feat_tile, BATCHED_MAX_TILE)
    groups = -(-models // BATCHED_MAX_MODELS)
    while True:
        mb = -(-models // groups)
        for ft in range(cap, 0, -1):
            if rows_batched_smem(bin_bytes, num_bins, ft, mb) \
                    <= BATCHED_SMEM_BYTES:
                return ft, mb
        if mb == 1:
            return 1, 0
        groups += 1


def rows_batched_shape(bin_bytes: int, num_bins: int, feat_tile: int,
                       models: int) -> dict:
    """The batched launch's blocks (``ltt_hist_rows_batched_shape``): the
    features and the models one block takes, and its shared bytes."""
    out = (ctypes.c_int * 3)()
    _native.check(_native.library().ltt_hist_rows_batched_shape(
        bin_bytes, num_bins, feat_tile, models, ctypes.addressof(out)),
        "hist_rows_batched")
    return dict(features=out[0], models=out[1], smem_bytes=out[2])


def rows_batched_blocks(n: int, num_features: int, num_bins: int,
                        bin_bytes: int, models: int) -> int:
    """Blocks of one batched launch: chunks x feature sub-tiles x model
    groups (the rows of its timed build's ``times``)."""
    tile = leaf_feat_tile(num_features, num_bins, bin_bytes)
    ft, mb = rows_batched_block(bin_bytes, num_bins, tile, models)
    return leaf_child_chunks(n, num_features, tile) \
        * -(-num_features // ft) * -(-models // mb)


# the timed build's laps a block (csrc/hist_rows.cu kBatchedLaps)
BATCHED_LAPS = ("first fetch", "stage", "peers", "adds", "write-out")


def histogram_rows_batched_plain(binned: torch.Tensor, ghc: torch.Tensor,
                                 num_bins: int) -> torch.Tensor:
    """Plain version: ``build_histogram`` of all rows for each model's
    ghc in turn, stacked [models, F, B, 3]."""
    return torch.stack([build_histogram(binned, g, num_bins) for g in ghc])


def histogram_rows_batched(binned: torch.Tensor, ghc: torch.Tensor,
                           num_bins: int,
                           partial: Optional[torch.Tensor] = None,
                           times: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """[models, F, B, 3] f32 histograms of all rows of ``binned`` [N, F]
    (uint8, B <= 256; the int16 bits of uint16 bins, B <= 1024: the leaf
    kernel's) for ``ghc`` [models, N, 3] f32, one launch for all models:
    the roots of a bucket of models (``learner/batched.py``). On a CUDA
    tensor it launches ``ltt_hist_rows_batched`` (``csrc/hist_rows.cu``),
    whose model m equals ``histogram_rows(binned, ghc[m], num_bins)`` bit
    for bit; ``partial`` is its float64 scratch (``rows_partial_batched``),
    allocated here when not given. On a CPU tensor it runs
    ``histogram_rows_batched_plain``. The count channel is a 0/1
    indicator, as for ``histogram_rows``. ``times`` (for
    ``chip_profile.py``; not counted in ``LAUNCHES``): int64 [blocks,
    5] on the card (``rows_batched_blocks``); the launch goes through
    the kernel's timed instantiation, whose every block writes its
    cycles of each of ``BATCHED_LAPS`` there."""
    dev = binned.device
    if dev.type == "cpu":
        return histogram_rows_batched_plain(binned, ghc, num_bins)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    bin_bytes = leaf_bin_bytes(binned)
    if bin_bytes == 4 or not 1 <= num_bins <= (256 if bin_bytes == 1
                                               else 1024):
        raise ValueError(f"num_bins {num_bins} out of range for the "
                         f"batched histogram of {8 * bin_bytes}-bit bins")
    n, f = binned.shape
    if ghc.dim() != 3:
        raise ValueError("ghc must be [models, N, 3]")
    models = ghc.shape[0]
    req = _native.require
    req(binned, device=dev, dtype=binned.dtype, name="binned")
    req(ghc, device=dev, dtype=torch.float32, shape=(models, n, 3),
        name="ghc")
    tile = leaf_feat_tile(f, num_bins, bin_bytes)
    max_chunks = leaf_max_chunks(f, tile)
    if partial is None:
        partial = rows_partial_batched(binned, num_bins, models)
    req(partial, device=dev, dtype=torch.float64, name="partial")
    if tuple(partial.shape[1:]) != (max_chunks, f, num_bins, 3) \
            or partial.shape[0] < models:
        raise ValueError("partial does not fit this histogram")
    out = torch.empty((models, f, num_bins, 3), dtype=torch.float32,
                      device=dev)
    args = (bin_bytes, binned.data_ptr(), ghc.data_ptr(), n, models, f,
            num_bins, tile, max_chunks, partial.data_ptr(), out.data_ptr())
    if times is not None:
        req(times, device=dev, dtype=torch.int64,
            shape=(rows_batched_blocks(n, f, num_bins, bin_bytes, models),
                   len(BATCHED_LAPS)), name="times")
        _native.check(_native.library().ltt_hist_rows_batched_timed(
            *args, times.data_ptr(), _native.stream_of(binned)),
            "hist_rows_batched (timed)")
        return out
    err = _native.library().ltt_hist_rows_batched(
        *args, _native.stream_of(binned))
    _native.LAUNCHES["hist_rows_batched"] += 1
    _native.check(err, "hist_rows_batched")
    return out


# ---- refit's per-leaf sums ----------------------------------------------

# trees whose per-leaf sums took each route (both devices): up to 65,536
# leaves (the kernel's widest bins) the hist_rows kernel (its plain
# version on the CPU or with ``plain``), past that a stable sort by leaf
# and float64 segment sums
LEAF_SUM_ROUTES = {"hist_rows": 0, "sorted": 0}


def leaf_histogram(leaf: torch.Tensor, ghc: torch.Tensor, num_leaves: int,
                   plain: bool = False) -> torch.Tensor:
    """[L, 3] float32 sums of ``ghc`` [N, 3] (grad, hess, a 0/1 count)
    by the rows' leaf ``leaf`` [N] (refit's per-leaf sums, JAX
    ``models/gbdt.py:_refit_tree``'s scatter): the histogram of a
    one-column bin matrix whose bin is the leaf, through
    ``histogram_rows`` (uint8 bins up to 256 leaves, the int16 bits of
    u16 bins up to 32,768, int32 up to 65,536), so one ``hist_rows``
    launch a tree on the card and float64 sums rounded once. ``plain``
    runs its plain version on any device. Past 65,536 leaves (wider
    than the kernel's bins) the rows are stably sorted by leaf and each
    leaf's rows summed in float64 in row order (``segment_reduce``), on
    every device alike."""
    if num_leaves > BIN_BYTES_MAX_BINS[4]:
        LEAF_SUM_ROUTES["sorted"] += 1
        lid = leaf.long()
        order = torch.argsort(lid, stable=True)
        counts = torch.bincount(lid, minlength=num_leaves)
        sums = torch.segment_reduce(ghc.double()[order], "sum",
                                    lengths=counts, unsafe=True)
        return sums.float()
    LEAF_SUM_ROUTES["hist_rows"] += 1
    bins = leaf.to(next(dt for dt, bb in ((torch.uint8, 1), (torch.int16, 2),
                                          (torch.int32, 4))
                        if num_leaves <= BIN_BYTES_MAX_BINS[bb]))
    bins = bins.reshape(-1, 1)
    if plain:
        return histogram_rows_plain(bins, ghc, num_leaves)[0]
    return histogram_rows(bins, ghc.contiguous(), num_leaves)[0]
