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
"""

from __future__ import annotations

import torch

from . import _native

GH_COLS = 13       # payload columns after the (aligned) features
G_OFF, H_OFF, CNT_OFF, RID_OFF = 0, 4, 8, 9
VARIANTS = ("grouped", "perfeat", "perbin")

# histogram launch shape: each block takes a contiguous chunk of at
# least ROWS_PER_BLOCK rows; at most MAX_BLOCKS chunks (2 blocks of
# ~90 KB shared memory fit one H100 SM, 132 SMs)
ROWS_PER_BLOCK = 4096
MAX_BLOCKS = 264
SMEM_BYTES = 232448          # dynamic shared memory a block may use
TILE_ROWS = 256              # must match kTileRows in hist_segment.cu


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
                            absolute: bool = False) -> torch.Tensor:
    """Plain version: [F, B, 3] histogram of rows [begin, begin+count),
    accumulated in float64 and rounded once to float32.
    ``absolute`` sums |grad|, |hess| instead (the tolerance scale the
    checks use)."""
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
    return out.float()


def _launch_shape(max_count: int, num_features: int, num_bins: int):
    nblk = max(1, min(MAX_BLOCKS, -(-max_count // ROWS_PER_BLOCK)))
    feat_tile = min(num_features,
                    (SMEM_BYTES - 3 * TILE_ROWS * 4) // (num_bins * 12))
    return nblk, feat_tile


def histogram_segment(mat: torch.Tensor, begin, count, num_bins: int,
                      num_features: int, variant: str | None = None,
                      max_count: int | None = None) -> torch.Tensor:
    """Histogram of rows [begin, begin+count) -> [F, B, 3] f32.

    ``begin``/``count`` are ints, or ``begin`` is a device int32 [2]
    tensor (begin, count) — a segment the partition kernel produced —
    with ``count=None`` and ``max_count`` an upper bound on its size
    known to the host (the launch shape depends on it, so a split never
    waits for the device to learn a child's size). With int bounds,
    ``max_count`` (default ``count``) sets the launch shape the same way,
    so a child's histogram sized by its parent sums in the same order
    whichever form its segment came in. ``variant`` accepts
    the JAX package's names; all are the same function here."""
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"unknown histogram variant {variant!r}")
    seg_t = begin if isinstance(begin, torch.Tensor) else None
    if mat.device.type == "cpu":
        if seg_t is not None:
            begin, count = (int(v) for v in seg_t.tolist())
        return histogram_segment_plain(mat, int(begin), int(count),
                                       num_bins, num_features)
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
    nblk, feat_tile = _launch_shape(int(max_count), num_features, num_bins)
    out = torch.empty((num_features, num_bins, 3), dtype=torch.float32,
                      device=mat.device)
    partial = torch.empty((nblk, num_features, num_bins, 3),
                          dtype=torch.float32, device=mat.device) \
        if nblk > 1 else out
    err = lib.ltt_hist_segment(
        mat.data_ptr(), cols, payload_offset(num_features),
        seg_t.data_ptr(), num_features, num_bins, nblk, feat_tile,
        partial.data_ptr(), out.data_ptr(), _native.stream_of(mat))
    _native.LAUNCHES["hist_segment"] += 1
    _native.check(err, "hist_segment")
    return out
