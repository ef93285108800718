"""The multi-val histogram (the port of the JAX package's XLA scatter
``lightgbm_tpu/ops/histogram.py:103 multival_hist``; no Pallas kernel).

An EFB dataset whose sparse features overflow the shared-column budget
keeps them in multi-val pseudo-groups with no column of the bin matrix:
each row's values ride the ``[N, K]`` int32 slot matrix
(``data/bundling.py:build_mv_slots``, value ``p * 256 + offset + bin -
1`` of pseudo-group ``p``, 0-padded). ``hist_multival`` is their
``[G_mv, B, 3]`` (sum grad, sum hess, count) histogram over all rows or
over a list of row ids in row order: every slot adds its row's ghc to
bin ``(p, value % 256)``, the padding (value 0) too, into pseudo-group 0,
bin 0, which the debundle never reads, as in the JAX function. The flat
``[G_mv, 256, 3]`` space is cut or zero-padded to ``B`` bins.

On a CUDA tensor it launches ``csrc/hist_multival.cu`` (one launch, plus
the reduce of the chunks' partials); on a CPU tensor it runs
``hist_multival_plain``. Both follow the port's sum rule: the rows are
cut into chunks from the row count, K and G_mv alone (``child_chunks``,
the constants mirrored from the kernel), each chunk summed in float64,
the partials summed in chunk order and rounded once to float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _native

MV_SLOT_STRIDE = 256           # data/bundling.py MV_SLOT_STRIDE
MV_CHUNK_SLOTS = 1 << 17       # csrc/hist_multival.cu kChunkSlots
MV_CHUNK_ROWS = (32, 4096)     # kMinChunkRows, kMaxChunkRows
MV_MAX_VBLOCKS = 1024          # kMaxVBlocks
MV_SMEM_BUDGET = 200 * 1024    # kSmemBudget
MV_TILE_BYTES = 32 * 129 * 4 + 32 * 3 * 4   # kTileBytes
MV_GROUP_BYTES = MV_SLOT_STRIDE * 3 * 8     # kGroupBytes


def window_groups(g_mv: int) -> int:
    """Pseudo-groups one block holds (their float64 bins in shared
    memory)."""
    return min((MV_SMEM_BUDGET - MV_TILE_BYTES) // MV_GROUP_BYTES, g_mv)


def max_chunks(g_mv: int) -> int:
    """The most chunks of a row list: the partials' leading dimension."""
    w = window_groups(g_mv)
    return max(1, MV_MAX_VBLOCKS // -(-g_mv // w))


def chunk_rows(k: int) -> int:
    """Rows a chunk: about ``MV_CHUNK_SLOTS`` slots, 32 to 4096 rows."""
    lo, hi = MV_CHUNK_ROWS
    return min(hi, max(lo, MV_CHUNK_SLOTS // int(k)))


def child_chunks(count: int, k: int, g_mv: int) -> int:
    """Chunks of a list of ``count`` rows of ``k`` slots (``chunk_rows``
    rows a chunk, at most ``max_chunks``): from the count, K and G_mv
    alone."""
    return max(1, min(max_chunks(g_mv), -(-int(count) // chunk_rows(k))))


def multival_partial(g_mv: int, device) -> torch.Tensor:
    """The kernel's float64 partials [max_chunks, G_mv, 256, 3], allocated
    once by a caller that launches many histograms."""
    return torch.empty((max_chunks(g_mv), g_mv, MV_SLOT_STRIDE, 3),
                       dtype=torch.float64, device=device)


def hist_multival_plain(slots: torch.Tensor, ghc: torch.Tensor, g_mv: int,
                        num_bins: int,
                        ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: the same chunks, each a float64 ``index_add_`` over
    the flattened (row, slot) entries, the partials summed in chunk order
    and rounded once."""
    if ids is not None:
        ids = ids.long()
        slots, ghc = slots.index_select(0, ids), ghc.index_select(0, ids)
    n, k = slots.shape
    chunks = child_chunks(n, k, g_mv)
    size = -(-n // chunks) if n else 0
    total = torch.zeros((g_mv * MV_SLOT_STRIDE, 3), dtype=torch.float64,
                        device=slots.device)
    vals = ghc.to(torch.float64)
    for c in range(chunks):
        r0, r1 = min(n, c * size), min(n, (c + 1) * size)
        part = torch.zeros_like(total)
        part.index_add_(0, slots[r0:r1].reshape(-1).long(),
                        vals[r0:r1, None, :].expand(r1 - r0, k, 3)
                        .reshape(-1, 3))
        total += part
    hist = total.float().reshape(g_mv, MV_SLOT_STRIDE, 3)
    if num_bins <= MV_SLOT_STRIDE:
        return hist[:, :num_bins].contiguous()
    return torch.nn.functional.pad(hist,
                                   (0, 0, 0, num_bins - MV_SLOT_STRIDE))


def hist_multival(slots: torch.Tensor, ghc: torch.Tensor, g_mv: int,
                  num_bins: int, ids: Optional[torch.Tensor] = None,
                  partial: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[G_mv, B, 3] f32 histogram of the multi-val pseudo-groups:
    ``slots`` [N, K] int32, ``ghc`` [N, 3] f32, over all rows or the rows
    ``ids`` (int32, in row order). On a CUDA tensor it launches
    ``csrc/hist_multival.cu`` (``partial``, the float64 scratch from
    ``multival_partial``, is allocated here when not given); on a CPU
    tensor it runs ``hist_multival_plain``."""
    dev = slots.device
    if dev.type == "cpu":
        return hist_multival_plain(slots, ghc, g_mv, num_bins, ids)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if g_mv < 1 or num_bins < 1:
        raise ValueError(f"need g_mv >= 1 and num_bins >= 1, got {g_mv}, "
                         f"{num_bins}")
    n, k = slots.shape
    req = _native.require
    req(slots, device=dev, dtype=torch.int32, name="slots")
    req(ghc, device=dev, dtype=torch.float32, shape=(n, 3), name="ghc")
    if ids is None:
        count, ids_ptr = n, None
    else:
        req(ids, device=dev, dtype=torch.int32, name="ids")
        if ids.dim() != 1:
            raise ValueError("ids must be one-dimensional")
        count, ids_ptr = ids.numel(), ids.data_ptr() or None
    if partial is None:
        partial = multival_partial(g_mv, dev)
    req(partial, device=dev, dtype=torch.float64,
        shape=(max_chunks(g_mv), g_mv, MV_SLOT_STRIDE, 3), name="partial")
    out = torch.empty((g_mv, num_bins, 3), dtype=torch.float32, device=dev)
    err = _native.library().ltt_hist_multival(
        slots.data_ptr(), k, ghc.data_ptr(), ids_ptr, count, g_mv, num_bins,
        max_chunks(g_mv), partial.data_ptr(), out.data_ptr(),
        _native.stream_of(slots))
    _native.LAUNCHES["hist_multival"] += 1
    _native.check(err, "hist_multival")
    return out
