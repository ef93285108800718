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

The slots are static through training, so ``MultivalLayout`` compacts
them once (on their device): the pseudo-groups fall into windows of
``MV_WINDOW_GROUPS``; for each window and row, the row's real slots of
that window in slot order as window-local bins (int16), behind int64
offsets ``off[w * N + r]``; and each row's padding count ``npad``. The
padding is never read again: bin (0, 0) takes ``npad[r] * ghc[r]``.

On a CUDA layout ``hist_multival`` launches ``csrc/hist_multival.cu``
(one launch, plus the reduce of the chunks' partials); on a CPU layout it
runs ``hist_multival_plain``. Both follow the port's sum rule: the list
is cut into chunks from the row count and G_mv alone (``child_chunks``,
the constants mirrored from the kernel), each chunk summed in float64,
the partials summed in chunk order and rounded once to float32. With
``float64=True`` both return that chunk-ordered float64 sum unrounded
(the data-parallel learners' route: their all-reduce rounds it once,
``learner/comm.py:reduce_hist``); the kernel then writes every chunk's
partial, the one-chunk case too, and its reduce writes float64. The
count channel of ``ghc`` must be a 0/1 indicator (``make_ghc``).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _native

MV_SLOT_STRIDE = 256           # data/bundling.py MV_SLOT_STRIDE
MV_WINDOW_GROUPS = 16          # csrc/hist_multival.cu kWindowGroups
MV_CHUNK_ROWS = 2048           # kChunkRows
MV_MAX_VBLOCKS = 512           # kMaxVBlocks


def windows(g_mv: int) -> int:
    """Windows of pseudo-groups (a block's float64 bins in shared
    memory)."""
    return -(-int(g_mv) // MV_WINDOW_GROUPS)


def max_chunks(g_mv: int) -> int:
    """The most chunks of a row list: the partials' leading dimension."""
    return max(1, MV_MAX_VBLOCKS // windows(g_mv))


def child_chunks(count: int, g_mv: int) -> int:
    """Chunks of a list of ``count`` rows (at least ``MV_CHUNK_ROWS``
    rows a chunk, at most ``max_chunks``): from the count and G_mv
    alone."""
    return max(1, min(max_chunks(g_mv), -(-int(count) // MV_CHUNK_ROWS)))


class MultivalLayout:
    """The slot matrix ``slots`` [N, K] int32 of ``g_mv`` pseudo-groups,
    compacted on its device: ``ent`` int16 [E] (the real slots: window by
    window, row by row, slot order; the window-local bin ``(p - w *
    MV_WINDOW_GROUPS) * 256 + value % 256``), ``off`` int64 [windows * N
    + 1] (row r's entries of window w are ``ent[off[w * N + r]:off[w * N
    + r + 1]]``) and ``npad`` int32 [N] (the row's padding slots)."""

    def __init__(self, slots: torch.Tensor, g_mv: int):
        if slots.dim() != 2 or slots.dtype != torch.int32:
            raise ValueError("slots must be an [N, K] int32 matrix")
        self.n, self.k = slots.shape
        self.g_mv = int(g_mv)
        self.windows = windows(g_mv)
        self.device = slots.device
        real = slots != 0
        self.npad = (self.k - real.sum(1)).to(torch.int32)
        group = slots >> 8
        win = torch.where(real, group // MV_WINDOW_GROUPS,
                          torch.full_like(slots, -1))
        local = ((group % MV_WINDOW_GROUPS) << 8) | (slots & 255)
        counts, ents = [], []
        for w in range(self.windows):
            in_w = win == w
            counts.append(in_w.sum(1))
            ents.append(local[in_w])
        self.off = torch.zeros(self.windows * self.n + 1, dtype=torch.int64,
                               device=self.device)
        if self.n:
            torch.cumsum(torch.cat(counts), 0, out=self.off[1:])
        self.ent = torch.cat(ents).to(torch.int16) if ents else \
            torch.zeros(0, dtype=torch.int16, device=self.device)

    def rows_entries(self, rows: torch.Tensor):
        """(the entries of ``rows`` as flat values ``p * 256 + bin``, the
        row of each entry): window by window, then row by row, then slot
        order."""
        w = torch.arange(self.windows, device=rows.device)
        at = (w[:, None] * self.n + rows[None, :]).reshape(-1)
        base = self.off[at]
        lens = self.off[at + 1] - base
        starts = torch.cumsum(lens, 0) - lens
        pos = torch.arange(int(lens.sum()), device=rows.device)
        pos = pos - torch.repeat_interleave(starts, lens) \
            + torch.repeat_interleave(base, lens)
        span = MV_WINDOW_GROUPS * MV_SLOT_STRIDE
        win = torch.repeat_interleave(w.repeat_interleave(len(rows)), lens)
        return (self.ent[pos].long() + win * span,
                torch.repeat_interleave(rows.repeat(self.windows), lens))


def multival_partial(g_mv: int, num_bins: int, device) -> torch.Tensor:
    """The kernel's float64 partials [max_chunks, G_mv, min(B, 256), 3],
    allocated once by a caller that launches many histograms."""
    return torch.empty((max_chunks(g_mv), g_mv,
                        min(int(num_bins), MV_SLOT_STRIDE), 3),
                       dtype=torch.float64, device=device)


def hist_multival_plain(layout: MultivalLayout, ghc: torch.Tensor,
                        num_bins: int,
                        ids: Optional[torch.Tensor] = None,
                        float64: bool = False) -> torch.Tensor:
    """Plain version: the same chunks of the list, each a float64
    ``index_add_`` of its rows' real entries plus ``npad * ghc`` into bin
    (0, 0), the partials summed in chunk order and rounded once (with
    ``float64``, returned unrounded)."""
    dev, g_mv = layout.device, layout.g_mv
    rows = torch.arange(layout.n, device=dev) if ids is None \
        else ids.to(device=dev, dtype=torch.int64)
    count = rows.numel()
    chunks = child_chunks(count, g_mv)
    size = -(-count // chunks) if count else 0
    total = torch.zeros((g_mv * MV_SLOT_STRIDE, 3), dtype=torch.float64,
                        device=dev)
    vals = ghc.to(torch.float64)
    npad = layout.npad.to(torch.float64)
    for c in range(chunks):
        part_rows = rows[min(count, c * size):min(count, (c + 1) * size)]
        part = torch.zeros_like(total)
        flat, of = layout.rows_entries(part_rows)
        part.index_add_(0, flat, vals.index_select(0, of))
        part[0] += (npad[part_rows, None] * vals[part_rows]).sum(0)
        total += part
    hist = (total if float64 else total.float()).reshape(
        g_mv, MV_SLOT_STRIDE, 3)
    if num_bins <= MV_SLOT_STRIDE:
        return hist[:, :num_bins].contiguous()
    return torch.nn.functional.pad(hist,
                                   (0, 0, 0, num_bins - MV_SLOT_STRIDE))


def hist_multival(layout: MultivalLayout, ghc: torch.Tensor, num_bins: int,
                  ids: Optional[torch.Tensor] = None,
                  partial: Optional[torch.Tensor] = None,
                  times: Optional[torch.Tensor] = None,
                  float64: bool = False) -> torch.Tensor:
    """[G_mv, B, 3] f32 histogram of the multi-val pseudo-groups of
    ``layout`` with ``ghc`` [N, 3] f32, over all rows or the rows ``ids``
    (int32, distinct, in row order); with ``float64`` its float64 sums,
    unrounded (the kernel's ``out64``). On a CUDA layout it launches
    ``csrc/hist_multival.cu`` (``partial``, the float64 scratch from
    ``multival_partial``, is allocated here when not given); on a CPU
    layout it runs ``hist_multival_plain``.

    ``times`` (for ``chip_profile.py``; not counted in ``LAUNCHES``):
    int64 [blocks, 5] on the card, a row for each (chunk, window) block;
    the launch goes through the kernel's timed instantiation, whose every
    block writes its cycles of staging, the passes' loads and sorts, the
    accumulation and the write-out, and its entries there."""
    dev = layout.device
    if dev.type == "cpu":
        return hist_multival_plain(layout, ghc, num_bins, ids, float64)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    g_mv, n = layout.g_mv, layout.n
    if num_bins < 1:
        raise ValueError(f"need num_bins >= 1, got {num_bins}")
    req = _native.require
    req(ghc, device=dev, dtype=torch.float32, shape=(n, 3), name="ghc")
    if ids is None:
        count, ids_ptr = n, None
    else:
        req(ids, device=dev, dtype=torch.int32, name="ids")
        if ids.dim() != 1:
            raise ValueError("ids must be one-dimensional")
        count, ids_ptr = ids.numel(), ids.data_ptr() or None
    if partial is None:
        partial = multival_partial(g_mv, num_bins, dev)
    req(partial, device=dev, dtype=torch.float64,
        shape=(max_chunks(g_mv), g_mv, min(num_bins, MV_SLOT_STRIDE), 3),
        name="partial")
    out = torch.empty((g_mv, num_bins, 3), device=dev,
                      dtype=torch.float64 if float64 else torch.float32)
    if times is not None:
        blocks = child_chunks(count, g_mv) * layout.windows
        req(times, device=dev, dtype=torch.int64, shape=(blocks, 5),
            name="times")
    err = _native.library().ltt_hist_multival(
        layout.ent.data_ptr() or None, layout.off.data_ptr(), n,
        layout.npad.data_ptr() or None, ghc.data_ptr(), ids_ptr, count,
        g_mv, num_bins, max_chunks(g_mv), partial.data_ptr(),
        None if float64 else out.data_ptr(),
        out.data_ptr() if float64 else None,
        None if times is None else times.data_ptr(),
        _native.stream_of(ghc))
    if times is None:
        _native.LAUNCHES["hist_multival"] += 1
    _native.check(err, "hist_multival")
    return out
