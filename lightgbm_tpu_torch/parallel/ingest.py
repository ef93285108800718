"""Row ingest of the parallel learners: each rank holds its own row
block (port of ``lightgbm_tpu/parallel/ingest.py``; the reference's
``pre_partition`` and per-machine loading, ``dataset_loader.cpp``).

``host_row_range`` is the one definition of "which rows are mine" for a
rank that loads its own rows (``pre_partition=true``): contiguous blocks,
the remainder rows to the first ``num_rows % size`` ranks.
``shard_rows`` cuts a rank's block out of a matrix that every rank holds,
as the JAX package's ``shard_rows`` over a mesh does: the rows as if
padded to a multiple of the world size, equal blocks in rank order
(``shard_bounds``), without the padding rows, which would add nothing.
The feature-parallel learner holds every row (``Dataset.binned_device``,
the JAX ``replicate``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .distributed import current_world


def _rank_size(rank: Optional[int], size: Optional[int]) -> Tuple[int, int]:
    if rank is not None and size is not None:
        return int(rank), int(size)
    w = current_world()
    return (0, 1) if w is None else (w.rank, w.size)


def host_row_range(num_rows: int, rank: Optional[int] = None,
                   size: Optional[int] = None) -> Tuple[int, int]:
    """[start, stop) of rank ``rank``'s block of ``num_rows`` rows split
    evenly over ``size`` ranks (this process's place in the group by
    default), the remainder rows to the first ranks."""
    p, n = _rank_size(rank, size)
    base, rem = divmod(int(num_rows), n)
    start = p * base + min(p, rem)
    return start, start + base + (1 if p < rem else 0)


def padded_rows(num_rows: int, size: int) -> int:
    """``num_rows`` rounded up to a multiple of ``size``."""
    return -(-int(num_rows) // int(size)) * int(size)


def shard_bounds(num_rows: int, rank: int, size: int) -> Tuple[int, int]:
    """[start, stop) of rank ``rank``'s equal block of the padded rows
    (``padded_rows``), clipped to the real rows: a last rank's block may
    be shorter, or empty."""
    block = padded_rows(num_rows, size) // size
    start = min(rank * block, num_rows)
    return start, min(start + block, num_rows)


def shard_rows(arr, device, rank: Optional[int] = None,
               size: Optional[int] = None,
               num_bins: Optional[int] = None) -> torch.Tensor:
    """Rank ``rank``'s block (``shard_bounds``) of the rows of a host
    array ``arr`` that every rank holds, as a tensor on ``device``: only
    the block is uploaded. A uint16 bin matrix of ``num_bins`` bins (the
    widest column's; default: its largest value + 1) goes as the device
    copy of its bins does (``Dataset.binned_device``): int16 bits up to
    32,768 bins, int32 past, the same on every rank."""
    p, n = _rank_size(rank, size)
    arr = np.asarray(arr)
    lo, hi = shard_bounds(arr.shape[0], p, n)
    part = np.ascontiguousarray(arr[lo:hi])
    if part.dtype == np.uint16:
        if num_bins is None:
            num_bins = int(arr.max(initial=0)) + 1
        part = part.view(np.int16) if num_bins <= 32768 \
            else part.astype(np.int32)
    return torch.from_numpy(part).to(device)
