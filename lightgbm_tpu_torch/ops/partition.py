"""Bin-space split decision and the leaf_id update (port of
``lightgbm_tpu/ops/partition.py``).

``rows_go_left`` is the one decision rule the partition kernel
(``csrc/partition_segment.cu``, ``go_left``), the leaf fused step
(``csrc/split_step_leaf.cu``) and their plain versions follow; the
reference analog is the bin-space decision of ``Dense/SparseBin::Split``
(dense_bin.hpp:132+). ``split_leaf`` applies it to the serial learner's
``leaf_id`` vector.
"""

from __future__ import annotations

import numpy as np
import torch

from .split import MAX_CAT_WORDS, MISSING_NAN_CODE, MISSING_ZERO_CODE


def rows_go_left(bin_col: torch.Tensor, threshold, default_left,
                 missing_code, default_bin, num_bin, is_cat=False,
                 cat_bitset=None) -> torch.Tensor:
    """Decide left/right per row in BIN space.

    Missing rows (the default bin under Zero-missing, the last bin under
    NaN-missing) follow ``default_left``; others compare
    ``bin <= threshold``. Categorical splits test membership of the bin
    in ``cat_bitset`` ([MAX_CAT_WORDS] uint32 words, a host array, left
    = member); a bin at or above 256 goes right."""
    b = bin_col.to(torch.int64)
    if missing_code == MISSING_ZERO_CODE:
        is_missing = b == int(default_bin)
    elif missing_code == MISSING_NAN_CODE:
        is_missing = b == int(num_bin) - 1
    else:
        is_missing = torch.zeros_like(b, dtype=torch.bool)
    numeric_left = torch.where(is_missing, bool(default_left),
                               b <= int(threshold))
    if not is_cat:
        return numeric_left
    words = torch.as_tensor(np.asarray(cat_bitset, np.uint32).astype(
        np.int64), device=b.device)
    word = torch.clamp(b // 32, 0, MAX_CAT_WORDS - 1)
    bit = (words[word] >> (b % 32)) & 1
    return (bit == 1) & (b < 32 * MAX_CAT_WORDS)


def split_leaf(leaf_id: torch.Tensor, bin_col: torch.Tensor, target_leaf,
               new_leaf, threshold, default_left, missing_code, default_bin,
               num_bin, is_cat=False, cat_bitset=None) -> torch.Tensor:
    """Send the right-side rows of ``target_leaf`` to ``new_leaf``
    (DataPartition::Split on the ``leaf_id[N]`` layout); returns the new
    ``leaf_id``, as the JAX function does."""
    in_leaf = leaf_id == int(target_leaf)
    go_left = rows_go_left(bin_col, threshold, default_left, missing_code,
                           default_bin, num_bin, is_cat, cat_bitset)
    return torch.where(in_leaf & ~go_left,
                       torch.full_like(leaf_id, int(new_leaf)), leaf_id)
