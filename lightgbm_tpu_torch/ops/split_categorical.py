"""Categorical best-split search over feature histograms, in PyTorch
(port of ``lightgbm_tpu/ops/split_categorical.py``; reference
``FeatureHistogram::FindBestThresholdCategoricalInner``,
feature_histogram.hpp:149-310).

Two regimes, chosen per feature:

  * **one-hot** (``num_bin <= max_cat_to_onehot``): each category alone
    on the left, every bin at once;
  * **many-vs-many**: the categories with at least ``cat_smooth`` rows,
    sorted (stably) by ``sum_grad / (sum_hess + cat_smooth)``, are taken
    onto the left from either end of the order, up to
    ``min(max_cat_threshold, (used + 1) // 2)`` of them, with
    ``min_data_per_group`` batching of the candidates and ``cat_l2`` added
    to the L2 term.

The JAX package runs the many-vs-many steps as a ``lax.scan``. Here the
work is vectorised over both children of a split, every feature and
both directions, in float32 in the JAX expression order, on the
histograms' device. Two Python loops of ``min(B, max_cat_threshold)``
steps remain. The first accumulates the left sums, one add per step, in
the scan's order. The second carries the group count, which resets
whenever a candidate is evaluated. The early stop (a right side too
small) is sticky, so it is found after the first loop: the left sums of
later steps are never read. There is no CUDA kernel behind this module:
the JAX function is XLA, not a TPU kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .split import (MAX_CAT_WORDS, MISSING_NONE_CODE, NEG_INF, SplitParams,
                    _f32, _split_gains, kEpsilon, leaf_output,
                    leaf_split_gain)


def _pack_bitset(bits: torch.Tensor) -> torch.Tensor:
    """[..., B] bool -> [..., MAX_CAT_WORDS] int64 words (bit b of word w
    = bin 32 w + b, each word < 2^32); bins at or above 256 are dropped,
    as ``_pack_bitset`` of the JAX package drops them."""
    total = MAX_CAT_WORDS * 32
    b = bits.shape[-1]
    if b < total:
        bits = torch.nn.functional.pad(bits, (0, total - b))
    else:
        bits = bits[..., :total]
    w = bits.reshape(*bits.shape[:-1], MAX_CAT_WORDS, 32).to(torch.int64)
    shift = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (w << shift).sum(dim=-1)


def _leaf_scalars(leaves: Sequence[tuple], dev) -> list:
    """Per-leaf (g, h, c, cmin, cmax) -> five float32 [K, 1, 1] tensors."""
    return [torch.stack([_f32(leaf[i], dev) for leaf in leaves])[:, None,
                                                                 None]
            for i in range(5)]


def per_feature_categorical(hists: Sequence[torch.Tensor],
                            leaves: Sequence[tuple], meta_t: dict,
                            params: SplitParams,
                            node_mask: Optional[torch.Tensor] = None
                            ) -> dict:
    """Best categorical split per feature of K leaves.

    ``hists``: K histograms [F, B, 3] (sum_grad, sum_hess, count);
    ``leaves``: per leaf ``(parent_g, parent_h, parent_c, cmin, cmax)``
    float32 scalars; ``meta_t`` from ``ops/split.py:meta_tensors``.
    Returns [K, F] tensors ``score`` (penalized gain above the shift,
    -inf where the feature is not categorical, not in the mask, wider
    than 256 bins or has no valid split), ``left_g``, ``left_h``
    (eps-free), ``left_h_eps`` (with its kEpsilon seed), ``left_c``,
    ``left_output``, ``right_output``, ``default_left`` (0.0) and
    ``bitset`` [K, F, MAX_CAT_WORDS] int64 (the left side's bins).
    ``node_mask`` [K, F] bool (by-node feature sampling) narrows the
    mask per leaf, as the JAX package's ``feature_mask`` argument does."""
    h3 = torch.stack(list(hists))                          # [K, F, B, 3]
    k, f, b, _ = h3.shape
    dev = h3.device
    p = params
    pg, ph, pc, cmin, cmax = _leaf_scalars(leaves, dev)    # [K, 1, 1]
    eps = _f32(kEpsilon, dev)
    min_data = _f32(p.min_data_in_leaf, dev)
    min_hess = _f32(p.min_sum_hessian_in_leaf, dev)
    g, h, c = h3[..., 0], h3[..., 1], h3[..., 2]            # [K, F, B]
    bins = torch.arange(b, device=dev)
    nb = meta_t["num_bins"].long()
    # the NaN bin (when present) is the last bin and never a category
    # (is_full_categorical, feature_histogram.hpp:161-162)
    used_bin = nb - (meta_t["missing"] != MISSING_NONE_CODE).long()
    in_range = bins[None, None, :] < used_bin[None, :, None]
    parent_h_eps = ph + _f32(2.0 * kEpsilon, dev)
    gain_shift = leaf_split_gain(pg, parent_h_eps, p.lambda_l1, p.lambda_l2,
                                 p.max_delta_step)
    min_gain_shift = gain_shift + _f32(p.min_gain_to_split, dev)
    zero_mono = torch.zeros((), dtype=torch.int32, device=dev)
    ninf = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    # ---------------- one-hot (feature_histogram.hpp:171-216) ----------
    oh_valid = in_range & (c >= min_data) & (h >= min_hess)
    other_c = pc - c
    other_h = parent_h_eps - h - eps
    other_g = pg - g
    oh_valid &= (other_c >= min_data) & (other_h >= min_hess)
    oh_gain = _split_gains(other_g, other_h, g, h + eps, p, zero_mono,
                           cmin, cmax)
    oh_score = torch.where(oh_valid & (oh_gain > min_gain_shift), oh_gain,
                           ninf)
    oh_t = torch.argmax(oh_score, dim=2, keepdim=True)     # first maximum
    oh_best = oh_score.gather(2, oh_t)[..., 0]
    oh_lg = g.gather(2, oh_t)[..., 0]
    oh_lh = h.gather(2, oh_t)[..., 0] + eps
    oh_lc = c.gather(2, oh_t)[..., 0]
    oh_bits = bins[None, None, :] == oh_t

    # -------------- many-vs-many (feature_histogram.hpp:217-299) -------
    l2m = p.lambda_l2 + p.cat_l2
    pm = p._replace(lambda_l2=l2m)
    ok = in_range & (c >= _f32(p.cat_smooth, dev))         # count filter
    used_f = ok.sum(dim=2)                                 # [K, F]
    ctr = torch.where(ok, g / (h + _f32(p.cat_smooth, dev)),
                      torch.full((), float("inf"), device=dev))
    order = torch.argsort(ctr, dim=2, stable=True)         # slot -> bin
    rank = torch.argsort(order, dim=2, stable=True)        # bin -> slot
    max_num_cat = torch.clamp((used_f + 1) // 2, max=p.max_cat_threshold)
    steps = min(b, max(int(p.max_cat_threshold), 1))
    s_idx = torch.arange(steps, device=dev)
    # slot of step s from either end of the order: [K, F, S, 2]
    slot = torch.stack([s_idx[None, None, :].expand(k, f, steps),
                        used_f[..., None] - 1 - s_idx], dim=-1)
    slot = torch.clamp(slot, 0, b - 1).reshape(k, f, 2 * steps)
    picked = torch.stack([torch.gather(x, 2, order).gather(2, slot)
                          for x in (g, h, c)])             # [3, K, F, 2S]
    picked = picked.reshape(3, k, f, steps, 2).permute(0, 3, 1, 2, 4)
    active0 = ((s_idx[:, None, None] < used_f[None])
               & (s_idx[:, None, None] < max_num_cat[None]))[..., None]
    picked = torch.where(active0, picked, zero)            # [3, S, K, F, 2]

    # the left sums, one float32 add a step in the scan's order
    acc = torch.stack([torch.zeros((k, f, 2), device=dev),
                       torch.zeros((k, f, 2), device=dev) + eps,
                       torch.zeros((k, f, 2), device=dev)])
    sums = []
    for s in range(steps):
        acc = acc + picked[:, s]
        sums.append(acc)
    lg, lh, lc = torch.stack(sums, dim=1)                  # [S, K, F, 2]
    pg4, pc4, phe4 = pg[None], pc[None], parent_h_eps[None]
    skip1 = (lc < min_data) | (lh < min_hess)
    rc = pc4 - lc
    rh = phe4 - lh
    rg = pg4 - lg
    brk = active0 & ~skip1 & (
        (rc < min_data) | (rc < _f32(p.min_data_per_group, dev))
        | (rh < min_hess))
    # the stop is sticky: a step after the first break is inactive
    stopped = (torch.cumsum(brk.to(torch.int32), dim=0)
               - brk.to(torch.int32)) > 0
    cond = active0 & ~stopped & ~skip1 & ~brk
    # group counts: a candidate is evaluated once its group holds
    # min_data_per_group rows, and the group restarts
    mdpg = _f32(p.min_data_per_group, dev)
    grp = torch.zeros((k, f, 2), device=dev)
    evs = []
    for s in range(steps):
        grp = grp + picked[2, s]
        ev = cond[s] & (grp >= mdpg)
        grp = grp.masked_fill(ev, 0.0)
        evs.append(ev)
    ev = torch.stack(evs)
    gains = _split_gains(lg, lh, rg, rh, pm, zero_mono, cmin[None],
                         cmax[None])
    cand = torch.where(ev & (gains > min_gain_shift[None]), gains, ninf)
    # the running best of the scan keeps the first step of the maximum
    bi = torch.argmax(cand, dim=0, keepdim=True)           # [1, K, F, 2]
    bg = cand.gather(0, bi)[0]
    found = torch.isfinite(bg)
    blg, blh, blc = (torch.where(found, x.gather(0, bi)[0], zero)
                     for x in (lg, lh, lc))
    bi = bi[0]
    best_dir = torch.argmax(bg, dim=2, keepdim=True)       # 0: +1, 1: -1
    mm_best = bg.gather(2, best_dir)[..., 0]
    mm_i = bi.gather(2, best_dir)                          # [K, F, 1]
    mm_lg = blg.gather(2, best_dir)[..., 0]
    mm_lh = blh.gather(2, best_dir)[..., 0]
    mm_lc = blc.gather(2, best_dir)[..., 0]
    used3 = used_f[..., None]
    mm_bits = torch.where(best_dir == 1,
                          (rank >= used3 - 1 - mm_i) & (rank < used3),
                          rank <= mm_i) & ok

    # ---------------- the regime per feature ---------------------------
    use_onehot = (nb <= p.max_cat_to_onehot)[None, :]
    best = torch.where(use_onehot, oh_best, mm_best)
    lg_f = torch.where(use_onehot, oh_lg, mm_lg)
    lh_f = torch.where(use_onehot, oh_lh, mm_lh)           # eps-included
    lc_f = torch.where(use_onehot, oh_lc, mm_lc)
    bits = torch.where(use_onehot[..., None], oh_bits, mm_bits)
    l2_f = torch.where(use_onehot, _f32(p.lambda_l2, dev), _f32(l2m, dev))
    valid = torch.isfinite(best) & meta_t["catmask"][None, :]
    if node_mask is not None:
        valid = valid & node_mask
    score = torch.where(valid, (best - min_gain_shift[..., 0])
                        * meta_t["penalty"][None, :], ninf)
    cmin2, cmax2 = cmin[..., 0], cmax[..., 0]
    wl = leaf_output(lg_f, lh_f, p.lambda_l1, l2_f, p.max_delta_step,
                     cmin2, cmax2)
    wr = leaf_output(pg[..., 0] - lg_f, parent_h_eps[..., 0] - lh_f,
                     p.lambda_l1, l2_f, p.max_delta_step, cmin2, cmax2)
    return dict(score=score, bitset=_pack_bitset(bits), left_g=lg_f,
                left_h=lh_f - eps, left_h_eps=lh_f, left_c=lc_f,
                left_output=wl, right_output=wr,
                default_left=torch.zeros_like(score))
