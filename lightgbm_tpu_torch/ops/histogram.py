"""Histogram construction over a whole binned matrix, in plain PyTorch
(port of ``lightgbm_tpu/ops/histogram.py``: ``make_ghc``,
``histogram_scatter`` as ``build_histogram``, ``fix_histogram``, and
the EFB helpers ``Debundler`` / ``debundle_hist`` / ``debundle_totals``
/ ``debundle_leaf_hists`` and the multi-val bin decoders; the multi-val histogram itself is
``ops/hist_multival_cuda.py``).

``build_histogram`` is the plain version of the serial learner's
histograms: the root over all rows, and per split the smaller child's
over masked ``ghc`` (rows outside the child carry zero ghc). The JAX
package reaches the same function through ``build_histogram`` as an XLA
scatter, a one-hot contraction, or with ``method="pallas"`` the Pallas
kernel ``histogram_pallas`` (``lightgbm_tpu/ops/hist_pallas.py:642``).
The port's kernel for it is ``hist_cuda.histogram_rows``
(``csrc/hist_rows.cu``), which the serial learner runs on the card and
holds against this function; the fused leaf step
(``csrc/split_step_leaf.cu``) builds its children's histograms itself,
in the same order.

Histogram layout: ``[F, B, 3]`` float32 with channels (sum_grad,
sum_hess, count). Sums accumulate in float64 and round once to float32
(as ``hist_cuda.histogram_segment_plain`` does), so a bin's value does
not depend on the order of its rows; the JAX package's CPU scatter sums
in float32, so the two differ by float32 rounding only. Rows with zero
ghc add exactly nothing, so a masked histogram equals the histogram of
the child's rows alone.
"""

from __future__ import annotations

from typing import Optional

import torch


def make_ghc(grad: torch.Tensor, hess: torch.Tensor,
             weight_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stack (grad, hess, count) channels [N, 3], optionally
    bagging-masked: the count channel is the selection indicator
    (weight > 0), not the weight (goss.hpp:92)."""
    if weight_mask is None:
        return torch.stack([grad, hess, torch.ones_like(grad)], dim=-1)
    return torch.stack([grad * weight_mask, hess * weight_mask,
                        (weight_mask > 0).to(grad.dtype)], dim=-1)


def build_histogram(binned: torch.Tensor, ghc: torch.Tensor,
                    num_bins: int, float64: bool = False) -> torch.Tensor:
    """Per-feature scatter histogram. ``binned`` [N, F] integer bins
    (uint8, the int16 bit pattern of uint16 bins below 2**15, or int32
    past 32,768 bins: every value is its bin), ``ghc`` [N, 3] -> [F, B,
    3] float32 (``float64``: the float64 sums, not rounded). The scatter
    is the port's one method: the JAX package's one-hot and Pallas
    methods are TPU formulations of the same function."""
    n, f = binned.shape
    vals = ghc.to(torch.float64)
    out = torch.zeros((f, num_bins, 3), dtype=torch.float64,
                      device=binned.device)
    for j in range(f):
        out[j].index_add_(0, binned[:, j].long(), vals)
    return out if float64 else out.float()


# ---- EFB: group histograms to feature histograms, multi-val bins -------

class Debundler:
    """EFB group histograms -> per-feature histograms (JAX
    ``debundle_hist``; the reference's ``FixHistogram``,
    dataset.cpp:1424-1442), for a dataset's fixed maps: the gather index
    and the bin mask are built once. A feature with offset o > 0 has its
    bins 1..nb-1 at group bins o..o+nb-2, and its bin 0 is the leaf's
    totals less those bins; offset 0 passes the group's histogram
    through. A feature's bins are summed in float64 (one ``sum`` over the
    bin axis, the same function wherever it runs) and bin 0 is rounded
    once from the float64 difference; the JAX package sums and subtracts
    in float32. One call debundles K leaves: four PyTorch ops whatever
    K."""

    def __init__(self, group, offset, num_bins, b: int, device):
        as_long = lambda t: torch.as_tensor(t).to(  # noqa: E731
            device=device, dtype=torch.int64)
        group, offset, num_bins = (as_long(t)
                                   for t in (group, offset, num_bins))
        bins = torch.arange(b, device=device)[None, :]
        bundled = offset[:, None] > 0
        src = torch.where(bundled, (offset[:, None] + bins - 1).clamp(
            0, b - 1), bins)
        self.index = (group[:, None] * b + src).reshape(-1)
        self.keep = (~bundled | ((bins >= 1) & (bins < num_bins[:, None])))
        self.bundled = bundled[:, 0]
        self.shape = (len(group), b)

    def __call__(self, hists: torch.Tensor,
                 totals: torch.Tensor) -> torch.Tensor:
        """``hists`` [K, G, B, 3] f32, ``totals`` [K, 3] float64 leaf
        (g, h, c) -> [K, F, B, 3] f32."""
        k, g, b, _ = hists.shape
        f = self.shape[0]
        x = hists.reshape(k, g * b, 3).index_select(1, self.index)
        x = torch.where(self.keep.reshape(1, f * b, 1), x,
                        torch.zeros((), dtype=x.dtype, device=x.device)
                        ).reshape(k, f, b, 3)
        bin0 = (totals[:, None, :] - x.double().sum(dim=2)).float()
        x[:, :, 0] = torch.where(self.bundled[None, :, None], bin0,
                                 x[:, :, 0])
        return x


def debundle_hist(hist_g: torch.Tensor, group: torch.Tensor,
                  offset: torch.Tensor, num_bins: torch.Tensor,
                  leaf_g, leaf_h, leaf_c) -> torch.Tensor:
    """One leaf's group histograms [G, B, 3] -> per-feature [F, B, 3]
    (``Debundler``, the maps taken as given)."""
    totals = torch.tensor([[float(leaf_g), float(leaf_h), float(leaf_c)]],
                          dtype=torch.float64, device=hist_g.device)
    return Debundler(group, offset, num_bins, hist_g.shape[1],
                     hist_g.device)(hist_g[None], totals)[0]


def debundle_totals(hists, leaves, local_hist: bool) -> torch.Tensor:
    """[K, 3] float64 leaf totals for the debundle's bin 0 (JAX
    ``debundle_totals``): rank-local histograms (``local_hist``, the
    voting learner's) take their own, group 0's bins summed (any group's
    bins sum to the rank's rows of the leaf); globally reduced ones the
    leaves' (g, h, c) host scalars."""
    if local_hist:
        return torch.stack([h[0].double().sum(dim=0) for h in hists])
    return torch.tensor([[float(v) for v in leaf[:3]] for leaf in leaves],
                        dtype=torch.float64, device=hists[0].device)


def debundle_leaf_hists(debundler: Debundler, hists, leaves,
                        local_hist: bool = False):
    """The scans' debundle of K leaves (1 or 2: the root, or a split's
    children), each from its own leaf totals (``debundle_totals``).
    ``leaves``: per leaf (g, h, c, ...) host scalars. Returns the K
    [F, B, 3] histograms."""
    totals = debundle_totals(hists, leaves, local_hist)
    return list(debundler(torch.stack(list(hists)), totals))


def fix_histogram(hist: torch.Tensor, parent_g, parent_h, parent_c,
                  most_freq_bins: torch.Tensor) -> torch.Tensor:
    """An elided most-frequent bin rebuilt from the leaf totals
    (``Dataset::FixHistogram``, dataset.cpp:1424-1442; JAX
    ``ops/histogram.py:197``, for a reduce that skips that bin): each
    feature's bin ``most_freq_bins[f]`` of ``hist`` [F, B, 3] gains the
    parent's (g, h, c) less the feature's bins, summed in float64 and
    rounded once."""
    f = hist.shape[0]
    parent = torch.tensor([float(parent_g), float(parent_h),
                           float(parent_c)], dtype=torch.float64,
                          device=hist.device)
    missing = parent[None, :] - hist.double().sum(dim=1)
    rows = torch.arange(f, device=hist.device)
    mfb = torch.as_tensor(most_freq_bins, device=hist.device).long()
    out = hist.clone()
    out[rows, mfb] = (hist[rows, mfb].double() + missing).to(hist.dtype)
    return out


def multival_feature_bins(slots: torch.Tensor, base,
                          nbins) -> torch.Tensor:
    """Per-row bins of ONE multi-val feature: the slot holding a value in
    [base, base + nbins - 1) decodes to bins 1.., every other row reads
    the default bin 0 (JAX ``multival_feature_bins``)."""
    inr = (slots >= base) & (slots < base + nbins - 1)
    return torch.where(inr, slots - base + 1,
                       torch.zeros_like(slots)).sum(dim=1)


def multival_node_bins(mv_slots: torch.Tensor, col: torch.Tensor,
                       offset: torch.Tensor, num_bin: torch.Tensor,
                       g_dense: int) -> torch.Tensor:
    """Per-row bins for per-row node vectors (the bin walks): each row's
    node's multi-val feature decoded from the slot matrix (JAX
    ``multival_node_bins``)."""
    from .hist_multival_cuda import MV_SLOT_STRIDE
    base = ((col - g_dense) * MV_SLOT_STRIDE + offset)[:, None]
    return multival_feature_bins(mv_slots, base, num_bin[:, None])
