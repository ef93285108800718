"""Histogram construction over a whole binned matrix, in plain PyTorch
(port of ``lightgbm_tpu/ops/histogram.py``: ``make_ghc``, and
``histogram_scatter`` as ``build_histogram``).

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
                    num_bins: int) -> torch.Tensor:
    """Per-feature scatter histogram. ``binned`` [N, F] integer bins
    (uint8, or the int16 bit pattern of uint16 bins; every bin is below
    2**15), ``ghc`` [N, 3] -> [F, B, 3] float32. The scatter is the
    port's one method: the JAX package's one-hot and Pallas methods are
    TPU formulations of the same function."""
    n, f = binned.shape
    vals = ghc.to(torch.float64)
    out = torch.zeros((f, num_bins, 3), dtype=torch.float64,
                      device=binned.device)
    for j in range(f):
        out[j].index_add_(0, binned[:, j].long(), vals)
    return out.float()
