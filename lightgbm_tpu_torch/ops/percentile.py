"""(Weighted) percentiles and the per-leaf leaf-output refit (port of
``lightgbm_tpu/ops/percentile.py``; reference ``PercentileFun`` /
``WeightedPercentileFun``, src/objective/regression_objective.hpp:18-89,
and ``SerialTreeLearner::RenewTreeOutput``,
serial_tree_learner.cpp:720-758).

``percentile_host`` is the JAX package's numpy function, kept for
``boost_from_score``. ``renew_leaf_outputs`` refits every leaf at once
on the residuals' device, with no loop over leaves: the rows are sorted
once by (leaf, residual), each leaf's rows are then a segment of the
sorted order, and each leaf's percentile is read at its segment's
offsets by the exact rules of ``percentile_host``:

- unweighted: descending order, ``pos = int((1 - alpha) * cnt)``, then
  ``v1 - (v1 - v2) * bias`` in float64, the same value picks and the
  same operations as numpy, so the results are equal to the bit;
- weighted: ascending stable order (ties in row order, as numpy's
  stable argsort of a leaf's rows), cumulative weights in float64 and
  the first position whose cumulative weight exceeds
  ``total * alpha``. A leaf's cumulative weights are differences of one
  cumulative sum over all sorted rows, which associate otherwise than
  numpy's per-leaf ``cumsum``: they agree to ~1e-12 relative, not to
  the bit.
"""

from __future__ import annotations

import numpy as np
import torch


def percentile_host(data: np.ndarray, weights, alpha: float) -> float:
    """Exact reference semantics on the host (boost_from_score)."""
    data = np.asarray(data, np.float64)
    cnt = len(data)
    if cnt == 0:
        return 0.0
    if cnt <= 1:
        return float(data[0])
    if weights is None:
        # PercentileFun (regression_objective.hpp:18-48): descending order
        desc = np.sort(data)[::-1]
        float_pos = (1.0 - alpha) * cnt
        pos = int(float_pos)
        if pos < 1:
            return float(desc[0])
        if pos >= cnt:
            return float(desc[-1])
        bias = float_pos - pos
        v1, v2 = float(desc[pos - 1]), float(desc[pos])
        return v1 - (v1 - v2) * bias
    # WeightedPercentileFun (regression_objective.hpp:50-89)
    weights = np.asarray(weights, np.float64)
    order = np.argsort(data, kind="stable")
    sdata = data[order]
    cdf = np.cumsum(weights[order])
    threshold = cdf[-1] * alpha
    pos = int(np.searchsorted(cdf, threshold, side="right"))
    pos = min(pos, cnt - 1)
    if pos == 0 or pos == cnt - 1:
        return float(sdata[pos])
    v1, v2 = float(sdata[pos - 1]), float(sdata[pos])
    if cdf[pos + 1] - cdf[pos] >= 1.0:
        return (threshold - cdf[pos]) / (cdf[pos + 1] - cdf[pos]) \
            * (v2 - v1) + v1
    return v2


def _leaf_order(residual: torch.Tensor, leaf_id: torch.Tensor,
                descending: bool) -> torch.Tensor:
    """Row order sorted by leaf, then by residual (stable: ties keep
    row order)."""
    by_value = torch.sort(residual, descending=descending, stable=True)[1]
    by_leaf = torch.sort(leaf_id[by_value], stable=True)[1]
    return by_value[by_leaf]


def renew_leaf_outputs(residual: torch.Tensor, leaf_id: torch.Tensor,
                       num_leaves: int, weights, alpha: float
                       ) -> torch.Tensor:
    """Each leaf's (weighted) ``alpha`` percentile of its rows'
    residuals: float64 [num_leaves] on the residuals' device, 0 for a
    leaf without rows. ``residual`` [N] float64, ``leaf_id`` [N]
    integer, ``weights`` None or [N]."""
    dev = residual.device
    leaf_id = leaf_id.to(torch.int64)
    cnt = torch.bincount(leaf_id, minlength=num_leaves)[:num_leaves]
    start = torch.cumsum(cnt, 0) - cnt
    last = torch.clamp(start + cnt - 1, min=0)
    if weights is None:
        desc = residual[_leaf_order(residual, leaf_id, True)]
        float_pos = (1.0 - alpha) * cnt.to(torch.float64)
        pos = torch.floor(float_pos).to(torch.int64)
        bias = float_pos - pos.to(torch.float64)
        v1 = desc[torch.clamp(start + pos - 1, 0, max(len(desc) - 1, 0))]
        v2 = desc[torch.clamp(start + pos, 0, max(len(desc) - 1, 0))]
        out = v1 - (v1 - v2) * bias
        out = torch.where(pos < 1, desc[start.clamp(max=len(desc) - 1)], out)
        out = torch.where(pos >= cnt, desc[last], out)
    else:
        order = _leaf_order(residual, leaf_id, False)
        sdata = residual[order]
        w = torch.as_tensor(weights, device=dev).to(torch.float64)[order]
        csum = torch.cumsum(w, 0)
        # a leaf's cumulative weights: csum minus the sum before it
        before = torch.where(start > 0, csum[(start - 1).clamp(min=0)],
                             torch.zeros((), dtype=torch.float64,
                                         device=dev))
        leaf_sorted = leaf_id[order]
        cdf = csum - before[leaf_sorted]
        threshold = cdf[last] * alpha
        # searchsorted(cdf, threshold, side="right") within each leaf:
        # how many of its cumulative weights are <= threshold
        pos = torch.bincount(leaf_sorted[cdf <= threshold[leaf_sorted]],
                             minlength=num_leaves)[:num_leaves]
        pos = torch.minimum(pos, cnt - 1)
        n = len(sdata) - 1
        at = start + pos
        v1 = sdata[(at - 1).clamp(0, n)]
        v2 = sdata[at.clamp(0, n)]
        c0 = cdf[at.clamp(0, n)]
        c1 = cdf[(at + 1).clamp(0, n)]
        gap = c1 - c0
        interp = (threshold - c0) / gap * (v2 - v1) + v1
        out = torch.where(gap >= 1.0, interp, v2)
        out = torch.where((pos == 0) | (pos == cnt - 1), v2, out)
    return torch.where(cnt > 0, out, torch.zeros_like(out))
