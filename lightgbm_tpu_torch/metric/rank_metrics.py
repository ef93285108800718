"""Ranking metrics: NDCG@k and MAP@k (port of
``lightgbm_tpu/metric/rank_metrics.py``; reference
src/metric/rank_metric.hpp, dcg_calculator.cpp, map_metric.hpp).

Queries are padded to the longest one and held as ``[nq, q]`` row
indices on the device; each query's rows are sorted by descending score
with a stable sort (the reference's ``std::stable_sort``), so ties keep
row order exactly as in the JAX package's per-query numpy loop. The
per-query sums are cumulative sums in float64 over blocks of queries.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..objective.rank import (check_rank_labels, max_dcg_table,
                              padded_queries, resolve_label_gain)
from ..utils.log import log_fatal
from .metrics import Metric

# padded query slots a block of queries may hold
BLOCK_CELLS = 1 << 24


def _default_eval_at(ks) -> List[int]:
    """DCGCalculator::DefaultEvalAt (dcg_calculator.cpp:20-31)."""
    ks = [int(k) for k in ks]
    if not ks:
        return [1, 2, 3, 4, 5]
    if any(k <= 0 for k in ks):
        log_fatal("eval_at positions must be positive")
    return ks


class _RankMetric(Metric):
    factor_to_bigger_better = 1.0

    def __init__(self, config):
        super().__init__(config)
        self.eval_at = _default_eval_at(config.eval_at)

    @property
    def names(self) -> List[str]:
        return [f"{self.name}@{k}" for k in self.eval_at]

    def init(self, metadata, num_data: int, device) -> None:
        super().init(metadata, num_data, device)
        qb = metadata.query_boundaries
        if qb is None:
            log_fatal(f"The {self.name.upper()} metric requires query "
                      "information")
        self.query_boundaries = np.asarray(qb, np.int64)
        self.num_queries = len(self.query_boundaries) - 1
        qw = metadata.query_weights
        self.sum_query_weights = float(self.num_queries) if qw is None \
            else float(np.asarray(qw, np.float64).sum())
        idx, counts = padded_queries(self.query_boundaries, num_data)
        self.max_query = idx.shape[1]
        dev = self.device
        self._pad_idx = torch.from_numpy(idx).to(dev)
        self._pad_mask = self._pad_idx < num_data
        self._counts = torch.from_numpy(counts).to(dev)
        self._labels_pad = torch.from_numpy(np.append(
            self.label_np, 0.0)[idx]).to(dev)
        self._ks = torch.as_tensor(self.eval_at, device=dev)
        self._query_weights = None if qw is None else torch.from_numpy(
            np.asarray(qw, np.float64)).to(dev)
        self._block = max(1, BLOCK_CELLS // self.max_query)

    def _sorted_labels(self, score, lo, hi):
        """Labels of queries [lo, hi) in descending score order (stable;
        pad slots last), and the top position each k reads per query."""
        s = torch.cat([score.to(torch.float64).reshape(-1),
                       score.new_zeros(1, dtype=torch.float64)])
        key = torch.where(self._pad_mask[lo:hi], -s[self._pad_idx[lo:hi]],
                          float("inf"))
        order = torch.sort(key, dim=1, stable=True)[1]
        lab = torch.gather(self._labels_pad[lo:hi], 1, order)
        at = torch.minimum(self._ks[None, :],
                           self._counts[lo:hi, None]) - 1
        return lab, at

    def _weighted_mean(self, per_query: torch.Tensor) -> List[torch.Tensor]:
        """per_query [nq, K] -> K query-weight-averaged values."""
        if self._query_weights is not None:
            per_query = per_query * self._query_weights[:, None]
        return list(per_query.sum(dim=0) / self.sum_query_weights)

    def eval(self, score, pred):
        out = torch.cat([self._eval_block(score, lo, min(
            lo + self._block, self.num_queries)) for lo in range(
                0, self.num_queries, self._block)])
        return self._weighted_mean(out)


class NDCGMetric(_RankMetric):
    """NDCGMetric (rank_metric.hpp:19-168)."""

    name = "ndcg"

    def __init__(self, config):
        super().__init__(config)
        self.label_gain = resolve_label_gain(config)

    def init(self, metadata, num_data: int, device) -> None:
        super().init(metadata, num_data, device)
        check_rank_labels(self.label_np, len(self.label_gain))
        discount = 1.0 / np.log2(2.0 + np.arange(self.max_query))
        # inverse ideal DCG per (query, k); -1 for a query without gain
        m = max_dcg_table(self.eval_at, self.query_boundaries,
                          self.label_np, self.label_gain, discount)
        inv = np.where(m > 0, 1.0 / np.where(m > 0, m, 1.0), -1.0)
        dev = self.device
        self._discount = torch.from_numpy(discount).to(dev)
        self._gain = torch.from_numpy(self.label_gain).to(dev)
        self._inv_max_dcg = torch.from_numpy(inv).to(dev)

    def _eval_block(self, score, lo, hi):
        lab, at = self._sorted_labels(score, lo, hi)
        g = self._gain[lab.to(torch.int64)] * self._discount[None, :]
        cum = torch.cumsum(g, dim=1)
        inv = self._inv_max_dcg[lo:hi]
        # a query without gain counts as perfect
        return torch.where(inv[:, :1] <= 0.0, torch.ones_like(inv),
                           torch.gather(cum, 1, at) * inv)


class MapMetric(_RankMetric):
    """MapMetric (map_metric.hpp:21-166)."""

    name = "map"

    def init(self, metadata, num_data: int, device) -> None:
        super().init(metadata, num_data, device)
        npos = np.add.reduceat((self.label_np > 0.5).astype(np.int64),
                               self.query_boundaries[:-1])
        self._npos = torch.from_numpy(npos).to(self.device)

    def _eval_block(self, score, lo, hi):
        lab, at = self._sorted_labels(score, lo, hi)
        hits = lab > 0.5
        cumhits = torch.cumsum(hits.to(torch.float64), dim=1)
        pos = torch.arange(1, lab.shape[1] + 1, device=lab.device,
                           dtype=torch.float64)
        ap = torch.where(hits, cumhits / pos, torch.zeros_like(cumhits))
        cum_ap = torch.cumsum(ap, dim=1)
        npos = self._npos[lo:hi, None]
        val = torch.gather(cum_ap, 1, at) / torch.minimum(npos, at + 1)
        return torch.where(npos > 0, val, torch.ones_like(val))
