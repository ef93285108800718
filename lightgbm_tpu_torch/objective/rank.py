"""Ranking objectives: lambdarank and rank_xendcg (port of
``lightgbm_tpu/objective/rank.py``; reference
src/objective/rank_objective.hpp:98-330).

Queries are padded to a common length q and held as ``[nq, q]`` tensors
on the training device: per-query sorts are batched sorts, and
lambdarank's pairwise lambdas are a ``[C, q, q]`` block over a chunk of
C queries, with ``C = (1 << 22) // q**2`` as in the JAX package, so the
pair block stays bounded however long the longest query is. The sigmoid
is evaluated exactly (the reference's 2**20-entry lookup table is not
reproduced, as in the JAX package). rank_xendcg draws its uniforms from
``np.random.RandomState(objective_seed)``, one ``rand(num_data)`` an
iteration, so it draws the JAX package's numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..data.dataset import Metadata
from ..utils.log import log_fatal
from .base import ObjectiveFunction

kEpsilon = 1e-15
PAIR_BLOCK = 1 << 22


def default_label_gain() -> np.ndarray:
    """DCGCalculator::DefaultLabelGain (dcg_calculator.cpp:33-41):
    gain[i] = 2^i - 1, capped at 31 labels."""
    return np.asarray([0.0] + [float((1 << i) - 1) for i in range(1, 31)])


def resolve_label_gain(config: Config) -> np.ndarray:
    if config.label_gain:
        return np.asarray(config.label_gain, np.float64)
    return default_label_gain()


def check_rank_labels(label: np.ndarray, num_gain: int) -> None:
    """DCGCalculator::CheckLabel (dcg_calculator.cpp:155-171)."""
    if np.abs(label - np.round(label)).max(initial=0.0) > kEpsilon:
        log_fatal("label should be int type for ranking task, for the "
                  "gain of label, please set the label_gain parameter")
    if label.min(initial=0.0) < 0:
        log_fatal("Label should be non-negative for ranking task")
    if int(label.max(initial=0)) >= num_gain:
        log_fatal(f"Label {int(label.max())} is not less than the number "
                  f"of label mappings ({num_gain})")


def max_dcg_table(ks, query_boundaries, label: np.ndarray,
                  gain: np.ndarray, discount: np.ndarray) -> np.ndarray:
    """DCGCalculator::CalMaxDCGAtK (dcg_calculator.cpp:54-80), the ideal
    DCG of every query at every k at once, float64 [nq, len(ks)]: each
    query's labels sorted descending, gains times discounts, the
    cumulative sum read at min(k, size). The sums are sequential, as
    numpy's per-query sums in the JAX package are below 8 terms; past
    that numpy's pairwise sum associates otherwise (last-bit
    differences)."""
    idx, counts = padded_queries(query_boundaries, len(label))
    top = -np.sort(-np.append(label.astype(np.int64), -1)[idx], axis=1)
    g = np.where(top >= 0, gain[np.maximum(top, 0)], 0.0) \
        * discount[None, :top.shape[1]]
    at = np.minimum(np.asarray(ks)[None, :], counts[:, None]) - 1
    return np.take_along_axis(np.cumsum(g, axis=1), at, axis=1)


def padded_queries(query_boundaries, num_data: int):
    """Row index of each query's slots, ``[nq, q]`` int64 with
    ``num_data`` in the pad slots, and the query sizes."""
    qb = np.asarray(query_boundaries, np.int64)
    counts = np.diff(qb)
    q = int(counts.max(initial=1))
    slot = np.arange(q)[None, :]
    idx = qb[:-1, None] + slot
    return np.where(slot < counts[:, None], idx, num_data), counts


class RankingObjective(ObjectiveFunction):
    """RankingObjective (rank_objective.hpp:25-96): padded query
    layout."""

    def init(self, metadata: Metadata, num_data: int, device) -> None:
        super().init(metadata, num_data, device)
        qb = metadata.query_boundaries
        if qb is None:
            log_fatal("Ranking tasks require query information")
        idx, counts = padded_queries(qb, num_data)
        self.num_queries, self.max_query = idx.shape
        lab = np.append(np.asarray(metadata.label, np.float64), 0.0)
        dev = self.device
        self._pad_idx = torch.from_numpy(idx).to(dev)
        self._pad_mask = self._pad_idx < num_data
        self._labels_pad = torch.from_numpy(
            lab[idx].astype(np.int64)).to(dev)
        self._counts = torch.from_numpy(counts).to(dev)
        # chunk queries so the [C, q, q] pair block stays bounded
        self._chunk = max(1, PAIR_BLOCK // max(self.max_query ** 2, 1))

    def _pad_scores(self, score: torch.Tensor) -> torch.Tensor:
        ext = torch.cat([score.to(torch.float32),
                         score.new_zeros(1, dtype=torch.float32)])
        return torch.where(self._pad_mask, ext[self._pad_idx],
                           -float("inf"))

    def _scatter_back(self, lam_pad, hess_pad):
        """Each row sits in exactly one slot: the scatter places it."""
        rows = self._pad_idx[self._pad_mask]
        lam = torch.zeros(self.num_data, dtype=torch.float32,
                          device=self.device)
        hess = torch.zeros_like(lam)
        lam[rows] = lam_pad[self._pad_mask]
        hess[rows] = hess_pad[self._pad_mask]
        return self._weighted(lam, hess)


class LambdarankNDCG(RankingObjective):
    """LambdarankNDCG (rank_objective.hpp:98-260)."""

    def __init__(self, config: Config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        self.norm = bool(config.lambdarank_norm)
        self.truncation_level = int(config.lambdarank_truncation_level)
        if self.sigmoid <= 0.0:
            log_fatal(f"Sigmoid param {self.sigmoid} should be greater "
                      "than zero")
        self.label_gain = resolve_label_gain(config)

    def init(self, metadata: Metadata, num_data: int, device) -> None:
        super().init(metadata, num_data, device)
        lab = np.asarray(metadata.label, np.float64)
        check_rank_labels(lab, len(self.label_gain))
        discount = 1.0 / np.log2(2.0 + np.arange(self.max_query))
        m = max_dcg_table([self.truncation_level],
                          metadata.query_boundaries, lab, self.label_gain,
                          discount)[:, 0]
        inv = np.where(m > 0, 1.0 / np.where(m > 0, m, 1.0), 0.0)
        dev = self.device
        self._inv_max_dcg = torch.from_numpy(inv.astype(np.float32)).to(dev)
        self._discount = torch.from_numpy(discount.astype(np.float32)).to(
            dev)
        self._gain_tbl = torch.from_numpy(
            self.label_gain.astype(np.float32)).to(dev)

    def gradients(self, score: torch.Tensor):
        s_pad = self._pad_scores(score)
        lam = torch.empty_like(s_pad)
        hess = torch.empty_like(s_pad)
        c = self._chunk
        for lo in range(0, self.num_queries, c):
            hi = min(lo + c, self.num_queries)
            lam[lo:hi], hess[lo:hi] = lambdarank_chunk(
                s_pad[lo:hi], self._labels_pad[lo:hi],
                self._pad_mask[lo:hi], self._inv_max_dcg[lo:hi],
                self._counts[lo:hi], discount=self._discount,
                gain_tbl=self._gain_tbl, sigmoid=self.sigmoid,
                norm=self.norm)
        return self._scatter_back(lam, hess)

    def name(self) -> str:
        return "lambdarank"


def lambdarank_chunk(sc, lab, msk, inv, cnt, *, discount, gain_tbl,
                     sigmoid, norm):
    """Pairwise lambdas for a [C, q] query chunk
    (GetGradientsForOneQuery, rank_objective.hpp:139-230; the JAX
    package's ``_lambdarank_chunk``)."""
    q = sc.shape[1]
    order = torch.sort(-sc, dim=1, stable=True)[1]     # pads sort last
    sc_s = torch.gather(sc, 1, order)
    lab_s = torch.gather(lab, 1, order)
    valid_s = torch.gather(msk, 1, order) & (sc_s > -float("inf"))

    best = sc_s[:, 0]
    worst = torch.gather(sc_s, 1, (cnt - 1).clamp(min=0)[:, None])[:, 0]

    lab_a = lab_s[:, :, None]
    lab_b = lab_s[:, None, :]
    pair_ok = (lab_a > lab_b) & valid_s[:, :, None] & valid_s[:, None, :]

    ds = sc_s[:, :, None] - sc_s[:, None, :]
    gap = gain_tbl[lab_a] - gain_tbl[lab_b]
    d = discount[:q]
    pd = torch.abs(d[None, :, None] - d[None, None, :])
    delta = gap * pd * inv[:, None, None]
    if norm:
        use_norm = (best != worst)[:, None, None]
        delta = torch.where(use_norm, delta / (0.01 + torch.abs(ds)), delta)
    sig = 1.0 / (1.0 + torch.exp(sigmoid * ds))         # GetSigmoid
    zero = torch.zeros((), dtype=sc.dtype, device=sc.device)
    p_lambda = torch.where(pair_ok, -sigmoid * delta * sig, zero)
    p_hess = torch.where(pair_ok,
                         sigmoid * sigmoid * delta * sig * (1.0 - sig), zero)

    lam_s = p_lambda.sum(dim=2) - p_lambda.sum(dim=1)
    hess_s = p_hess.sum(dim=2) + p_hess.sum(dim=1)
    if norm:
        sum_lambdas = -2.0 * p_lambda.sum(dim=(1, 2))
        nf = torch.where(sum_lambdas > 0,
                         torch.log2(1.0 + sum_lambdas)
                         / torch.clamp(sum_lambdas, min=kEpsilon),
                         torch.ones_like(sum_lambdas))
        lam_s = lam_s * nf[:, None]
        hess_s = hess_s * nf[:, None]

    lam = torch.empty_like(lam_s).scatter_(1, order, lam_s)
    hess = torch.empty_like(hess_s).scatter_(1, order, hess_s)
    return lam, hess


class RankXENDCG(RankingObjective):
    """RankXENDCG (rank_objective.hpp:262-330), arxiv.org/abs/1911.09798."""

    def __init__(self, config: Config):
        super().__init__(config)
        self._rng = np.random.RandomState(config.objective_seed)

    def init(self, metadata: Metadata, num_data: int, device) -> None:
        super().init(metadata, num_data, device)
        check_rank_labels(np.asarray(metadata.label, np.float64), 31)

    def gradients(self, score: torch.Tensor):
        u = torch.from_numpy(
            self._rng.rand(self.num_data).astype(np.float32)).to(self.device)
        return xendcg_grad(score, u, self._pad_idx, self._pad_mask,
                           self._labels_pad, self._counts, self.num_data,
                           self.weights)

    def name(self) -> str:
        return "rank_xendcg"


def xendcg_grad(score, uniforms, pad_idx, pad_mask, labels_pad, counts,
                num_data, weights):
    """The JAX package's ``_xendcg_grad``: softmax cross-entropy
    gradients over each query's valid documents."""
    zero = torch.zeros((), dtype=torch.float32, device=score.device)
    ext = torch.cat([score.to(torch.float32), zero[None]])
    s = torch.where(pad_mask, ext[pad_idx], -float("inf"))
    u = torch.where(pad_mask, torch.cat([uniforms, zero[None]])[pad_idx],
                    zero)

    m = s.max(dim=1, keepdim=True).values
    e = torch.where(pad_mask, torch.exp(s - m), zero)
    rho = e / torch.clamp(e.sum(dim=1, keepdim=True), min=kEpsilon)

    phi = torch.where(pad_mask,
                      torch.exp2(labels_pad.to(torch.float32)) - u, zero)
    sum_labels = torch.clamp(phi.sum(dim=1, keepdim=True), min=kEpsilon)
    l1 = torch.where(pad_mask, -phi / sum_labels + rho, zero)
    sum_l1 = l1.sum(dim=1, keepdim=True)

    denom = torch.clamp(1.0 - rho, min=kEpsilon)
    l2 = torch.where(pad_mask, (sum_l1 - l1) / denom, zero)
    sum_l2 = l2.sum(dim=1, keepdim=True)
    l3 = torch.where(pad_mask, (sum_l2 - l2) / denom, zero)

    lam_full = l1 + rho * l2 + rho * rho * l3
    single = (counts <= 1)[:, None]
    lam = torch.where(pad_mask, torch.where(single, l1, lam_full), zero)
    hess = torch.where(pad_mask, rho * (1.0 - rho), zero)

    rows = pad_idx[pad_mask]
    g = torch.zeros(num_data, dtype=torch.float32, device=score.device)
    h = torch.zeros_like(g)
    g[rows] = lam[pad_mask]
    h[rows] = hess[pad_mask]
    if weights is not None:
        g = g * weights
        h = h * weights
    return g, h
