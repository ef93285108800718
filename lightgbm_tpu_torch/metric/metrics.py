"""Evaluation metrics (port of ``lightgbm_tpu/metric/metrics.py``;
reference src/metric/*.hpp, factory metric.cpp:16-63).

The JAX package fetches each dataset's raw and converted scores to the
host once an eval boundary and reduces them there in float64 numpy.
Here every metric is a float64 torch function on the scores' device
that returns 0-dim tensors without reading the device, so an eval
boundary reads all its values to the host at once (``eval_all``).
Each metric gets the raw score and the converted prediction (the raw
score again when there is no objective: custom objectives, and the JAX
package's batched eval path, do the same). ``factor_to_bigger_better``
tells early stopping which way is better, as in the reference's
metric.h.

The ranking metrics (ndcg, map) are in ``rank_metrics.py``, auc_mu in
``multiclass_extra.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..utils.log import log_fatal

kEpsilon = 1e-15
_LOG_EPS = 1.0e-12


def _xent_loss(label, prob):
    """XentLoss (xentropy_metric.hpp:35-50) with log-arg clipping."""
    a = label * torch.log(torch.clamp(prob, min=_LOG_EPS))
    b = (1.0 - label) * torch.log(torch.clamp(1.0 - prob, min=_LOG_EPS))
    return -(a + b)


def group_bounds(new_run: torch.Tensor):
    """For rows in sorted order with ``new_run`` marking the first row of
    each run of equal keys: each row's run start and run end (inclusive)
    indices, without reading the device."""
    n = new_run.shape[0]
    idx = torch.arange(n, device=new_run.device)
    start = torch.cummax(torch.where(new_run, idx, torch.zeros_like(idx)),
                         0)[0]
    last = torch.cat([new_run[1:], new_run.new_ones(1)])
    end = torch.flip(torch.cummin(torch.flip(
        torch.where(last, idx, torch.full_like(idx, n - 1)), [0]), 0)[0],
        [0])
    return start, end


class Metric:
    """Base: subclasses define name, bigger_better and eval()."""

    factor_to_bigger_better = -1.0  # smaller is better by default

    def __init__(self, config: Config):
        self.config = config
        self.label: Optional[torch.Tensor] = None
        self.weights: Optional[torch.Tensor] = None
        self.sum_weights = 0.0

    def init(self, metadata, num_data: int, device) -> None:
        self.num_data = num_data
        self.device = torch.device(device)
        self.label_np = None if metadata.label is None \
            else np.asarray(metadata.label, np.float64)
        self.weights_np = None if metadata.weights is None \
            else np.asarray(metadata.weights, np.float64)
        self.label = None if self.label_np is None \
            else torch.from_numpy(self.label_np).to(self.device)
        self.weights = None if self.weights_np is None \
            else torch.from_numpy(self.weights_np).to(self.device)
        self.sum_weights = float(num_data) if self.weights_np is None \
            else float(self.weights_np.sum())

    @property
    def names(self) -> List[str]:
        return [self.name]

    def eval(self, score: torch.Tensor, pred: torch.Tensor
             ) -> List[torch.Tensor]:
        """0-dim float64 tensors, one per name, from the raw ``score``
        ([N] or [N, k]) and its converted ``pred``."""
        raise NotImplementedError

    def _average(self, loss_per_point) -> torch.Tensor:
        if self.weights is None:
            return loss_per_point.sum() / self.sum_weights
        return (loss_per_point * self.weights).sum() / self.sum_weights


class _PointwiseRegressionMetric(Metric):
    """RegressionMetric<T> (regression_metric.hpp:21-117)."""

    def eval(self, score, pred):
        return [self._finalize(self._average(
            self._loss(self.label, pred.to(torch.float64))))]

    def _finalize(self, avg):
        return avg

    def _loss(self, label, pred):
        raise NotImplementedError


class L2Metric(_PointwiseRegressionMetric):
    name = "l2"

    def _loss(self, label, pred):
        return (pred - label) ** 2


class RMSEMetric(L2Metric):
    name = "rmse"

    def _finalize(self, avg):
        return torch.sqrt(avg)


class L1Metric(_PointwiseRegressionMetric):
    name = "l1"

    def _loss(self, label, pred):
        return torch.abs(pred - label)


class QuantileMetric(_PointwiseRegressionMetric):
    name = "quantile"

    def _loss(self, label, pred):
        delta = label - pred
        alpha = self.config.alpha
        return torch.where(delta < 0, (alpha - 1.0) * delta, alpha * delta)


class HuberLossMetric(_PointwiseRegressionMetric):
    name = "huber"

    def _loss(self, label, pred):
        diff = pred - label
        a = self.config.alpha
        return torch.where(torch.abs(diff) <= a, 0.5 * diff * diff,
                           a * (torch.abs(diff) - 0.5 * a))


class FairLossMetric(_PointwiseRegressionMetric):
    name = "fair"

    def _loss(self, label, pred):
        x = torch.abs(pred - label)
        c = self.config.fair_c
        return c * x - c * c * torch.log(1.0 + x / c)


class PoissonMetric(_PointwiseRegressionMetric):
    name = "poisson"

    def _loss(self, label, pred):
        pred = torch.clamp(pred, min=1e-10)
        return pred - label * torch.log(pred)


class MAPEMetric(_PointwiseRegressionMetric):
    name = "mape"

    def _loss(self, label, pred):
        return torch.abs(label - pred) / torch.clamp(torch.abs(label),
                                                     min=1.0)


class GammaMetric(_PointwiseRegressionMetric):
    name = "gamma"

    def _loss(self, label, pred):
        # negative gamma log-likelihood with psi=1
        # (regression_metric.hpp:261-268 reduces to label/pred + log(pred))
        return label / pred + torch.log(torch.clamp(pred, min=kEpsilon))


class GammaDevianceMetric(_PointwiseRegressionMetric):
    name = "gamma_deviance"

    def _loss(self, label, pred):
        tmp = label / (pred + 1e-9)
        return tmp - torch.log(torch.clamp(tmp, min=kEpsilon)) - 1.0

    def eval(self, score, pred):
        loss = self._loss(self.label, pred.to(torch.float64))
        total = loss.sum() if self.weights is None \
            else (loss * self.weights).sum()
        return [total * 2]  # AverageLoss: sum * 2, no averaging


class TweedieMetric(_PointwiseRegressionMetric):
    name = "tweedie"

    def _loss(self, label, pred):
        rho = self.config.tweedie_variance_power
        pred = torch.clamp(pred, min=1e-10)
        a = label * torch.exp((1 - rho) * torch.log(pred)) / (1 - rho)
        b = torch.exp((2 - rho) * torch.log(pred)) / (2 - rho)
        return -a + b


class BinaryLoglossMetric(Metric):
    """binary_metric.hpp:115-130."""
    name = "binary_logloss"

    def eval(self, score, pred):
        y = (self.label > 0).to(torch.float64)
        return [self._average(_xent_loss(y, pred.to(torch.float64)))]


class BinaryErrorMetric(Metric):
    """binary_metric.hpp:133-150: an error where prob > 0.5 mismatches
    the label."""
    name = "binary_error"

    def eval(self, score, pred):
        wrong = (pred.to(torch.float64) > 0.5) != (self.label > 0)
        return [self._average(wrong.to(torch.float64))]


class AUCMetric(Metric):
    """Weighted AUC with tie handling (binary_metric.hpp:153-250): rows
    sorted by descending score (stable), each run of equal scores adds
    its negatives times (half its positives + the positives before it).
    The run sums come from cumulative sums, not from numpy's grouped
    ``add.at``, so the value agrees with the JAX package's to ~1e-12
    relative."""
    name = "auc"
    factor_to_bigger_better = 1.0

    def eval(self, score, pred):
        s = score.to(torch.float64).reshape(-1)
        w = torch.ones_like(self.label) if self.weights is None \
            else self.weights
        pos = (self.label > 0).to(torch.float64) * w
        neg = (self.label <= 0).to(torch.float64) * w
        order = torch.sort(-s, stable=True)[1]
        s, pos, neg = s[order], pos[order], neg[order]
        start, end = group_bounds(torch.cat(
            [s.new_ones(1, dtype=torch.bool), s[1:] != s[:-1]]))
        cp = torch.cumsum(pos, 0)
        before = torch.where(start > 0, cp[(start - 1).clamp(min=0)],
                             torch.zeros_like(cp))
        run_pos = cp[end] - before
        accum = (neg * (run_pos * 0.5 + before)).sum()
        total_pos = cp[-1]
        total_neg = neg.sum()
        ok = (total_pos > 0) & (total_neg > 0)
        return [torch.where(ok, accum / (total_pos * total_neg),
                            torch.ones_like(accum))]


class MultiLoglossMetric(Metric):
    """multiclass_metric.hpp MultiSoftmaxLoglossMetric."""
    name = "multi_logloss"

    def eval(self, score, pred):
        lbl = self.label.to(torch.int64)
        p = torch.gather(pred.to(torch.float64), 1, lbl[:, None])[:, 0]
        return [self._average(-torch.log(torch.clamp(p, min=kEpsilon)))]


class MultiErrorMetric(Metric):
    """Top-k error (multiclass_metric.hpp, multi_error_top_k): an error
    where k or more classes have a larger probability than the true
    class (ties count for the true class, as in the reference)."""
    name = "multi_error"

    def eval(self, score, pred):
        prob = pred.to(torch.float64)
        lbl = self.label.to(torch.int64)
        k = max(1, int(self.config.multi_error_top_k))
        p_true = torch.gather(prob, 1, lbl[:, None])
        rank = (prob > p_true).sum(dim=1)
        return [self._average((rank >= k).to(torch.float64))]


class CrossEntropyMetric(Metric):
    """xentropy_metric.hpp:71-160."""
    name = "cross_entropy"

    def eval(self, score, pred):
        return [self._average(_xent_loss(self.label,
                                         pred.to(torch.float64)))]


class CrossEntropyLambdaMetric(Metric):
    """xentropy_metric.hpp:166-245: the weights enter the loss itself;
    the sum is divided by num_data."""
    name = "cross_entropy_lambda"

    def eval(self, score, pred):
        hhat = pred.to(torch.float64).reshape(-1)
        w = torch.ones_like(hhat) if self.weights is None else self.weights
        prob = 1.0 - torch.exp(-w * hhat)
        return [_xent_loss(self.label, prob).sum() / self.num_data]


class KullbackLeiblerDivergence(Metric):
    """xentropy_metric.hpp:249-330: cross-entropy plus label entropy."""
    name = "kullback_leibler"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        p = self.label_np
        hp = np.where(p > 0, p * np.log(np.maximum(p, kEpsilon)), 0.0) \
            + np.where(1 - p > 0,
                       (1 - p) * np.log(np.maximum(1 - p, kEpsilon)), 0.0)
        if self.weights_np is not None:
            hp = hp * self.weights_np
        self.presum_label_entropy = float(hp.sum() / self.sum_weights)

    def eval(self, score, pred):
        xent = self._average(_xent_loss(self.label, pred.to(torch.float64)))
        return [xent + self.presum_label_entropy]


def create_metric(name: str, config: Config) -> Optional[Metric]:
    """Factory (metric.cpp:16-63)."""
    from .multiclass_extra import AucMuMetric
    from .rank_metrics import MapMetric, NDCGMetric
    table = {
        "l2": L2Metric, "mean_squared_error": L2Metric, "mse": L2Metric,
        "rmse": RMSEMetric, "l2_root": RMSEMetric,
        "l1": L1Metric, "mean_absolute_error": L1Metric, "mae": L1Metric,
        "quantile": QuantileMetric,
        "huber": HuberLossMetric,
        "fair": FairLossMetric,
        "poisson": PoissonMetric,
        "mape": MAPEMetric,
        "gamma": GammaMetric,
        "gamma_deviance": GammaDevianceMetric,
        "tweedie": TweedieMetric,
        "binary_logloss": BinaryLoglossMetric,
        "binary_error": BinaryErrorMetric,
        "auc": AUCMetric,
        "auc_mu": AucMuMetric,
        "multi_logloss": MultiLoglossMetric,
        "multi_error": MultiErrorMetric,
        "cross_entropy": CrossEntropyMetric, "xentropy": CrossEntropyMetric,
        "cross_entropy_lambda": CrossEntropyLambdaMetric,
        "xentlambda": CrossEntropyLambdaMetric,
        "kullback_leibler": KullbackLeiblerDivergence,
        "kldiv": KullbackLeiblerDivergence,
        "ndcg": NDCGMetric, "map": MapMetric,
    }
    if name in ("custom", "none", "null", "na", ""):
        return None
    if name not in table:
        log_fatal(f"Unknown metric type name: {name}")
    return table[name](config)


def create_metrics(names: Sequence[str], config: Config) -> List[Metric]:
    out = []
    for n in names:
        m = create_metric(n, config)
        if m is not None:
            out.append(m)
    return out
