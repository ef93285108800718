"""Cross-entropy objectives for probabilistic labels in [0, 1] (port of
``lightgbm_tpu/objective/xentropy.py``; reference
src/objective/xentropy_objective.hpp)."""

from __future__ import annotations

import numpy as np
import torch

from ..utils.log import log_fatal, log_info
from .base import ObjectiveFunction

kEpsilon = 1e-15


def _check_interval(label, name):
    lbl = np.asarray(label)
    if (lbl < 0.0).any() or (lbl > 1.0).any():
        log_fatal(f"[{name}]: label must be in [0, 1] interval")


class _XentropyBase(ObjectiveFunction):

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        _check_interval(self.label_np, self.name())
        if self.weights is not None and self.weights_np.min() <= 0.0:
            log_fatal(f"[{self.name()}]: at least one weight is "
                      "non-positive")

    def _label_average(self) -> float:
        lbl = np.asarray(self.label_np, np.float64)
        if self.weights is not None:
            w = np.asarray(self.weights_np, np.float64)
            return float((lbl * w).sum() / w.sum())
        return float(lbl.mean())


class CrossEntropy(_XentropyBase):
    """Straight cross-entropy (xentropy_objective.hpp:38-140)."""

    def gradients(self, score):
        z = 1.0 / (1.0 + torch.exp(-score))
        grad = z - self.label
        hess = z * (1.0 - z)
        return self._weighted(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        pavg = min(max(self._label_average(), kEpsilon), 1.0 - kEpsilon)
        init = float(np.log(pavg / (1.0 - pavg)))
        log_info(f"[{self.name()}:BoostFromScore]: pavg = {pavg:.6f} -> "
                 f"initscore = {init:.6f}")
        return init

    def convert_output(self, score):
        return 1.0 / (1.0 + torch.exp(-score))

    def name(self):
        return "cross_entropy"


class CrossEntropyLambda(_XentropyBase):
    """Alternative parameterization with weight-as-trials
    (xentropy_objective.hpp:146-275)."""

    def gradients(self, score):
        if self.weights is None:
            z = 1.0 / (1.0 + torch.exp(-score))
            return z - self.label, z * (1.0 - z)
        w = self.weights
        y = self.label
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = torch.exp(-score)
        grad = (1.0 - y / z) * w / (1.0 + enf)
        c = 1.0 / (1.0 - z)
        d = 1.0 + epf
        a = w * epf / (d * d)
        d2 = c - 1.0
        bb = (c / (d2 * d2)) * (1.0 + w * epf - c)
        hess = a * (1.0 + y * bb)
        return grad, hess

    def boost_from_score(self, class_id: int = 0) -> float:
        havg = self._label_average()
        init = float(np.log(np.expm1(max(havg, kEpsilon))
                            if havg > 0 else kEpsilon))
        log_info(f"[{self.name()}:BoostFromScore]: havg = {havg:.6f} -> "
                 f"initscore = {init:.6f}")
        return init

    def convert_output(self, score):
        # the normalized exponential parameter lambda > 0
        return torch.log1p(torch.exp(score))

    def name(self):
        return "cross_entropy_lambda"
