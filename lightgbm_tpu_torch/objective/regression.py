"""Regression objectives (port of ``lightgbm_tpu/objective/regression.py``;
reference src/objective/regression_objective.hpp).

L2 (with ``reg_sqrt``), L1, huber, fair, poisson, quantile, MAPE, gamma
and tweedie, each term for term the JAX expression in float32. The
L1-type losses (L1, quantile, MAPE) refit each leaf's output with a
(weighted) percentile of its rows' residuals
(``RenewTreeOutput``, regression_objective.hpp:250-276,538-564,637-657)
on the training device (``ops/percentile.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..ops.percentile import percentile_host, renew_leaf_outputs
from ..utils.log import log_fatal, log_warning
from .base import ObjectiveFunction


def _sign(x):
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, 0.0)).to(x.dtype)


class RegressionL2Loss(ObjectiveFunction):
    """L2 loss (regression_objective.hpp:90-185)."""

    def __init__(self, config: Config):
        super().__init__(config)
        self.sqrt = bool(config.reg_sqrt)

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if self.sqrt:
            lbl = self.label_np
            self.label_np = (np.sign(lbl) * np.sqrt(np.abs(lbl))).astype(
                np.float32)
            self.label = torch.from_numpy(self.label_np).to(self.device)

    def gradients(self, score):
        grad = score - self.label
        hess = torch.ones_like(score)
        return self._weighted(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        lbl = np.asarray(self.label_np, np.float64)
        if self.weights is not None:
            w = np.asarray(self.weights_np, np.float64)
            return float((lbl * w).sum() / w.sum())
        return float(lbl.mean())

    def convert_output(self, score):
        if self.sqrt:
            return torch.sign(score) * score * score
        return score

    def name(self):
        return "regression"


class RegressionL1Loss(RegressionL2Loss):
    """L1 loss with median leaf refit (regression_objective.hpp:190-290)."""

    renew_alpha = 0.5
    is_renew_tree_output = True

    def gradients(self, score):
        grad = _sign(score - self.label)
        hess = torch.ones_like(score)
        return self._weighted(grad, hess)

    def _refit_weights(self):
        return self.weights

    def boost_from_score(self, class_id: int = 0) -> float:
        w = self._refit_weights()
        return percentile_host(self.label_np,
                               None if w is None else w.cpu().numpy(),
                               self.renew_alpha)

    def renew_tree_output(self, score, leaf_id, num_leaves):
        # the residual in float32 (label - score), as the JAX package
        # forms it on its device, then float64
        residual = (self.label - score).to(torch.float64)
        return renew_leaf_outputs(residual, leaf_id, num_leaves,
                                  self._refit_weights(), self.renew_alpha)

    def name(self):
        return "regression_l1"


class RegressionHuberLoss(RegressionL2Loss):
    """Huber loss (regression_objective.hpp:296-400); alpha threshold."""

    def __init__(self, config: Config):
        super().__init__(config)
        self.alpha = float(config.alpha)
        if self.sqrt:
            log_warning("Cannot use sqrt transform in huber Regression, "
                        "will auto disable it")
            self.sqrt = False

    def gradients(self, score):
        diff = score - self.label
        grad = torch.where(torch.abs(diff) <= self.alpha, diff,
                           _sign(diff) * self.alpha)
        hess = torch.ones_like(score)
        return self._weighted(grad, hess)

    def name(self):
        return "huber"


class RegressionFairLoss(RegressionL2Loss):
    """Fair loss (regression_objective.hpp:354-404)."""

    def __init__(self, config: Config):
        super().__init__(config)
        self.c = float(config.fair_c)
        self.sqrt = False

    def gradients(self, score):
        x = score - self.label
        c = self.c
        grad = c * x / (torch.abs(x) + c)
        hess = c * c / (torch.abs(x) + c) ** 2
        return self._weighted(grad, hess)

    def name(self):
        return "fair"


class RegressionPoissonLoss(RegressionL2Loss):
    """Poisson regression (regression_objective.hpp:407-478): the score
    is the log-rate; grad = exp(f) - y, hess = exp(f + max_delta_step)."""

    def __init__(self, config: Config):
        super().__init__(config)
        self.max_delta_step = float(config.poisson_max_delta_step)
        self.sqrt = False

    def check_label(self):
        lbl = self.label_np
        if lbl.min(initial=0.0) < 0.0:
            log_fatal(f"[{self.name()}]: at least one target label is "
                      "negative")
        if lbl.sum() == 0.0:
            log_fatal(f"[{self.name()}]: sum of labels is zero")

    def gradients(self, score):
        grad = torch.exp(score) - self.label
        hess = torch.exp(score + self.max_delta_step)
        return self._weighted(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        return float(np.log(max(RegressionL2Loss.boost_from_score(self),
                                1e-300)))

    def convert_output(self, score):
        return torch.exp(score)

    def name(self):
        return "poisson"


class RegressionQuantileLoss(RegressionL1Loss):
    """Quantile (pinball) loss (regression_objective.hpp:483-596)."""

    def __init__(self, config: Config):
        super().__init__(config)
        self.alpha = float(config.alpha)
        if not 0.0 < self.alpha < 1.0:
            log_fatal("Quantile alpha should be in (0, 1)")
        self.renew_alpha = self.alpha

    def gradients(self, score):
        delta = score - self.label
        grad = torch.where(delta >= 0, 1.0 - self.alpha,
                           -self.alpha).to(score.dtype)
        hess = torch.ones_like(score)
        return self._weighted(grad, hess)

    def name(self):
        return "quantile"


class RegressionMAPELoss(RegressionL1Loss):
    """MAPE loss (regression_objective.hpp:583-670): L1 scaled by
    1/max(1, |label|); weighted-median refits."""

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        lbl = self.label_np
        if np.abs(lbl).min(initial=1.0) <= 1.0:
            log_warning("Some label values are < 1 in absolute value. "
                        "MAPE is unstable with such values, so LightGBM "
                        "rounds them to 1.0 when computing MAPE.")
        w = np.ones_like(lbl) if self.weights is None \
            else self.weights_np
        self.label_weight = torch.from_numpy(np.asarray(
            1.0 / np.maximum(1.0, np.abs(lbl)) * w, np.float32)).to(
                self.device)

    def _refit_weights(self):
        return self.label_weight

    def gradients(self, score):
        grad = _sign(score - self.label) * self.label_weight
        hess = torch.ones_like(score) if self.weights is None \
            else torch.broadcast_to(self.weights, score.shape).clone()
        return grad, hess

    def name(self):
        return "mape"


class RegressionGammaLoss(RegressionPoissonLoss):
    """Gamma regression (regression_objective.hpp:673-706)."""

    def gradients(self, score):
        if self.weights is not None:
            # the reference weighs the label term only
            # (regression_objective.hpp:695-697)
            e = self.label * torch.exp(-score) * self.weights
            return 1.0 - e, e
        grad = 1.0 - self.label * torch.exp(-score)
        hess = self.label * torch.exp(-score)
        return grad, hess

    def name(self):
        return "gamma"


class RegressionTweedieLoss(RegressionPoissonLoss):
    """Tweedie regression (regression_objective.hpp:708-753)."""

    def __init__(self, config: Config):
        super().__init__(config)
        self.rho = float(config.tweedie_variance_power)

    def gradients(self, score):
        rho = self.rho
        grad = -self.label * torch.exp((1 - rho) * score) \
            + torch.exp((2 - rho) * score)
        hess = -self.label * (1 - rho) * torch.exp((1 - rho) * score) \
            + (2 - rho) * torch.exp((2 - rho) * score)
        return self._weighted(grad, hess)

    def name(self):
        return "tweedie"
