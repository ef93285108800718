"""Objective function interface + factory (port of
``lightgbm_tpu/objective/base.py``; reference ``ObjectiveFunction``,
include/LightGBM/objective_function.h:19-95, factory
src/objective/objective_function.cpp:15-53).

Gradients and hessians are one vectorized function of the score tensor
([N], or [N, k] for k trees an iteration) on the training device, in
float32 as the JAX package computes them; GBDT gradients are analytic,
so no autograd is involved. The L1-family objectives refit their
leaves' outputs (``renew_tree_output``) on the training device
(``ops/percentile.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data.dataset import Metadata
from ..utils.log import log_fatal


class ObjectiveFunction:
    """Base objective. Subclasses override gradients() and friends."""

    #: number of models (trees) trained per boosting iteration
    num_model_per_iteration = 1
    is_renew_tree_output = False

    def __init__(self, config: Config):
        self.config = config
        self.num_data = 0
        self.device = torch.device("cpu")
        self.label: Optional[torch.Tensor] = None
        self.weights: Optional[torch.Tensor] = None
        self.label_np = None
        self.weights_np = None

    def init(self, metadata: Metadata, num_data: int, device) -> None:
        self.num_data = num_data
        self.device = torch.device(device)
        if metadata.label is None:
            log_fatal("Label is required for training")
        self.label_np = metadata.label
        self.weights_np = metadata.weights
        self.label = torch.from_numpy(metadata.label).to(self.device)
        self.weights = None if metadata.weights is None \
            else torch.from_numpy(metadata.weights).to(self.device)
        self.check_label()

    def check_label(self) -> None:
        pass

    def gradients(self, score: torch.Tensor):
        """score [N] or [N, k] -> (grad, hess), the same shape."""
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def class_need_train(self, class_id: int = 0) -> bool:
        return True

    def convert_output(self, score: torch.Tensor) -> torch.Tensor:
        return score

    def renew_tree_output(self, score: torch.Tensor, leaf_id: torch.Tensor,
                          num_leaves: int) -> Optional[np.ndarray]:
        """RenewTreeOutput: the L1 family's leaf refit from the train
        score column and each row's leaf; float64 [num_leaves], or None
        when the objective keeps its leaf outputs."""
        return None

    def name(self) -> str:
        raise NotImplementedError

    def _weighted(self, grad, hess):
        if self.weights is not None:
            w = self.weights
            if grad.ndim == 2:
                w = w[:, None]
            return grad * w, hess * w
        return grad, hess


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """Factory (objective_function.cpp:15-53); ``None`` for a custom
    objective (``fobj``)."""
    from . import binary, multiclass, rank, regression, xentropy
    name = config.objective
    table = {
        "regression": regression.RegressionL2Loss,
        "regression_l1": regression.RegressionL1Loss,
        "quantile": regression.RegressionQuantileLoss,
        "huber": regression.RegressionHuberLoss,
        "fair": regression.RegressionFairLoss,
        "poisson": regression.RegressionPoissonLoss,
        "mape": regression.RegressionMAPELoss,
        "gamma": regression.RegressionGammaLoss,
        "tweedie": regression.RegressionTweedieLoss,
        "binary": binary.BinaryLogloss,
        "multiclass": multiclass.MulticlassSoftmax,
        "multiclassova": multiclass.MulticlassOVA,
        "lambdarank": rank.LambdarankNDCG,
        "rank_xendcg": rank.RankXENDCG,
        "cross_entropy": xentropy.CrossEntropy,
        "cross_entropy_lambda": xentropy.CrossEntropyLambda,
    }
    if name in ("custom", "none", "null", "na"):
        return None
    if name not in table:
        log_fatal(f"Unknown objective type name: {name}")
    return table[name](config)
