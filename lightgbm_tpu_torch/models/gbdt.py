"""GBDT boosting driver (port of the core of
``lightgbm_tpu/models/gbdt.py``; reference ``GBDT``,
src/boosting/gbdt.cpp:42-780).

Covered: ``boost_from_average`` (gbdt.cpp:312-335), ``train_one_iter``
(gradients -> grow -> shrinkage -> score update -> bias, with the
constant-tree fallback, gbdt.cpp:337-419), the train-score update
from leaf membership (``_update_scores``) and continued training from
an existing model's trees (``init_from_models``). Scores and gradients live
on the training device; trees live on the host. Valid sets, metrics,
callbacks, early stopping, bagging and the DART/GOSS/RF variants are
not in this slice.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import Config
from ..data.dataset import Dataset
from ..objective import create_objective
from ..parallel.learners import create_tree_learner
from ..utils.log import log_info, log_warning
from .tree import Tree, constant_tree

kEpsilon = 1e-15


class GBDT:
    """Gradient Boosting Decision Tree driver on one device."""

    def __init__(self, config: Config, train_data: Dataset,
                 device: torch.device, ops: str = "kernel"):
        self.config = config
        self.train_data = train_data
        self.device = torch.device(device)
        self.objective = create_objective(config)
        self.num_class = int(config.num_class)
        self.num_tree_per_iteration = 1
        self.models: List[Tree] = []
        self.iter = 0
        self.shrinkage_rate = float(config.learning_rate)
        self.learner = create_tree_learner(config.tree_learner, train_data,
                                           config, self.device, ops=ops)
        self.num_data = train_data.num_data
        self.objective.init(train_data.metadata, self.num_data, self.device)
        init = train_data.metadata.init_score
        if init is not None:
            score0 = np.asarray(init, np.float64).reshape(self.num_data, 1)
            self._has_init_score = True
        else:
            score0 = np.zeros((self.num_data, 1))
            self._has_init_score = False
        self.train_score = torch.as_tensor(score0, dtype=torch.float32,
                                           device=self.device)
        self._feature_rng = np.random.RandomState(
            config.feature_fraction_seed)

    @property
    def num_iterations_trained(self) -> int:
        return len(self.models) // self.num_tree_per_iteration

    def init_from_models(self, models: List[Tree],
                         train_add: Optional[torch.Tensor] = None) -> None:
        """Continued training (GBDT::LoadModelFromString + the resume
        of boosting.cpp:35-68): adopt an existing model's trees and add
        their raw float64 sum, rounded to float32, to the train scores, so
        the next ``train_one_iter`` boosts on the right residuals (and
        skips boost_from_average, as there are trees)."""
        self.models = list(models)
        self.iter = len(models) // self.num_tree_per_iteration
        if train_add is not None:
            add = torch.as_tensor(train_add).to(self.device, torch.float32)
            self.train_score += add.reshape(self.num_data, -1)

    # ------------------------------------------------------------------
    def _feature_mask(self) -> Optional[np.ndarray]:
        frac = self.config.feature_fraction
        if frac >= 1.0:
            return None
        f = self.train_data.num_features
        used = max(1, int(round(f * frac)))
        idx = self._feature_rng.choice(f, used, replace=False)
        mask = np.zeros(f, bool)
        mask[idx] = True
        return mask

    def boost_from_average(self, class_id: int = 0) -> float:
        """gbdt.cpp:312-335."""
        if self.models or self._has_init_score:
            return 0.0
        if self.config.boost_from_average \
                or self.train_data.num_features == 0:
            init_score = float(self.objective.boost_from_score(class_id))
            if abs(init_score) > kEpsilon:
                self.train_score[:, class_id] += init_score
                log_info(f"Start training from score {init_score:.6f}")
                return init_score
        return 0.0

    def train_one_iter(self) -> bool:
        """Returns True when training should STOP (no more valid
        splits), mirroring GBDT::TrainOneIter (gbdt.cpp:337-419)."""
        init_score = self.boost_from_average(0)
        grad, hess = self.objective.gradients(self.train_score[:, 0])
        fmask = self._feature_mask()
        tree = None
        leaf_id = None
        if self.objective.class_need_train(0) \
                and self.train_data.num_features > 0:
            tree, leaf_id = self.learner.train(grad, hess,
                                               feature_mask=fmask)
        if tree is not None and tree.num_leaves > 1:
            tree.shrink(self.shrinkage_rate)
            self._update_scores(tree, leaf_id)
            if abs(init_score) > kEpsilon:
                tree.add_bias(init_score)
        else:
            output = 0.0
            if not self.models:
                output = init_score if self.objective.class_need_train(0) \
                    else float(self.objective.boost_from_score(0))
                self.train_score[:, 0] += output
            tree = None if self.models else constant_tree(output)
            log_warning("Stopped training because there are no more "
                        "leaves that meet the split requirements")
            if tree is not None:
                self.models.append(tree)
            return True
        self.models.append(tree)
        self.iter += 1
        return False

    def _update_scores(self, tree: Tree, leaf_id: torch.Tensor) -> None:
        """Train score += leaf value of each row's leaf (no traversal:
        the learner knows every row's leaf)."""
        vals = torch.as_tensor(tree.leaf_value.astype(np.float32),
                               device=self.device)
        self.train_score[:, 0] += vals[leaf_id]

    def train(self, num_iterations: int) -> None:
        for _ in range(num_iterations):
            if self.train_one_iter():
                break
