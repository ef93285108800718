"""Multiclass objectives: softmax and one-vs-all (port of
``lightgbm_tpu/objective/multiclass.py``; reference
src/objective/multiclass_objective.hpp:22-273).

The score is ``[N, k]``, one column per class; the k trees of an
iteration each train on their own column of the gradients.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..utils.log import log_fatal
from .base import ObjectiveFunction
from .binary import BinaryLogloss

kEpsilon = 1e-15


def softmax(score: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis as ``jax.nn.softmax`` forms it:
    exp(x - max) divided by its sum (torch.softmax multiplies by the
    reciprocal instead)."""
    e = torch.exp(score - score.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)


class MulticlassSoftmax(ObjectiveFunction):
    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        self.num_model_per_iteration = self.num_class

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        lbl = self.label_np.astype(np.int32)
        if (lbl < 0).any() or (lbl >= self.num_class).any():
            log_fatal("Label must be in [0, num_class) for multiclass "
                      "objective")
        self.onehot = torch.nn.functional.one_hot(
            torch.from_numpy(lbl.astype(np.int64)),
            self.num_class).to(torch.float32).to(self.device)
        w = np.ones(num_data) if self.weights is None \
            else np.asarray(self.weights_np, np.float64)
        probs = np.zeros(self.num_class)
        np.add.at(probs, lbl, w)
        self.class_init_probs = probs / w.sum()

    def gradients(self, score):
        p = softmax(score)
        grad = p - self.onehot
        hess = 2.0 * p * (1.0 - p)
        return self._weighted(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        return float(np.log(max(kEpsilon,
                                self.class_init_probs[class_id])))

    def class_need_train(self, class_id: int = 0) -> bool:
        p = self.class_init_probs[class_id]
        return not (abs(p) <= kEpsilon or abs(p) >= 1.0 - kEpsilon)

    def convert_output(self, score):
        return softmax(score)

    def name(self):
        return "multiclass"


class MulticlassOVA(ObjectiveFunction):
    """One-vs-all: k independent sigmoid binary objectives
    (multiclass_objective.hpp:200-273)."""

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        self.num_model_per_iteration = self.num_class
        self.sigmoid = float(config.sigmoid)
        self._binary = [BinaryLogloss(config, is_pos=_IsClass(k))
                        for k in range(self.num_class)]

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        for b in self._binary:
            b.init(metadata, num_data, device)

    def gradients(self, score):
        gh = [self._binary[k].gradients(score[:, k])
              for k in range(self.num_class)]
        return (torch.stack([g for g, _ in gh], dim=1),
                torch.stack([h for _, h in gh], dim=1))

    def boost_from_score(self, class_id: int = 0) -> float:
        return self._binary[class_id].boost_from_score(0)

    def class_need_train(self, class_id: int = 0) -> bool:
        return self._binary[class_id].need_train

    def convert_output(self, score):
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * score))

    def name(self):
        return "multiclassova"


class _IsClass:
    def __init__(self, k: int):
        self.k = k

    def __call__(self, label):
        return np.abs(label - self.k) < 1e-6
