"""Binary log-loss objective (port of ``lightgbm_tpu/objective/binary.py``;
reference ``src/objective/binary_objective.hpp:21-213``).

The float32 arithmetic keeps the JAX expression order term for term,
so the two packages' gradients agree to the last bit wherever their
``exp`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..utils.log import log_fatal, log_info, log_warning
from .base import ObjectiveFunction

kEpsilon = 1e-15


class BinaryLogloss(ObjectiveFunction):

    def __init__(self, config: Config, is_pos=None):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0.0:
            log_fatal(f"Sigmoid parameter {self.sigmoid} should be greater "
                      "than zero")
        self.is_unbalance = bool(config.is_unbalance)
        self.scale_pos_weight = float(config.scale_pos_weight)
        if self.is_unbalance and abs(self.scale_pos_weight - 1.0) > 1e-6:
            log_fatal("Cannot set is_unbalance and scale_pos_weight at the "
                      "same time")
        # which labels are positive (one class of a one-vs-all model)
        self._is_pos = is_pos if is_pos is not None \
            else (lambda label: label > 0)
        self.need_train = True

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        pos_mask = self._is_pos(self.label_np)
        cnt_positive = int(pos_mask.sum())
        cnt_negative = num_data - cnt_positive
        self.need_train = cnt_positive > 0 and cnt_negative > 0
        if not self.need_train:
            log_warning("Contains only one class")
        log_info(f"Number of positive: {cnt_positive}, number of negative: "
                 f"{cnt_negative}")
        w_pos, w_neg = 1.0, 1.0
        if self.is_unbalance and cnt_positive > 0 and cnt_negative > 0:
            if cnt_positive > cnt_negative:
                w_neg = cnt_positive / cnt_negative
            else:
                w_pos = cnt_negative / cnt_positive
        w_pos *= self.scale_pos_weight
        pos = torch.from_numpy(pos_mask).to(self.device)
        self.label_val = torch.where(
            pos, torch.tensor(1.0), torch.tensor(-1.0)).to(self.device)
        self.label_weight = torch.where(
            pos, torch.tensor(w_pos, dtype=torch.float32),
            torch.tensor(w_neg, dtype=torch.float32)).to(self.device)

    def gradients(self, score):
        if not self.need_train:
            return torch.zeros_like(score), torch.zeros_like(score)
        lv = self.label_val
        response = -lv * self.sigmoid \
            / (1.0 + torch.exp(lv * self.sigmoid * score))
        abs_resp = torch.abs(response)
        grad = response * self.label_weight
        hess = abs_resp * (self.sigmoid - abs_resp) * self.label_weight
        return self._weighted(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        pos = self._is_pos(self.label_np).astype(np.float64)
        if self.weights_np is not None:
            w = np.asarray(self.weights_np, np.float64)
            pavg = float((pos * w).sum() / w.sum())
        else:
            pavg = float(pos.mean())
        pavg = min(max(pavg, kEpsilon), 1.0 - kEpsilon)
        initscore = float(np.log(pavg / (1.0 - pavg)) / self.sigmoid)
        log_info(f"[binary:BoostFromScore]: pavg={pavg:.6f} -> "
                 f"initscore={initscore:.6f}")
        return initscore

    def class_need_train(self, class_id: int = 0) -> bool:
        return self.need_train

    def convert_output(self, score):
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * score))

    def name(self):
        return "binary"
