"""auc_mu, the multiclass AUC of Kleiman & Page (ICML'19) (port of
``lightgbm_tpu/metric/multiclass_extra.py``; reference ``AucMuMetric``,
src/metric/multiclass_metric.hpp:183-300).

For every class pair (i, j) the raw scores are projected onto
``v = w[i] - w[j]`` scaled by ``t1 = v[i] - v[j]``; each class-i point
counts the class-j points at a smaller distance plus half those at the
same distance (the reference sorts class j first within a tie), over
``n_i * n_j``. Every count is an integer or a half, so the pair's sum is
exact: the port sorts all rows once a pair on the device, with rows of
other classes pushed past the end, and counts through cumulative sums.
Sample weights are ignored, as the reference's ``Init`` reads only the
label; a class without data makes its pairs NaN (the reference's 0/0).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.log import log_fatal
from .metrics import Metric, group_bounds


class AucMuMetric(Metric):
    name = "auc_mu"
    factor_to_bigger_better = 1.0

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        c = int(self.config.num_class)
        if c < 2:
            log_fatal("auc_mu requires num_class >= 2")
        w = self.config.auc_mu_weights
        if w:
            if len(w) != c * c:
                log_fatal(
                    f"auc_mu_weights must have {c * c} elements "
                    f"(num_class^2), got {len(w)}")
            cw = np.asarray(w, np.float64).reshape(c, c)
        else:
            # all ones off the diagonal (Config::GetAucMuWeights,
            # src/io/config.cpp:156-178)
            cw = np.ones((c, c), np.float64)
            np.fill_diagonal(cw, 0.0)
        self.class_weights = torch.from_numpy(cw).to(self.device)
        self.num_class = c
        lbl = self.label_np.astype(np.int64)
        self._lbl = torch.from_numpy(lbl).to(self.device)
        self._class_size = np.bincount(lbl, minlength=c)

    def eval(self, score, pred):
        c = self.num_class
        if score.ndim != 2 or score.shape[1] != c:
            log_fatal(f"auc_mu expects [num_data, num_class] scores, got "
                      f"shape {tuple(score.shape)} for num_class={c}")
        score = score.to(torch.float64)
        total = torch.zeros((), dtype=torch.float64, device=score.device)
        for i in range(c):
            for j in range(i + 1, c):
                if self._class_size[i] == 0 or self._class_size[j] == 0:
                    total = total + float("nan")  # reference: S/(0*n)
                    continue
                total = total + self._pair_auc(score, i, j)
        return [2.0 * total / (c * (c - 1))]

    def _pair_auc(self, score, i, j) -> torch.Tensor:
        v = self.class_weights[i] - self.class_weights[j]
        t1 = v[i] - v[j]
        is_i = self._lbl == i
        is_j = self._lbl == j
        d = torch.where(is_i | is_j, t1 * (score @ v), float("inf"))
        order = torch.sort(d, stable=True)[1]
        d, is_i, is_j = d[order], is_i[order], is_j[order]
        start, end = group_bounds(torch.cat(
            [d.new_ones(1, dtype=torch.bool), d[1:] != d[:-1]]))
        cum_j = torch.cumsum(is_j.to(torch.float64), 0)
        j_before = torch.where(start > 0, cum_j[(start - 1).clamp(min=0)],
                               torch.zeros_like(cum_j))
        j_same = cum_j[end] - j_before
        contrib = torch.where(is_i, j_before + 0.5 * j_same,
                              torch.zeros_like(cum_j))
        return contrib.sum() / float(self._class_size[i]
                                     * self._class_size[j])
