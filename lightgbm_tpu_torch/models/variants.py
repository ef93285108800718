"""Boosting variants: GOSS, DART, RF (port of
``lightgbm_tpu/models/variants.py``; reference ``src/boosting/goss.hpp``,
``dart.hpp``, ``rf.hpp``).

* **GOSS** keeps the rows of the largest ``|g * h|`` (summed over the
  classes) and a Bernoulli sample of the rest, up-weighted, as a weight
  vector on the device (0 / 1 / ``(1 - top_rate) / other_rate``): the
  threshold is ``jnp.quantile``'s linear quantile written out in
  float32 (sort, index, lerp), and the sample is the JAX package's
  ``jax.random`` draw (``utils/threefry.py``), so the weights equal the
  JAX package's. No sampling for the first ``int(1 / learning_rate)``
  iterations.
* **DART** drops trees with the reference's LCG (``utils/ref_random.py``),
  so it drops the JAX package's trees, and re-adds a dropped tree's
  scores by the bin-space walk of the training bins
  (``Tree.predict_binned_add``).
* **RF** grows bagged trees on one-time gradients from the constant
  boost-from-average score, with no shrinkage, and keeps the scores a
  running average (``average_output``).

``create_boosting`` picks the class from ``config.boosting``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..observability.telemetry import get_telemetry
from ..observability.tracing import profile_boundary
from ..utils.log import log_fatal, log_info
from ..utils.ref_random import RefRandom
from ..utils.threefry import Key, fold_in, uniform
from .gbdt import GBDT, kEpsilon
from .tree import constant_tree


def quantile_linear_f32(s: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(s, q)`` (method "linear") of a float32 vector, in
    float32: ``q * (n - 1)`` gives the two neighbouring order statistics
    and their weights, then ``low * (1 - w) + high * w``. A NaN anywhere
    makes it NaN, as in JAX."""
    f32 = torch.float32
    n = s.shape[0]
    srt = torch.sort(s)[0]
    pos = torch.tensor(np.float32(q) * np.float32(n - 1), dtype=f32)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    hw = (pos - low).to(s.device)
    lw = torch.ones((), dtype=f32, device=s.device) - hw
    lo = int(min(max(float(low), 0.0), n - 1))
    hi = int(min(max(float(high), 0.0), n - 1))
    out = srt[lo] * lw + srt[hi] * hw
    return torch.where(torch.isnan(s).any(),
                       torch.full_like(out, float("nan")), out)


def goss_weights(grad: torch.Tensor, hess: torch.Tensor, key: Key, *,
                 top_rate: float, other_rate: float) -> torch.Tensor:
    """Per-row GOSS weights, float32 [N] (JAX ``variants.py:37
    _goss_weights``); ``grad``/``hess`` [N, k]."""
    s = torch.abs(grad[:, 0] * hess[:, 0])
    for j in range(1, grad.shape[1]):
        s = s + torch.abs(grad[:, j] * hess[:, j])
    thr = quantile_linear_f32(s, 1.0 - top_rate)
    top = s >= thr
    p_rest = other_rate / max(1e-12, 1.0 - top_rate)
    u = uniform(key, s.shape[0], s.device)
    sampled = (u < torch.tensor(p_rest, dtype=torch.float32,
                                device=s.device)) & ~top
    multiply = torch.tensor((1.0 - top_rate) / other_rate,
                            dtype=torch.float32, device=s.device)
    return top.to(torch.float32) + sampled.to(torch.float32) * multiply


class GOSS(GBDT):
    """Gradient-based One-Side Sampling (goss.hpp)."""

    def __init__(self, config, train_data, device, ops: str = "kernel"):
        if not (0.0 < config.top_rate and 0.0 < config.other_rate
                and config.top_rate + config.other_rate <= 1.0):
            log_fatal("GOSS requires top_rate > 0, other_rate > 0 and "
                      "top_rate + other_rate <= 1")
        if config.bagging_freq > 0 and config.bagging_fraction != 1.0:
            log_fatal("Cannot use bagging in GOSS")
        log_info("Using GOSS")
        super().__init__(config, train_data, device, ops=ops)

    def _bagging_weight(self, it: int, grad=None,
                        hess=None) -> Optional[torch.Tensor]:
        # no sampling for the first 1 / learning_rate iterations
        # (goss.hpp:129)
        if it < int(1.0 / self.config.learning_rate) or grad is None:
            self.bag_weight = None
            return None
        self.bag_weight = goss_weights(
            grad, hess, fold_in(self._bag_key, it),
            top_rate=float(self.config.top_rate),
            other_rate=float(self.config.other_rate))
        return self.bag_weight


class DART(GBDT):
    """Dropout Additive Regression Trees (dart.hpp)."""

    def __init__(self, config, train_data, device, ops: str = "kernel"):
        super().__init__(config, train_data, device, ops=ops)
        self._drop_rng = RefRandom(config.drop_seed)
        self._tree_weight: List[float] = []
        self._sum_weight = 0.0
        self._drop_index: List[int] = []

    def _dropping_trees(self) -> None:
        """DroppingTrees (dart.hpp:100-146)."""
        cfg = self.config
        self._drop_index = []
        if self._drop_rng.next_float() >= cfg.skip_drop:
            drop_rate = cfg.drop_rate
            if not cfg.uniform_drop and self._sum_weight > 0:
                inv_avg = len(self._tree_weight) / self._sum_weight
                if cfg.max_drop > 0:
                    drop_rate = min(
                        drop_rate, cfg.max_drop * inv_avg / self._sum_weight)
                for i in range(self.iter):
                    if self._drop_rng.next_float() < (
                            drop_rate * self._tree_weight[i] * inv_avg):
                        self._drop_index.append(i)
                        if len(self._drop_index) >= cfg.max_drop > 0:
                            break
            else:
                if cfg.max_drop > 0 and self.iter > 0:
                    drop_rate = min(drop_rate, cfg.max_drop / self.iter)
                for i in range(self.iter):
                    if self._drop_rng.next_float() < drop_rate:
                        self._drop_index.append(i)
                        if len(self._drop_index) >= cfg.max_drop > 0:
                            break
        # take the dropped trees out of the training scores
        k = self.num_tree_per_iteration
        for i in self._drop_index:
            for tid in range(k):
                tree = self.models[i * k + tid]
                tree.shrink(-1.0)
                self._add_tree_score(tree, tid, train=True, valid=False)
                tree.shrink(-1.0)
        ndrop = len(self._drop_index)
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = cfg.learning_rate / (1.0 + ndrop)
        else:
            self.shrinkage_rate = cfg.learning_rate if ndrop == 0 else \
                cfg.learning_rate / (cfg.learning_rate + ndrop)

    def _normalize(self) -> None:
        """Normalize (dart.hpp:148-196): a dropped tree ends at
        k / (k + 1) of its weight (k / (k + lr) in xgboost mode), the
        train and valid scores with it."""
        cfg = self.config
        kdrop = float(len(self._drop_index))
        if kdrop == 0:
            return
        k = self.num_tree_per_iteration
        factor = kdrop / (kdrop + 1.0) if not cfg.xgboost_dart_mode \
            else kdrop / (kdrop + cfg.learning_rate)
        for i in self._drop_index:
            for tid in range(k):
                tree = self.models[i * k + tid]
                # valid kept the whole tree: take the (1 - factor) slice
                tree.shrink(-(1.0 - factor))
                self._add_tree_score(tree, tid, train=False, valid=True)
                # train had it taken out: add factor x tree back
                tree.shrink(-factor / (1.0 - factor))
                self._add_tree_score(tree, tid, train=True, valid=False)
            if not cfg.uniform_drop:
                self._sum_weight -= self._tree_weight[i] * (1.0 - factor)
                self._tree_weight[i] *= factor
        for i in self._drop_index:
            for tid in range(k):
                self.models[i * k + tid].shrinkage = 1.0

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        self._dropping_trees()
        if super().train_one_iter(gradients, hessians):
            return True
        self._normalize()
        if not self.config.uniform_drop:
            self._tree_weight.append(self.shrinkage_rate)
            self._sum_weight += self.shrinkage_rate
        return False

    def _eval_and_check_early_stopping(self) -> bool:
        # DART cannot stop early: the drop bookkeeping would not match a
        # truncated model (dart.hpp:93-96)
        self.output_metric(self.iter)
        return False


class RF(GBDT):
    """Random forest mode (rf.hpp): bagged trees on one-time gradients,
    averaged output, no shrinkage."""

    def __init__(self, config, train_data, device, ops: str = "kernel"):
        if not (config.bagging_freq > 0
                and 0.0 < config.bagging_fraction < 1.0):
            log_fatal("RF mode requires bagging "
                      "(bagging_freq > 0 and bagging_fraction in (0,1))")
        if not (0.0 < config.feature_fraction <= 1.0):
            log_fatal("RF mode requires feature_fraction in (0, 1]")
        super().__init__(config, train_data, device, ops=ops)
        self.average_output = True
        self.shrinkage_rate = 1.0
        if self._has_init_score:
            log_fatal("RF mode does not support init score")
        self._rf_boosting()

    def _rf_boosting(self) -> None:
        """One-time gradients from the constant boost-from-average
        score (rf.hpp:84-103)."""
        if self.objective is None:
            log_fatal("RF mode does not support custom objective "
                      "functions, please use built-in objectives")
        k = self.num_tree_per_iteration
        self._init_scores = [
            float(self.objective.boost_from_score(tid))
            if self.config.boost_from_average else 0.0 for tid in range(k)]
        tmp = torch.as_tensor(np.float32(self._init_scores),
                              device=self.device).repeat(self.num_data, 1)
        g, h = self.objective.gradients(tmp if k > 1 else tmp[:, 0])
        if k == 1:
            g, h = g[:, None], h[:, None]
        self._rf_grad, self._rf_hess = g, h

    def _multiply_scores(self, tid: int, val: float) -> None:
        self.train_score[:, tid] *= val
        for vs in self.valid_scores:
            vs[:, tid] *= val

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """rf.hpp:105-160: the running-average score update."""
        if gradients is not None or hessians is not None:
            log_fatal("RF mode does not support custom objective gradients")
        k = self.num_tree_per_iteration
        bag = self._bagging_weight(self.iter, self._rf_grad, self._rf_hess)
        fmask = self._feature_mask()
        for tid in range(k):
            tree = None
            if self.class_need_train[tid] \
                    and self.train_data.num_features > 0:
                tree, leaf_id = self.learner.train(
                    self._rf_grad[:, tid].contiguous(),
                    self._rf_hess[:, tid].contiguous(),
                    feature_mask=fmask, bag_weight=bag)
            if tree is not None and tree.num_leaves > 1:
                self._renew_tree_output(tree, torch.full(
                    (self.num_data,), np.float32(self._init_scores[tid]),
                    dtype=torch.float32, device=self.device), leaf_id)
                if abs(self._init_scores[tid]) > kEpsilon:
                    tree.add_bias(self._init_scores[tid])
                self._multiply_scores(tid, float(self.iter))
                self._update_scores(tree, leaf_id, tid)
                self._multiply_scores(tid, 1.0 / (self.iter + 1))
            else:
                output = 0.0
                if len(self.models) < k \
                        and not self.class_need_train[tid] \
                        and self.objective is not None:
                    output = float(self.objective.boost_from_score(tid))
                tree = constant_tree(output)
                if len(self.models) < k:
                    self._multiply_scores(tid, float(self.iter))
                    self._add_score(tid, float(tree.leaf_value[0]))
                    self._multiply_scores(tid, 1.0 / (self.iter + 1))
            self.models.append(tree)
        self.iter += 1
        get_telemetry().end_iteration(self.iter - 1, trees=k,
                                      num_data=self.num_data,
                                      bag_fraction=float(
                                          self.config.bagging_fraction))
        profile_boundary("iter")
        return False


_BOOSTING_CLASSES = {"gbdt": GBDT, "gbrt": GBDT, "dart": DART,
                     "goss": GOSS, "rf": RF, "random_forest": RF}


def create_boosting(config, train_data, device, ops: str = "kernel") -> GBDT:
    """Boosting::CreateBoosting (src/boosting/boosting.cpp:35-68)."""
    cls = _BOOSTING_CLASSES.get(config.boosting)
    if cls is None:
        log_fatal(f"unknown boosting type {config.boosting}")
    return cls(config, train_data, device, ops=ops)
