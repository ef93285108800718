"""GBDT boosting driver (port of the core of
``lightgbm_tpu/models/gbdt.py``; reference ``GBDT``,
src/boosting/gbdt.cpp:42-780).

Covered: ``boost_from_average`` per class (gbdt.cpp:312-335),
``train_one_iter`` with k trees an iteration, each on its own column of
the gradients (gradients -> grow -> leaf refit -> shrinkage -> score
update -> bias, with the constant-tree fallback per class,
gbdt.cpp:337-419), custom gradients (``fobj``), valid sets scored by a
bin-space walk of each new tree on the device, the training and valid
metrics (``eval_metrics``: one host read an eval boundary),
``output_metric`` with ``early_stopping_round``, ``first_metric_only``
and ``metric_freq`` (gbdt.cpp:439-542), and continued training from an
existing model's trees (``init_from_models``), and bagging
(gbdt.cpp:163-243; balanced on the label too): each row's 0/1 weight
is the JAX package's ``jax.random`` draw for the iteration
(``bag_mask``, through ``utils/threefry.py``), made on the device and
handed to the learner, which packs ``grad * w``, ``hess * w`` and the
count ``w > 0``. Scores and gradients live on the training device as
float32 ``[N, k]``; trees live on the host. GOSS, DART and RF are
subclasses (``models/variants.py``). With ``linear_tree`` each grown tree
gets its leaf models (``models/linear.py``) before the leaf refit and
shrinkage, and the scores add them over the datasets' raw values.
``refit`` replays a model's trees on this booster's rows to refit their
leaf values (the per-leaf sums through the ``hist_rows`` kernel), and
``rollback_one_iter`` takes the last iteration's trees off the scores.

The robustness and observability planes (``robustness/``,
``observability/``) hook in here as in the JAX package: the ``grad`` /
``grow`` / ``tree`` / ``update`` phase spans, an ``iter`` telemetry
record an iteration (with its kernel launches), the ``nan_grad`` fault
and the non-finite guard after the gradients (``guard_policy``:
``skip_iter`` appends a constant tree a class), and ``train_end`` with
the one-time phase probe. None of them changes a number.
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.dataset import Dataset
from ..metric import create_metrics
from ..metric.metrics import batched_eval
from ..objective import create_objective
from ..observability.telemetry import get_telemetry, memory_snapshot
from ..observability.tracing import (get_tracer, profile_boundary,
                                     profile_close)
from ..ops import _native
from ..parallel.distributed import current_world
from ..parallel.learners import create_tree_learner
from ..robustness.guards import NonFiniteGradientError
from ..utils.log import log_fatal, log_info, log_warning
from ..utils.threefry import Key, fold_in, prng_key, uniform
from .linear import fit_linear_leaves, linear_leaf_values
from .tree import Tree, constant_tree

kEpsilon = 1e-15


def init_score_matrix(init, num_data: int, k: int) -> np.ndarray:
    """[N, k] start scores from a flat init score: ``N * k`` values are
    class-major (k blocks of N, the reference's layout), N values go to
    every class."""
    arr = np.asarray(init, np.float64)
    if arr.size == num_data * k:
        return arr.reshape(k, num_data).T
    return np.tile(arr.reshape(-1)[:, None], (1, k))


def coerce_custom_grad(arr, num_data: int, k: int,
                       device) -> torch.Tensor:
    """Custom gradients as float32 [N, k] on the device: [N], [N, k],
    [k, N] or the reference's flat [k * N] (k blocks of N)."""
    a = np.asarray(arr, np.float32)
    if a.ndim == 1:
        if a.size == num_data:
            a = a[:, None]
        elif a.size == num_data * k:
            a = a.reshape(k, num_data).T
        else:
            log_fatal(f"custom gradient length {a.size} does not match "
                      f"num_data*num_class {num_data * k}")
    elif a.shape == (k, num_data):
        a = a.T
    elif a.shape != (num_data, k):
        log_fatal(f"custom gradient shape {a.shape} does not match "
                  f"({num_data}, {k})")
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def bag_mask(key0: Key, it: int, n: int, device, *, freq: int,
             frac: float, pos_frac: float = 1.0, neg_frac: float = 1.0,
             label: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row 0/1 float32 bagging weights of iteration ``it`` (JAX
    ``models/gbdt.py:168 _bag_mask_core``): the iteration collapses to
    its ``bagging_freq`` boundary, the key is ``fold_in(key0, it)``,
    and a row is in the bag when its uniform draw is below
    ``frac`` (or, with ``label``, below ``pos_frac`` for a positive
    label and ``neg_frac`` otherwise), compared in float32."""
    it_eff = it - it % max(int(freq), 1)
    u = uniform(fold_in(key0, it_eff), n, device)
    f32 = torch.float32
    if label is None:
        thr = torch.tensor(frac, dtype=f32, device=device)
    else:
        thr = torch.where(label > 0,
                          torch.tensor(pos_frac, dtype=f32, device=device),
                          torch.tensor(neg_frac, dtype=f32, device=device))
    return (u < thr).to(f32)


class GBDT:
    """Gradient Boosting Decision Tree driver on one device."""

    def __init__(self, config: Config, train_data: Dataset,
                 device: torch.device, ops: str = "kernel"):
        self.config = config
        self.train_data = train_data
        self.device = torch.device(device)
        tel = get_telemetry()
        tel.ensure_started(config)
        tel.count("train.rows", train_data.num_data)
        # the kernel library's build directory (JAX gbdt.py:282-283)
        _native.maybe_enable_compile_cache(config)
        # the kernels' plain versions (the CPU, or ops="plain" on the
        # card): the learner's, and refit's per-leaf sums
        self.plain = ops == "plain" or self.device.type == "cpu"
        self.objective = create_objective(config)
        self.num_class = int(config.num_class)
        self.num_tree_per_iteration = (
            self.objective.num_model_per_iteration
            if self.objective is not None else self.num_class)
        self.models: List[Tree] = []
        self.iter = 0
        self.shrinkage_rate = float(config.learning_rate)
        self.valid_sets: List[Dataset] = []
        self.valid_names: List[str] = []
        self.valid_metrics: List[list] = []
        self.valid_scores: List[torch.Tensor] = []
        self.training_metrics: list = []
        self.best_iter: Dict = {}
        self.best_score: Dict = {}
        self.best_msg: Dict = {}
        self.evals_result: Dict[str, Dict[str, list]] = {}
        self.learner = create_tree_learner(config.tree_learner, train_data,
                                           config, self.device, ops=ops)
        self.num_data = train_data.num_data
        if self.objective is not None:
            self.objective.init(train_data.metadata, self.num_data,
                                self.device)
        # the L1 family's leaf refit over ranks that hold their own rows
        # (pre_partition): every rank's rows, gathered (_renew_gathered)
        self._renew_weights = None
        self._renew_over_ranks = self.objective is not None \
            and self.objective.is_renew_tree_output \
            and bool(getattr(self.learner, "local_data", False))
        k = self.num_tree_per_iteration
        init = train_data.metadata.init_score
        self._has_init_score = init is not None
        score0 = np.zeros((self.num_data, k)) if init is None \
            else init_score_matrix(init, self.num_data, k)
        self.train_score = torch.as_tensor(score0, dtype=torch.float32,
                                           device=self.device)
        self.class_need_train = [
            self.objective.class_need_train(i)
            if self.objective is not None else True for i in range(k)]
        if config.is_provide_training_metric:
            self.training_metrics = self._metrics_for(train_data)
        self._feature_rng = np.random.RandomState(
            config.feature_fraction_seed)
        self._bag_key = prng_key(config.bagging_seed)
        self._bag_label: Optional[torch.Tensor] = None
        self.bag_weight: Optional[torch.Tensor] = None
        # linear leaves (models/linear.py): fit after each grow, scored
        # on raw values; off, with a warning, where they cannot be
        # (JAX gbdt.py:329-359)
        self._linear_on = bool(config.linear_tree)
        if self._linear_on:
            if self.objective is not None \
                    and self.objective.is_renew_tree_output:
                log_warning(
                    "linear_tree is not supported with objective "
                    f"{self.objective.name()} (its percentile leaf "
                    "refit overwrites leaf outputs); using constant "
                    "leaves")
                self._linear_on = False
            elif train_data.raw_numeric is None \
                    or train_data.num_features == 0:
                log_warning(
                    "linear_tree needs the raw numeric matrix on a "
                    "single-device learner (in-memory dense data); "
                    "using constant leaves")
                self._linear_on = False

    @property
    def num_iterations_trained(self) -> int:
        return len(self.models) // self.num_tree_per_iteration

    def _metrics_for(self, data: Dataset) -> list:
        metrics = create_metrics(self.config.resolved_metrics(), self.config)
        for m in metrics:
            m.init(data.metadata, data.num_data, self.device)
        return metrics

    def add_valid(self, valid_data: Dataset, name: str) -> None:
        """A valid set binned with the training set's mappers: its
        metrics and its scores (its init score, or zeros)."""
        if self._linear_on and valid_data.raw_numeric is None:
            log_warning(
                f"valid set {name!r} carries no raw numeric matrix; "
                "linear_tree falls back to constant leaves")
            self._linear_on = False
        self.valid_sets.append(valid_data)
        self.valid_names.append(name)
        self.valid_metrics.append(self._metrics_for(valid_data))
        k = self.num_tree_per_iteration
        init = valid_data.metadata.init_score
        score0 = np.zeros((valid_data.num_data, k)) if init is None \
            else init_score_matrix(init, valid_data.num_data, k)
        self.valid_scores.append(torch.as_tensor(
            score0, dtype=torch.float32, device=self.device))

    def init_from_models(self, models: List[Tree],
                         train_add: Optional[torch.Tensor] = None,
                         valid_adds=()) -> None:
        """Continued training (GBDT::LoadModelFromString + the resume
        of boosting.cpp:35-68): adopt an existing model's trees and add
        their raw float64 sums, rounded to float32, to the train and
        valid scores, so the next ``train_one_iter`` boosts on the right
        residuals (and skips boost_from_average, as there are trees)."""
        self.models = list(models)
        self.iter = len(models) // self.num_tree_per_iteration
        for score, add in [(self.train_score, train_add)] \
                + list(zip(self.valid_scores, valid_adds)):
            if add is not None:
                add = torch.as_tensor(add).to(self.device, torch.float32)
                score += add.reshape(score.shape[0], -1)

    # ------------------------------------------------------------------
    def _bagging_need(self) -> bool:
        cfg = self.config
        return cfg.bagging_freq > 0 and (
            cfg.bagging_fraction < 1.0 or cfg.pos_bagging_fraction < 1.0
            or cfg.neg_bagging_fraction < 1.0)

    def _bagging_weight(self, it: int, grad=None,
                        hess=None) -> Optional[torch.Tensor]:
        """The rows' bagging weights for iteration ``it`` (JAX
        ``gbdt.py:403``), on the device with no host read; the draw of
        a ``bagging_freq`` boundary is kept until the next one.
        ``grad``/``hess`` [N, k] are for gradient-based sampling
        (GOSS)."""
        cfg = self.config
        if not self._bagging_need():
            return None
        if it % cfg.bagging_freq != 0 and self.bag_weight is not None:
            return self.bag_weight
        label = None
        if cfg.pos_bagging_fraction < 1.0 or cfg.neg_bagging_fraction < 1.0:
            if self._bag_label is None:
                self._bag_label = torch.as_tensor(
                    np.asarray(self.train_data.metadata.label),
                    dtype=torch.float32, device=self.device)
            label = self._bag_label
        self.bag_weight = bag_mask(
            self._bag_key, it, self.num_data, self.device,
            freq=cfg.bagging_freq, frac=cfg.bagging_fraction,
            pos_frac=cfg.pos_bagging_fraction,
            neg_frac=cfg.neg_bagging_fraction, label=label)
        return self.bag_weight

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

    def _add_score(self, tid: int, value: float) -> None:
        self.train_score[:, tid] += value
        for vs in self.valid_scores:
            vs[:, tid] += value

    def boost_from_average(self, class_id: int) -> float:
        """gbdt.cpp:312-335."""
        if self.models or self._has_init_score or self.objective is None:
            return 0.0
        if self.config.boost_from_average \
                or self.train_data.num_features == 0:
            init_score = float(self._objective_of_all_rows().boost_from_score(
                class_id))
            if abs(init_score) > kEpsilon:
                self._add_score(class_id, init_score)
                log_info(f"Start training from score {init_score:.6f}")
                return init_score
        elif self.objective.name() in ("regression_l1", "quantile", "mape"):
            log_warning(
                f"Disabling boost_from_average in {self.objective.name()} "
                "may cause the slow convergence")
        return 0.0

    def _objective_of_all_rows(self):
        """The objective, or with ``pre_partition`` in a process group
        (each rank holds its own rows) one over every rank's labels and
        weights, gathered in rank order: the init score is the single
        process's on the same rows."""
        from ..parallel.distributed import gather_rows
        if not self.config.pre_partition or current_world() is None:
            return self.objective
        md = self.train_data.metadata
        label = gather_rows(np.asarray(md.label, np.float64))
        weights = None if md.weights is None else gather_rows(
            np.asarray(md.weights, np.float64))
        obj = create_objective(self.config)
        obj.init(SimpleNamespace(label=label, weights=weights,
                                 query_boundaries=None, init_score=None),
                 len(label), "cpu")
        return obj

    def gradients(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The objective's float32 gradients and hessians, [N, k]."""
        k = self.num_tree_per_iteration
        score = self.train_score if k > 1 else self.train_score[:, 0]
        grad, hess = self.objective.gradients(score)
        if k == 1:
            grad, hess = grad[:, None], hess[:, None]
        return grad, hess

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """Returns True when training should STOP (no more valid
        splits), mirroring GBDT::TrainOneIter (gbdt.cpp:337-419).
        ``gradients`` / ``hessians`` are a custom objective's."""
        k = self.num_tree_per_iteration
        tel = get_telemetry()
        init_scores = [0.0] * k
        with tel.span("grad", phase=True):
            if gradients is None or hessians is None:
                if self.objective is None:
                    log_fatal("No objective function provided")
                for tid in range(k):
                    init_scores[tid] = self.boost_from_average(tid)
                tel.count_iter("host.dispatches")
                grad, hess = self.gradients()
            else:
                grad = coerce_custom_grad(gradients, self.num_data, k,
                                          self.device)
                hess = coerce_custom_grad(hessians, self.num_data, k,
                                          self.device)
            bag = self._bagging_weight(self.iter, grad, hess)
            fmask = self._feature_mask()
            try:
                grad = self._check_gradients(grad, hess)
            except NonFiniteGradientError as e:
                if e.policy == "skip_iter":
                    self.skip_iteration()
                    return False
                raise
        should_continue = False
        new_trees: List[Tree] = []
        for tid in range(k):
            tree = None
            if self.class_need_train[tid] \
                    and self.train_data.num_features > 0:
                # each tree trains on its own contiguous column
                with tel.span("grow", phase=True):
                    tree, leaf_id = self.learner.train(
                        grad[:, tid].contiguous(),
                        hess[:, tid].contiguous(),
                        feature_mask=fmask, bag_weight=bag)
            if tree is not None and tree.num_leaves > 1:
                should_continue = True
                with tel.span("tree", phase=True):
                    if self._linear_on:
                        # the leaves' batched ridge fit; one host read
                        # of the coefficients
                        tel.count_iter("host.syncs")
                        tel.count_iter("host.dispatches")
                        fit_linear_leaves(tree, self.train_data,
                                          self.config, leaf_id,
                                          grad[:, tid], hess[:, tid], bag)
                    self._renew_tree_output(
                        tree, self.train_score[:, tid], leaf_id)
                    tree.shrink(self.shrinkage_rate)
                with tel.span("update", phase=True):
                    tel.count_iter("host.dispatches",
                                   1 + len(self.valid_sets))
                    self._update_scores(tree, leaf_id, tid)
                if abs(init_scores[tid]) > kEpsilon:
                    tree.add_bias(init_scores[tid])
            else:
                # constant-tree fallback, first iteration only
                output = 0.0
                if len(self.models) < k:
                    if not self.class_need_train[tid]:
                        if self.objective is not None:
                            output = float(
                                self.objective.boost_from_score(tid))
                    else:
                        output = init_scores[tid]
                    self._add_score(tid, output)
                tree = constant_tree(output)
            new_trees.append(tree)
        if not should_continue:
            log_warning("Stopped training because there are no more "
                        "leaves that meet the split requirements")
            # keep first-iteration constant trees, drop later no-op
            # trees (gbdt.cpp:407-415)
            if not self.models:
                self.models.extend(new_trees)
            return True
        self.models.extend(new_trees)
        self.iter += 1
        tel.end_iteration(
            self.iter - 1, trees=k, num_data=self.num_data,
            bag_fraction=float(self.config.bagging_fraction)
            if bag is not None else 1.0)
        profile_boundary("iter")
        return False

    def _check_gradients(self, grad: torch.Tensor,
                         hess: torch.Tensor) -> torch.Tensor:
        """The ``nan_grad`` fault (NaN, or +inf with ``value=inf``, at
        ``[0, 0]`` of the iteration's gradients) and the non-finite
        guard (``robustness/guards.py``: one device reduction, one host
        read). Returns the (possibly poisoned) gradients; raises
        ``NonFiniteGradientError`` when the guard trips under a
        non-``off`` policy (``skip_iter`` is the caller's; ``raise`` and
        ``rollback`` go to the training driver)."""
        from ..robustness.faults import get_fault_plan
        from ..robustness.guards import finite_ok_device
        plan = get_fault_plan()
        if plan is not None:
            f = plan.take("nan_grad", iteration=self.iter)
            if f is not None:
                val = float("inf") if str(f.params.get("value", "")) \
                    == "inf" else float("nan")
                grad = grad.clone()
                grad[0, 0] = val
        policy = self.config.guard_policy
        if policy == "off":
            return grad
        tel = get_telemetry()
        tel.count_iter("host.dispatches")
        tel.count_iter("host.syncs")
        if bool(finite_ok_device(grad, hess).item()):
            return grad
        tel.count("guard.nonfinite_iters")
        log_warning(f"guard: non-finite gradients at iteration "
                    f"{self.iter} (policy={policy})")
        raise NonFiniteGradientError(self.iter, policy)

    def skip_iteration(self) -> None:
        """``guard_policy=skip_iter``: advance one iteration with a
        no-op constant tree per class so the model stays aligned with
        the iteration counter (checkpoint/resume and model truncation
        both index models by iteration)."""
        k = self.num_tree_per_iteration
        for _tid in range(k):
            self.models.append(constant_tree(0.0))
        self.iter += 1
        tel = get_telemetry()
        tel.count("guard.skipped_iters")
        tel.end_iteration(self.iter - 1, trees=k, skipped=True,
                          num_data=self.num_data)

    def _renew_tree_output(self, tree: Tree, score: torch.Tensor,
                           leaf_id: torch.Tensor) -> None:
        """The L1 family's leaf refit (serial_tree_learner.cpp:720-758)
        against ``score``, on the training device, over the rows in the
        bag only (JAX ``gbdt.py:670-693``): out-of-bag rows go to an
        extra last leaf, whose value is dropped. The refit values are
        read to the host tree once."""
        if self.objective is None or not self.objective.is_renew_tree_output:
            return
        nl = tree.num_leaves
        if self._renew_over_ranks:
            vals = self._renew_gathered(score, leaf_id, nl)
            tree.leaf_value = vals.cpu().numpy()[:nl]
            return
        if self.bag_weight is not None:
            leaf_id = torch.where(self.bag_weight > 0, leaf_id.long(),
                                  torch.full_like(leaf_id.long(), nl))
        vals = self.objective.renew_tree_output(score, leaf_id, nl + 1)
        get_telemetry().count_iter("host.syncs")
        tree.leaf_value = vals.cpu().numpy()[:nl]

    def _renew_gathered(self, score: torch.Tensor, leaf_id: torch.Tensor,
                        nl: int) -> torch.Tensor:
        """The leaf refit of a rank that holds its own rows
        (``pre_partition``): every rank's residuals (float32 label -
        score, then float64, as the objective forms them), refit weights
        (gathered once) and leaf ids (out-of-bag rows -1, as JAX
        ``gbdt.py:670-693`` marks them), in rank order, host-gathered;
        every rank then takes the same percentiles, so every rank keeps
        the same tree."""
        from ..ops.percentile import renew_leaf_outputs
        from ..parallel.distributed import gather_rows
        obj = self.objective
        tel = get_telemetry()
        tel.count_iter("host.syncs", 2)
        residual = gather_rows((obj.label - score).to(torch.float64)
                               .cpu().numpy())
        lid = leaf_id.long()
        if self.bag_weight is not None:
            lid = torch.where(self.bag_weight > 0, lid,
                              torch.full_like(lid, -1))
        lid = gather_rows(lid.cpu().numpy())
        if self._renew_weights is None:
            w = obj._refit_weights()
            self._renew_weights = (None,) if w is None else (
                torch.from_numpy(gather_rows(w.cpu().numpy())).to(
                    self.device),)
        lid = np.where(lid < 0, nl, lid)
        return renew_leaf_outputs(
            torch.from_numpy(residual).to(self.device),
            torch.from_numpy(lid).to(self.device), nl + 1,
            self._renew_weights[0], obj.renew_alpha)

    def _add_tree_score(self, tree: Tree, tid: int, train: bool,
                        valid: bool) -> None:
        """Add ``tree`` (at its current leaf values) to the train scores
        and/or every valid set's, by its bin-space walk."""
        if train:
            tree.predict_binned_add(self.train_score, tid,
                                    *_walk_inputs(self.train_data,
                                                  self.device))
        if valid:
            for vd, vs in zip(self.valid_sets, self.valid_scores):
                tree.predict_binned_add(vs, tid,
                                        *_walk_inputs(vd, self.device))

    def _update_scores(self, tree: Tree, leaf_id: torch.Tensor,
                       tid: int) -> None:
        """Train score += the leaf value of each row's leaf (the learner
        knows every row's leaf); each valid set's by a bin-space walk of
        the tree."""
        if tree.is_linear:
            self.train_score[:, tid] += linear_leaf_values(
                tree, leaf_id, self.train_data.raw_numeric_device(
                    self.device))
        else:
            vals = torch.as_tensor(tree.leaf_value.astype(np.float32),
                                   device=self.device)
            self.train_score[:, tid] += vals[leaf_id]
        for vd, vs in zip(self.valid_sets, self.valid_scores):
            tree.predict_binned_add(vs, tid, *_walk_inputs(vd, self.device))

    # ------------------------------------------------------------------
    def refit(self, leaf_preds: np.ndarray,
              raw: Optional[np.ndarray] = None) -> None:
        """RefitTree (gbdt.cpp:266-289) + FitByExistingTree
        (serial_tree_learner.cpp:194-224; JAX ``GBDT.refit``): keep every
        tree's structure and refit its leaf values on this booster's
        training data by replaying the iterations from a zero score: the
        objective's gradients at the current score over every row (no
        bagging or GOSS), each tree's per-leaf sums of (grad, hess, 1)
        (``hist_cuda.leaf_histogram``: the ``hist_rows`` kernel), the
        leaf output, ``decay * old + (1 - decay) * output * shrinkage``
        and the score update, all on the device in float32 as the JAX
        package's program does. The refit outputs are read to the host
        once, after the last tree, and blended into the float64 leaf
        values. A linear tree also refits each leaf's ridge model over
        its features (``models/linear.py``'s float64 sums and batched
        solve; a gated leaf decays toward the constant output) from
        ``raw``, the refit rows' raw matrix by original feature, or else
        the training set's ``raw_numeric``. ``leaf_preds`` [N, trees]:
        each row's leaf in every tree (``predict(pred_leaf=True)``)."""
        from ..ops.hist_cuda import leaf_histogram
        from ..ops.split import leaf_output_no_constraint
        from .linear import fit_linear_device, linear_values
        dev = self.device
        raw_dev, use_inner = None, False
        if any(t.is_linear for t in self.models):
            if raw is not None:
                raw_dev = torch.as_tensor(np.asarray(raw, np.float32),
                                          device=dev)
            elif self.train_data.raw_numeric is not None:
                raw_dev = self.train_data.raw_numeric_device(dev)
                use_inner = True
            else:
                from ..utils.log import LightGBMError
                raise LightGBMError(
                    "refit_linear_raw_missing: refit of a linear_tree=true "
                    "model must re-fit the per-leaf linear coefficients, "
                    "which needs the raw feature matrix of the refit data; "
                    "pass raw= (Booster.refit does) or construct the "
                    "training Dataset with linear_tree=true so it keeps "
                    "raw values")
        k = self.num_tree_per_iteration
        cfg = self.config
        decay = float(cfg.refit_decay_rate)
        leaf_preds = np.asarray(leaf_preds)
        if leaf_preds.ndim == 1:
            leaf_preds = leaf_preds.reshape(self.num_data, -1)
        if leaf_preds.shape != (self.num_data, len(self.models)):
            log_fatal(f"leaf_preds shape {leaf_preds.shape} does not match "
                      f"(num_data={self.num_data}, "
                      f"num_models={len(self.models)})")
        lp_dev = torch.as_tensor(leaf_preds.astype(np.int32), device=dev)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                                     device=dev)
        # float32 scalars as the JAX program has them: 1 - decay is
        # rounded from float32(decay)
        d32 = f32(decay)
        one_minus = 1.0 - d32
        l1, l2 = float(cfg.lambda_l1), float(cfg.lambda_l2)
        mds = float(cfg.max_delta_step)
        ones = torch.ones(self.num_data, dtype=torch.float32, device=dev)
        self.train_score = torch.zeros_like(self.train_score)
        pending = []   # (tree, device outputs, linear features or None)
        for it in range(len(self.models) // k):
            grad, hess = self.gradients()
            for tid in range(k):
                mi = it * k + tid
                tree = self.models[mi]
                nl = max(tree.num_leaves, 1)
                lp = lp_dev[:, mi]
                g, h = grad[:, tid].contiguous(), hess[:, tid].contiguous()
                sums = leaf_histogram(lp, torch.stack([g, h, ones], 1), nl,
                                      plain=self.plain)
                out = leaf_output_no_constraint(
                    sums[:, 0], sums[:, 1] + f32(kEpsilon), l1, l2, mds)
                shrink = f32(tree.shrinkage)
                new_leaf = d32 * f32(np.asarray(tree.leaf_value,
                                                np.float32)) \
                    + one_minus * out * shrink
                lpl = lp.long()
                if not tree.is_linear:
                    self.train_score[:, tid] += new_leaf[lpl]
                    pending.append((tree, (out,), None))
                    continue
                feats = np.asarray(tree.leaf_features_inner if use_inner
                                   else tree.leaf_features, np.int32)
                coeff, const, ok = fit_linear_device(
                    raw_dev, lp, g, h, None, feats, out,
                    lam=float(cfg.linear_lambda), l2=l2)
                bc = d32 * f32(np.asarray(tree.leaf_const, np.float32)) \
                    + one_minus * const * shrink
                bw = d32 * f32(np.asarray(tree.leaf_coeff, np.float32)) \
                    + one_minus * coeff * shrink
                self.train_score[:, tid] += linear_values(
                    lpl, raw_dev, new_leaf, bc, bw,
                    torch.as_tensor(feats, dtype=torch.int64, device=dev))
                pending.append((tree, (out, const, coeff, ok), feats))
        if any(t.num_leaves > 65536 for t in self.models):
            log_info("refit: the per-leaf sums of trees past 65,536 leaves "
                     "take the sorted route (hist_cuda.leaf_histogram)")
        # the one host read: every tree's outputs in one float64 buffer
        # (float32 and bool widen exactly)
        get_telemetry().count("host.syncs")
        parts = [t for _, outs, _ in pending for t in outs]
        flat = torch.cat([t.double().reshape(-1) for t in parts]).cpu() \
            .numpy() if parts else np.zeros(0)
        ends = np.cumsum([t.numel() for t in parts])
        host = iter(np.split(flat, ends[:-1]))
        host = [[next(host).reshape(tuple(t.shape)) for t in outs]
                for _, outs, _ in pending]
        for (tree, _, feats), outs in zip(pending, host):
            o64 = outs[0]
            shrink = tree.shrinkage
            tree.leaf_value = decay * tree.leaf_value \
                + (1.0 - decay) * o64 * shrink
            if feats is None:
                continue
            # the linear blend again in float64 on the tree's arrays
            _, fit_const, fit_coeff, ok = outs
            okh = ok > 0
            target_c = np.where(okh, fit_const, o64)
            const = decay * tree.leaf_const \
                + (1.0 - decay) * target_c * shrink
            coeff = decay * tree.leaf_coeff + (1.0 - decay) * np.where(
                okh[:, None], fit_coeff, 0.0) * shrink
            tree.set_linear(feats, coeff, const,
                            dataset=self.train_data if use_inner else None)

    def rollback_one_iter(self) -> None:
        """Drop the last iteration's trees, their outputs taken off the
        train and valid scores by a bin-space walk of each tree shrunk by
        -1 (gbdt.cpp:421-437)."""
        if self.iter <= 0:
            return
        k = self.num_tree_per_iteration
        for tid in range(k):
            tree = self.models[-k + tid]
            tree.shrink(-1.0)
            self._add_tree_score(tree, tid, train=True, valid=True)
        del self.models[-k:]
        self.iter -= 1

    # ------------------------------------------------------------------
    def eval_sets(self, jobs) -> List[Tuple[str, str, float, bool]]:
        """``jobs``: (metrics, [N, k] raw score, dataset name). Each
        dataset's score is converted once on the device; every metric
        value stays on the device until one host read for all of them
        (``metric/metrics.py:batched_eval``)."""
        k = self.num_tree_per_iteration
        per_job = batched_eval([(metrics, score if k > 1 else score[:, 0],
                                 name) for metrics, score, name in jobs],
                               self.objective)
        return [row for rows in per_job for row in rows]

    def eval_metrics(self) -> List[Tuple[str, str, float, bool]]:
        """All (dataset_name, metric_name, value, bigger_better) tuples:
        the training metrics (``is_provide_training_metric``), then each
        valid set's."""
        jobs = [(self.training_metrics, self.train_score, "training")]
        jobs += list(zip(self.valid_metrics, self.valid_scores,
                         self.valid_names))
        return self.eval_sets([j for j in jobs if j[0]])

    def output_metric(self, it: int) -> str:
        """OutputMetric (gbdt.cpp:484-542): logs every ``metric_freq``
        iterations, tracks the best valid scores, and returns the best
        iteration's message once ``early_stopping_round`` iterations
        passed without a better one."""
        cfg = self.config
        need_output = cfg.metric_freq > 0 and it % cfg.metric_freq == 0
        es_round = cfg.early_stopping_round
        ret = ""
        msg_lines = []
        first_metric_seen: Dict[str, bool] = {}
        for ds_name, mname, value, bigger in self.eval_metrics():
            line = f"Iteration:{it}, {ds_name} {mname} : {value:g}"
            if need_output:
                log_info(line)
            msg_lines.append(line)
            self.evals_result.setdefault(ds_name, {}).setdefault(
                mname, []).append(value)
            if ds_name == "training" or es_round <= 0:
                continue
            if cfg.first_metric_only and first_metric_seen.get(ds_name):
                continue
            first_metric_seen[ds_name] = True
            key = (ds_name, mname)
            cur = value if bigger else -value
            if key not in self.best_score or cur > self.best_score[key]:
                self.best_score[key] = cur
                self.best_iter[key] = it
                self.best_msg[key] = "\n".join(msg_lines)
            elif not ret and it - self.best_iter[key] >= es_round:
                ret = self.best_msg[key]
        return ret

    def _eval_and_check_early_stopping(self) -> bool:
        best_msg = self.output_metric(self.iter)
        if not best_msg:
            return False
        es = self.config.early_stopping_round
        log_info(f"Early stopping at iteration {self.iter}, the best "
                 f"iteration round is {self.iter - es}")
        log_info(f"Output of best iteration round:\n{best_msg}")
        # back to the best iteration, the cached scores with it
        k = self.num_tree_per_iteration
        for j in range(es):
            for tid in range(k):
                tree = self.models[-(es - j) * k + tid]
                tree.shrink(-1.0)
                self._add_tree_score(tree, tid, train=True, valid=True)
        del self.models[-es * k:]
        self.iter -= es
        return True

    def train(self, num_iterations: int) -> None:
        """GBDT::Train (gbdt.cpp:245-264) up to ``num_iterations``
        iterations in all, evaluating after each one when there are
        metrics. With telemetry on, the run is one ``train`` span and
        ends with the ``train_end`` record (``emit_train_end``); a
        profiler window still open is closed and the span timeline
        exported."""
        tel = get_telemetry()
        tel.ensure_started(self.config)
        it0 = self.iter
        t0 = time.perf_counter()
        has_eval = bool(self.training_metrics) \
            or any(len(m) > 0 for m in self.valid_metrics)
        try:
            with tel.span("train"):
                for _ in range(self.iter, num_iterations):
                    if self.train_one_iter():
                        break
                    if has_eval:
                        with tel.span("eval", trace="eval"):
                            stop = self._eval_and_check_early_stopping()
                        if stop:
                            break
        finally:
            profile_close()
            get_tracer().flush()
        if tel.enabled:
            self.emit_train_end(it0, time.perf_counter() - t0)

    def emit_train_end(self, it0: int, dur: float) -> None:
        """Emit the ``train_end`` summary record (+ the one-time phase
        probe, ``observability/probe.py``) after a training loop; shared
        with ``engine.train``'s per-iteration loop."""
        tel = get_telemetry()
        if not tel.enabled:
            return
        iters = self.iter - it0
        tel.record(
            "train_end", iters=iters, num_data=self.num_data,
            dur_s=round(dur, 6),
            rows_per_s=round(self.num_data * max(iters, 0) / dur, 3)
            if dur > 0 else 0.0,
            compile=tel.compile_stats(),
            phase_totals=tel.phase_totals(),
            counters=dict(tel.counters),
            memory=memory_snapshot())
        if not getattr(self, "_tel_probed", False):
            self._tel_probed = True
            # the probe launches a handful of component kernels, so it
            # runs only for full (JSONL) telemetry sessions
            from ..observability.telemetry import JsonlSink
            if any(isinstance(s, JsonlSink) for s in tel._sinks):
                from ..observability.probe import run_phase_probe
                ph = run_phase_probe(self)
                if ph:
                    tel.record("phase_probe",
                               learner=type(self.learner).__name__,
                               num_data=self.num_data, phases=ph)
        tel.flush()


def _walk_inputs(dataset: Dataset, device):
    """A dataset's bin matrix, multi-val slots (None without multi-val
    groups) and raw values (None without linear_tree) on ``device``:
    the bin walk's inputs."""
    return (dataset.binned_device(device), dataset.mv_slots_device(device),
            dataset.raw_numeric_device(device))
