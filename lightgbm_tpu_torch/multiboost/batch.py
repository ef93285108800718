"""BoosterBatch: B independent boosters trained together (port of
``lightgbm_tpu/multiboost/batch.py``).

The batch shares one constructed Dataset (one BinMapper pass, one
device bin matrix) and one ``BatchedSerialLearner``
(``learner/batched.py``); per-model state is stacked along a leading
model axis:

* ``_score``     [B, N] float32: every model's train score
* ``_attrs``     the objective's device attributes stacked to [B, N]
* ``_masks``     [B, N] float32 row-inclusion weights (cv folds, tenant
                 row partitions): a masked row contributes zeros to the
                 histograms and count 0, exactly like an out-of-bag row
* ``_hyp``       :class:`~.program.HyperBatch` of per-model [B] tensors

Models whose static shape or code differs (num_leaves, max_bin,
objective, bagging_freq, ...) cannot share a batch; callers split them
into buckets with :func:`bucket_models` first.

The training loop mirrors ``GBDT.train_one_iter`` of each model: iteration
0 adds ``boost_from_average`` and falls back to a constant tree when
the model cannot split; every iteration shrinks each tree on the host in
float64 and adds its float32 leaf values at the model's leaf ids; a
model is cut at its first no-split iteration. Each finished model
writes its text through the standard ``save_model_to_string``, so it
equals its ``engine.train`` twin's byte for byte.

Telemetry as in the JAX package: ``multiboost.batches`` and
``multiboost.models`` a bucket, and each iteration's ``host.dispatches``
(the gradients, the learner's launches, the score add) and
``host.syncs``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..models.gbdt import kEpsilon
from ..models.tree import constant_tree
from ..objective import create_objective
from ..observability.telemetry import get_telemetry
from ..utils.device import resolve_device
from ..utils.log import log_info
from ..utils.threefry import prng_key
from .program import (TRACE_ATTRS, HyperBatch, bag_weights,
                      batched_gradients, key_of, mb_score_add, stack_attrs)

#: hyperparameter axes that vary along the model axis; every other param
#: is static (shape- or code-affecting) and buckets instead
VMAPPED_PARAMS = (
    "learning_rate", "lambda_l1", "lambda_l2", "max_delta_step",
    "min_data_in_leaf", "min_sum_hessian_in_leaf", "min_gain_to_split",
    "bagging_fraction", "bagging_seed")

#: objectives whose gradients are elementwise in the stacked device
#: attributes (program.TRACE_ATTRS)
ELIGIBLE_OBJECTIVES = (
    "regression", "huber", "fair", "poisson", "gamma", "tweedie",
    "binary", "cross_entropy", "cross_entropy_lambda")


class MultiboostError(RuntimeError):
    """Batch construction failed; callers fall back to the loop."""


@dataclass
class ModelSpec:
    """One model of a batch: its params and (optionally) the sorted
    row subset it trains on (cv fold, tenant partition)."""
    params: Dict[str, Any]
    row_index: Optional[np.ndarray] = None
    name: str = ""

    def resolve(self) -> Config:
        return Config.from_params(self.params)


def multiboost_mode(cfg: Config) -> str:
    mode = str(getattr(cfg, "multiboost", "auto")).lower()
    if mode not in ("auto", "on", "off"):
        raise ValueError(
            f"multiboost must be auto|on|off, got {mode!r}")
    return mode


def multiboost_ineligible_reason(cfg: Config,
                                 inner=None) -> Optional[str]:
    """Why this config cannot ride the batch (None = can).

    The list is exactly the set of features whose serial-path numerics
    the batch does not reproduce: host-RNG sampling, label-stat-dependent
    class weights, leaf refits, CEGB state, custom learners. Ineligible
    models train through the per-model loop. (The JAX package's
    ``LGBM_TPU_HOST_BAG`` reason is not here: the port reads no such
    variable, its bagging is always the device draw the batch makes.)
    """
    if str(getattr(cfg, "boosting", "gbdt")) != "gbdt":
        return f"boosting={cfg.boosting}"
    if cfg.tree_learner != "serial":
        return f"tree_learner={cfg.tree_learner}"
    if int(cfg.num_class) != 1:
        return f"num_class={cfg.num_class}"
    if cfg.objective not in ELIGIBLE_OBJECTIVES:
        return f"objective={cfg.objective}"
    if cfg.objective == "binary" and cfg.is_unbalance:
        return "is_unbalance (label-stat class weights)"
    if cfg.linear_tree:
        return "linear_tree"
    if float(cfg.cegb_tradeoff) > 0.0 and (
            float(cfg.cegb_penalty_split) > 0.0
            or any(float(c) > 0.0
                   for c in cfg.cegb_penalty_feature_lazy)
            or any(float(c) > 0.0
                   for c in cfg.cegb_penalty_feature_coupled)):
        return "cegb"
    if cfg.forcedsplits_filename:
        return "forced splits"
    if cfg.extra_trees:
        return "extra_trees (per-tree host RNG)"
    if cfg.feature_fraction < 1.0 or cfg.feature_fraction_bynode < 1.0:
        return "feature sampling (per-tree host RNG)"
    if cfg.pos_bagging_fraction < 1.0 or cfg.neg_bagging_fraction < 1.0:
        return "balanced bagging"
    if cfg.guard_policy != "off":
        return f"guard_policy={cfg.guard_policy}"
    if cfg.faults:
        return "fault injection"
    if int(cfg.checkpoint_freq) > 0:
        return "mid-train checkpointing"
    if int(cfg.num_machines) > 1 or cfg.is_parallel:
        return "parallel learner"
    if inner is not None:
        md = inner.metadata
        if getattr(md, "init_score", None) is not None:
            return "init_score metadata"
        if getattr(md, "group", None) is not None:
            return "group metadata"
        if inner.num_features == 0:
            return "no usable features"
    return None


def bucket_key(cfg: Config) -> Tuple:
    """Models sharing a key share one batch; the key is every canonical
    param that is not a vmapped axis."""
    items = []
    for k, v in sorted(cfg.to_params().items()):
        if k in VMAPPED_PARAMS:
            continue
        if isinstance(v, list):
            v = tuple(v)
        items.append((k, v))
    return tuple(items)


def bucket_models(specs: Sequence[ModelSpec],
                  configs: Optional[Sequence[Config]] = None,
                  max_batch: int = 0
                  ) -> List[List[Tuple[int, ModelSpec, Config]]]:
    """Group specs into static-shape buckets (stable order), chunked
    at ``max_batch`` models (0 = unbounded)."""
    cfgs = list(configs) if configs is not None \
        else [s.resolve() for s in specs]
    buckets: Dict[Tuple, List[Tuple[int, ModelSpec, Config]]] = {}
    order: List[Tuple] = []
    for i, (spec, cfg) in enumerate(zip(specs, cfgs)):
        key = bucket_key(cfg)
        if key not in buckets:
            buckets[key] = []
            order.append(key)
        buckets[key].append((i, spec, cfg))
    out: List[List[Tuple[int, ModelSpec, Config]]] = []
    for key in order:
        group = buckets[key]
        if max_batch and max_batch > 0:
            for j in range(0, len(group), max_batch):
                out.append(group[j:j + max_batch])
        else:
            out.append(group)
    return out


def _meta_view(md, idx: Optional[np.ndarray]):
    """Metadata restricted to a sorted row subset (host views): what
    ``Dataset.subset`` would hand the fold's objective and metrics."""
    if idx is None:
        return md
    lbl = None if md.label is None else np.asarray(md.label)[idx]
    w = None if md.weights is None else np.asarray(md.weights)[idx]
    return SimpleNamespace(label=lbl, weights=w, init_score=None,
                           group=None, query_boundaries=None)


def _boost_from_average(cfg: Config, objective, num_features: int
                        ) -> float:
    """gbdt.cpp:312-335 for a fresh booster with no init score: the
    objective's boost_from_score when enabled and above kEpsilon, else
    0."""
    if cfg.boost_from_average or num_features == 0:
        s = float(objective.boost_from_score(0))
        if abs(s) > kEpsilon:
            return s
    return 0.0


class _ModelShim:
    """Duck-typed GBDT stand-in for ``save_model_to_string``: host trees
    and the model's own Config and objective over the shared dataset."""

    num_tree_per_iteration = 1
    num_class = 1
    average_output = False

    def __init__(self, models: List, config: Config, objective, dataset):
        self.models = models
        self.config = config
        self.objective = objective
        self.train_data = dataset


class BoosterBatch:
    """B boosters growing one tree each per iteration.

    Drive with :meth:`train` (the whole run) or step-wise via
    :meth:`setup` / :meth:`step` / :meth:`finalize` (``engine.cv``
    evaluates ``scores`` between steps). Models come out via
    :meth:`model_text` / :meth:`booster`, byte-identical to their
    ``engine.train`` twins. ``device``: the card unless it says
    otherwise (raises without one); ``ops="plain"`` runs the kernels'
    plain versions, as ``engine.train`` does.
    """

    def __init__(self, train_set, specs: Sequence[ModelSpec],
                 num_boost_round: int,
                 configs: Optional[Sequence[Config]] = None, *,
                 device=None, ops: str = "kernel"):
        if not specs:
            raise MultiboostError("empty batch")
        if int(num_boost_round) < 1:
            raise MultiboostError("num_boost_round must be >= 1")
        if ops not in ("kernel", "plain"):
            raise ValueError(f"ops must be 'kernel' or 'plain', got {ops!r}")
        self.device = resolve_device(device)
        self.ops = ops
        # Booster-style non-overriding merge so the bin layout sees the
        # bucket's dataset params (max_bin, ...) exactly like the twin
        p0 = dict(specs[0].params or {})
        train_set.params = {**p0, **train_set.params} \
            if train_set.params else p0
        self.train_set = train_set
        self.inner = train_set._construct(
            Config.from_params(train_set.params))
        self.specs = list(specs)
        self.configs = list(configs) if configs is not None \
            else [s.resolve() for s in specs]
        self.num_boost_round = int(num_boost_round)
        self.B = len(self.specs)
        self.N = int(self.inner.num_data)
        self._built = False
        self._finalized = False

    # -- construction --------------------------------------------------
    def setup(self) -> "BoosterBatch":
        if self._built:
            return self
        from ..learner.batched import BatchedSerialLearner, BucketTooLarge
        cfg0 = self.configs[0]
        for cfg in self.configs:
            reason = multiboost_ineligible_reason(cfg, self.inner)
            if reason:
                raise MultiboostError(reason)
        dev = self.device
        md = self.inner.metadata
        nf = int(self.inner.num_features)

        self._lr = [float(c.learning_rate) for c in self.configs]
        self._obj_eval: List[Any] = []
        obj_grad: List[Any] = []
        self._init: List[float] = []
        masks = None
        for spec, cfg in zip(self.specs, self.configs):
            oe = create_objective(cfg)
            idx = spec.row_index
            if idx is not None:
                idx = np.sort(np.asarray(idx, np.int64))
                spec.row_index = idx
                oe.init(_meta_view(md, idx), int(len(idx)), dev)
                og = create_objective(cfg)
                og.init(md, self.N, dev)
                if masks is None:
                    masks = np.zeros((self.B, self.N), np.float32)
                masks[len(self._obj_eval), idx] = 1.0
            else:
                oe.init(md, self.N, dev)
                og = oe
            if cfg.objective == "binary" and not og.need_train:
                raise MultiboostError("binary single-class rows")
            self._obj_eval.append(oe)
            obj_grad.append(og)
            self._init.append(_boost_from_average(cfg, oe, nf))
        has_mask = masks is not None
        if has_mask:
            ones = np.asarray(
                [s.row_index is None for s in self.specs])
            masks[ones] = 1.0

        names = tuple(a for a in TRACE_ATTRS
                      if getattr(obj_grad[0], a, None) is not None)
        for og in obj_grad:
            mine = tuple(a for a in TRACE_ATTRS
                         if getattr(og, a, None) is not None)
            if mine != names:
                raise MultiboostError(
                    "models disagree on objective attribute presence")
        self._grad_obj = obj_grad[0]
        self._attrs = stack_attrs(obj_grad, names)

        self._use_bagging = cfg0.bagging_freq > 0 and any(
            c.bagging_fraction < 1.0 for c in self.configs)
        if self._use_bagging and has_mask:
            raise MultiboostError("bagging combined with row masks")
        self._freq = int(max(cfg0.bagging_freq, 1))

        def f32s(field):
            return torch.tensor([float(getattr(c, field))
                                 for c in self.configs],
                                dtype=torch.float32, device=dev)
        self._hyp = HyperBatch(
            learning_rate=f32s("learning_rate"),
            lambda_l1=f32s("lambda_l1"), lambda_l2=f32s("lambda_l2"),
            max_delta_step=f32s("max_delta_step"),
            min_data_in_leaf=f32s("min_data_in_leaf"),
            min_sum_hessian_in_leaf=f32s("min_sum_hessian_in_leaf"),
            min_gain_to_split=f32s("min_gain_to_split"),
            bagging_fraction=f32s("bagging_fraction"),
            init_score=torch.tensor(self._init, dtype=torch.float32,
                                    device=dev),
            bag_key=torch.tensor([prng_key(int(c.bagging_seed))
                                  for c in self.configs],
                                 dtype=torch.int64, device=dev))
        self._masks = None if masks is None \
            else torch.as_tensor(masks, device=dev)
        try:
            self.learner = BatchedSerialLearner(
                self.inner, cfg0, self.configs, dev, self.ops)
        except BucketTooLarge as e:
            raise MultiboostError(str(e)) from e
        self.L = int(self.learner.num_leaves)

        self._score = torch.zeros((self.B, self.N), dtype=torch.float32,
                                  device=dev)
        self._models: List[List[Any]] = [[] for _ in range(self.B)]
        self._stop: List[Optional[int]] = [None] * self.B
        self._it = 0
        self._built = True
        tel = get_telemetry()
        tel.ensure_started(cfg0)
        tel.count("multiboost.batches")
        tel.count("multiboost.models", self.B)
        log_info(f"multiboost: batch of {self.B} models x "
                 f"{self.num_boost_round} rounds on {self.N} rows "
                 f"(bagging={'on' if self._use_bagging else 'off'}, "
                 f"masks={'on' if has_mask else 'off'})")
        return self

    # -- one iteration for ALL models ----------------------------------
    def _row_weights(self, it: int) -> Optional[torch.Tensor]:
        if self._use_bagging:
            keys = [key_of(self._hyp.bag_key, b) for b in range(self.B)]
            return bag_weights(keys, it, self.N, self.device,
                               freq=self._freq,
                               fracs=self._hyp.bagging_fraction.tolist())
        return self._masks

    def step(self) -> None:
        self.setup()
        tel = get_telemetry()
        it = self._it
        if it == 0:
            self._score += self._hyp.init_score[:, None]
        tel.count_iter("host.dispatches", 2)   # gradients, score add
        grad, hess = batched_gradients(self._grad_obj, self._attrs,
                                       self._score)
        trees, leaf_id = self.learner.grow(grad, hess,
                                           self._row_weights(it))
        leaf_pad = np.zeros((self.B, self.L), np.float32)
        for b, t in enumerate(trees):
            if t.num_leaves > 1:
                t.shrink(self._lr[b])
                # score moves by the f64-shrunk, rounded-back f32 leaf
                # values BEFORE the bias lands on the tree: the exact
                # train_one_iter ordering
                leaf_pad[b, :t.num_leaves] = np.asarray(t.leaf_value,
                                                        np.float32)
                if it == 0 and abs(self._init[b]) > kEpsilon:
                    t.add_bias(self._init[b])
                if self._stop[b] is None:
                    self._models[b].append(t)
            elif it == 0:
                # constant-tree fallback; this model is done
                self._models[b].append(constant_tree(self._init[b]))
                self._stop[b] = 1
                leaf_pad[b, :] = np.float32(self._init[b])
            elif self._stop[b] is None:
                # kept trees: the iterations before the first no-split
                self._stop[b] = it
        mb_score_add(self._score, torch.as_tensor(leaf_pad,
                                                  device=self.device),
                     leaf_id)
        self._it = it + 1

    @property
    def scores(self) -> torch.Tensor:
        """Current [B, N] device train score (cv evaluates from it)."""
        return self._score

    def poll_stops(self) -> bool:
        """True when every model has hit its first no-split iteration
        (each iteration's trees are read to the host, so the flags are
        always current: no flush is pending)."""
        return all(s is not None for s in self._stop)

    # -- the whole run -------------------------------------------------
    def train(self) -> "BoosterBatch":
        self.setup()
        while self._it < self.num_boost_round:
            self.step()
            if self.poll_stops():
                break
        self.finalize()
        return self

    def finalize(self) -> None:
        """Cut each model at its first no-split iteration (its trees are
        on the host already)."""
        if self._finalized:
            return
        self.setup()
        for b in range(self.B):
            kept = self._stop[b] if self._stop[b] is not None \
                else self._it
            del self._models[b][kept:]
        self._finalized = True

    # -- results -------------------------------------------------------
    def models(self, b: int) -> List[Any]:
        self.finalize()
        return self._models[b]

    def model_text(self, b: int) -> str:
        """Full model text, byte-compatible with the twin Booster's
        ``model_to_string`` (trailing pandas_categorical included)."""
        from ..io.model_text import save_model_to_string
        self.finalize()
        shim = _ModelShim(self._models[b], self.configs[b],
                          self._obj_eval[b], self.inner)
        pc = getattr(self.train_set, "pandas_categorical", None) or []
        return save_model_to_string(shim) + "\npandas_categorical:" \
            + json.dumps(pc, default=str) + "\n"

    def booster(self, b: int):
        from ..basic import Booster
        bst = Booster(model_str=self.model_text(b), device=self.device)
        bst.best_iteration = -1
        return bst

    def describe(self) -> Dict[str, Any]:
        return {"models": self.B, "rounds": self.num_boost_round,
                "rows": self.N, "num_leaves": getattr(self, "L", None),
                "stopped": sum(s is not None for s in self._stop)
                if self._built else 0,
                "route": self.learner.route if self._built else None}


__all__ = [
    "BoosterBatch", "ModelSpec", "MultiboostError", "VMAPPED_PARAMS",
    "ELIGIBLE_OBJECTIVES", "bucket_key", "bucket_models",
    "multiboost_ineligible_reason", "multiboost_mode", "mb_score_add"]
