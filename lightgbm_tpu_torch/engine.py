"""Training entry point (port of ``lightgbm_tpu/engine.py:train``;
reference python-package/lightgbm/engine.py:18-276).

``train(params, Dataset, num_boost_round, valid_sets=, valid_names=,
fobj=, feval=, init_model=, feature_name=, categorical_feature=,
early_stopping_rounds=, evals_result=, verbose_eval=, callbacks=)``
(the JAX package's positional order) returns a ``Booster``. It runs on the CUDA
device unless ``device`` says otherwise, and raises when there is none.
With valid sets, ``feval``, ``fobj`` or callbacks it steps one iteration
at a time: the update, one evaluation (one host read of every metric
value), then the callbacks (``callback.py``: print, record, reset
parameters, early stopping, which sets ``best_iteration``). Without
them the booster trains its iterations in one call. ``init_model`` (a
model file's path or a ``Booster``) continues training from that
model's trees. ``ops="plain"`` trains through the kernels' plain
PyTorch versions on the same device (used to check the kernels end to
end).
"""

from __future__ import annotations

import collections
import copy
from typing import Any, Dict, Optional

from .basic import Booster, Dataset
from .callback import (CallbackEnv, EarlyStopException, early_stopping,
                       print_evaluation, record_evaluation)
from .io.model_text import load_model_from_file
from .predictor import predict_raw
from .utils.log import LightGBMError, log_warning

_ROUND_ALIASES = ("num_boost_round", "num_iterations", "num_iteration",
                  "n_iter", "num_tree", "num_trees", "num_round",
                  "num_rounds", "n_estimators")
_ES_ALIASES = ("early_stopping_round", "early_stopping_rounds",
               "early_stopping", "n_iter_no_change")


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100, valid_sets=None, valid_names=None,
          fobj=None, feval=None, init_model=None,
          feature_name="auto", categorical_feature="auto",
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None, verbose_eval=True,
          keep_training_booster: bool = False, callbacks=None, *,
          device=None, ops: str = "kernel") -> Booster:
    params = copy.deepcopy(params)
    for alias in _ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
            log_warning(f"Found `{alias}` in params. Will use it instead "
                        "of argument")
    for alias in _ES_ALIASES:
        if alias in params:
            early_stopping_rounds = int(params.pop(alias))
    if num_boost_round <= 0:
        raise ValueError("num_boost_round should be greater than zero.")
    if fobj is not None:
        params["objective"] = "none"
    src = None
    if init_model is not None:
        # continued training (reference engine.py:119-130,
        # boosting.cpp:35-68): adopt the existing trees, seed the scores
        if isinstance(init_model, str):
            src = load_model_from_file(init_model)
        elif isinstance(init_model, Booster):
            src = init_model._src()
        else:
            raise TypeError("init_model should be a path or a Booster")
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature
    booster = Booster(params=params, train_set=train_set, device=device,
                      ops=ops)
    gbdt = booster._gbdt
    eval_on_train = False
    valid = []
    if valid_sets is not None:
        if isinstance(valid_sets, Dataset):
            valid_sets = [valid_sets]
        if isinstance(valid_names, str):
            valid_names = [valid_names]
        for i, valid_data in enumerate(valid_sets):
            if valid_data is train_set:
                eval_on_train = True
                if valid_names is not None:
                    booster._train_data_name = valid_names[i]
                continue
            if not isinstance(valid_data, Dataset):
                raise TypeError("Training only accepts Dataset object")
            booster.add_valid(valid_data, valid_names[i]
                              if valid_names is not None else f"valid_{i}")
            valid.append(valid_data)

    if src is not None and src.models:
        k = gbdt.num_tree_per_iteration
        if src.num_tree_per_iteration != k or len(src.models) % k != 0:
            raise LightGBMError(
                f"init_model has {src.num_tree_per_iteration} trees per "
                f"iteration ({len(src.models)} trees) but the new booster "
                f"expects {k}; objective/num_class must match for "
                "continued training")
        # the seed: the trees' raw float64 sum per row, tree i into
        # column i % k in tree order (the JAX engine's _raw_add)
        models = [copy.deepcopy(t) for t in src.models]

        def raw(ds):
            return predict_raw(models, ds.raw_matrix(booster.config),
                               gbdt.device, k)
        gbdt.init_from_models(models, raw(train_set),
                              [raw(ds) for ds in valid])

    # callbacks (engine.py:186-204)
    callbacks = set(callbacks) if callbacks is not None else set()
    if verbose_eval is True:
        callbacks.add(print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval:
        callbacks.add(print_evaluation(verbose_eval))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        callbacks.add(early_stopping(
            early_stopping_rounds,
            first_metric_only=bool(params.get("first_metric_only", False)),
            verbose=bool(verbose_eval)))
    if evals_result is not None:
        callbacks.add(record_evaluation(evals_result))
    before = sorted((cb for cb in callbacks
                     if getattr(cb, "before_iteration", False)),
                    key=lambda cb: getattr(cb, "order", 0))
    after = sorted((cb for cb in callbacks
                    if not getattr(cb, "before_iteration", False)),
                   key=lambda cb: getattr(cb, "order", 0))
    need_eval = bool(valid) or eval_on_train or feval is not None
    # print and record are inert without evaluation results
    inert = all(getattr(cb, "order", 0) in (10, 20) for cb in after)
    if not need_eval and fobj is None and not before and inert \
            and not (early_stopping_rounds or 0) > 0:
        gbdt.train(gbdt.iter + num_boost_round)
        return booster

    # one iteration at a time (engine.py:221-276); iteration numbers are
    # absolute, so best_iteration counts the init model's iterations too
    begin = gbdt.iter
    end = begin + num_boost_round
    results = []
    for i in range(begin, end):
        for cb in before:
            cb(CallbackEnv(model=booster, params=params, iteration=i,
                           begin_iteration=begin, end_iteration=end,
                           evaluation_result_list=None))
        booster.update(fobj=fobj)
        results = []
        if eval_on_train or valid:
            results = booster.eval_all(feval, include_train=eval_on_train)
        elif feval is not None:
            results = booster.eval_valid(feval)
        try:
            for cb in after:
                cb(CallbackEnv(model=booster, params=params, iteration=i,
                               begin_iteration=begin, end_iteration=end,
                               evaluation_result_list=results))
        except EarlyStopException as stop:
            booster.best_iteration = stop.best_iteration + 1
            results = stop.best_score
            break
    booster.best_score = collections.defaultdict(collections.OrderedDict)
    for name, metric, score, _ in results or []:
        booster.best_score[name][metric] = score
    if booster.best_iteration <= 0:
        booster.best_iteration = -1
    return booster
