"""Training entry points (port of ``lightgbm_tpu/engine.py``: ``train``
and ``cv``; reference python-package/lightgbm/engine.py:18-276, 299-580).

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

``cv(params, Dataset, num_boost_round, folds=, nfold=, stratified=,
shuffle=, ...)`` trains one booster a fold, each on a ``subset`` of the
binned data (the parent's bins) with the held-out rows as its valid
set, one iteration of every fold at a time, and returns the mean and
standard deviation of each metric by iteration (``CVBooster`` with
``return_cvbooster``). Folds are whole queries for ranking data
(``_GroupKFold``), stratified by label for binary and multiclass
(``_StratifiedKFold``), else cut from a permutation: the two splitters
are copies of scikit-learn's, so the port needs no scikit-learn. The
folds train one after another (the JAX package's per-fold loop); its
batched route (``multiboost=on``) is refused with ROADMAP.md Queue 1
item 9.
"""

from __future__ import annotations

import collections
import copy
from typing import Any, Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .callback import (CallbackEnv, EarlyStopException, early_stopping,
                       print_evaluation, record_evaluation)
from .config import Config, refuse_cv_multiboost
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


# ----------------------------------------------------------------------
class CVBooster:
    """The boosters of a cv run, one a fold (engine.py:283-297): a
    method called on it is called on every booster, and returns the
    list of their results."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def _append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler_function(*args, **kwargs):
            return [getattr(booster, name)(*args, **kwargs)
                    for booster in self.boosters]
        return handler_function


def _check_random_state(seed):
    """scikit-learn's ``check_random_state``."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, (int, np.integer)):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(f"{seed!r} cannot be used to seed a "
                     "numpy.random.RandomState instance")


class _StratifiedKFold:
    """scikit-learn 1.9.0's ``StratifiedKFold(n_splits, shuffle,
    random_state).split`` (``sklearn/model_selection/_split.py``
    ``_make_test_folds``): the same numpy calls in the same order, so
    the same folds, without scikit-learn. Classes are numbered by first
    appearance, each class's rows are dealt to the folds in blocks of
    the round-robin allocation over the sorted labels, and with
    ``shuffle`` each class's block order is shuffled by one
    ``RandomState``."""

    def __init__(self, n_splits: int, shuffle: bool = False,
                 random_state=None):
        self.n_splits = int(n_splits)
        self.shuffle = shuffle
        self.random_state = random_state

    def _make_test_folds(self, y) -> np.ndarray:
        rng = _check_random_state(self.random_state)
        y = np.asarray(y).ravel()
        _, y_idx, y_inv = np.unique(y, return_index=True,
                                    return_inverse=True)
        _, class_perm = np.unique(y_idx, return_inverse=True)
        y_encoded = class_perm[y_inv]
        n_classes = len(y_idx)
        y_counts = np.bincount(y_encoded)
        if np.all(self.n_splits > y_counts):
            raise ValueError(f"n_splits={self.n_splits} cannot be greater "
                             "than the number of members in each class.")
        if self.n_splits > np.min(y_counts):
            log_warning(f"The least populated class in y has only "
                        f"{np.min(y_counts)} members, which is less than "
                        f"n_splits={self.n_splits}.")
        y_order = np.sort(y_encoded)
        allocation = np.asarray(
            [np.bincount(y_order[i::self.n_splits], minlength=n_classes)
             for i in range(self.n_splits)])
        test_folds = np.empty(len(y), dtype="i")
        for k in range(n_classes):
            folds_for_class = np.arange(self.n_splits).repeat(
                allocation[:, k])
            if self.shuffle:
                rng.shuffle(folds_for_class)
            test_folds[y_encoded == k] = folds_for_class
        return test_folds

    def split(self, X, y, groups=None):
        test_folds = self._make_test_folds(y)
        indices = np.arange(len(test_folds))
        for i in range(self.n_splits):
            mask = test_folds == i
            yield indices[~mask], indices[mask]


class _GroupKFold:
    """scikit-learn 1.9.0's ``GroupKFold(n_splits).split`` (no shuffle,
    ``_iter_test_indices``): groups are dealt, most rows first (a stable
    ``argsort`` reversed, so ties go to the later group first), each to
    the fold with the fewest rows so far (``argmin``: the first such
    fold)."""

    def __init__(self, n_splits: int):
        self.n_splits = int(n_splits)

    def split(self, X, y=None, groups=None):
        groups = np.asarray(groups)
        unique_groups, group_idx = np.unique(groups, return_inverse=True)
        if self.n_splits > len(unique_groups):
            raise ValueError(
                f"Cannot have number of splits n_splits={self.n_splits} "
                f"greater than the number of groups: {len(unique_groups)}.")
        n_samples_per_group = np.bincount(group_idx)
        indices = np.argsort(n_samples_per_group, kind="stable")[::-1]
        n_samples_per_group = n_samples_per_group[indices]
        n_samples_per_fold = np.zeros(self.n_splits)
        group_to_fold = np.zeros(len(unique_groups))
        for group_index, weight in enumerate(n_samples_per_group):
            lightest_fold = np.argmin(n_samples_per_fold)
            n_samples_per_fold[lightest_fold] += weight
            group_to_fold[indices[group_index]] = lightest_fold
        fold_of_row = group_to_fold[group_idx]
        rows = np.arange(len(groups))
        for f in range(self.n_splits):
            mask = fold_of_row == f
            yield rows[~mask], rows[mask]


def _make_n_folds(full_data: Dataset, folds, nfold: int, params,
                  seed: int, stratified: bool, shuffle: bool):
    """(train rows, test rows) of each fold (engine.py:299-356): a given
    list or splitter (``split(X, y, groups)``) as it is; whole queries
    for ranking data; stratified by label; else ``nfold`` cuts of a
    permutation."""
    full_data.construct()
    num_data = full_data.num_data()
    if folds is not None:
        if not hasattr(folds, "__iter__") and not hasattr(folds, "split"):
            raise AttributeError(
                "folds should be a generator or iterator of (train_idx, "
                "test_idx) tuples or scikit-learn splitter object")
        if hasattr(folds, "split"):
            group_info = full_data.get_group()
            group = np.repeat(np.arange(len(group_info)), group_info) \
                if group_info is not None else None
            folds = folds.split(X=np.empty(num_data),
                                y=full_data.get_label(), groups=group)
        return list(folds)
    group_info = full_data.get_group()
    if group_info is not None:
        group_info = np.asarray(group_info, np.int64)
        flatted_group = np.repeat(np.arange(len(group_info)), group_info)
        return list(_GroupKFold(nfold).split(np.empty(num_data),
                                             groups=flatted_group))
    if stratified:
        # no random_state without shuffle: it would draw nothing
        # (scikit-learn refuses the pair)
        skf = _StratifiedKFold(nfold, shuffle=shuffle,
                               random_state=seed if shuffle else None)
        return list(skf.split(np.empty(num_data), full_data.get_label()))
    rng = np.random.RandomState(seed)
    idx = rng.permutation(num_data) if shuffle else np.arange(num_data)
    kstep = num_data // nfold
    out = []
    for i in range(nfold):
        test = idx[i * kstep: (i + 1) * kstep if i < nfold - 1 else None]
        out.append((np.setdiff1d(idx, test), test))
    return out


def _agg_cv_result(raw_results, eval_train_metric: bool = False):
    """(``"cv_agg"``, metric, mean, bigger_better, stdv) of every metric
    over the folds (engine.py:359-373); with train metrics the dataset's
    name prefixes the metric."""
    cvmap = collections.OrderedDict()
    metric_type = {}
    for one_result in raw_results:
        for one_line in one_result:
            key = f"{one_line[0]} {one_line[1]}" if eval_train_metric \
                else one_line[1]
            metric_type[key] = one_line[3]
            cvmap.setdefault(key, []).append(one_line[2])
    return [("cv_agg", k, float(np.mean(v)), metric_type[k],
             float(np.std(v))) for k, v in cvmap.items()]


def cv(params: Dict[str, Any], train_set: Dataset,
       num_boost_round: int = 100, folds=None, nfold: int = 5,
       stratified: bool = True, shuffle: bool = True, metrics=None,
       fobj=None, feval=None, init_model=None, feature_name="auto",
       categorical_feature="auto",
       early_stopping_rounds: Optional[int] = None, verbose_eval=None,
       show_stdv: bool = True, seed: int = 0, callbacks=None,
       eval_train_metric: bool = False, return_cvbooster: bool = False, *,
       device=None, ops: str = "kernel"):
    """k-fold cross-validated boosting (engine.py:375-580): a dict of
    ``"<metric>-mean"`` / ``"<metric>-stdv"`` lists by iteration (cut
    to the best iteration by early stopping), with ``"cvbooster"`` when
    ``return_cvbooster``. Each fold's booster trains on its rows'
    ``subset`` of ``train_set`` on ``device`` (the card unless it says
    otherwise) through ``ops``. ``init_model`` is accepted and unused,
    as in the JAX package."""
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    params = copy.deepcopy(params)
    for alias in _ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
    for alias in _ES_ALIASES:
        if alias in params:
            early_stopping_rounds = int(params.pop(alias))
    if fobj is not None:
        params["objective"] = "none"
    if metrics is not None:
        params["metric"] = metrics
    refuse_cv_multiboost(Config.from_params(params))
    obj = params.get("objective", "")
    if stratified and (obj not in ("binary", "multiclass", "multiclassova")
                       or train_set.group is not None):
        stratified = False
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature
    train_set.params = {**params, **train_set.params}
    folds = _make_n_folds(train_set, folds, nfold, params, seed,
                          stratified, shuffle)

    cvbooster = CVBooster()
    for train_idx, test_idx in folds:
        tr = train_set.subset(np.asarray(train_idx))
        te = train_set.subset(np.asarray(test_idx))
        booster = Booster(params=params, train_set=tr, device=device,
                          ops=ops)
        booster.add_valid(te, "valid")
        cvbooster._append(booster)

    results = collections.defaultdict(list)
    callbacks = set(callbacks) if callbacks is not None else set()
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        callbacks.add(early_stopping(early_stopping_rounds, verbose=False))
    if verbose_eval is True:
        callbacks.add(print_evaluation(show_stdv=show_stdv))
    elif isinstance(verbose_eval, int) and verbose_eval:
        callbacks.add(print_evaluation(verbose_eval, show_stdv))
    before = sorted((cb for cb in callbacks
                     if getattr(cb, "before_iteration", False)),
                    key=lambda cb: getattr(cb, "order", 0))
    after = sorted((cb for cb in callbacks
                    if not getattr(cb, "before_iteration", False)),
                   key=lambda cb: getattr(cb, "order", 0))
    for i in range(num_boost_round):
        for cb in before:
            cb(CallbackEnv(model=cvbooster, params=params, iteration=i,
                           begin_iteration=0, end_iteration=num_boost_round,
                           evaluation_result_list=None))
        raw = []
        for booster in cvbooster.boosters:
            booster.update(fobj=fobj)
            one = []
            if eval_train_metric:
                one.extend(booster.eval_train(feval))
            one.extend(booster.eval_valid(feval))
            raw.append(one)
        res = _agg_cv_result(raw, eval_train_metric)
        for _, key, mean, _, std in res:
            results[f"{key}-mean"].append(mean)
            results[f"{key}-stdv"].append(std)
        try:
            for cb in after:
                cb(CallbackEnv(model=cvbooster, params=params, iteration=i,
                               begin_iteration=0,
                               end_iteration=num_boost_round,
                               evaluation_result_list=res))
        except EarlyStopException as stop:
            cvbooster.best_iteration = stop.best_iteration + 1
            for k in results:
                results[k] = results[k][:cvbooster.best_iteration]
            break
    if return_cvbooster:
        results["cvbooster"] = cvbooster
    return dict(results)
