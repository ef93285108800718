"""scikit-learn estimators (port of ``lightgbm_tpu/sklearn.py``;
reference python-package/lightgbm/sklearn.py: LGBMModel ``:169-743``,
LGBMRegressor ``:744``, LGBMClassifier ``:771``, LGBMRanker ``:913``).

The same constructor surface and fit / predict / predict_proba
contract over the port's ``train``, plus two keywords of the port,
``device`` and ``ops``, which go to ``train`` and never into the
parameters. With scikit-learn installed the estimators derive from its
``BaseEstimator`` and mixins, so ``clone`` and grid search work. Without
it (the card's machine has none) they still fit and predict:
``get_params`` / ``set_params`` come from the constructor's signature,
classes are encoded with ``np.unique(return_inverse=True)`` (what
``LabelEncoder`` computes) and ``class_weight`` weighs rows as
``compute_sample_weight`` does, all here.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional

import numpy as np

from .basic import Booster, Dataset
from .engine import train
from .utils.log import LightGBMError

try:
    from sklearn.base import BaseEstimator, ClassifierMixin, RegressorMixin
    SKLEARN_INSTALLED = True
except ImportError:
    SKLEARN_INSTALLED = False

    class BaseEstimator:  # type: ignore[no-redef]
        """``get_params`` / ``set_params`` over the constructor's named
        parameters, as scikit-learn's ``BaseEstimator`` gives them."""

        @classmethod
        def _get_param_names(cls):
            sig = inspect.signature(cls.__init__)
            return sorted(p.name for p in sig.parameters.values()
                          if p.name != "self" and p.kind
                          not in (p.VAR_KEYWORD, p.VAR_POSITIONAL))

        def get_params(self, deep: bool = True) -> Dict[str, Any]:
            return {k: getattr(self, k) for k in self._get_param_names()}

    class ClassifierMixin:  # type: ignore[no-redef]
        _estimator_type = "classifier"

    class RegressorMixin:  # type: ignore[no-redef]
        _estimator_type = "regressor"


def _eval_function_wrapper(func: Callable):
    """A scikit-learn style ``feval(y_true, y_pred)`` as the engine's
    ``feval(preds, dataset)`` (sklearn.py:87-168)."""
    def inner(preds, dataset):
        return func(dataset.get_label(), preds)
    return inner


def _objective_function_wrapper(func: Callable):
    """A scikit-learn style ``fobj(y_true, y_pred) -> (grad, hess)`` as
    the engine's ``fobj(preds, dataset)`` (sklearn.py:18-86)."""
    def inner(preds, dataset):
        return func(dataset.get_label(), preds)
    return inner


def compute_sample_weight(class_weight, y) -> np.ndarray:
    """Row weights of ``class_weight`` (a {class: weight} dict or
    ``"balanced"``: n_rows / (n_classes * rows of the class)), as
    scikit-learn's ``compute_sample_weight`` for one output."""
    classes, inv = np.unique(np.asarray(y), return_inverse=True)
    if class_weight == "balanced":
        per_class = len(inv) / (len(classes) * np.bincount(inv))
    elif isinstance(class_weight, dict):
        per_class = np.asarray([class_weight.get(c, 1.0) for c in classes],
                               np.float64)
        unweighted = [c for c in classes if c not in class_weight]
        if unweighted and len(classes) - len(unweighted) \
                != len(class_weight):
            raise ValueError(f"The classes, {list(unweighted)}, are not in "
                             "class_weight")
    else:
        raise ValueError("class_weight must be a dict, 'balanced' or None")
    return per_class[inv.ravel()]


class LGBMModel(BaseEstimator):
    """The estimator base (sklearn.py:169-743)."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[str] = None, class_weight=None,
                 min_split_gain: float = 0.0,
                 min_child_weight: float = 1e-3, min_child_samples: int = 20,
                 subsample: float = 1.0, subsample_freq: int = 0,
                 colsample_bytree: float = 1.0, reg_alpha: float = 0.0,
                 reg_lambda: float = 0.0, random_state=None,
                 n_jobs: int = -1, silent: bool = True,
                 importance_type: str = "split", device=None,
                 ops: str = "kernel", **kwargs):
        self.boosting_type = boosting_type
        self.objective = objective
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.class_weight = class_weight
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.importance_type = importance_type
        self.device = device
        self.ops = ops
        self._Booster: Optional[Booster] = None
        self._evals_result = None
        self._best_score = None
        self._best_iteration = None
        self._n_features = None
        self._classes = None
        self._n_classes = None
        self._other_params: Dict[str, Any] = {}
        self.set_params(**kwargs)

    # -- scikit-learn plumbing --------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = super().get_params(deep=deep)
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        named = inspect.signature(LGBMModel.__init__).parameters
        for key, value in params.items():
            setattr(self, key, value)
            if hasattr(self, f"_{key}"):
                setattr(self, f"_{key}", value)
            if key not in named:
                self._other_params[key] = value
        return self

    def _process_params(self) -> Dict[str, Any]:
        """The training parameters: the constructor's under the
        engine's names, without the estimator-only ones."""
        params = self.get_params()
        for key in ("silent", "importance_type", "n_estimators",
                    "class_weight", "device", "ops"):
            params.pop(key, None)
        ren = {"boosting_type": "boosting",
               "min_split_gain": "min_gain_to_split",
               "min_child_weight": "min_sum_hessian_in_leaf",
               "min_child_samples": "min_data_in_leaf",
               "subsample": "bagging_fraction",
               "subsample_freq": "bagging_freq",
               "colsample_bytree": "feature_fraction",
               "reg_alpha": "lambda_l1", "reg_lambda": "lambda_l2",
               "subsample_for_bin": "bin_construct_sample_cnt",
               "random_state": "seed", "n_jobs": None}
        out = {}
        for key, value in params.items():
            if value is None:
                continue
            if key in ren:
                if ren[key] is not None:
                    out[ren[key]] = value
            else:
                out[key] = value
        out.setdefault("verbosity", -1 if self.silent else 1)
        return out

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None, eval_metric=None,
            early_stopping_rounds=None, verbose=False,
            feature_name="auto", categorical_feature="auto",
            callbacks=None) -> "LGBMModel":
        params = self._process_params()
        if self._objective_resolved is not None:
            params["objective"] = self._objective_resolved
        fobj = None
        if callable(self.objective):
            fobj = _objective_function_wrapper(self.objective)
            params["objective"] = "none"
        feval = _eval_function_wrapper(eval_metric) \
            if callable(eval_metric) else None
        if isinstance(eval_metric, str):
            params["metric"] = eval_metric
        elif isinstance(eval_metric, (list, tuple)):
            params["metric"] = list(eval_metric)
        if self.class_weight is not None and sample_weight is None:
            sample_weight = compute_sample_weight(self.class_weight, y)

        train_set = Dataset(X, label=y, weight=sample_weight, group=group,
                            init_score=init_score, feature_name=feature_name,
                            categorical_feature=categorical_feature)
        valid_sets, valid_names = [], []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                if vx is X and vy is y:
                    valid_sets.append(train_set)
                else:
                    pick = lambda a: a[i] if a else None  # noqa: E731
                    valid_sets.append(train_set.create_valid(
                        vx, label=vy, weight=pick(eval_sample_weight),
                        group=pick(eval_group),
                        init_score=pick(eval_init_score)))
                valid_names.append(eval_names[i] if eval_names
                                   else f"valid_{i}")
        evals_result: Dict = {}
        self._Booster = train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None, valid_names=valid_names or None,
            fobj=fobj, feval=feval,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=evals_result, verbose_eval=verbose,
            callbacks=callbacks, device=self.device, ops=self.ops)
        self._evals_result = evals_result
        self._best_iteration = self._Booster.best_iteration
        self._best_score = self._Booster.best_score
        self._n_features = self._Booster.num_feature()
        return self

    @property
    def _objective_resolved(self) -> Optional[str]:
        return self.objective if isinstance(self.objective, str) else None

    def predict(self, X, raw_score: bool = False,
                num_iteration: Optional[int] = None,
                pred_leaf: bool = False, pred_contrib: bool = False,
                **kwargs):
        if self._Booster is None:
            raise LightGBMError("Estimator not fitted, call `fit` before "
                                "exploiting the model.")
        return self._Booster.predict(
            X, raw_score=raw_score, num_iteration=num_iteration,
            pred_leaf=pred_leaf, pred_contrib=pred_contrib, **kwargs)

    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise LightGBMError("No booster found. Need to call fit "
                                "beforehand.")
        return self._Booster

    @property
    def best_iteration_(self):
        return self._best_iteration

    @property
    def best_score_(self):
        return self._best_score

    @property
    def evals_result_(self):
        return self._evals_result

    @property
    def n_features_(self):
        return self._n_features

    @property
    def feature_importances_(self) -> np.ndarray:
        return self.booster_.feature_importance(
            importance_type=self.importance_type)


class LGBMRegressor(RegressorMixin, LGBMModel):
    """sklearn.py:744-770."""

    @property
    def _objective_resolved(self):
        if isinstance(self.objective, str):
            return self.objective
        return None if callable(self.objective) else "regression"


class LGBMClassifier(ClassifierMixin, LGBMModel):
    """sklearn.py:771-912. Labels of any sortable type; ``classes_`` is
    their sorted unique values."""

    def _encode(self, y) -> np.ndarray:
        y = np.asarray(y).ravel()
        idx = np.searchsorted(self._classes, y)
        idx = np.clip(idx, 0, len(self._classes) - 1)
        if not np.array_equal(self._classes[idx], y):
            raise ValueError("y contains previously unseen labels")
        return idx

    def fit(self, X, y, **kwargs):
        self._classes, encoded = np.unique(np.asarray(y).ravel(),
                                           return_inverse=True)
        self._n_classes = len(self._classes)
        if self._n_classes > 2:
            if not (isinstance(self.objective, str) and self.objective
                    in ("multiclass", "multiclassova")) \
                    and not callable(self.objective):
                self.objective = "multiclass"
            self._other_params["num_class"] = self._n_classes
        eval_set = kwargs.get("eval_set")
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            kwargs["eval_set"] = [(vx, self._encode(vy))
                                  for vx, vy in eval_set]
        if self.class_weight is not None \
                and kwargs.get("sample_weight") is None:
            # keyed by the caller's labels, not the encoded ones
            kwargs["sample_weight"] = compute_sample_weight(
                self.class_weight, y)
        super().fit(X, encoded.ravel(), **kwargs)
        return self

    @property
    def _objective_resolved(self):
        if isinstance(self.objective, str):
            return self.objective
        if callable(self.objective):
            return None
        return "binary" if (self._n_classes or 2) <= 2 else "multiclass"

    @property
    def classes_(self):
        return self._classes

    @property
    def n_classes_(self):
        return self._n_classes

    def predict(self, X, raw_score: bool = False,
                num_iteration: Optional[int] = None,
                pred_leaf: bool = False, pred_contrib: bool = False,
                **kwargs):
        result = self.predict_proba(X, raw_score, num_iteration, pred_leaf,
                                    pred_contrib, **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if result.ndim > 1:
            return self._classes[np.argmax(result, axis=1)]
        return self._classes[(result > 0.5).astype(int)]

    def predict_proba(self, X, raw_score: bool = False,
                      num_iteration: Optional[int] = None,
                      pred_leaf: bool = False, pred_contrib: bool = False,
                      **kwargs):
        result = super().predict(X, raw_score, num_iteration, pred_leaf,
                                 pred_contrib, **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if result.ndim == 1:
            return np.vstack([1.0 - result, result]).T
        return result


class LGBMRanker(LGBMModel):
    """sklearn.py:913-961."""

    def fit(self, X, y, group=None, **kwargs):
        if group is None:
            raise ValueError("Should set group for ranking task")
        if kwargs.get("eval_set") is not None \
                and kwargs.get("eval_group") is None:
            raise ValueError("Eval_group cannot be None when eval_set is "
                             "not None")
        super().fit(X, y, group=group, **kwargs)
        return self

    @property
    def _objective_resolved(self):
        if isinstance(self.objective, str):
            return self.objective
        return None if callable(self.objective) else "lambdarank"
