"""User-facing ``Dataset`` and ``Booster`` (port of the training,
evaluation, predict and model IO surface of ``lightgbm_tpu/basic.py``).

``Dataset`` holds the raw arrays (dense, or a scipy sparse matrix that
is binned without densifying), or the path of a CSV / TSV / LibSVM file
(read in two passes with ``two_round=true``), until training constructs
the binned dataset with the booster's parameters (the reference's lazy
construction); a valid set is binned with its training set's mappers
and bundled through its EFB plan. ``Booster`` trains on one device, with
valid sets and evaluation, or holds a model loaded from text
(``model_file`` / ``model_str``), and predicts through ``predictor.py``
on its device: the card unless ``device`` says otherwise. After early
stopping, ``predict``, ``model_to_string`` and ``save_model`` default
to ``best_iteration``.

Categorical features come from the ``categorical_feature`` argument
(indices, names, or a ``"0,1"`` / ``"name:a,b"`` string), else from the
``categorical_feature`` parameter (the reference CLI's form), else, for
a pandas DataFrame, from its ``category`` columns. A DataFrame's
category columns become their integer codes, and their categories ride
the model text's ``pandas_categorical`` trailer, so ``predict`` on a
DataFrame codes its columns the same way. pandas is imported only when
a DataFrame is passed.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np

from .config import Config
from .data.dataset import Dataset as _BinnedDataset
from .data.dataset import load_forced_bins
from .io.model_text import (LoadedBooster, dump_model_json,
                            feature_importance, load_model_from_string,
                            save_model_to_string)
from .models.gbdt import GBDT
from .models.variants import create_boosting
from .objective import create_objective
from .predictor import predict as _predict
from .utils.device import resolve_device
from .utils.log import LightGBMError

SPARSE_PREDICT_CHUNK_ROWS = 65536


def _is_pandas_df(data) -> bool:
    """A pandas DataFrame, told apart without importing pandas."""
    cls = type(data)
    return cls.__name__ == "DataFrame" \
        and cls.__module__.split(".")[0] == "pandas"


def _resolve_categorical(categorical_feature, feature_name) -> List[int]:
    """Categorical feature indices, sorted and unique, from indices,
    names, or a string: ``"0,1"`` (indices), ``"name:a,b"`` (names);
    ``"auto"``, None and ``""`` mean none (JAX ``basic.py:62``, with the
    reference's string forms; an index past the features is ignored,
    as there)."""
    if categorical_feature in ("auto", None, ""):
        return []
    if isinstance(categorical_feature, str):
        text = categorical_feature.strip()
        if text.startswith("name:"):
            categorical_feature = [c.strip() for c in text[5:].split(",")
                                   if c.strip()]
        else:
            categorical_feature = [int(c) for c in text.split(",")
                                   if c.strip()]
    names = None if feature_name in ("auto", None) else list(feature_name)
    out = []
    for c in categorical_feature:
        if isinstance(c, str):
            if names is None or c not in names:
                raise LightGBMError(f"Unknown categorical feature name {c}")
            out.append(names.index(c))
        else:
            out.append(int(c))
    return sorted(set(out))


def _data_from_pandas(df, pandas_categorical=None):
    """A DataFrame -> (float64 matrix, column names, category column
    indices, each category column's categories). Category columns become
    their codes, missing (-1) as NaN; with ``pandas_categorical`` (a
    training set's) each is first recoded to those categories (JAX
    ``basic.py:36 _data_from_pandas`` and ``_apply_pandas_categorical``)."""
    import pandas as pd
    df = df.copy()
    cat_cols = [i for i, c in enumerate(df.columns)
                if isinstance(df[c].dtype, pd.CategoricalDtype)]
    cats = []
    for i, idx in enumerate(cat_cols):
        col = df.columns[idx]
        if pandas_categorical is not None and i < len(pandas_categorical):
            df[col] = df[col].cat.set_categories(pandas_categorical[i])
        cats.append(list(df[col].cat.categories))
        codes = df[col].cat.codes.astype(np.float64)
        df[col] = codes.where(codes >= 0, np.nan)
    return (df.astype(np.float64).to_numpy(), [str(c) for c in df.columns],
            cat_cols, cats)


def _parse_pandas_categorical(text: str) -> List:
    """The model text's trailing ``pandas_categorical:`` JSON line, or []
    (JAX ``basic.py:822``)."""
    tail = text[-min(len(text), 1 << 16):]
    pos = tail.rfind("pandas_categorical:")
    if pos < 0:
        return []
    lines = tail[pos + len("pandas_categorical:"):].splitlines()
    try:
        return (json.loads(lines[0]) if lines else None) or []
    except json.JSONDecodeError:
        return []


def _is_sparse(data) -> bool:
    try:
        import scipy.sparse as sp
    except ImportError:  # pragma: no cover
        return False
    return sp.issparse(data)


class Dataset:
    """Raw training data + label, binned on first use. ``data`` is a
    dense matrix or the path of a text file (``data/file_loader.py``),
    whose label, weight, query groups, init score and header names fill
    what the caller did not give. A dataset with a ``reference`` (a
    valid set) is binned with the reference's mappers. The signature is
    the JAX package's: ``feature_name="auto"`` means no names (a
    DataFrame's columns name themselves), ``categorical_feature`` as
    the module note says, and ``free_raw_data`` drops ``data`` once
    binned."""

    def __init__(self, data, label=None, reference: Optional["Dataset"]
                 = None, weight=None, group=None, init_score=None,
                 feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = False):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self.free_raw_data = free_raw_data
        self.pandas_categorical: List = []
        self._pandas_cat_cols: List[int] = []
        self._raw: Optional[np.ndarray] = None
        self._binned: Optional[_BinnedDataset] = None

    def raw_matrix(self, config: Config) -> np.ndarray:
        """The raw feature matrix, float64 (read once from a file). Binning
        reads a sparse matrix and a ``two_round`` file without it
        (``construct``); a continued training's ``init_model`` scores
        them through it (a sparse matrix densified here)."""
        if self._raw is not None:
            return self._raw
        if isinstance(self.data, str):
            from .data.file_loader import load_file
            X, label, weight, group, init, names = load_file(self.data,
                                                             config)
            for key, val in (("label", label), ("weight", weight),
                             ("group", group), ("init_score", init)):
                if getattr(self, key) is None:
                    setattr(self, key, val)
            if self.feature_name in ("auto", None) and names:
                self.feature_name = names
        elif _is_pandas_df(self.data):
            ref = self.reference.pandas_categorical \
                if self.reference is not None else None
            X, names, self._pandas_cat_cols, self.pandas_categorical = \
                _data_from_pandas(self.data, ref or None)
            if self.feature_name in ("auto", None):
                self.feature_name = names
        elif _is_sparse(self.data):
            X = self.data.toarray()
        else:
            X = self.data
        self._raw = np.asarray(X, np.float64)
        return self._raw

    def construct(self, config: Config) -> _BinnedDataset:
        """Bin the data (once): a dense matrix, a DataFrame or a text
        file through ``from_numpy``; a scipy sparse matrix through
        ``from_scipy``, never densified (JAX ``basic.py:241-260``); a
        text file with ``two_round=true`` through
        ``from_file_two_round``, in two passes over the file."""
        if self._binned is None:
            ref = None
            if self.reference is not None:
                ref = self.reference.construct(config)
            two_round = isinstance(self.data, str) and config.two_round
            sparse = _is_sparse(self.data)
            X = None if two_round or sparse else self.raw_matrix(config)
            if two_round and self.feature_name in ("auto", None):
                from .data.file_loader import TwoRoundLoader
                self.feature_name = TwoRoundLoader(
                    self.data, config).resolve_feature_names() or "auto"
            names = None if self.feature_name in ("auto", None) \
                else list(self.feature_name)
            kw = dict(label=self.label, weight=self.weight,
                      group=self.group, init_score=self.init_score,
                      feature_names=names, reference=ref,
                      categorical_features=self.categorical_indices(config),
                      forced_bins=None if ref is not None
                      else load_forced_bins(config.forcedbins_filename))
            if two_round:
                self._binned = _BinnedDataset.from_file_two_round(
                    self.data, config, **kw)
            elif sparse:
                self._binned = _BinnedDataset.from_scipy(self.data, config,
                                                         **kw)
            else:
                self._binned = _BinnedDataset.from_numpy(X, config, **kw)
            if self.free_raw_data:
                self.data = None
        return self._binned

    def categorical_indices(self, config: Config) -> List[int]:
        """The categorical features' indices: the ``categorical_feature``
        argument, else the parameter, else a DataFrame's category
        columns."""
        if self.categorical_feature not in ("auto", None):
            spec = self.categorical_feature
        elif config.categorical_feature:
            spec = config.categorical_feature
        else:
            return list(self._pandas_cat_cols)
        return _resolve_categorical(spec, self.feature_name)

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A valid set binned with this dataset's mappers
        (basic.py:996-1022)."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       feature_name=self.feature_name,
                       categorical_feature=self.categorical_feature,
                       params=params or self.params)

    def subset(self, used_indices, params=None) -> "Dataset":
        """Refused: ROADMAP.md Queue 1 item 7.6 (with ``cv``)."""
        raise NotImplementedError("Dataset.subset is not in the port yet "
                                  "(ROADMAP.md Queue 1 item 7.6)")

    def save_binary(self, filename: str) -> "Dataset":
        """Refused: ROADMAP.md Queue 1 item 7.6."""
        raise NotImplementedError("save_binary is not in the port yet "
                                  "(ROADMAP.md Queue 1 item 7.6)")

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Refused: ROADMAP.md Queue 1 item 7.6."""
        raise NotImplementedError("add_features_from is not in the port "
                                  "yet (ROADMAP.md Queue 1 item 7.6)")

    def set_group(self, group) -> "Dataset":
        self.group = group
        if self._binned is not None:
            self._binned.metadata.set_query(group)
        return self

    def get_group(self):
        if self._binned is not None \
                and self._binned.metadata.query_boundaries is not None:
            return np.diff(self._binned.metadata.query_boundaries)
        return self.group

    def get_label(self):
        if self._binned is not None \
                and self._binned.metadata.label is not None:
            return self._binned.metadata.label
        return self.label


class Booster:
    """A trained (or training) model on one device, or a model loaded
    from text (``model_file`` / ``model_str``) predicting on one."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None, device=None,
                 ops: str = "kernel"):
        self.params = dict(params or {})
        self.config = Config.from_params(self.params)
        self.device = resolve_device(device)
        self.best_iteration = -1
        self.best_score: Dict = {}
        self._train_data_name = "training"
        self._gbdt: Optional[GBDT] = None
        self._loaded: Optional[LoadedBooster] = None
        self.train_set = train_set
        self.valid_sets: List[Dataset] = []
        self.name_valid_sets: List[str] = []
        self.pandas_categorical: List = []
        if train_set is not None:
            # the JAX Booster's order (lightgbm_tpu/basic.py:408-416):
            # the data is binned with the booster's params under the
            # Dataset's own, and boosting reads the booster's alone
            train_set.params = {**self.params, **train_set.params}
            binned = train_set.construct(
                Config.from_params(train_set.params))
            self._gbdt = create_boosting(self.config, binned, self.device,
                                         ops=ops)
            self.pandas_categorical = train_set.pandas_categorical
        elif model_file is not None:
            with open(model_file) as f:
                text = f.read()
            self._loaded = load_model_from_string(text)
            self.pandas_categorical = _parse_pandas_categorical(text)
        elif model_str is not None:
            self._loaded = load_model_from_string(model_str)
            self.pandas_categorical = _parse_pandas_categorical(model_str)
        else:
            raise TypeError("Need at least one training dataset or model "
                            "file or model string to create Booster "
                            "instance")

    @classmethod
    def from_trees(cls, trees: List, params=None, device=None) -> "Booster":
        """A predict-only booster over carried-over trees
        (``convert.py``), converting scores with ``params``'s
        objective."""
        loaded = LoadedBooster()
        loaded.models = list(trees)
        loaded.objective = create_objective(Config.from_params(params))
        bst = cls(params=params, model_str="", device=device)
        bst._loaded = loaded
        return bst

    def _src(self):
        """The trained GBDT, or the loaded model."""
        return self._gbdt if self._gbdt is not None else self._loaded

    @property
    def models(self) -> List:
        return self._src().models

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Evaluate ``data`` (binned with the training set's mappers)
        after every iteration under ``name``."""
        if self._gbdt is None:
            raise LightGBMError("Booster was loaded from a model file; "
                                "cannot add validation data")
        if data.reference is None:
            data.reference = self.train_set
        self._gbdt.add_valid(data.construct(Config.from_params(
            {**self.train_set.params, **data.params})), name)
        self.valid_sets.append(data)
        self.name_valid_sets.append(name)
        return self

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Change parameters mid training (the ``reset_parameter``
        callback): the learning rate takes effect from the next tree."""
        self.params.update(params)
        if self._gbdt is not None:
            if "learning_rate" in params:
                self._gbdt.shrinkage_rate = float(params["learning_rate"])
            self.config = Config.from_params(self.params)
            self._gbdt.config = self.config
        return self

    def update(self, train_set: Optional[Dataset] = None,
               fobj=None) -> bool:
        """One boosting iteration, with the objective's gradients or
        ``fobj(raw_train_score, train_set) -> (grad, hess)``; True when
        training should stop."""
        if self._gbdt is None:
            raise LightGBMError("Cannot update a loaded-model Booster")
        if train_set is not None and train_set is not self.train_set:
            raise LightGBMError("change of train set is not supported; "
                                "create a new Booster")
        if fobj is None:
            return self._gbdt.train_one_iter()
        grad, hess = fobj(self._inner_predict_train(), self.train_set)
        return self._gbdt.train_one_iter(grad, hess)

    def _inner_predict_train(self) -> np.ndarray:
        """The raw train scores, float64: [N], or the reference's flat
        k blocks of N."""
        sc = self._gbdt.train_score.cpu().numpy().astype(np.float64)
        return sc[:, 0] if sc.shape[1] == 1 else sc.T.reshape(-1)

    # ------------------------------------------------------------------
    def eval(self, data: Dataset, name: str, feval=None) -> List:
        """Evaluate the training set or an added valid set."""
        if data is self.train_set:
            return self.eval_train(feval)
        for i, vd in enumerate(self.valid_sets):
            if vd is data:
                return self._eval_jobs(
                    [(self._gbdt.valid_metrics[i],
                      self._gbdt.valid_scores[i], name, data)], feval)
        raise LightGBMError("Data should be train set or a set added by "
                            "add_valid")

    def eval_train(self, feval=None) -> List:
        return self.eval_all(feval, include_train=True, include_valid=False)

    def eval_valid(self, feval=None) -> List:
        return self.eval_all(feval, include_train=False)

    def eval_all(self, feval=None, include_train: bool = True,
                 include_valid: bool = True) -> List:
        """(dataset, metric, value, bigger_better) of the training set
        and every valid set, with one host read of the metric values."""
        g = self._gbdt
        jobs = []
        if include_train:
            if not g.training_metrics:
                g.training_metrics = g._metrics_for(g.train_data)
            jobs.append((g.training_metrics, g.train_score,
                         self._train_data_name, self.train_set))
        if include_valid:
            jobs += list(zip(g.valid_metrics, g.valid_scores,
                             self.name_valid_sets, self.valid_sets))
        return self._eval_jobs(jobs, feval)

    def _eval_jobs(self, jobs, feval) -> List:
        g = self._gbdt
        rows = g.eval_sets([(m, sc, name) for m, sc, name, _ in jobs])
        out = []
        for metrics, score, name, dataset in jobs:
            n = sum(len(m.names) for m in metrics)
            out += rows[:n]
            rows = rows[n:]
            if feval is not None:
                flat = score.cpu().numpy().astype(np.float64)
                flat = flat[:, 0] if flat.shape[1] == 1 \
                    else flat.T.reshape(-1)
                res = feval(flat, dataset)
                if res is not None:
                    for mname, v, bigger in ([res] if isinstance(res, tuple)
                                             else res):
                        out.append((name, mname, v, bigger))
        return out

    def current_iteration(self) -> int:
        return self._src().num_iterations_trained

    def num_trees(self) -> int:
        return len(self._src().models)

    def num_model_per_iteration(self) -> int:
        return self._src().num_tree_per_iteration

    def num_feature(self) -> int:
        if self._gbdt is not None:
            return self._gbdt.train_data.num_total_features
        return self._loaded.max_feature_idx + 1

    def feature_name(self) -> List[str]:
        if self._gbdt is not None:
            return list(self._gbdt.train_data.feature_names)
        return list(self._loaded.feature_names)

    # ------------------------------------------------------------------
    def predict(self, data, num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, start_iteration: int = 0,
                **kwargs) -> np.ndarray:
        """Scores per row ([N], or [N, k] for k trees an iteration; raw,
        or converted by the objective), leaf indices ([N, T] int32) or
        SHAP contributions (``pred_contrib``: float64 [N, k * (F + 1)],
        each class's expected value last) of the iterations from
        ``start_iteration`` on (``num_iteration`` of them when > 0).
        ``pred_early_stop`` (with ``pred_early_stop_freq`` /
        ``_margin``, else the booster's params) stops a row's trees
        once its margin is reached. Sparse rows are densified in fixed
        chunks. A DataFrame's category columns are coded with the
        training set's categories (``pandas_categorical``)."""
        if _is_pandas_df(data):
            data = _data_from_pandas(data, self.pandas_categorical)[0]
        if num_iteration is None and self.best_iteration > 0:
            num_iteration = self.best_iteration
        es = {key: kwargs.get(key, getattr(self.config, key))
              for key in ("pred_early_stop", "pred_early_stop_freq",
                          "pred_early_stop_margin")}
        kw = dict(num_iteration=num_iteration,
                  start_iteration=start_iteration, raw_score=raw_score,
                  pred_leaf=pred_leaf, pred_contrib=pred_contrib, **es)
        if _is_sparse(data):
            csr = data.tocsr()
            step = SPARSE_PREDICT_CHUNK_ROWS
            return np.concatenate([
                self.predict(np.asarray(csr[lo:lo + step].todense()), **kw)
                for lo in range(0, max(csr.shape[0], 1), step)])
        return _predict(self._src(), data, self.device, **kw).cpu().numpy()

    # ------------------------------------------------------------------
    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        """The model text (of the iterations up to ``best_iteration``
        unless ``num_iteration`` says otherwise), with the
        ``pandas_categorical`` trailer line the JAX Booster appends (a
        DataFrame's categories, one list a category column, else
        ``[]``)."""
        text = save_model_to_string(
            self._src(), start_iteration,
            self._iterations(num_iteration))
        return text + "\npandas_categorical:" + json.dumps(
            self.pandas_categorical, default=str) + "\n"

    def save_model(self, filename: str,
                   num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        with open(filename, "w") as f:
            f.write(self.model_to_string(num_iteration, start_iteration))
        return self

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> Dict:
        return json.loads(dump_model_json(
            self._src(), start_iteration, self._iterations(num_iteration)))

    def _iterations(self, num_iteration: Optional[int]) -> int:
        if num_iteration is not None:
            return num_iteration
        return self.best_iteration if self.best_iteration > 0 else -1

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        imp = feature_importance(self._src(), importance_type,
                                 iteration if iteration is not None else 0)
        return imp.astype(np.int64) if importance_type == "split" else imp
