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
to ``best_iteration``. ``Dataset.subset`` cuts rows out of a binned
dataset when first used (whole queries for ranking data), a
``save_binary`` file loads as a dataset (checked against its
reference's bin layout), and ``add_features_from`` joins two binned
datasets' columns. ``Booster.refit`` refits a model's leaf values on
new rows (``GBDT.refit``), ``rollback_one_iter`` drops the last
iteration and ``reset_training_data`` moves a model onto new rows.

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

import copy
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
from .predictor import predict_raw
from .utils.device import resolve_device
from .utils.log import LightGBMError, log_fatal

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
        self.used_indices: Optional[np.ndarray] = None
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
        if self.data is None:
            raise LightGBMError(
                "the raw feature matrix is gone (free_raw_data=True, or a "
                "subset); construct the Dataset with free_raw_data=False "
                "and not via subset()")
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

    def construct(self) -> "Dataset":
        """Bin the data (once) with this dataset's params over its
        reference's, and return this ``Dataset`` (JAX ``basic.py:118``,
        LightGBM's ``Dataset.construct``); ``_construct`` returns the
        binned dataset itself."""
        self._construct()
        return self

    def _construct(self, config: Optional[Config] = None) -> _BinnedDataset:
        """Bin the data (once), with ``config`` or, without one, this
        dataset's params over its reference's: a dense matrix, a
        DataFrame or a text file through ``from_numpy``; a scipy sparse
        matrix through ``from_scipy``, never densified (JAX
        ``basic.py:241-260``); a text file with ``two_round=true``
        through ``from_file_two_round``, in two passes over the file; a
        file written by ``save_binary`` by loading it; a ``subset`` by
        cutting its reference's binned rows."""
        if self._binned is not None:
            return self._binned
        if config is None:
            config = Config.from_params(self._merged_params())
        ref = None
        if self.reference is not None:
            ref = self.reference._construct(config)
        if self.used_indices is not None:
            self._binned = self._subset_of(ref)
            return self._binned
        if isinstance(self.data, str) \
                and _BinnedDataset.is_binary_file(self.data):
            self._binned = self._load_binary(ref)
            return self._binned
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
            self._binned = _BinnedDataset.from_scipy(self.data, config, **kw)
        else:
            self._binned = _BinnedDataset.from_numpy(X, config, **kw)
        from .observability.telemetry import get_telemetry
        tel = get_telemetry()
        tel.count("data.rows_binned", self._binned.num_data)
        tel.count("data.cells_binned",
                  self._binned.num_data * self._binned.num_features)
        if self.free_raw_data:
            self.data = None
        return self._binned

    def _merged_params(self) -> Dict[str, Any]:
        if self.reference is not None:
            return {**self.reference.params, **self.params}
        return dict(self.params)

    def _subset_of(self, parent: _BinnedDataset) -> _BinnedDataset:
        """The reference's rows ``used_indices`` (JAX
        ``basic.py:124-136``); without a ``group`` of its own, a subset of
        a ranking set keeps whole queries: their sizes are rebuilt from
        the parent's query ids of the kept rows."""
        out = parent.subset(self.used_indices)
        if self.group is not None:
            out.metadata.set_query(self.group)
        elif parent.metadata.query_boundaries is not None:
            qb = parent.metadata.query_boundaries
            qid = np.repeat(np.arange(len(qb) - 1),
                            np.diff(qb))[self.used_indices]
            change = np.nonzero(np.diff(qid))[0]
            bounds = np.concatenate([[0], change + 1, [len(qid)]])
            out.metadata.set_query(np.diff(bounds))
        return out

    def _load_binary(self, ref: Optional[_BinnedDataset]) -> _BinnedDataset:
        """A ``save_binary`` file (DatasetLoader::CheckCanLoadFromBin):
        with a reference its bin layout must be the reference's
        (``CheckAlign``); the label, weight, group and init score given
        here override the file's, and the file's fill those not given
        (JAX ``basic.py:145-184``)."""
        out = _BinnedDataset.load_binary(self.data)
        if ref is not None and ref.bin_layout_fingerprint() \
                != out.bin_layout_fingerprint():
            log_fatal(f"binary dataset {self.data!r} was saved with a "
                      "different bin layout than its reference (train) "
                      "set; re-save it with reference=<train set> so the "
                      "bin mappers align, or load the text file instead")
        md = out.metadata
        if self.label is not None:
            md.set_label(self.label)
        else:
            self.label = md.label
        if self.weight is not None:
            md.set_weights(self.weight)
        else:
            self.weight = md.weights
        if self.group is not None:
            md.set_query(self.group)
        elif md.query_boundaries is not None:
            self.group = np.diff(md.query_boundaries)
        if self.init_score is not None:
            md.set_init_score(self.init_score)
        else:
            self.init_score = md.init_score
        if self.free_raw_data:
            self.data = None
        return out

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
        """The rows ``used_indices`` (sorted) of this dataset, binned
        with its bins when first used (reference basic.py:1322-1341; the
        folds of ``cv``)."""
        out = Dataset(None, reference=self, feature_name=self.feature_name,
                      categorical_feature=self.categorical_feature,
                      params=params or self.params)
        out.used_indices = np.sort(np.asarray(used_indices, np.int64))
        return out

    def save_binary(self, filename: str) -> "Dataset":
        """Write the binned dataset to ``filename`` (the JAX package's
        npz format: either package loads the other's)."""
        self._construct().save_binary(filename)
        return self

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Append ``other``'s features to this dataset in place (both
        binned, the same rows; this dataset keeps its label, weight and
        group)."""
        self._construct().add_features_from(other._construct())
        return self

    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._binned is not None and label is not None:
            self._binned.metadata.set_label(label)
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._binned is not None:
            self._binned.metadata.set_weights(weight)
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._binned is not None:
            self._binned.metadata.set_init_score(init_score)
        return self

    def set_group(self, group) -> "Dataset":
        self.group = group
        if self._binned is not None:
            self._binned.metadata.set_query(group)
        return self

    def set_reference(self, reference: "Dataset") -> "Dataset":
        self.reference = reference
        return self

    def get_label(self):
        if self._binned is not None \
                and self._binned.metadata.label is not None:
            return self._binned.metadata.label
        return self.label

    def get_weight(self):
        if self._binned is not None \
                and self._binned.metadata.weights is not None:
            return self._binned.metadata.weights
        return self.weight

    def get_group(self):
        if self._binned is not None \
                and self._binned.metadata.query_boundaries is not None:
            return np.diff(self._binned.metadata.query_boundaries)
        return self.group

    def get_init_score(self):
        return self.init_score

    def get_data(self):
        return self.data

    def num_data(self) -> int:
        return self._construct().num_data

    def num_feature(self) -> int:
        return self._construct().num_total_features

    def get_feature_name(self) -> List[str]:
        return list(self._construct().feature_names)

    def get_ref_chain(self, ref_limit: int = 100):
        """This dataset and its references, up to ``ref_limit``."""
        chain, head = set(), self
        while head is not None and len(chain) < ref_limit:
            chain.add(head)
            head = head.reference
        return chain


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
        self.ops = ops
        self.best_iteration = -1
        self.best_score: Dict = {}
        # set by engine.train: the checkpoint iteration a run resumed
        # from, and whether a preemption signal stopped it
        self.resumed_iteration: Optional[int] = None
        self.preempted = False
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
            binned = train_set._construct(
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
        self._gbdt.add_valid(data._construct(Config.from_params(
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

    def rollback_one_iter(self) -> "Booster":
        """Drop the last iteration's trees and their scores."""
        self._gbdt.rollback_one_iter()
        return self

    def reset_training_data(self, train_set: Dataset) -> "Booster":
        """Swap the training data under the model (GBDT::ResetTrainingData,
        gbdt.cpp:244-262; JAX ``basic.py:463-520``): the trees are kept
        and their raw sums over the new rows seed its scores (the
        continued-training seed), so the next ``update`` boosts on the
        new data's residuals. The new data has the model's feature count
        and comes before any ``add_valid`` (a valid set's bins follow
        the old training set's mappers)."""
        if self._gbdt is None:
            raise LightGBMError("Booster was loaded from a model file; "
                                "cannot reset training data")
        if self.valid_sets:
            raise LightGBMError(
                "reset_training_data must be called before adding "
                "validation data (valid bins reference the old training "
                "mappers)")
        if not isinstance(train_set, Dataset):
            raise TypeError("Training data should be Dataset instance, met "
                            f"{type(train_set).__name__}")
        train_set.params = {**self.params, **train_set.params}
        binned = train_set._construct(Config.from_params(train_set.params))
        want = self._gbdt.train_data.num_features
        if binned.num_features != want:
            raise LightGBMError(
                f"reset_training_data: new dataset has "
                f"{binned.num_features} features, model expects {want}")
        gbdt = create_boosting(self.config, binned, self.device,
                               ops=self.ops)
        models = list(self._gbdt.models)
        if models:
            gbdt.init_from_models(models, predict_raw(
                models, train_set.raw_matrix(self.config), self.device,
                gbdt.num_tree_per_iteration))
        self._gbdt = gbdt
        self.train_set = train_set
        self.pandas_categorical = train_set.pandas_categorical
        return self

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
        from .observability.telemetry import get_telemetry
        g = self._gbdt
        tel = get_telemetry()
        # every dataset's metrics on the device, one host read for all
        tel.count_iter("host.syncs")
        tel.count_iter("host.dispatches", len(jobs))
        rows = g.eval_sets([(m, sc, name) for m, sc, name, _ in jobs])
        out = []
        for metrics, score, name, dataset in jobs:
            n = sum(len(m.names) for m in metrics)
            out += rows[:n]
            rows = rows[n:]
            if feval is not None:
                tel.count_iter("host.syncs")
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
    def refit(self, data, label, decay_rate: float = 0.9,
              **kwargs) -> "Booster":
        """A new Booster with this model's trees, their leaf values refit
        on ``data``/``label`` (reference basic.py:2614-2659; JAX
        ``basic.py:722-773``): ``predict(pred_leaf=True)`` over every
        tree (``kwargs`` go to it), then ``GBDT.refit``'s replay on a
        Booster over the new rows, on this booster's device and ops,
        with ``leaf = decay_rate * old + (1 - decay_rate) * new``. A
        model loaded from text takes its objective from its
        ``objective`` line; linear trees refit their coefficients from
        the raw rows."""
        src = self._src()
        if getattr(src, "objective", None) is None \
                and not getattr(src, "objective_str", ""):
            raise LightGBMError("Cannot refit due to null objective function.")
        kwargs.setdefault("num_iteration", -1)
        leaf_preds = self.predict(data, pred_leaf=True, **kwargs)
        params = dict(self.params, refit_decay_rate=decay_rate)
        obj_str = getattr(src, "objective_str", "")
        if "objective" not in params and obj_str:
            # "binary sigmoid:1", "multiclass num_class:3", ...
            toks = obj_str.split()
            params["objective"] = toks[0]
            for tok in toks[1:]:
                key, _, val = tok.partition(":")
                if key and val:
                    params.setdefault(key, val)
        raw = None
        if any(t.is_linear for t in src.models):
            params.setdefault("linear_tree", True)
            if _is_pandas_df(data):
                raw = _data_from_pandas(data, self.pandas_categorical)[0]
            elif _is_sparse(data):
                raw = data.toarray()
            raw = np.asarray(data if raw is None else raw, np.float64)
        return self._refit_on(Dataset(data, label=label), leaf_preds,
                              params, raw)

    def _refit_on(self, train_set: Dataset, leaf_preds: np.ndarray,
                  params: Dict[str, Any], raw=None,
                  ops: Optional[str] = None) -> "Booster":
        """``refit``'s second half: a Booster over ``train_set`` with
        copies of this model's trees, refit from ``leaf_preds``."""
        src = self._src()
        out = Booster(params, train_set, device=self.device,
                      ops=self.ops if ops is None else ops)
        out._gbdt.models = [copy.deepcopy(t) for t in src.models]
        out._gbdt.iter = len(src.models) // src.num_tree_per_iteration
        out._gbdt.refit(leaf_preds, raw=raw)
        return out

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
