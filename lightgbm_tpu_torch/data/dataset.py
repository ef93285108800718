"""Constructed (binned) dataset + metadata for the PyTorch port.

Port of the dense numpy construction path of
``lightgbm_tpu/data/dataset.py`` (``Dataset.from_numpy``): the same
bin mappers, used-feature filter, monotone/penalty resolution and EFB
check, so both packages produce the same binned matrix from the same
arrays. The device copy is a ``torch`` tensor on the caller's device
(``binned_device``) instead of a lazily uploaded jax array.

Forced bin bounds come from a ``forcedbins_filename`` JSON
(``load_forced_bins``). A valid set is binned with its training set's
mappers (``reference=``, the JAX package's ``CreateValid`` path:
``values_to_bins`` through the same bins, no bin search), and query
groups fill ``Metadata`` (``set_query``). The features listed in
``categorical_features`` get the categorical bin mappers (count-sorted
categories, the 99% cut), as in the JAX package. Out of this slice
(``NotImplementedError`` naming the ROADMAP item): EFB plans that bundle
features or go multi-val, linear trees and the sparse / two-round /
streaming loaders.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..utils.log import log_fatal, log_warning
from .binning import (BIN_TYPE_CATEGORICAL, BIN_TYPE_NUMERICAL, BinMapper,
                      kZeroThreshold)


def load_forced_bins(path: str) -> Dict[int, List[float]]:
    """Parse a forced-bin-bounds JSON file (``forcedbins_filename``;
    DatasetLoader::GetForcedBins, src/io/dataset_loader.cpp:1203-1236):
    a list of ``{"feature": i, "bin_upper_bound": [...]}`` entries."""
    if not path:
        return {}
    if not os.path.exists(path):
        log_warning(f"Forced bins file {path} does not exist")
        return {}
    with open(path) as fh:
        entries = json.load(fh)
    return {int(e["feature"]): [float(v) for v in e["bin_upper_bound"]]
            for e in entries}


class Metadata:
    """Labels and side information (dataset.h:41-249)."""

    def __init__(self, num_data: int = 0):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None          # float32 [N]
        self.weights: Optional[np.ndarray] = None        # float32 [N]
        self.query_boundaries: Optional[np.ndarray] = None  # int32 [nq+1]
        self.query_weights: Optional[np.ndarray] = None  # float32 [nq]
        self.init_score: Optional[np.ndarray] = None     # float64 [N*k]

    def set_label(self, label: Sequence[float]) -> None:
        label = np.asarray(label, dtype=np.float32).ravel()
        if self.num_data and len(label) != self.num_data:
            log_fatal(f"Length of label ({len(label)}) doesn't match "
                      f"num_data ({self.num_data})")
        self.label = label
        self.num_data = len(label)

    def set_weights(self, weights: Optional[Sequence[float]]) -> None:
        if weights is None:
            self.weights = None
            return
        weights = np.asarray(weights, dtype=np.float32).ravel()
        if self.num_data and len(weights) != self.num_data:
            log_fatal(f"Length of weights ({len(weights)}) doesn't match "
                      f"num_data ({self.num_data})")
        self.weights = weights
        self._update_query_weights()

    def set_query(self, group: Optional[Sequence[int]]) -> None:
        """Query structure from per-query sizes (the ``.query`` file /
        ``set_group`` convention); boundary arrays (first element 0,
        last num_data, nondecreasing) are accepted when they cannot be
        row counts."""
        if group is None:
            self.query_boundaries = None
            self.query_weights = None
            return
        group = np.asarray(group, dtype=np.int64).ravel()
        if len(group) == 0:
            log_fatal("group/query must be non-empty")
        if group.sum() == self.num_data:
            boundaries = np.concatenate([[0], np.cumsum(group)])
        elif group[0] == 0 and group[-1] == self.num_data \
                and (np.diff(group) >= 0).all():
            boundaries = group
        else:
            log_fatal("Sum of query counts doesn't match num_data")
        self.query_boundaries = boundaries.astype(np.int32)
        self._update_query_weights()

    def _update_query_weights(self) -> None:
        # metadata.cpp: a query's weight is the mean of its rows' weights
        if self.weights is not None and self.query_boundaries is not None:
            qb = self.query_boundaries
            sums = np.add.reduceat(self.weights, qb[:-1])
            self.query_weights = (sums / np.maximum(np.diff(qb), 1)
                                  ).astype(np.float32)

    def num_queries(self) -> int:
        return 0 if self.query_boundaries is None \
            else len(self.query_boundaries) - 1

    def set_init_score(self, init_score: Optional[Sequence[float]]) -> None:
        if init_score is None:
            self.init_score = None
            return
        self.init_score = np.asarray(init_score, dtype=np.float64).ravel()


class Dataset:
    """Binned dataset: a dense ``[N, F]`` bin matrix on the host (uint8,
    or uint16 when a feature has more than 256 bins), copied to the
    training device as a tensor on demand."""

    def __init__(self):
        self.num_data: int = 0
        self.bin_mappers: List[BinMapper] = []       # per ORIGINAL feature
        self.used_feature_map: List[int] = []        # orig idx -> inner or -1
        self.real_feature_idx: List[int] = []        # inner idx -> orig idx
        self.binned: Optional[np.ndarray] = None     # [N, F_used] uint8/16
        self.num_total_features: int = 0
        self.feature_names: List[str] = []
        self.metadata = Metadata()
        self.max_bin: int = 255
        self.bin_construct_sample_cnt: int = 200000
        self.min_data_in_bin: int = 3
        self.use_missing: bool = True
        self.zero_as_missing: bool = False
        self.monotone_types: List[int] = []
        self.feature_penalty: List[float] = []
        self._device_copies = {}

    # ------------------------------------------------------------------
    def binned_device(self, device) -> torch.Tensor:
        """Device copy of the binned matrix (uploaded once per device):
        uint8, or for more than 256 bins the uint16 bins' bit patterns
        as int16 (torch's uint16 has few CPU ops; every bin is below
        2**15, so the values are the bins, and the leaf kernel reads the
        bits as uint16)."""
        key = str(torch.device(device))
        if key not in self._device_copies:
            host = np.ascontiguousarray(self.binned)
            if host.dtype == np.uint16:
                host = host.view(np.int16)
            self._device_copies[key] = torch.from_numpy(host).to(device)
        return self._device_copies[key]

    @property
    def num_features(self) -> int:
        return len(self.real_feature_idx)

    def num_bin(self, inner_feature: int) -> int:
        return self.bin_mappers[self.real_feature_idx[inner_feature]].num_bin

    def num_bins_array(self) -> np.ndarray:
        return np.asarray([self.num_bin(f) for f in range(self.num_features)],
                          dtype=np.int32)

    def feature_mapper(self, inner_feature: int) -> BinMapper:
        return self.bin_mappers[self.real_feature_idx[inner_feature]]

    # ------------------------------------------------------------------
    @classmethod
    def from_numpy(cls, data: np.ndarray, config: Config,
                   label: Optional[Sequence[float]] = None,
                   weight: Optional[Sequence[float]] = None,
                   init_score: Optional[Sequence[float]] = None,
                   feature_names: Optional[List[str]] = None,
                   categorical_features: Sequence[int] = (),
                   bin_mappers: Optional[List[BinMapper]] = None,
                   forced_bins: Optional[Dict[int, List[float]]] = None,
                   group: Optional[Sequence[int]] = None,
                   reference: Optional["Dataset"] = None
                   ) -> "Dataset":
        """Bin a raw dense feature matrix (CostructFromSampleData,
        dataset_loader.cpp:528-712, + ExtractFeatures push loop).

        ``bin_mappers`` adopts mappers built elsewhere (for example
        carried over from the JAX package by ``convert.py``) instead of
        finding bins, so both packages bin a matrix identically.
        ``forced_bins`` maps a feature to the bin upper bounds its bins
        must keep (``load_forced_bins``). ``categorical_features`` (original
        feature indices) get categorical mappers when bins are found here.
        ``reference`` (a valid set's training set) gives its whole layout:
        mappers, used features, monotone types and penalties; the rows go
        through its bins."""
        if config.linear_tree:
            raise NotImplementedError(
                "linear_tree is not in the port's first slice (ROADMAP.md "
                "Queue 1 item 7)")
        data = np.asarray(data)
        if data.ndim != 2:
            log_fatal("Dataset data must be 2-dimensional")
        n, num_features = data.shape
        self = cls()
        self.num_data = n
        self.num_total_features = num_features
        self.max_bin = config.max_bin
        self.bin_construct_sample_cnt = config.bin_construct_sample_cnt
        self.min_data_in_bin = config.min_data_in_bin
        self.use_missing = config.use_missing
        self.zero_as_missing = config.zero_as_missing
        self.feature_names = feature_names or [
            f"Column_{i}" for i in range(num_features)]

        if reference is not None:
            # valid set aligned with train (CreateValid, dataset.cpp:703)
            self._copy_layout_from(reference)
        elif bin_mappers is not None:
            if len(bin_mappers) != num_features:
                log_fatal(f"{len(bin_mappers)} bin mappers for "
                          f"{num_features} features")
            self.bin_mappers = list(bin_mappers)
            self._finalize_used_features()
        else:
            self._find_bins(data, config, categorical_features, forced_bins)
        if reference is None:
            self._resolve_monotone_and_penalty(config)
        self._extract_features(data)
        if reference is None:
            self._check_bundles(config)
        self.metadata.num_data = n
        if label is not None:
            self.metadata.set_label(label)
        self.metadata.set_weights(weight)
        self.metadata.set_query(group)
        self.metadata.set_init_score(init_score)
        return self

    def _copy_layout_from(self, ref: "Dataset") -> None:
        if self.num_total_features != ref.num_total_features:
            log_fatal(f"The validation data has {self.num_total_features} "
                      f"features but the training data "
                      f"{ref.num_total_features}")
        self.bin_mappers = list(ref.bin_mappers)
        self.used_feature_map = list(ref.used_feature_map)
        self.real_feature_idx = list(ref.real_feature_idx)
        self.monotone_types = list(ref.monotone_types)
        self.feature_penalty = list(ref.feature_penalty)
        self.max_bin = ref.max_bin

    def _find_bins(self, data: np.ndarray, config: Config,
                   categorical_features: Sequence[int],
                   forced_bins: Optional[Dict[int, List[float]]]) -> None:
        n = data.shape[0]
        sample_cnt = min(n, self.bin_construct_sample_cnt)
        rng = np.random.RandomState(config.data_random_seed)
        if sample_cnt < n:
            sample_idx = np.sort(rng.choice(n, sample_cnt, replace=False))
        else:
            sample_idx = np.arange(n)
        sample = np.asarray(data[sample_idx], np.float64)
        num_features = sample.shape[1]
        cat_set = set(int(c) for c in categorical_features)
        filter_cnt = int(max(
            config.min_data_in_leaf * sample_cnt / max(n, 1), 1)) \
            if config.feature_pre_filter else 0
        self.bin_mappers = []
        for j in range(num_features):
            col = sample[:, j]
            nonzero = col[(np.abs(col) > kZeroThreshold) | np.isnan(col)]
            mapper = BinMapper()
            mapper.find_bin(
                nonzero, total_sample_cnt=sample_cnt,
                max_bin=_max_bin_for(config, j),
                min_data_in_bin=self.min_data_in_bin,
                min_split_data=filter_cnt,
                pre_filter=config.feature_pre_filter,
                bin_type=BIN_TYPE_CATEGORICAL if j in cat_set
                else BIN_TYPE_NUMERICAL, use_missing=self.use_missing,
                zero_as_missing=self.zero_as_missing,
                forced_upper_bounds=(forced_bins or {}).get(j, ()))
            self.bin_mappers.append(mapper)
        self._finalize_used_features()

    def _finalize_used_features(self) -> None:
        self.used_feature_map = []
        self.real_feature_idx = []
        for j, m in enumerate(self.bin_mappers):
            if m.is_trivial:
                self.used_feature_map.append(-1)
            else:
                self.used_feature_map.append(len(self.real_feature_idx))
                self.real_feature_idx.append(j)
        if not self.real_feature_idx:
            log_warning("There are no meaningful features, as all feature "
                        "values are constant.")

    def _check_bundles(self, config: Config) -> None:
        """Run the EFB planner as the JAX package does
        (``Dataset._maybe_bundle``) and refuse any plan that is not the
        identity: the port's matrix has one column per feature."""
        if not config.enable_bundle or self.num_features < 2:
            return
        from .bundling import plan_bundles
        nb = self.num_bins_array()
        eligible = np.asarray([
            m.bin_type == BIN_TYPE_NUMERICAL and m.most_freq_bin == 0
            and m.default_bin == 0 and m.num_bin <= 256
            for m in (self.feature_mapper(i)
                      for i in range(self.num_features))])
        if not eligible.any():
            return
        plan = plan_bundles(self.binned, nb, eligible,
                            sample_cnt=self.bin_construct_sample_cnt,
                            seed=config.data_random_seed)
        if plan.num_groups < self.num_features or plan.has_multival:
            raise NotImplementedError(
                f"EFB would bundle {self.num_features} features into "
                f"{plan.num_groups} columns"
                + (" (multi-val)" if plan.has_multival else "")
                + "; bundled and multi-val datasets are not in the "
                "port's first slice (ROADMAP.md Queue 1 item 7). "
                "Pass enable_bundle=false to train unbundled.")

    def _resolve_monotone_and_penalty(self, config: Config) -> None:
        mt = list(config.monotone_constraints)
        fp = list(config.feature_contri)
        self.monotone_types = [
            (mt[j] if j < len(mt) else 0) for j in self.real_feature_idx] \
            if mt else []
        self.feature_penalty = [
            (fp[j] if j < len(fp) else 1.0) for j in self.real_feature_idx] \
            if fp else []

    def _extract_features(self, data: np.ndarray) -> None:
        n = data.shape[0]
        width = max(self.num_features, 1)
        max_b = max([self.num_bin(f) for f in range(self.num_features)],
                    default=2)
        dtype = np.uint8 if max_b <= 256 else np.uint16
        out = np.zeros((n, width), dtype=dtype)
        for inner, orig in enumerate(self.real_feature_idx):
            mapper = self.bin_mappers[orig]
            out[:, inner] = mapper.values_to_bins(
                np.asarray(data[:, orig], dtype=np.float64)).astype(dtype)
        self.binned = out


def _max_bin_for(config: Config, feature_idx: int) -> int:
    if config.max_bin_by_feature \
            and feature_idx < len(config.max_bin_by_feature):
        return int(config.max_bin_by_feature[feature_idx])
    return config.max_bin
