"""Constructed (binned) dataset + metadata for the PyTorch port.

Port of ``lightgbm_tpu/data/dataset.py``: the same bin mappers,
used-feature filter, monotone/penalty resolution and Exclusive Feature
Bundling (``_maybe_bundle``, ``data/bundling.py``), so both packages
produce the same binned matrix from the same arrays. After bundling the
matrix is ``[N, G_dense]`` group columns (uint8, or uint16 when a
singleton group keeps more than 256 bins), with the per-feature maps
``feature_group`` / ``feature_offset`` / ``group_num_bins``; features
that go multi-val ride the ``[N, K]`` int32 slot matrix ``mv_slots``
(``mv_group_start`` and up are its pseudo-groups). The device copies are
``torch`` tensors on the caller's device (``binned_device``,
``mv_slots_device``).

Loaders: ``from_numpy`` (a dense matrix), ``from_scipy`` (a scipy sparse
matrix, binned from its CSC nonzeros straight into the bundled matrix:
the raw float matrix never materializes) and ``from_file_two_round``
(``two_round=true``: pass 1 samples rows and reads the label columns,
pass 2 bins chunk by chunk). Forced bin bounds come from a
``forcedbins_filename`` JSON (``load_forced_bins``). A valid set is
binned with its training set's mappers and bundled through its plan
(``reference=``, the JAX package's ``CreateValid`` path), and query
groups fill ``Metadata`` (``set_query``). The features listed in
``categorical_features`` get the categorical bin mappers. With
``linear_tree`` a dense dataset also keeps its raw values of the used
features (``raw_numeric``, float32 [N, F] with NaN kept, on the device as
``raw_numeric_device``), as does a valid set of such a training set: the
linear leaves fit and score on raw values. A sparse or two-round dataset
keeps none, and training then falls back to constant leaves with a
warning, as in the JAX package.

A dataset's rows cut out (``subset``: bins, slots, raw values and
metadata, the layout kept; ``cv``'s folds), its features joined with
another's (``add_features_from``) and the binary file
(``save_binary`` / ``load_binary``, the JAX package's npz members and
meta keys, so either package reads the other's, with
``bin_layout_fingerprint`` for the alignment check) follow the JAX
package's functions of those names.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..utils.log import log_fatal, log_info, log_warning
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

    def subset(self, indices: np.ndarray) -> "Metadata":
        """The rows ``indices`` (JAX ``Metadata.subset``): label,
        weights and the class-major ``[k, N]`` init score. Queries
        cannot be cut by rows: the caller rebuilds them."""
        out = Metadata(len(indices))
        if self.label is not None:
            out.label = self.label[indices]
        if self.weights is not None:
            out.weights = self.weights[indices]
        if self.init_score is not None:
            k = len(self.init_score) // max(self.num_data, 1)
            out.init_score = self.init_score.reshape(
                k, self.num_data)[:, indices].ravel()
        return out


def _bundle_eligible(mapper: BinMapper) -> bool:
    """A feature EFB may share a column with: numerical, default and
    most frequent bin 0, at most 256 bins (the sparse-feature shape)."""
    return (mapper.bin_type == BIN_TYPE_NUMERICAL
            and mapper.most_freq_bin == 0 and mapper.default_bin == 0
            and mapper.num_bin <= 256)


class Dataset:
    """Binned dataset: a dense ``[N, G]`` bin matrix on the host (one
    column a feature unless EFB bundled them; uint8, or uint16 when a
    column has more than 256 bins) and, for multi-val pseudo-groups, the
    ``[N, K]`` slot matrix, copied to the training device as tensors on
    demand."""

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
        # EFB maps (None when unbundled; data/bundling.py)
        self.feature_group: Optional[np.ndarray] = None   # [F] i32
        self.feature_offset: Optional[np.ndarray] = None  # [F] i32
        self.group_num_bins: Optional[np.ndarray] = None  # [G] i32
        # multi-val pseudo-groups: slots [N, K] i32, groups >=
        # mv_group_start have no column
        self.mv_slots: Optional[np.ndarray] = None
        self.mv_group_start: Optional[int] = None
        # raw values of the used features [N, F] f32 (NaN kept), only
        # with linear_tree (the leaf models read raw values, not bins)
        self.raw_numeric: Optional[np.ndarray] = None
        self._device_copies = {}

    # ------------------------------------------------------------------
    def binned_device(self, device) -> torch.Tensor:
        """Device copy of the binned matrix (uploaded once per device):
        uint8; for more than 256 bins the uint16 bins' bit patterns as
        int16 while every bin is below 2**15 (torch's uint16 has few CPU
        ops; the values are the bins, and the kernels read the bits as
        uint16); past 32,768 bins in a column, int32 (int16 bits would
        read as negative values in every plain reader)."""
        key = str(torch.device(device))
        if key not in self._device_copies:
            host = np.ascontiguousarray(self.binned)
            if host.dtype == np.uint16:
                host = host.view(np.int16) if self.max_column_bins() \
                    <= 32768 else host.astype(np.int32)
            self._device_copies[key] = torch.from_numpy(host).to(device)
        return self._device_copies[key]

    def max_column_bins(self) -> int:
        """The most bins of a column of the bin matrix (a feature's, or
        with EFB a group's)."""
        _, _, group_bins = self.bundle_maps()
        return max(int(self.num_bins_array().max(initial=2)),
                   int(np.asarray(group_bins).max(initial=2)))

    def mv_slots_device(self, device) -> Optional[torch.Tensor]:
        """Device copy of the multi-val slot matrix (int32 [N, K]), or
        None without multi-val groups."""
        if self.mv_slots is None:
            return None
        key = "mv:" + str(torch.device(device))
        if key not in self._device_copies:
            self._device_copies[key] = torch.from_numpy(
                np.ascontiguousarray(self.mv_slots)).to(device)
        return self._device_copies[key]

    def mv_layout_device(self, device):
        """The compact layout of the device slot matrix that the multi-val
        histogram reads (``ops/hist_multival_cuda.py:MultivalLayout``),
        built once a device, or None without multi-val groups."""
        if self.mv_slots is None:
            return None
        key = "mvlayout:" + str(torch.device(device))
        if key not in self._device_copies:
            from ..ops.hist_multival_cuda import MultivalLayout
            self._device_copies[key] = MultivalLayout(
                self.mv_slots_device(device),
                self.num_groups - self.num_dense_groups)
        return self._device_copies[key]

    def raw_numeric_device(self, device) -> Optional[torch.Tensor]:
        """Device copy of ``raw_numeric`` (float32 [N, F]), or None."""
        if self.raw_numeric is None:
            return None
        key = "raw:" + str(torch.device(device))
        if key not in self._device_copies:
            self._device_copies[key] = torch.from_numpy(
                self.raw_numeric).to(device)
        return self._device_copies[key]

    def _store_raw(self, data: np.ndarray) -> None:
        """Keep the used features' raw values for the linear leaves (the
        reference's linear_tree keeps raw data too)."""
        idx = np.asarray(self.real_feature_idx, np.int64)
        self.raw_numeric = np.ascontiguousarray(
            np.asarray(data, np.float64)[:, idx], np.float32) \
            if idx.size else np.zeros((data.shape[0], 0), np.float32)

    @property
    def has_multival(self) -> bool:
        return self.mv_slots is not None

    @property
    def is_bundled(self) -> bool:
        return self.feature_offset is not None

    @property
    def num_features(self) -> int:
        return len(self.real_feature_idx)

    @property
    def num_groups(self) -> int:
        """Histogram groups, multi-val pseudo-groups included
        (``num_features`` when unbundled)."""
        if self.group_num_bins is not None:
            return len(self.group_num_bins)
        return self.num_features

    @property
    def num_dense_groups(self) -> int:
        """Physical matrix columns (the groups below mv_group_start)."""
        if self.mv_group_start is not None:
            return self.mv_group_start
        return self.num_groups

    def bundle_maps(self):
        """(feature_group, feature_offset, group_num_bins), the identity
        for an unbundled dataset."""
        f = self.num_features
        if self.feature_group is None:
            return (np.arange(f, dtype=np.int32), np.zeros(f, np.int32),
                    self.num_bins_array())
        return self.feature_group, self.feature_offset, self.group_num_bins

    def bundle_plan(self):
        """The stored bundling as a ``BundlePlan`` (valid sets bundle
        through it), or None when unbundled."""
        if self.feature_group is None:
            return None
        from .bundling import BundlePlan
        return BundlePlan(self.feature_group, self.feature_offset,
                          len(self.group_num_bins), self.group_num_bins,
                          mv_group_start=self.mv_group_start)

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
        data = np.asarray(data)
        if data.ndim != 2:
            log_fatal("Dataset data must be 2-dimensional")
        n, num_features = data.shape
        self = cls()
        self._init_from_config(config, n, num_features, feature_names)
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
        if config.linear_tree or (reference is not None
                                  and reference.raw_numeric is not None):
            self._store_raw(data)
        self._bundle_extracted(config, reference)
        self._set_metadata(n, label, weight, group, init_score)
        return self

    def _set_metadata(self, n, label, weight, group, init_score) -> None:
        self.metadata.num_data = n
        if label is not None:
            self.metadata.set_label(label)
        self.metadata.set_weights(weight)
        self.metadata.set_query(group)
        self.metadata.set_init_score(init_score)

    def _bundle_extracted(self, config: Config, reference) -> None:
        """After an unbundled extraction: plan and apply EFB, or for a
        valid set apply its training set's plan."""
        if reference is None:
            self._maybe_bundle(config)
        elif self.feature_group is not None:
            from .bundling import (build_mv_slots, bundle_matrix,
                                   dense_feature_bins)
            plan = self.bundle_plan()
            raw = self.binned
            self.binned = bundle_matrix(raw, plan)
            if plan.has_multival:
                self.mv_slots = build_mv_slots(plan, raw.shape[0],
                                               dense_feature_bins(raw))

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
        self.feature_group = ref.feature_group
        self.feature_offset = ref.feature_offset
        self.group_num_bins = ref.group_num_bins
        self.mv_group_start = ref.mv_group_start

    def _find_bins(self, data: np.ndarray, config: Config,
                   categorical_features: Sequence[int],
                   forced_bins: Optional[Dict[int, List[float]]]) -> None:
        n = data.shape[0]
        sample_idx = _sample_rows(n, self.bin_construct_sample_cnt,
                                  config.data_random_seed)
        self._find_bins_from_sample(np.asarray(data[sample_idx], np.float64),
                                    n, config, categorical_features,
                                    forced_bins)

    def _find_bins_from_sample(self, sample: np.ndarray, n: int,
                               config: Config,
                               categorical_features: Sequence[int],
                               forced_bins) -> None:
        """Bin mappers from an already drawn row sample (the in-memory
        and the two-round loaders). With ``pre_partition`` in a process
        group the ranks' samples are pooled first, in rank order
        (``parallel/distributed.py:maybe_gather_bin_sample``; JAX
        ``data/dataset.py:358``), so every rank bins alike."""
        from ..parallel.distributed import maybe_gather_bin_sample
        sample, n = maybe_gather_bin_sample(sample, config, n)
        cols = [sample[:, j] for j in range(sample.shape[1])]
        self._find_bins_from_columns(
            [c[(np.abs(c) > kZeroThreshold) | np.isnan(c)] for c in cols],
            sample.shape[0], n, config, categorical_features, forced_bins)

    def _find_bins_from_columns(self, nonzeros: List[np.ndarray],
                                sample_cnt: int, n: int, config: Config,
                                categorical_features: Sequence[int],
                                forced_bins) -> None:
        """One ``find_bin`` a column over its sampled non-zero values
        (zeros are implicit, counted through ``sample_cnt``)."""
        cat_set = set(int(c) for c in categorical_features)
        filter_cnt = int(max(
            config.min_data_in_leaf * sample_cnt / max(n, 1), 1)) \
            if config.feature_pre_filter else 0
        self.bin_mappers = []
        for j, nonzero in enumerate(nonzeros):
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

    def _maybe_bundle(self, config: Config) -> None:
        """EFB (FindGroups/FastFeatureBundling, dataset.cpp:41-314):
        collapse nearly exclusive features into shared columns, and
        overflowing sparse sets into multi-val pseudo-groups. No-op for
        dense data (every group a singleton)."""
        if not config.enable_bundle or self.num_features < 2:
            return
        from .bundling import (build_mv_slots, bundle_matrix,
                               dense_feature_bins, plan_bundles)
        eligible = np.asarray([_bundle_eligible(self.feature_mapper(i))
                               for i in range(self.num_features)])
        if not eligible.any():
            return
        plan = plan_bundles(self.binned, self.num_bins_array(), eligible,
                            sample_cnt=self.bin_construct_sample_cnt,
                            seed=config.data_random_seed)
        if plan.num_groups >= self.num_features \
                and not plan.has_multival:
            return
        log_info(f"EFB: bundled {self.num_features} features into "
                 f"{plan.num_groups} columns"
                 + (f" ({plan.num_groups - plan.mv_group_start} "
                    "multi-val)" if plan.has_multival else ""))
        raw = self.binned
        self.binned = bundle_matrix(raw, plan)
        if plan.has_multival:
            self.mv_slots = build_mv_slots(plan, raw.shape[0],
                                           dense_feature_bins(raw))
            self.mv_group_start = plan.mv_group_start
        self.feature_group = plan.feature_group
        self.feature_offset = plan.feature_offset
        self.group_num_bins = plan.group_num_bins

    def _resolve_monotone_and_penalty(self, config: Config) -> None:
        mt = list(config.monotone_constraints)
        fp = list(config.feature_contri)
        self.monotone_types = [
            (mt[j] if j < len(mt) else 0) for j in self.real_feature_idx] \
            if mt else []
        self.feature_penalty = [
            (fp[j] if j < len(fp) else 1.0) for j in self.real_feature_idx] \
            if fp else []

    def _empty_binned(self, n: int) -> np.ndarray:
        """The unbundled [n, F] bin matrix to fill: uint8, or uint16 when
        a feature has more than 256 bins."""
        max_b = max([self.num_bin(f) for f in range(self.num_features)],
                    default=2)
        return np.zeros((n, max(self.num_features, 1)),
                        np.uint8 if max_b <= 256 else np.uint16)

    def _bin_rows(self, data: np.ndarray, dtype) -> np.ndarray:
        out = np.zeros((data.shape[0], max(self.num_features, 1)), dtype)
        for inner, orig in enumerate(self.real_feature_idx):
            out[:, inner] = self.bin_mappers[orig].values_to_bins(
                np.asarray(data[:, orig], dtype=np.float64)).astype(dtype)
        return out

    def _extract_features(self, data: np.ndarray) -> None:
        self.binned = self._bin_rows(data, self._empty_binned(0).dtype)


    # ------------------------------------------------------------------
    @classmethod
    def from_scipy(cls, data, config: Config,
                   label: Optional[Sequence[float]] = None,
                   weight: Optional[Sequence[float]] = None,
                   init_score: Optional[Sequence[float]] = None,
                   feature_names: Optional[List[str]] = None,
                   categorical_features: Sequence[int] = (),
                   forced_bins: Optional[Dict[int, List[float]]] = None,
                   group: Optional[Sequence[int]] = None,
                   reference: Optional["Dataset"] = None) -> "Dataset":
        """Bin a scipy sparse matrix without densifying it (JAX
        ``Dataset.from_scipy``; the reference's SparseBin /
        MultiValSparseBin story): bin finding samples each CSC column's
        stored entries (zeros implicit, as the reference's sparse
        sampler), the EFB plan comes from the sampled rows' non-default
        entries, and extraction writes the binned nonzeros straight into
        the bundled matrix. Duplicate entries sum (scipy's semantics), on
        a copy: the caller's matrix is never changed."""
        import scipy.sparse as sp
        if not sp.issparse(data):
            log_fatal("Dataset.from_scipy requires a scipy.sparse matrix")
        csc = data.tocsc()
        if not csc.has_canonical_format:
            if csc is data:
                csc = csc.copy()
            csc.sum_duplicates()
        n, num_features = csc.shape
        self = cls()
        self._init_from_config(config, n, num_features, feature_names)
        if reference is not None:
            self._copy_layout_from(reference)
        else:
            self._find_bins_sparse(csc, config, categorical_features,
                                   forced_bins)
            self._resolve_monotone_and_penalty(config)
        self._extract_sparse(csc, config, reference)
        self._set_metadata(n, label, weight, group, init_score)
        return self

    def _init_from_config(self, config: Config, n: int, num_features: int,
                          feature_names) -> None:
        self.num_data = n
        self.num_total_features = num_features
        self.max_bin = config.max_bin
        self.bin_construct_sample_cnt = config.bin_construct_sample_cnt
        self.min_data_in_bin = config.min_data_in_bin
        self.use_missing = config.use_missing
        self.zero_as_missing = config.zero_as_missing
        self.feature_names = feature_names or [
            f"Column_{i}" for i in range(num_features)]

    def _find_bins_sparse(self, csc, config: Config,
                          categorical_features: Sequence[int],
                          forced_bins) -> None:
        """Per-column ``find_bin`` over the CSC nonzeros of a row sample
        (the same rows as the dense path's sample: the same draw)."""
        n, num_features = csc.shape
        sample_cnt = min(n, self.bin_construct_sample_cnt)
        in_sample = None
        if sample_cnt < n:
            in_sample = np.zeros(n, bool)
            in_sample[_sample_rows(n, sample_cnt,
                                   config.data_random_seed)] = True
        indptr, indices, vals = csc.indptr, csc.indices, csc.data
        nonzeros = []
        for j in range(num_features):
            colv = vals[indptr[j]:indptr[j + 1]]
            if in_sample is not None:
                colv = colv[in_sample[indices[indptr[j]:indptr[j + 1]]]]
            colv = np.asarray(colv, np.float64)
            nonzeros.append(colv[(np.abs(colv) > kZeroThreshold)
                                 | np.isnan(colv)])
        from ..parallel.distributed import maybe_gather_sparse_bin_sample
        nonzeros, sample_cnt, n = maybe_gather_sparse_bin_sample(
            nonzeros, sample_cnt, config, n)
        self._find_bins_from_columns(nonzeros, sample_cnt, n, config,
                                     categorical_features, forced_bins)

    def _extract_sparse(self, csc, config: Config, reference) -> None:
        """CSC nonzeros -> the (bundled) binned matrix and slots, with no
        [N, F] intermediate; the EFB plan comes from the row sample's
        non-default entries (``plan_bundles_from_nonzeros``)."""
        from .bundling import build_mv_slots, plan_bundles_from_nonzeros
        n = csc.shape[0]
        f_used = self.num_features
        indptr, indices, vals = csc.indptr, csc.indices, csc.data
        nbins = self.num_bins_array()
        dtype = np.uint8 if int(nbins.max(initial=2)) <= 256 else np.uint16
        zero_bin = np.zeros(max(f_used, 1), np.int64)
        bins_nz: List[np.ndarray] = []
        for inner, orig in enumerate(self.real_feature_idx):
            m = self.bin_mappers[orig]
            zero_bin[inner] = int(m.values_to_bins(np.zeros(1))[0])
            bins_nz.append(m.values_to_bins(np.asarray(
                vals[indptr[orig]:indptr[orig + 1]], np.float64)
            ).astype(dtype))

        def rows_of(inner):
            orig = self.real_feature_idx[inner]
            return indices[indptr[orig]:indptr[orig + 1]]

        plan = None
        if reference is not None:
            plan = self.bundle_plan()
        elif config.enable_bundle and f_used >= 2:
            take = min(n, self.bin_construct_sample_cnt)
            pos_of_row = None
            if take < n:
                rows = _sample_rows(n, take, config.data_random_seed)
                pos_of_row = np.full(n, -1, np.int32)
                pos_of_row[rows] = np.arange(take, dtype=np.int32)
            nz_idx: List[Optional[np.ndarray]] = []
            for inner in range(f_used):
                if not _bundle_eligible(self.feature_mapper(inner)):
                    nz_idx.append(None)
                    continue
                rows_j = rows_of(inner)[bins_nz[inner] != 0]
                if pos_of_row is None:
                    nz_idx.append(rows_j.astype(np.int32))
                else:
                    pos = pos_of_row[rows_j]
                    nz_idx.append(pos[pos >= 0])
            if any(ix is not None for ix in nz_idx):
                cand = plan_bundles_from_nonzeros(
                    nz_idx, nbins, take, seed=config.data_random_seed)
                if cand.num_groups < f_used or cand.has_multival:
                    log_info(
                        f"EFB: bundled {f_used} sparse features into "
                        f"{cand.num_groups} columns"
                        + (f" ({cand.num_groups - cand.mv_group_start}"
                           " multi-val)" if cand.has_multival else ""))
                    plan = cand
        g_dense = plan.num_dense_groups if plan is not None \
            else max(f_used, 1)
        if plan is not None:
            max_g = int(plan.group_num_bins[:g_dense].max(initial=2))
            dtype = np.uint8 if max_g <= 256 else np.uint16
        out = np.zeros((n, max(g_dense, 1)), dtype)
        for inner in range(f_used):
            if plan is not None and plan.feature_group[inner] >= g_dense:
                continue            # multi-val: the slot matrix below
            rows_j, bj = rows_of(inner), bins_nz[inner]
            if plan is None or plan.feature_offset[inner] == 0:
                g = inner if plan is None else plan.feature_group[inner]
                if zero_bin[inner]:
                    out[:, g] = zero_bin[inner]
                out[rows_j, g] = bj.astype(dtype)
            else:
                g = plan.feature_group[inner]
                off = int(plan.feature_offset[inner])
                nz = bj != 0
                out[rows_j[nz], g] = (bj[nz].astype(np.int64) + off
                                      - 1).astype(dtype)
        self.binned = out
        if plan is not None and plan.has_multival:
            def feature_bins(inner):
                bj = bins_nz[inner]
                nz = bj != 0
                return rows_of(inner)[nz], bj[nz].astype(np.int64)
            self.mv_slots = build_mv_slots(plan, n, feature_bins)
            self.mv_group_start = plan.mv_group_start
        if plan is not None and reference is None:
            self.feature_group = plan.feature_group
            self.feature_offset = plan.feature_offset
            self.group_num_bins = plan.group_num_bins

    # ------------------------------------------------------------------
    @classmethod
    def from_file_two_round(cls, path: str, config: Config, label=None,
                            weight=None, group=None, init_score=None,
                            feature_names: Optional[List[str]] = None,
                            categorical_features: Sequence[int] = (),
                            forced_bins=None,
                            reference: Optional["Dataset"] = None
                            ) -> "Dataset":
        """Two-pass file ingestion (``two_round=true``, the reference's
        DatasetLoader::LoadFromFile two_round branch,
        dataset_loader.cpp:201-216; JAX ``from_file_two_round``): pass 1
        streams the file for the bin sample (the in-memory path's draw,
        so the mappers are the same) and the label, weight and query
        columns; pass 2 bins it chunk by chunk into the packed matrix,
        which is then bundled. The float matrix of the whole file never
        materializes. Explicit label/weight/group/init_score arguments
        override the file's columns and sidecars."""
        from .file_loader import TwoRoundLoader, _qid_to_group_sizes
        loader = TwoRoundLoader(path, config)
        n = loader.count_rows()
        sample_idx = _sample_rows(n, min(n, config.bin_construct_sample_cnt),
                                  config.data_random_seed)
        parts, labels, weights, qids = [], [], [], []
        r = 0
        num_features = 0
        for X, lab, wt, qid in loader.iter_chunks():
            m = X.shape[0]
            num_features = X.shape[1]
            lo, hi = np.searchsorted(sample_idx, [r, r + m])
            if hi > lo:
                parts.append(X[sample_idx[lo:hi] - r])
            labels.append(np.asarray(lab, np.float64))
            if wt is not None:
                weights.append(np.asarray(wt, np.float64))
            if qid is not None:
                qids.append(np.asarray(qid, np.float64))
            r += m
        if r != n:
            log_fatal(f"two_round load of {path}: pass 1 saw {r} rows "
                      f"but the file has {n}")
        self = cls()
        self._init_from_config(config, n, num_features,
                               feature_names or loader.feature_names)
        sample = np.concatenate(parts) if parts \
            else np.zeros((0, num_features))
        if reference is not None:
            self._copy_layout_from(reference)
        else:
            self._find_bins_from_sample(sample, n, config,
                                        categorical_features, forced_bins)
            self._resolve_monotone_and_penalty(config)
        del sample, parts
        out = self._empty_binned(n)
        r = 0
        for X, _, _, _ in loader.iter_chunks():
            out[r:r + X.shape[0]] = self._bin_rows(X, out.dtype)
            r += X.shape[0]
        self.binned = out
        self._bundle_extracted(config, reference)
        f_weight, f_group, f_init = loader.load_sidecars()
        if label is None and labels:
            label = np.concatenate(labels)
        if weight is None:
            weight = f_weight if f_weight is not None else (
                np.concatenate(weights) if weights else None)
        if group is None:
            if f_group is not None:
                group = f_group
            elif qids:
                group = _qid_to_group_sizes(np.concatenate(qids))
        if init_score is None:
            init_score = f_init
        self._set_metadata(n, label, weight, None if group is None
                           else np.asarray(group, np.int64), init_score)
        log_info(f"Loaded {n} rows x {num_features} features from {path} "
                 f"in two passes ({loader.fmt})")
        return self


    # ------------------------------------------------------------------
    def subset(self, indices: np.ndarray) -> "Dataset":
        """The rows ``indices`` (CopySubset, dataset.cpp; JAX
        ``Dataset.subset``): their bins, multi-val slots and, with
        linear leaves, raw values; the mappers, used-feature maps and
        EFB layout are the parent's. The metadata is cut by
        ``Metadata.subset``; queries are the caller's to rebuild."""
        indices = np.asarray(indices)
        out = Dataset()
        out.__dict__.update({
            k: v for k, v in self.__dict__.items()
            if k not in ("binned", "metadata", "num_data", "mv_slots",
                         "raw_numeric", "_device_copies")})
        out.binned = self.binned[indices]
        out.mv_slots = self.mv_slots[indices] \
            if self.mv_slots is not None else None
        out.raw_numeric = np.ascontiguousarray(self.raw_numeric[indices]) \
            if self.raw_numeric is not None else None
        out.num_data = len(indices)
        out.metadata = self.metadata.subset(indices)
        return out

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Append ``other``'s features in place (Dataset::AddFeaturesFrom,
        dataset.h:497; JAX ``add_features_from``). Both hold the same
        rows; ``self`` keeps its metadata. A bundled layout stays
        bundled: ``other``'s group columns follow ``self``'s with
        shifted group ids. Multi-val pseudo-groups cannot be appended
        and are refused, as in the JAX package."""
        if other.num_data != self.num_data:
            log_fatal("Cannot add features from a dataset with "
                      f"{other.num_data} rows to one with "
                      f"{self.num_data} rows")
        if self.has_multival or other.has_multival:
            log_fatal("add_features_from is not supported for multi-val "
                      "datasets (pseudo-group ids cannot be appended)")
        f_self, f_other = self.num_features, other.num_features
        base_orig = self.num_total_features
        if self.feature_group is not None \
                or other.feature_group is not None:
            g_s, o_s, b_s = self.bundle_maps()
            g_o, o_o, b_o = other.bundle_maps()
            self.feature_group = np.concatenate(
                [g_s, g_o + len(b_s)]).astype(np.int32)
            self.feature_offset = np.concatenate([o_s, o_o]).astype(np.int32)
            self.group_num_bins = np.concatenate([b_s, b_o]).astype(np.int32)
        dtype = self.binned.dtype \
            if self.binned.dtype.itemsize >= other.binned.dtype.itemsize \
            else other.binned.dtype
        self.binned = np.concatenate(
            [self.binned.astype(dtype, copy=False),
             other.binned.astype(dtype, copy=False)], axis=1)
        if self.raw_numeric is not None and other.raw_numeric is not None:
            self.raw_numeric = np.concatenate(
                [self.raw_numeric, other.raw_numeric], axis=1)
        else:
            self.raw_numeric = None
        self._device_copies = {}
        self.bin_mappers = list(self.bin_mappers) + list(other.bin_mappers)
        self.used_feature_map = list(self.used_feature_map) + [
            (-1 if m < 0 else m + f_self) for m in other.used_feature_map]
        self.real_feature_idx = list(self.real_feature_idx) + [
            r + base_orig for r in other.real_feature_idx]
        self.num_total_features += other.num_total_features
        self.feature_names = list(self.feature_names) \
            + list(other.feature_names)

        def joined(a, b, fill):
            return (list(a) if a else [fill] * f_self) \
                + (list(b) if b else [fill] * f_other)
        if self.monotone_types or other.monotone_types:
            self.monotone_types = joined(self.monotone_types,
                                         other.monotone_types, 0)
        if self.feature_penalty or other.feature_penalty:
            self.feature_penalty = joined(self.feature_penalty,
                                          other.feature_penalty, 1.0)
        return self

    # ---- the binary dataset file (SaveBinaryFile, dataset.cpp) ---------
    def _layout_meta(self) -> dict:
        group = lambda a: None if a is None \
            else [int(v) for v in a]  # noqa: E731
        return {"mappers": [m.to_dict() for m in self.bin_mappers],
                "used_feature_map": [int(v) for v in self.used_feature_map],
                "num_total_features": int(self.num_total_features),
                "feature_group": group(self.feature_group),
                "feature_offset": group(self.feature_offset),
                "mv_group_start": self.mv_group_start}

    def save_binary(self, path: str) -> None:
        """Write the binned dataset to ``path`` exactly (no suffix
        added): an npz archive with the JAX package's members
        (``binned``, ``mv_slots``, ``label``, ``weights``,
        ``query_boundaries``, ``init_score``, ``meta``) and meta keys,
        so a file written by either package loads in the other. Raw
        values (``raw_numeric``) are not kept, as there."""
        md = self.metadata
        meta = dict(self._layout_meta(),
                    real_feature_idx=[int(v) for v in self.real_feature_idx],
                    feature_names=list(self.feature_names),
                    max_bin=self.max_bin,
                    min_data_in_bin=self.min_data_in_bin,
                    use_missing=self.use_missing,
                    zero_as_missing=self.zero_as_missing,
                    group_num_bins=None if self.group_num_bins is None
                    else [int(v) for v in self.group_num_bins])

        def or_empty(a, dtype, ndim=1):
            return a if a is not None else np.zeros((0,) * ndim, dtype)
        with open(path, "wb") as fh:
            np.savez_compressed(
                fh, binned=self.binned,
                mv_slots=or_empty(self.mv_slots, np.int32, 2),
                label=or_empty(md.label, np.float32),
                weights=or_empty(md.weights, np.float32),
                query_boundaries=or_empty(md.query_boundaries, np.int32),
                init_score=or_empty(md.init_score, np.float64),
                meta=np.frombuffer(json.dumps(meta).encode(), np.uint8))
        log_info(f"Saved binary dataset to {path}")

    @staticmethod
    def is_binary_file(path: str) -> bool:
        """True when ``path`` is a saved binary dataset
        (DatasetLoader::CheckCanLoadFromBin): a zip holding the
        ``binned`` and ``meta`` members, not merely a ``PK`` prefix."""
        import zipfile
        try:
            with open(path, "rb") as fh:
                if fh.read(2) != b"PK":
                    return False
            with np.load(path, allow_pickle=False) as z:
                return "binned" in z.files and "meta" in z.files
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            return False

    def bin_layout_fingerprint(self) -> str:
        """A digest of everything that decides where a raw value lands
        in the binned matrix (the mappers, the used-feature map, the EFB
        layout): two datasets with equal fingerprints bin alike. The
        binary load's alignment check against a reference compares them
        (the reference's ``CheckAlign``); the JAX package's digest of
        the same payload."""
        import hashlib
        blob = json.dumps(self._layout_meta(), sort_keys=True, default=float)
        return hashlib.sha1(blob.encode()).hexdigest()

    @classmethod
    def load_binary(cls, path: str) -> "Dataset":
        """A dataset written by ``save_binary`` (either package's)."""
        from .binning import BinMapper
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            self = cls()
            self.bin_mappers = [BinMapper.from_dict(d)
                                for d in meta["mappers"]]
            for key in ("used_feature_map", "real_feature_idx",
                        "feature_names", "num_total_features", "max_bin",
                        "min_data_in_bin", "use_missing", "zero_as_missing"):
                setattr(self, key, meta[key])
            if meta.get("feature_group") is not None:
                for key in ("feature_group", "feature_offset",
                            "group_num_bins"):
                    setattr(self, key, np.asarray(meta[key], np.int32))
            self.binned = z["binned"]
            if meta.get("mv_group_start") is not None:
                self.mv_group_start = meta["mv_group_start"]
                self.mv_slots = z["mv_slots"]
            self.num_data = len(self.binned)
            md = Metadata(self.num_data)
            if len(z["label"]):
                md.set_label(z["label"])
            if len(z["weights"]):
                md.set_weights(z["weights"])
            if len(z["query_boundaries"]):
                md.query_boundaries = z["query_boundaries"]
                md._update_query_weights()
            if len(z["init_score"]):
                md.init_score = z["init_score"]
            self.metadata = md
        return self

    # ---- refused until their ROADMAP items --------------------------
    @classmethod
    def from_sampled_columns(cls, *args, **kwargs):
        """The C API's streaming construction (JAX
        ``Dataset.from_sampled_columns``, LGBM_DatasetCreateFromSampled
        Column): ROADMAP.md Queue 1 item 12, with the C API."""
        _refuse("from_sampled_columns (streaming ingestion)", "12")

    def push_rows(self, *args, **kwargs):
        _refuse("push_rows (streaming ingestion)", "12")


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(
        f"{what} is not in the port yet (ROADMAP.md Queue 1 item {item})")


def _sample_rows(n: int, sample_cnt: int, seed: int) -> np.ndarray:
    """The bin-construction row sample: sorted, the same draw for every
    loader (dense, sparse, two-round) and for the EFB planner."""
    if sample_cnt < n:
        return np.sort(np.random.RandomState(seed).choice(
            n, sample_cnt, replace=False))
    return np.arange(n)


def _max_bin_for(config: Config, feature_idx: int) -> int:
    if config.max_bin_by_feature \
            and feature_idx < len(config.max_bin_by_feature):
        return int(config.max_bin_by_feature[feature_idx])
    return config.max_bin
