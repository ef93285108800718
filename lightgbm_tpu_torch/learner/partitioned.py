"""Partitioned leaf-wise tree learner (port of
``lightgbm_tpu/learner/partitioned.py``).

Like the JAX learner, it keeps the training matrix PHYSICALLY
partitioned by leaf (contiguous row segments, the reference's
``DataPartition``), so each split costs O(leaf rows): partition the
chosen leaf's rows in place, build the SMALLER child's histogram from its
segment, get the sibling as parent minus child
(serial_tree_learner.cpp:434-436), and find both children's best splits.
The per-leaf state and the tree arrays ride the JAX package's merged
packed layout (``S``, ``T``; ``learner/split_step.py``).

Two grow loops, chosen before training (``fused_split_kernel``):

  * **fused** (default "auto" on a CUDA device, or "on"): the root's
    histogram and scan run through their kernels, ``S``, ``T`` and the
    per-leaf histogram cache are packed on the device, and the host
    enqueues ``num_leaves - 1`` launches of the fused split-step kernel
    (``ops/split_step_cuda.py``) without waiting on any of them; the
    kernel stops growing by itself. Then ``S``, ``T`` and ``k`` are read
    once. On the CPU, or with ``ops="plain"``, each step is its plain
    version.
  * **per-phase** ("off", "auto" on the CPU, and configurations outside
    the fused step's scope, categorical features among them): a Python
    loop over splits; per split the host enqueues the partition (a
    categorical split through its LUT route), histogram and scan
    kernels (``ops/partition_cuda.py``, ``ops/hist_cuda.py``,
    ``ops/split_scan_cuda.py``) and, with categorical features, the
    categorical search (``ops/split_categorical.py``), then reads the
    scan tables and the child segments once.

Both loops write the same state through the same float32 bookkeeping
(on host scalars in the per-phase loop and the fused step's plain
version, on the device in its kernel) and size the child histogram by
the parent's row count, so they grow the same trees. The
row order persists across trees; only the grad/hess payload is repacked
per tree, through the row id each row carries.

An EFB dataset (``data/bundling.py``) trains on its group columns: the
matrix, the root and child histograms and the per-leaf cache are over
the G groups, each leaf's histograms are debundled into per-feature
ones before its scans (``ops/histogram.py:Debundler``), and a numerical
split of a feature sharing its group partitions the group's column
through the partition kernel's LUT route
(``ops/partition_cuda.py:partition_decision_lut``).
Bundled data always takes the per-phase loop, and a multi-val dataset
(pseudo-groups without a column) goes to the serial learner.

On a CPU device every op runs its plain PyTorch version. ``ops="plain"``
runs the plain versions on a CUDA device too (the parity check of
``chip_smoke.py``); it is the caller's explicit choice, never a
fall-back.

The per-phase loop also carries what the fused step does not model
(``learner/grow_extras.py``, ``learner/node_rand.py``): extra_trees and
by-node feature sampling (a node table a tree, which the scan kernel
reads by each leaf's salt), CEGB (penalties applied to the scan tables
on the host, with the raw tables kept for the coupled refund), forced
splits (split first, from the leaf's histogram) and a bounded
histogram memory (an LRU pool of ``histogram_pool_size`` MB, or both
children rebuilt every split). Any of them keeps a tree per-phase.
The parallel learners (``parallel/learners.py``) are these learners
with a communication recipe (``comm``, ``learner/comm.py``): the
per-phase loop only, the histograms reduced and the splits chosen
across ranks.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data.binning import (BIN_TYPE_CATEGORICAL, MISSING_NAN,
                            MISSING_NONE, MISSING_ZERO)
from ..data.dataset import Dataset
from ..ops.hist_cuda import (build_matrix, extract_row_ids,
                             histogram_segment, histogram_segment_plain,
                             pack_gh)
from ..ops.histogram import Debundler, debundle_leaf_hists
from ..ops.split import (MISSING_NAN_CODE, MISSING_NONE_CODE,
                         MISSING_ZERO_CODE, FeatureMeta, SplitParams,
                         meta_tensors, per_feature_splits)
from ..ops.split_scan_cuda import (per_feature_numerical_cuda,
                                   per_feature_numerical_plain,
                                   scan_meta_tables)
from ..ops.split_step_cuda import (MAX_BINS, FusedScratch, SegmentStep,
                                   fused_split_step_segment_plain,
                                   learner_fused_kernel_on,
                                   pack_meta_tables, segment_histogram,
                                   segment_split_ops)
from ..ops.split_scan_cuda import node_rows, node_table
from ..utils.log import log_warning
from .comm import comm_root_hooks
from .grow_extras import (CegbState, HistMemory, build_forced_plan,
                          cegb_on, cegb_penalties, hist_pool_slots)
from .node_rand import NodeRand
from .split_step import (SEG_SI_PREFIX, count_tree_telemetry, f32,
                         fused_split_eligible,
                         fused_split_kernel_mode, grown_tree,
                         make_grow_pack, root_state, split_step_host)

_MISSING_CODE = {MISSING_NONE: MISSING_NONE_CODE,
                 MISSING_ZERO: MISSING_ZERO_CODE,
                 MISSING_NAN: MISSING_NAN_CODE}


def split_params_from_config(config: Config, any_missing: bool = True,
                             has_categorical: bool = False) -> SplitParams:
    on, lazy = cegb_on(config)
    return SplitParams(
        lambda_l1=float(config.lambda_l1),
        lambda_l2=float(config.lambda_l2),
        max_delta_step=float(config.max_delta_step),
        min_data_in_leaf=float(config.min_data_in_leaf),
        min_sum_hessian_in_leaf=float(config.min_sum_hessian_in_leaf),
        min_gain_to_split=float(config.min_gain_to_split),
        any_missing=any_missing,
        max_cat_threshold=int(config.max_cat_threshold),
        cat_l2=float(config.cat_l2),
        cat_smooth=float(config.cat_smooth),
        max_cat_to_onehot=int(config.max_cat_to_onehot),
        min_data_per_group=float(config.min_data_per_group),
        has_categorical=has_categorical,
        cegb_on=on, cegb_lazy_on=lazy,
        cegb_tradeoff=float(config.cegb_tradeoff),
        cegb_penalty_split=float(config.cegb_penalty_split))


def dataset_any_missing(dataset: Dataset) -> bool:
    return any(dataset.feature_mapper(i).missing_type != MISSING_NONE
               for i in range(dataset.num_features))


def dataset_has_categorical(dataset: Dataset) -> bool:
    return any(dataset.feature_mapper(i).bin_type == BIN_TYPE_CATEGORICAL
               for i in range(dataset.num_features))


def dataset_has_monotone(dataset: Dataset) -> bool:
    return bool(dataset.monotone_types) \
        and any(int(t) != 0 for t in dataset.monotone_types)


def feature_meta_from_dataset(dataset: Dataset,
                              config: Optional[Config] = None
                              ) -> FeatureMeta:
    """Static per-feature metadata (learner/serial.py of the JAX
    package), with each feature's EFB group and offset and, given the
    config, its CEGB penalties."""
    f = dataset.num_features
    coupled, lazy = cegb_penalties(dataset, config) \
        if config is not None else (None, None)
    mappers = [dataset.feature_mapper(i) for i in range(f)]
    group, offset, _ = dataset.bundle_maps()
    return FeatureMeta(
        num_bins=dataset.num_bins_array(),
        missing=np.asarray([_MISSING_CODE[m.missing_type] for m in mappers],
                           np.int32),
        default_bin=np.asarray([m.default_bin for m in mappers], np.int32),
        most_freq_bin=np.asarray([m.most_freq_bin for m in mappers],
                                 np.int32),
        monotone=np.asarray(dataset.monotone_types, np.int32)
        if dataset.monotone_types else np.zeros(f, np.int32),
        penalty=np.asarray(dataset.feature_penalty, np.float32)
        if dataset.feature_penalty else np.ones(f, np.float32),
        is_categorical=np.asarray(
            [m.bin_type == BIN_TYPE_CATEGORICAL for m in mappers], bool),
        group=np.asarray(group, np.int32),
        offset=np.asarray(offset, np.int32),
        cegb_coupled_penalty=coupled, cegb_lazy_penalty=lazy)


class LeafwiseLearner:
    """What the two learners share: the feature metadata and split
    parameters, the histogram memory, the per-node randomness, the
    forced plan and CEGB state, the merged pack of the learner's layout,
    the fused gate and the scan. A subclass names its layout
    (``LAYOUT``, a key of ``MAX_BINS``: the fused kernel's bins), its
    pack's int prefix rows (``SI_PREFIX``), the most bins it takes
    (``MAX_LEARNER_BINS``) and its refusal past them (``BIN_NOTE``, the
    bins as ``{n}``),
    whether its
    histogram memory may be an LRU pool (``POOL``) and whether it keeps
    the lazy CEGB penalty (``LAZY_CEGB``), then adds its layout's own
    state."""

    LAYOUT = "segment"
    SI_PREFIX = SEG_SI_PREFIX
    MAX_LEARNER_BINS = MAX_BINS["segment"]
    BIN_NOTE = ""
    POOL = True
    LAZY_CEGB = False
    # a parallel learner's recipe (learner/comm.py); None: serial
    comm = None

    def __init__(self, dataset: Dataset, config: Config,
                 device: torch.device, ops: str = "kernel"):
        if ops not in ("kernel", "plain"):
            raise ValueError(f"ops must be 'kernel' or 'plain', got {ops!r}")
        self.dataset = dataset
        self.config = config
        self.device = torch.device(device)
        self.plain = ops == "plain" or self.device.type == "cpu"
        self.meta = feature_meta_from_dataset(dataset, config)
        self.has_categorical = dataset_has_categorical(dataset)
        self.params = split_params_from_config(
            config, dataset_any_missing(dataset), self.has_categorical)
        if self.params.cegb_lazy_on and not self.LAZY_CEGB:
            log_warning("cegb_penalty_feature_lazy is only supported by "
                        "the serial tree learner (partitioned learners "
                        "keep rows physically reordered); ignoring the "
                        "lazy penalty")
            on, lazy = cegb_on(config, lazy_ok=False)
            self.params = self.params._replace(cegb_on=on,
                                               cegb_lazy_on=lazy)
        # the histograms are over the EFB groups (a feature a group when
        # unbundled); the widest of a feature and a group sets B
        _, _, group_bins = dataset.bundle_maps()
        self.num_bins_max = max(
            int(dataset.num_bins_array().max(initial=2)),
            int(np.asarray(group_bins).max(initial=2)))
        if self.num_bins_max > self.MAX_LEARNER_BINS:
            raise ValueError(f"{type(self).__name__} " + self.BIN_NOTE.format(
                n=self.num_bins_max))
        self.num_leaves = int(config.num_leaves)
        self.bundled = dataset.is_bundled
        self.num_groups = dataset.num_groups
        self.num_cols = dataset.num_dense_groups   # bin matrix columns
        self.max_depth = int(config.max_depth)
        self.num_features = dataset.num_features
        self.num_data = dataset.num_data
        self.has_monotone = dataset_has_monotone(dataset)
        # a cache row holds the histograms of the dataset's groups
        self.hist_slots = hist_pool_slots(config, self.num_leaves,
                                          self.num_groups, self.num_bins_max)
        self.mem = HistMemory.for_learner(
            self.hist_slots, self.num_leaves,
            (self.num_groups, self.num_bins_max, 3), self.device,
            pool_ok=self.POOL)
        self.hist = self.mem.hist
        self.node_rand = NodeRand(config, self.meta.num_bins)
        self._node = None
        self.forced_plan = build_forced_plan(dataset, config, _MISSING_CODE)
        self.cegb = CegbState(
            self.params, self.meta.cegb_coupled_penalty,
            self.meta.cegb_lazy_penalty, self.num_data, self.device,
            self.params.cegb_lazy_on) if self.params.cegb_on else None
        self._meta_all = meta_tensors(self.meta, self.device)
        self._debundler = Debundler(
            self.meta.group, self.meta.offset, self.meta.num_bins,
            self.num_bins_max, self.device) if self.bundled else None
        self._tables_all = scan_meta_tables(self._meta_all)
        self._packed_all = pack_meta_tables(self.meta, None, self.device)
        self.pack = make_grow_pack(self.SI_PREFIX,
                                   has_monotone=self.has_monotone,
                                   big_l=self.num_leaves,
                                   has_cat=self.has_categorical)
        # CEGB, per-node randomness, a bounded histogram memory and a
        # forced plan keep the per-phase loop (the JAX package's gate)
        self.fused = learner_fused_kernel_on(
            fused_split_kernel_mode(config.fused_split_kernel),
            eligible=fused_split_eligible(
                self.params, cache_hists=self.mem.mode == "cache",
                merged=True, extra_trees=bool(config.extra_trees),
                ff_bynode=float(config.feature_fraction_bynode),
                mv_groups=self.num_groups - self.num_cols,
                serial_comm=self.comm is None,
                num_leaves=self.num_leaves) and not self.forced_plan,
            device=self.device, params=self.params,
            num_bins_max=self.num_bins_max, layout=self.LAYOUT,
            bundled=self.bundled)

    def _device_bins(self, dataset: Dataset) -> torch.Tensor:
        """The bin matrix this learner trains on, on its device (a
        parallel learner's row block: ``parallel/learners.py``)."""
        return dataset.binned_device(self.device)

    def checkpoint_arrays(self) -> dict:
        """The learner's state that outlives a tree, as host arrays for
        a checkpoint (``robustness/checkpoint.py``): CEGB's used features
        and the lazy penalty's charged rows."""
        if self.cegb is None:
            return {}
        out = {"cegb_used": self.cegb.used.copy()}
        if self.cegb.charged is not None:
            out["cegb_charged"] = self.cegb.charged.cpu().numpy()
        return out

    def restore_arrays(self, arrays: dict) -> None:
        """Put back what ``checkpoint_arrays`` saved."""
        if self.cegb is None or "cegb_used" not in arrays:
            return
        self.cegb.used[:] = arrays["cegb_used"]
        if self.cegb.charged is not None and "cegb_charged" in arrays:
            self.cegb.charged.copy_(torch.from_numpy(
                arrays["cegb_charged"].copy()))

    def _tree_meta(self, feature_mask: Optional[np.ndarray]):
        """The scan's meta tensors and tables and the fused step's packed
        tables for one tree's features; draws the tree's node table
        (extra_trees, by-node sampling) for every salt of the tree."""
        keys = self._tree_keys = self.node_rand.next_tree_keys()
        self._node = None
        if keys is not None:
            rb, nm = self.node_rand.tables(keys, feature_mask,
                                           2 * self.num_leaves + 1)
            self._node = node_table(rb, nm, self.num_features, self.device)
        if feature_mask is None:
            return (self._meta_all, self._tables_all) + self._packed_all
        meta_t = meta_tensors(self.meta, self.device, feature_mask)
        return (meta_t, scan_meta_tables(meta_t)) + pack_meta_tables(
            self.meta, feature_mask, self.device)

    def _feature_hist(self, hist, sums):
        """A leaf's per-feature histograms (debundled from its totals
        when the dataset is bundled)."""
        if not self.bundled:
            return hist
        return debundle_leaf_hists(self._debundler, [hist], [sums])[0]

    def _scan(self, hists, leaves, meta_t, tables, salts=(0, 0)
              ) -> torch.Tensor:
        """Both children's (or the root's) per-feature table, the same on
        every rank: the serial scan, or a parallel recipe's select
        (``learner/comm.py``)."""
        return comm_root_hooks(self.comm)[1](self, hists, leaves, meta_t,
                                             tables, salts)

    def serial_scan(self, hists, leaves, meta_t, tables, salts=(0, 0)
                    ) -> torch.Tensor:
        """The numerical scan (the kernel, or its plain version) with
        each leaf's row of the tree's node table (``salts``), merged with
        the categorical search when the dataset has categorical
        features. An EFB dataset's group histograms are debundled into
        per-feature histograms first (JAX partitioned.py:430-434,
        split_step.py:425-440), each from its own leaf's totals."""
        if self.bundled:
            hists = debundle_leaf_hists(self._debundler, hists, leaves)
        return self.scan_table(hists, leaves, meta_t, tables, self.params,
                               self._node, salts)

    def scan_table(self, hists, leaves, meta_t, tables, params,
                   node=None, salts=(0, 0)) -> torch.Tensor:
        """[K, F, C] table of K leaves' per-feature histograms (``meta_t``
        and ``tables`` of the same F features) under ``params``."""
        if self.plain:
            table = per_feature_numerical_plain(hists, leaves, meta_t,
                                                params, node, salts)
        else:
            table = per_feature_numerical_cuda(hists, leaves, meta_t,
                                               params, tables,
                                               node=node, salts=salts)
        nm = None if node is None or not params.has_categorical \
            else torch.stack([m for _, m in node_rows(node,
                                                      salts[:len(hists)])])
        return per_feature_splits(table, hists, leaves, meta_t, params, nm)

    def _root_scan(self, root_hist, meta_t, tables):
        """Keep the root's histogram and scan it; returns the scan
        table (penalized, with CEGB) and the root's (g, h, count). The
        root's one host read is its sums, which the scan takes as
        scalars (the same on every rank of a parallel learner)."""
        self.mem.start_tree(root_hist, self.num_leaves)
        root = comm_root_hooks(self.comm)[0](self, root_hist)
        inf = f32(np.inf)
        table = self._scan([root_hist], [root + (-inf, inf)], meta_t,
                           tables, (0,))[0]
        if self.cegb is not None:
            table = torch.from_numpy(self.cegb.root(table.cpu().numpy(),
                                                    root[2]))
        return table, root

    def _grow_host(self, st, ops: SplitOps, imeta) -> int:
        """The per-phase split loop over host-side ``S``/``T``: the
        forced plan's splits first (the first that fails ends the plan),
        then the best open leaf's until none gains; returns k."""
        kw = dict(imeta=imeta, params=self.params, big_l=self.num_leaves,
                  max_depth=self.max_depth, has_monotone=self.has_monotone,
                  cegb=self.cegb)
        k = 1
        builds0 = self.mem.builds
        for step in self.forced_plan:
            if not split_step_host(self.pack, st, self.mem, k, ops,
                                   forced=(step, self._feature_hist), **kw):
                break
            k += 1
        while split_step_host(self.pack, st, self.mem, k, ops, **kw):
            k += 1
        # a split: its partition, child histogram and scan, and the
        # histogram memory's extra builds; the gains read before every
        # split tried and the scan tables' read after it
        splits = k - 1
        self._count_tree(2 + 3 * splits + self.mem.builds - builds0,
                         1 + 2 * splits + int(k < self.num_leaves))
        return k

    def _count_tree(self, dispatches: int, syncs: int) -> None:
        """A tree's telemetry (``learner/split_step.py``)."""
        count_tree_telemetry(self, dispatches, syncs)


class PartitionedTreeLearner(LeafwiseLearner):
    """The port's segment-layout learner (the JAX package's accelerator
    learner for datasets whose bins fit a byte).

    ``train(grad, hess)`` grows one tree and returns ``(Tree, leaf_id)``
    with ``leaf_id`` [N] int64 on the device. ``fused`` says which grow
    loop it runs (decided here, before training)."""

    # JAX learner/partitioned.py:141-145
    BIN_NOTE = ("packs bins as uint8 and supports max 256 bins per "
                "feature, got {n}; use max_bin<=255 or "
                "tree_learner='serial'")

    def __init__(self, dataset: Dataset, config: Config,
                 device: torch.device, ops: str = "kernel"):
        if dataset.has_multival:
            raise ValueError(
                f"{type(self).__name__} needs a matrix column per group; "
                "a multi-val dataset trains on the SerialTreeLearner")
        super().__init__(dataset, config, device, ops)
        self.mat = build_matrix(self._device_bins(dataset))
        self.ws = torch.empty_like(self.mat)
        self._ones = torch.ones(self.num_data, dtype=torch.float32,
                                device=self.device)
        self._scratch = FusedScratch(self.mat, self.num_cols,
                                     self.num_bins_max) \
            if self.fused and not self.plain else None

    # ------------------------------------------------------------------
    def train(self, grad: torch.Tensor, hess: torch.Tensor,
              feature_mask: Optional[np.ndarray] = None,
              bag_weight: Optional[torch.Tensor] = None):
        f, n = self.num_cols, self.num_data
        meta_t, tables, imeta, fmeta = self._tree_meta(feature_mask)
        # repack the gh payload in the current row order (rows carry
        # their id), weighted (JAX partitioned.py:331-335): an
        # out-of-bag row keeps its place in its segment with zero g/h
        # and count 0, so every count below comes from the count
        # channel and every segment length stays a row count
        rids = extract_row_ids(self.mat, f, n).long()
        if bag_weight is None:
            pack_gh(self.mat, f, grad[rids], hess[rids], self._ones)
        else:
            w = bag_weight[rids]
            pack_gh(self.mat, f, grad[rids] * w, hess[rids] * w, w)
        if self.cegb is not None:
            self.cegb.start_tree(self.num_leaves)
        table, root = self._root_scan(self._segment_hist(0, n, n), meta_t,
                                      tables)
        if self.fused:
            st, k = self._grow_fused(table, root, imeta, fmeta)
            # the root's histogram and scan, L - 1 steps; one read
            self._count_tree(self.num_leaves + 1, 1)
        else:
            st, k = self._grow_per_phase(table.cpu(), root, meta_t, tables,
                                         imeta)
        tree, v = grown_tree(self.pack, st, k, self.dataset)
        return tree, self._leaf_id(v["leaf_begin"], v["leaf_cnt"], k)

    def checkpoint_arrays(self) -> dict:
        """Adds the matrix's row order: it persists across trees, and a
        segment histogram's float64 sums follow it."""
        out = super().checkpoint_arrays()
        out["row_order"] = extract_row_ids(self.mat, self.num_cols,
                                           self.num_data).cpu().numpy()
        return out

    def restore_arrays(self, arrays: dict) -> None:
        super().restore_arrays(arrays)
        if "row_order" not in arrays:
            return
        cur = extract_row_ids(self.mat, self.num_cols,
                              self.num_data).long()
        pos = torch.empty_like(cur)
        pos[cur] = torch.arange(self.num_data, device=self.device)
        want = torch.from_numpy(arrays["row_order"].astype(np.int64))
        self.mat.copy_(self.mat[pos[want.to(self.device)]])

    def _segment_hist(self, begin: int, count: int, max_count: int):
        """One segment's histogram (host bounds): with a data-parallel
        recipe its float64 sums reduced across the ranks and rounded
        once, else the rank's own."""
        if self.comm is None or not self.comm.float64_hist:
            return segment_histogram(self.mat, begin, count,
                                     self.num_bins_max, self.num_cols,
                                     plain=self.plain, max_count=max_count)
        if self.plain:
            h = histogram_segment_plain(self.mat, begin, count,
                                        self.num_bins_max, self.num_cols,
                                        float64=True)
        else:
            h = histogram_segment(self.mat, begin, count, self.num_bins_max,
                                  self.num_cols, max_count=max_count,
                                  float64=True)
        return self.comm.reduce_hist(h)

    def _grow_fused(self, table, root, imeta, fmeta):
        """S, T and the histogram cache stay on the device; L - 1 fused
        steps are enqueued without a host read (each stops by itself
        once the tree is done), then S, T and k are read once."""
        st = root_state(self.pack, table, *root, self.num_data,
                        self.params, self.num_leaves)
        k = torch.ones((1,), dtype=torch.int32, device=self.device)
        self._launch_fused(k, st["S"], st["T"], imeta, fmeta)
        # the tree's one host read
        return {"S": st["S"].cpu(), "T": st["T"].cpu()}, int(k.cpu()[0])

    def _launch_fused(self, k, S, T, imeta, fmeta) -> None:
        """The split loop of one tree: L - 1 fused steps, enqueued with
        no host read in between."""
        kw = dict(params=self.params, big_l=self.num_leaves,
                  max_depth=self.max_depth, b=self.num_bins_max,
                  f=self.num_cols, has_monotone=self.has_monotone)
        args = (k, S, T, self.mat, self.ws, self.hist, imeta, fmeta)
        if self.plain:
            step = partial(fused_split_step_segment_plain, *args, **kw)
        else:   # checked and converted once a tree
            step = SegmentStep(*args, scratch=self._scratch, **kw)
        for _ in range(self.num_leaves - 1):
            step()

    def _grow_per_phase(self, table, root, meta_t, tables, imeta):
        """S and T on the host; one host read of the scan tables and the
        child segments per split (inside ``split_step_host``)."""
        st = root_state(self.pack, table, *root, self.num_data,
                        self.params, self.num_leaves)
        im = imeta.cpu().numpy()
        ops = segment_split_ops(
            self.mat, self.ws, im, self.num_bins_max, self.num_cols,
            lambda hists, leaves, salts: self._scan(hists, leaves, meta_t,
                                                    tables, salts),
            plain=self.plain, bundled=self.bundled,
            histogram=None if self.comm is None or not self.comm.float64_hist
            else lambda mat, begin, count, cnt: self._segment_hist(
                begin, count, cnt))
        return st, self._grow_host(st, ops, im)

    def _leaf_id(self, begin: np.ndarray, cnt: np.ndarray,
                 k: int) -> torch.Tensor:
        """Row id -> leaf from the final segments: leaves in segment
        order, each repeated over its rows, scattered by row id. Built
        on the device from the k segments (``output_size`` spares the
        sync), not as an N-long host array copied across."""
        order = np.argsort(begin[:k], kind="stable")
        pos_leaf = torch.repeat_interleave(
            torch.as_tensor(order, dtype=torch.int64, device=self.device),
            torch.as_tensor(cnt[:k][order].astype(np.int64),
                            device=self.device),
            output_size=self.num_data)
        rids = extract_row_ids(self.mat, self.num_cols,
                               self.num_data).long()
        return torch.empty(self.num_data, dtype=torch.int64,
                           device=self.device).scatter_(0, rids, pos_leaf)
