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
    the fused step's scope): a Python loop over splits; per split the
    host enqueues the partition, histogram and scan kernels
    (``ops/partition_cuda.py``, ``ops/hist_cuda.py``,
    ``ops/split_scan_cuda.py``), then reads the scan tables and the
    child segments once.

Both loops write the same state through the same float32 bookkeeping
(on host scalars in the per-phase loop, on 0-dim tensors in the fused
step's plain version, on the device in its kernel) and size the child
histogram by the parent's row count, so they grow the same trees. The
row order persists across trees; only the grad/hess payload is repacked
per tree, through the row id each row carries.

On a CPU device every op runs its plain PyTorch version. ``ops="plain"``
runs the plain versions on a CUDA device too (the parity check of
``chip_smoke.py``); it is the caller's explicit choice, never a
fall-back.

Configurations outside this slice raise ``NotImplementedError`` naming
the ROADMAP item (``check_slice``).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data.binning import MISSING_NAN, MISSING_NONE, MISSING_ZERO
from ..data.dataset import Dataset
from ..ops.hist_cuda import (build_matrix, extract_row_ids,
                             histogram_segment, histogram_segment_plain,
                             pack_gh)
from ..ops.partition_cuda import partition_segment, partition_segment_plain
from ..ops.split import (MISSING_NAN_CODE, MISSING_NONE_CODE,
                         MISSING_ZERO_CODE, FeatureMeta, SplitParams,
                         meta_tensors)
from ..ops.split_scan_cuda import (per_feature_numerical_cuda,
                                   per_feature_numerical_plain,
                                   scan_meta_tables)
from ..ops.split_step_cuda import (MAX_BINS, FusedScratch, SegmentStep,
                                   fused_split_step_segment_plain,
                                   learner_fused_kernel_on,
                                   pack_meta_tables)
from .split_step import (SEG_SI_PREFIX, SplitOps, f32,
                         fused_split_eligible, fused_split_kernel_mode,
                         grown_tree, make_grow_pack, root_state,
                         split_step_host)

_MISSING_CODE = {MISSING_NONE: MISSING_NONE_CODE,
                 MISSING_ZERO: MISSING_ZERO_CODE,
                 MISSING_NAN: MISSING_NAN_CODE}


def _reject(what: str, item: str) -> None:
    raise NotImplementedError(
        f"{what} is not in the port yet (ROADMAP.md {item})")


def check_slice(config: Config) -> None:
    """Refuse configurations outside the port's slices; nothing is
    approximated."""
    if config.boosting != "gbdt":
        _reject(f"boosting={config.boosting}", "Queue 1 item 7")
    if config.bagging_freq > 0 and (
            config.bagging_fraction < 1.0
            or config.pos_bagging_fraction < 1.0
            or config.neg_bagging_fraction < 1.0):
        _reject("bagging", "Queue 1 item 7")
    if split_cegb_on(config):
        _reject("CEGB", "Queue 1 item 7")
    if config.extra_trees:
        _reject("extra_trees", "Queue 1 item 7")
    if config.forcedsplits_filename:
        _reject("forced splits", "Queue 1 item 7")
    if config.linear_tree:
        _reject("linear_tree", "Queue 1 item 7")
    if config.feature_fraction_bynode < 1.0:
        _reject("feature_fraction_bynode", "Queue 1 item 7")
    if config.tree_learner not in ("serial", "partitioned"):
        _reject(f"tree_learner={config.tree_learner}", "Queue 1 item 8")


def check_pool_mode(config: Config, num_features: int, num_bins_max: int,
                    num_leaves: int) -> None:
    """Refuse a ``histogram_pool_size`` too small for a cache row per
    leaf (the JAX package's pool-bounded mode)."""
    pool = float(config.histogram_pool_size)
    if pool > 0 and pool * 1024 * 1024 // (
            num_features * num_bins_max * 12) < num_leaves:
        _reject("histogram_pool_size pool mode", "Queue 1 item 7")


def split_cegb_on(config: Config) -> bool:
    lazy = any(float(c) > 0.0 for c in config.cegb_penalty_feature_lazy)
    coupled = any(float(c) > 0.0
                  for c in config.cegb_penalty_feature_coupled)
    return float(config.cegb_tradeoff) > 0.0 and (
        lazy or coupled or float(config.cegb_penalty_split) > 0.0)


def split_params_from_config(config: Config,
                             any_missing: bool = True) -> SplitParams:
    return SplitParams(
        lambda_l1=float(config.lambda_l1),
        lambda_l2=float(config.lambda_l2),
        max_delta_step=float(config.max_delta_step),
        min_data_in_leaf=float(config.min_data_in_leaf),
        min_sum_hessian_in_leaf=float(config.min_sum_hessian_in_leaf),
        min_gain_to_split=float(config.min_gain_to_split),
        any_missing=any_missing)


def dataset_any_missing(dataset: Dataset) -> bool:
    return any(dataset.feature_mapper(i).missing_type != MISSING_NONE
               for i in range(dataset.num_features))


def dataset_has_monotone(dataset: Dataset) -> bool:
    return bool(dataset.monotone_types) \
        and any(int(t) != 0 for t in dataset.monotone_types)


def feature_meta_from_dataset(dataset: Dataset) -> FeatureMeta:
    """Static per-feature metadata (learner/serial.py of the JAX
    package)."""
    f = dataset.num_features
    mappers = [dataset.feature_mapper(i) for i in range(f)]
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
        is_categorical=np.zeros(f, bool))


class LeafwiseLearner:
    """What the two learners share: the slice checks, the feature
    metadata and split parameters, the per-leaf histogram cache, the
    merged pack of the learner's layout, the fused gate and the scan.
    A subclass names its layout (``LAYOUT``, a key of ``MAX_BINS``), its
    pack's int prefix rows (``SI_PREFIX``) and what its bin cap means
    (``BIN_NOTE``), then adds its layout's own state."""

    LAYOUT = "segment"
    SI_PREFIX = SEG_SI_PREFIX
    BIN_NOTE = ""

    def __init__(self, dataset: Dataset, config: Config,
                 device: torch.device, ops: str = "kernel"):
        check_slice(config)
        if ops not in ("kernel", "plain"):
            raise ValueError(f"ops must be 'kernel' or 'plain', got {ops!r}")
        self.dataset = dataset
        self.config = config
        self.device = torch.device(device)
        self.plain = ops == "plain" or self.device.type == "cpu"
        self.meta = feature_meta_from_dataset(dataset)
        self.params = split_params_from_config(
            config, dataset_any_missing(dataset))
        self.num_bins_max = int(dataset.num_bins_array().max(initial=2))
        if self.num_bins_max > MAX_BINS[self.LAYOUT]:
            _reject(f"{self.num_bins_max} bins per feature {self.BIN_NOTE}",
                    "Queue 1 item 4")
        self.num_leaves = int(config.num_leaves)
        check_pool_mode(config, dataset.num_features, self.num_bins_max,
                        self.num_leaves)
        self.max_depth = int(config.max_depth)
        self.num_features = dataset.num_features
        self.num_data = dataset.num_data
        self.has_monotone = dataset_has_monotone(dataset)
        self.hist = torch.zeros(
            (self.num_leaves, self.num_features, self.num_bins_max, 3),
            dtype=torch.float32, device=self.device)
        self._meta_all = meta_tensors(self.meta, self.device)
        self._tables_all = scan_meta_tables(self._meta_all)
        self._packed_all = pack_meta_tables(self.meta, None, self.device)
        self.pack = make_grow_pack(self.SI_PREFIX,
                                   has_monotone=self.has_monotone,
                                   big_l=self.num_leaves)
        self.fused = learner_fused_kernel_on(
            fused_split_kernel_mode(config.fused_split_kernel),
            eligible=fused_split_eligible(
                self.params, cache_hists=True, merged=True,
                extra_trees=bool(config.extra_trees),
                ff_bynode=float(config.feature_fraction_bynode),
                num_leaves=self.num_leaves),
            device=self.device, params=self.params,
            num_bins_max=self.num_bins_max, layout=self.LAYOUT)

    def _tree_meta(self, feature_mask: Optional[np.ndarray]):
        """The scan's meta tensors and tables and the fused step's packed
        tables for one tree's features."""
        if feature_mask is None:
            return (self._meta_all, self._tables_all) + self._packed_all
        meta_t = meta_tensors(self.meta, self.device, feature_mask)
        return (meta_t, scan_meta_tables(meta_t)) + pack_meta_tables(
            self.meta, feature_mask, self.device)

    def _scan(self, hists, leaves, meta_t, tables) -> torch.Tensor:
        if self.plain:
            return per_feature_numerical_plain(hists, leaves, meta_t,
                                               self.params)
        return per_feature_numerical_cuda(hists, leaves, meta_t,
                                          self.params, tables)

    def _root_scan(self, root_hist, meta_t, tables):
        """Cache the root's histogram and scan it; returns the scan
        table and the root's (g, h, count). The root's one host read is
        its sums, which the scan takes as scalars."""
        self.hist[0] = root_hist
        sums = root_hist[0].sum(dim=0).cpu().numpy()
        root = (f32(sums[0]), f32(sums[1]), f32(sums[2]))
        inf = f32(np.inf)
        table = self._scan([root_hist], [root + (-inf, inf)], meta_t,
                           tables)[0]
        return table, root

    def _grow_host(self, st, ops: SplitOps, imeta) -> int:
        """The per-phase split loop over host-side ``S``/``T``; returns
        k."""
        k = 1
        while split_step_host(self.pack, st, self.hist, k, ops, imeta=imeta,
                              params=self.params, big_l=self.num_leaves,
                              max_depth=self.max_depth,
                              has_monotone=self.has_monotone):
            k += 1
        return k


class PartitionedTreeLearner(LeafwiseLearner):
    """The port's segment-layout learner (the JAX package's accelerator
    learner for datasets whose bins fit a byte).

    ``train(grad, hess)`` grows one tree and returns ``(Tree, leaf_id)``
    with ``leaf_id`` [N] int64 on the device. ``fused`` says which grow
    loop it runs (decided here, before training)."""

    BIN_NOTE = ("in the partitioned learner (the matrix packs bins as "
                "uint8; tree_learner=serial takes up to 1024)")

    def __init__(self, dataset: Dataset, config: Config,
                 device: torch.device, ops: str = "kernel"):
        super().__init__(dataset, config, device, ops)
        self.mat = build_matrix(dataset.binned_device(self.device))
        self.ws = torch.empty_like(self.mat)
        self._ones = torch.ones(self.num_data, dtype=torch.float32,
                                device=self.device)
        self._scratch = FusedScratch(self.mat, self.num_features,
                                     self.num_bins_max) \
            if self.fused and not self.plain else None

    # ---- the per-phase ops, kernel or plain ----------------------------
    def _histogram(self, begin, count, max_count):
        f, b = self.num_features, self.num_bins_max
        if self.plain:
            if isinstance(begin, torch.Tensor):
                begin, count = (int(v) for v in begin.tolist())
            return histogram_segment_plain(self.mat, int(begin), int(count),
                                           b, f)
        return histogram_segment(self.mat, begin, count, b, f,
                                 max_count=max_count)

    def _partition(self, begin, cnt, feat, thr, dleft):
        m = self.meta
        fn = partition_segment_plain if self.plain else partition_segment
        return fn(self.mat, self.ws, int(begin), int(cnt), feat, thr, dleft,
                  int(m.missing[feat]), int(m.default_bin[feat]),
                  int(m.num_bins[feat]), False, None)

    # ------------------------------------------------------------------
    def train(self, grad: torch.Tensor, hess: torch.Tensor,
              feature_mask: Optional[np.ndarray] = None):
        f, n = self.num_features, self.num_data
        meta_t, tables, imeta, fmeta = self._tree_meta(feature_mask)
        # repack the gh payload in the current row order (rows carry
        # their id); bagging is out of this slice, so every row counts
        rids = extract_row_ids(self.mat, f, n).long()
        pack_gh(self.mat, f, grad[rids], hess[rids], self._ones)
        table, root = self._root_scan(self._histogram(0, n, n), meta_t,
                                      tables)
        if self.fused:
            st, k = self._grow_fused(table, root, imeta, fmeta)
        else:
            st, k = self._grow_per_phase(table.cpu(), root, meta_t, tables,
                                         imeta)
        tree, v = grown_tree(self.pack, st, k, self.dataset)
        return tree, self._leaf_id(v["leaf_begin"], v["leaf_cnt"], k)

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
                  f=self.num_features, has_monotone=self.has_monotone)
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
        def partition(site, leaf, new):
            cnt = int(site["leaf_cnt"])
            seg = self._partition(site["leaf_begin"], cnt,
                                  int(site["bs_feat"]), int(site["bs_thr"]),
                                  bool(site["bs_dleft"]))
            return seg, cnt

        def histogram(part, small_left):
            # the launch is sized by the parent's row count (a bound the
            # host knows); the kernel cuts the chunks from the child's own
            # count on the device, as the fused step does
            seg, cnt = part
            return self._histogram(seg[0:2] if small_left else seg[2:4],
                                   None, cnt)

        def extra_i(part):
            # the child segments travel as extra int state fields
            sg = part[0].cpu().numpy()
            return tuple(dict(leaf_begin=int(sg[i]), leaf_cnt=int(sg[i + 1]))
                         for i in (0, 2))

        ops = SplitOps(
            partition=partition, histogram=histogram,
            scan=lambda hists, leaves: self._scan(hists, leaves, meta_t,
                                                  tables),
            extra_i=extra_i)
        return st, self._grow_host(st, ops, imeta.cpu().numpy())

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
        rids = extract_row_ids(self.mat, self.num_features,
                               self.num_data).long()
        return torch.empty(self.num_data, dtype=torch.int64,
                           device=self.device).scatter_(0, rids, pos_leaf)
