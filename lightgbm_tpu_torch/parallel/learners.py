"""The tree learners and ``create_tree_learner`` (port of
``lightgbm_tpu/parallel/learners.py``; TreeLearner::CreateTreeLearner,
src/treelearner/tree_learner.cpp:13-38, and the data-, feature- and
voting-parallel learners).

**Which learner.** The port applies the JAX package's accelerator rule
(``learners.py:620-664``) on every device: ``serial`` gives the
partitioned (segment) learner when the widest feature's bins fit a byte
and the serial (``leaf_id``) learner otherwise; ``partitioned`` always
gives the partitioned learner. On the CPU, which stands in for the card
in the tests, the JAX package sends ``serial`` to its
``SerialTreeLearner`` whatever the bins; this is the one place where the
port departs from the JAX package's CPU routing. A multi-val dataset
(EFB pseudo-groups without a matrix column) pins the serial learner, as
in the JAX package; ``partitioned`` refuses it. The lazy CEGB penalty
pins the serial learner too; ``partitioned`` drops it with a warning.
``data`` and ``voting`` give ``MeshPartitionedTreeLearner`` (the segment
kernels on each rank) when the bins fit a byte, else the
``DataParallelTreeLearner`` / ``VotingParallelTreeLearner`` on the
``leaf_id`` layout (``hist_rows`` and the scan kernel on each rank);
``feature`` always gives ``FeatureParallelTreeLearner`` on the
``leaf_id`` layout (the segment matrix is row-contiguous, so feature
shards have no segment form: JAX ``learners.py:629-648``).

**The ranks.** One process a rank in a ``torch.distributed`` group
(``parallel/distributed.py``); without a group every parallel learner
is a world of one, as the JAX package on one device. The data and
voting learners hold a row block: the dataset's own rows under
``pre_partition=true`` (each rank loaded its rows, binned from the
pooled sample), else the rank's block of the rows every rank holds
(``ingest.shard_bounds``: equal blocks of the rows padded to a multiple
of the ranks, the JAX mesh's split), and then the learner slices the
gradients to its block and gathers every rank's leaf ids after a tree,
so the booster sees every row. The feature learner holds every row and
builds the histograms of its feature shard. Each runs the per-phase loop
of its layout (the fused kernels own a whole split, with no place for a
collective: JAX ``fused_split_eligible(serial_comm=False)``) with a
recipe of ``learner/comm.py``.

Per mode, as the JAX package: voting divides ``min_data_in_leaf`` and
the hessian minimum by the ranks for its local scan, drops CEGB and
ignores forced splits with a warning; feature drops CEGB and forced
splits; data keeps CEGB (coupled) and forced splits through the
full-reduce recipe, and its config turns the histogram pool off
(``config.py``); every parallel learner drops the lazy CEGB penalty
with a warning (its charged rows would be split over the ranks).

A multi-val dataset trains on the data and voting learners (each rank
its block of the slot matrix, ``MultivalLayout``; the data recipe's
multi-val histograms in float64, unrounded, beside the dense ones, so
the all-reduce rounds both once); the feature learner refuses it with
the JAX package's words. Per-node randomness (extra_trees, by-node
sampling) follows the JAX learners' keys: the voting learner and the
data learner's root and full-reduce scans draw with the tree's keys
over every feature; a feature-sharded scan (the data recipe's per-split
scans, every feature-learner scan) draws with the keys folded with the
rank (``utils/threefry.py:fold_in``, JAX ``_fold_shard_key``) over the
shard's features, with its slice of the by-node budget
(``partition_rules.split_bynode_budget``). ``n_devices`` > 1 asks for
that many shards: the port's shards are ranks, so a run without a group
of that many ranks is refused rather than trained as a world of one.
The NCCL route (a card a rank) is written but not run.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data.dataset import Dataset
from ..learner.comm import (all_gather, make_data_parallel_comm,
                            make_feature_parallel_comm,
                            make_voting_parallel_comm)
from ..learner.grow_extras import cegb_on
from ..learner.partitioned import PartitionedTreeLearner
from ..learner.serial import SerialTreeLearner
from ..ops.hist_multival_cuda import MultivalLayout
from ..ops.histogram import Debundler, debundle_leaf_hists
from ..ops.split_scan_cuda import node_table
from ..utils.log import log_fatal, log_warning
from ..utils.threefry import fold_in
from .distributed import _all_gather_host, current_world
from .ingest import padded_rows, shard_bounds, shard_rows
from .partition_rules import (ROWS, plan_feature_shards, role_of,
                              split_bynode_budget)


class _ParallelMixin:
    """What the parallel learners share over either layout: the world,
    the row block, the feature shards, the recipe and its hooks
    (``learner/comm.py``). ``MODE`` is a mode of
    ``partition_rules.MODE_RULES``."""

    MODE = "data"
    # the lazy CEGB penalty needs every row's charged state in place
    # (JAX _drop_cegb_lazy: "row-sharded learners would need a sharded
    # charged-state matrix"); LeafwiseLearner drops it with a warning
    LAZY_CEGB = False

    @property
    def _type(self) -> str:
        return self.MODE.split("-")[-1]

    def _setup_world(self, dataset: Dataset, config: Config) -> None:
        w = current_world()
        self.rank, self.world_size = (0, 1) if w is None else (w.rank,
                                                               w.size)
        shards = int(config.n_devices)
        if shards > 1 and shards != self.world_size:
            # JAX meshes n_devices devices of one process; the port's
            # shards are ranks (ROADMAP Queue 3 fault 1: never a world
            # of one where more shards were asked for)
            have = "no torch.distributed group is up" if w is None \
                else f"the torch.distributed group has {w.size} ranks"
            raise ValueError(
                f"n_devices={shards} asks tree_learner={self._type} for "
                f"{shards} shards, but {have}: the port's shards are "
                "ranks, one process each; start each of them with "
                f"lt.init_distributed(rank=..., world_size={shards}, "
                "init_method=...) before lt.train")
        self._subsets = {}
        # a dataset of this rank's rows (pre_partition in a group), or
        # every row, of which a learner whose rows are split
        # (partition_rules.MODE_RULES) takes its block
        self.row_split = role_of(self.MODE, "grad") == ROWS
        self.local_data = bool(config.pre_partition) and w is not None
        n = dataset.num_data
        self.row_lo, self.row_hi = shard_bounds(n, self.rank,
                                                self.world_size) \
            if self.row_split and not self.local_data else (0, n)
        self.block = padded_rows(n, self.world_size) // self.world_size
        if self.local_data:
            # where this rank's rows sit among the run's (a coordinated
            # checkpoint's score ranges; robustness/checkpoint.py)
            counts = [int(c[0]) for c in _all_gather_host(
                np.asarray([n], np.int64))]
            self.global_row_lo = sum(counts[:self.rank])
            self.global_num_data = sum(counts)

    def _mv_device(self, dataset: Dataset):
        """The rank's block of the multi-val slots and its layout (only
        the block is uploaded), or every row's."""
        if not dataset.has_multival or (self.row_lo == 0 and
                                        self.row_hi == dataset.num_data):
            return super()._mv_device(dataset)
        slots = torch.from_numpy(np.ascontiguousarray(
            dataset.mv_slots[self.row_lo:self.row_hi])).to(self.device)
        return slots, MultivalLayout(
            slots, dataset.num_groups - dataset.num_dense_groups)

    def _device_bins(self, dataset: Dataset) -> torch.Tensor:
        """The rank's block of the bin matrix (only the block is
        uploaded), or every row."""
        self.num_data = self.row_hi - self.row_lo
        if self.row_lo == 0 and self.row_hi == dataset.num_data:
            return dataset.binned_device(self.device)
        return shard_rows(dataset.binned, self.device, self.rank,
                          self.world_size, dataset.max_column_bins())

    def _setup_shards(self) -> None:
        """The feature shards (JAX ``plan_feature_shards``) and this
        rank's slice: global feature ids on the device, and the group
        columns they read."""
        group, _, _ = self.dataset.bundle_maps()
        self.plan = plan_feature_shards(np.asarray(group), self.num_features,
                                        self.num_groups, self.world_size)
        ids = self.plan.local_features(self.rank)
        self.shard_ids = torch.as_tensor(ids, dtype=torch.int64,
                                         device=self.device)

    def _tree_meta(self, feature_mask):
        """The base learner's tree meta and node table (the tree's keys,
        every feature), and with per-node randomness on a feature-sharded
        scan the shard's node table (``_node_shard``): the keys folded
        with the rank, the shard's features over its padded slots, its
        slice of the by-node budget (JAX ``ShardScanCtx``)."""
        out = super()._tree_meta(feature_mask)
        self._node_shard = None
        if self._node is not None and getattr(self, "sharded_scan", False):
            ids = self.plan.local_features(self.rank)
            floor, rem, cap = split_bynode_budget(self.node_rand.count,
                                                  self.world_size)
            keys = tuple(fold_in(k, self.rank) for k in self._tree_keys)
            rb, nm = self.node_rand.tables(
                keys, None if feature_mask is None
                else np.asarray(feature_mask, bool)[ids],
                2 * self.num_leaves + 1, num_bins=self.meta.num_bins[ids],
                count=floor + int(self.rank < rem), cap=cap,
                width=self.plan.f_local)
            self._node_shard = node_table(rb, nm, len(ids), self.device)
        return out

    def _drop_cegb(self) -> None:
        if self.cegb is not None or self.params.cegb_on:
            log_warning(f"CEGB is not supported by the {self._type}-parallel "
                        "learner; ignoring it")
            self.params = self.params._replace(cegb_on=False,
                                               cegb_lazy_on=False)
            self.cegb = None

    def _drop_forced(self) -> None:
        if self.forced_plan:
            log_warning("forcedsplits_filename is not supported by the "
                        f"{self._type}-parallel learner; ignoring it")
            self.forced_plan = ()

    # -- hooks the recipes call (learner/comm.py) -------------------------
    def meta_subset(self, meta_t, tables, ids):
        """The scan's meta tensors and kernel tables of features ``ids``
        (global ids, a tensor on the device); the shard's are kept while
        the tree's ``meta_t`` is the same."""
        shard = ids is getattr(self, "shard_ids", None)
        if shard and self._subsets.get("meta") is meta_t:
            return self._subsets["sub"]
        sub = ({k: v.index_select(0, ids) for k, v in meta_t.items()},
               tuple(t.index_select(0, ids).contiguous() for t in tables))
        if shard:
            self._subsets = {"meta": meta_t, "sub": sub}
        return sub

    def sharded_feature_hists(self, hists, leaves):
        """The leaves' per-feature histograms of this rank's shard: the
        reduced group histograms debundled (each from its leaf's global
        totals) and cut to the shard."""
        if self.bundled:
            hists = debundle_leaf_hists(self._debundler, hists, leaves)
        return [h.index_select(0, self.shard_ids) for h in hists]

    def local_feature_hists(self, hists):
        """Every feature's rank-local histograms of the leaves (voting):
        an EFB dataset debundles each with its local totals (JAX
        ``debundle_totals(local_hist=True)``)."""
        if not self.bundled:
            return list(hists)
        return debundle_leaf_hists(self._debundler, hists, None,
                                   local_hist=True)

    # -- the row block ------------------------------------------------------
    def _local(self, t: Optional[torch.Tensor]):
        if t is None or (self.row_lo == 0 and self.row_hi == t.shape[0]):
            return t
        return t[self.row_lo:self.row_hi]

    def _gather_leaf_id(self, leaf_id: torch.Tensor) -> torch.Tensor:
        """Every row's leaf: the ranks' blocks in rank order (padded to
        the block size for the gather, cut to the rows after)."""
        if self.local_data or not self.row_split or self.world_size == 1:
            return leaf_id
        pad = torch.full((self.block,), -1, dtype=leaf_id.dtype,
                         device=leaf_id.device)
        pad[:leaf_id.shape[0]] = leaf_id
        full = all_gather(pad, self.world_size).reshape(-1)
        return full[:self.dataset.num_data]

    def train(self, grad, hess, feature_mask=None, bag_weight=None):
        tree, leaf_id = super().train(self._local(grad), self._local(hess),
                                      feature_mask=feature_mask,
                                      bag_weight=self._local(bag_weight))
        return tree, self._gather_leaf_id(leaf_id)


def _init_parallel(lrn, mode: str, config: Config):
    """The recipe of ``mode`` for a learner whose base class has set
    itself up (row block, meta, histogram memory)."""
    d = lrn.world_size
    if mode == "data":
        sharded = not lrn.params.cegb_on and not lrn.forced_plan
        if sharded:
            lrn._setup_shards()
        lrn.sharded_scan = sharded
        lrn.comm = make_data_parallel_comm(d, sharded)
    elif mode == "voting":
        lrn._drop_cegb()
        lrn._drop_forced()
        params_local = lrn.params._replace(
            min_data_in_leaf=lrn.params.min_data_in_leaf / d,
            min_sum_hessian_in_leaf=lrn.params.min_sum_hessian_in_leaf / d)
        lrn.comm = make_voting_parallel_comm(d, int(config.top_k),
                                             params_local)
    else:
        raise ValueError(mode)


class DataParallelTreeLearner(_ParallelMixin, SerialTreeLearner):
    """Rows split over the ranks on the ``leaf_id`` layout
    (data_parallel_tree_learner.cpp): float64 histograms all-reduced,
    the feature-shard scan and the winner gather (``learner/comm.py``).
    """

    MODE = "data"

    def __init__(self, dataset: Dataset, config: Config,
                 device: torch.device, ops: str = "kernel"):
        self._setup_world(dataset, config)
        self.comm = make_data_parallel_comm(self.world_size, False)
        super().__init__(dataset, config, device, ops)
        _init_parallel(self, self.MODE, config)


class VotingParallelTreeLearner(DataParallelTreeLearner):
    """PV-Tree voting-parallel on the ``leaf_id`` layout
    (voting_parallel_tree_learner.cpp): rows split; only the top-k
    voted features' histograms are reduced."""

    MODE = "voting"


class FeatureParallelTreeLearner(_ParallelMixin, SerialTreeLearner):
    """Every row on every rank; the histograms and the scan of the
    rank's feature shard, the winners gathered
    (feature_parallel_tree_learner.cpp). Bagging draws over the full
    data on every rank, as the booster does."""

    MODE = "feature"
    sharded_scan = True

    def __init__(self, dataset: Dataset, config: Config,
                 device: torch.device, ops: str = "kernel"):
        if dataset.has_multival:
            # JAX parallel/learners.py:263-268
            log_fatal("feature-parallel training does not support "
                      "multi-val datasets (row-wise slots span the "
                      "column shards); use tree_learner=serial/data/"
                      "voting")
        self._setup_world(dataset, config)
        self.comm = make_feature_parallel_comm(self.world_size)
        self.dataset = dataset
        self.num_features = dataset.num_features
        self.num_groups = dataset.num_groups
        self.device = torch.device(device)
        self._setup_shards()
        super().__init__(dataset, config, device, ops)
        self._drop_cegb()
        self._drop_forced()
        # the histogram memory holds this rank's groups only
        from ..learner.grow_extras import HistMemory
        groups = self.plan.local_groups(self.rank)
        self.mem = HistMemory.for_learner(
            self.hist_slots, self.num_leaves,
            (max(len(groups), 1), self.num_bins_max, 3), self.device,
            pool_ok=self.POOL)
        self.hist = self.mem.hist
        group, offset, _ = dataset.bundle_maps()
        self._shard_debundler = Debundler(
            self.plan.local_columns(self.rank, group),
            np.asarray(offset)[self.plan.local_features(self.rank)],
            self.meta.num_bins[self.plan.local_features(self.rank)],
            self.num_bins_max, self.device)
        # the rank that holds group 0 (the root's sums, as the serial
        # learner takes them) and its column there
        owner = [r for r in range(self.world_size)
                 if 0 in set(self.plan.local_groups(r).tolist())]
        self.group0_rank = owner[0]
        self.group0_local = int(np.nonzero(groups == 0)[0][0]) \
            if self.rank == self.group0_rank else None

    def _hist_bins(self) -> torch.Tensor:
        """This rank's group columns of the bin matrix, in its slot
        order (a rank without groups keeps one column it never
        scans)."""
        groups = self.plan.local_groups(self.rank)
        cols = torch.as_tensor(groups if len(groups) else [0],
                               dtype=torch.int64, device=self.device)
        return self.binned.index_select(1, cols).contiguous()

    def sharded_feature_hists(self, hists, leaves):
        """This rank's per-feature histograms from its group columns
        (debundled from the leaves' totals where bundled)."""
        totals = torch.tensor([[float(v) for v in leaf[:3]]
                               for leaf in leaves], dtype=torch.float64,
                              device=hists[0].device)
        return list(self._shard_debundler(torch.stack(list(hists)),
                                          totals))


class MeshPartitionedTreeLearner(_ParallelMixin, PartitionedTreeLearner):
    """Data- or voting-parallel on the segment kernels (JAX
    ``MeshPartitionedTreeLearner``): each rank keeps its row block
    physically partitioned by leaf and runs the partitioned per-phase
    loop (the segment histogram, partition and scan kernels) with the
    recipe of its mode."""

    def __init__(self, dataset: Dataset, config: Config,
                 device: torch.device, ops: str = "kernel",
                 mode: str = "data"):
        if mode not in ("data", "voting"):
            raise ValueError(f"mode must be data or voting, got {mode!r}")
        self.MODE = f"partitioned-{mode}"
        self._setup_world(dataset, config)
        self.comm = make_data_parallel_comm(self.world_size, False)
        super().__init__(dataset, config, device, ops)
        _init_parallel(self, mode, config)


def create_tree_learner(learner_type: str, dataset: Dataset, config: Config,
                        device: torch.device, ops: str = "kernel"):
    """The tree learner for ``learner_type`` on ``dataset`` (JAX
    ``create_tree_learner`` with the accelerator rule)."""
    if learner_type not in ("serial", "partitioned", "data", "feature",
                            "voting"):
        raise ValueError(f"unknown tree_learner {learner_type}")
    fits_u8 = int(dataset.num_bins_array().max(initial=2)) <= 256
    lazy_on = cegb_on(config)[1]
    mv = dataset.has_multival
    if learner_type == "partitioned" or (learner_type == "serial"
                                         and fits_u8 and not lazy_on
                                         and not mv):
        return PartitionedTreeLearner(dataset, config, device, ops=ops)
    if learner_type == "serial":
        return SerialTreeLearner(dataset, config, device, ops=ops)
    if learner_type == "feature":
        return FeatureParallelTreeLearner(dataset, config, device, ops=ops)
    if fits_u8 and not mv:
        return MeshPartitionedTreeLearner(dataset, config, device, ops=ops,
                                          mode=learner_type)
    if learner_type == "voting":
        return VotingParallelTreeLearner(dataset, config, device, ops=ops)
    return DataParallelTreeLearner(dataset, config, device, ops=ops)
