"""Serial leaf-wise tree learner on the ``leaf_id[N]`` layout (port of
``lightgbm_tpu/learner/serial.py``: ``SerialTreeLearner`` and the
serial-comm, histogram-cache part of ``grow_tree``).

Rows stay where they are: a ``leaf_id`` [N] int32 vector says which leaf
each row is in, and a split relabels the right-going rows of the chosen
leaf (``split_leaf``). The smaller child's histogram comes from the
rows of that child, the sibling as parent minus child from the
per-leaf cache (serial_tree_learner.cpp:434-436). The binned matrix is
[N, F] uint8, the int16 bits of uint16 bins when a feature has more
than 256 bins, or int32 past 32,768 bins (up to 65,536): this is the
learner ``create_tree_learner`` gives such datasets, whose bins the
partitioned learner's u8 matrix cannot hold.

Two grow loops, chosen before training (``fused_split_kernel``):

  * **fused** ("auto" on a CUDA device, or "on"): the root's histogram
    (the ``hist_rows`` kernel, ``ops/hist_cuda.py:histogram_rows``, the
    port of the JAX package's ``histogram_pallas``) and scan kernel, then
    ``num_leaves - 1`` launches of the leaf-layout fused split step
    (``ops/split_step_cuda.py:fused_split_step_leaf``) enqueued without
    a host read; ``S``, ``T`` and ``k`` are read once per tree. On the
    CPU, or with ``ops="plain"``, each op is its plain version
    (``build_histogram`` for the histograms).
  * **per-phase** ("off", "auto" on the CPU): a Python loop over splits
    through ``split_step_host``: ``split_leaf``, the smaller child's
    histogram (on the card the ``hist_rows`` kernel over the child's
    row ids, which sums as the fused step does; plain: ``build_histogram``
    over masked ghc), the sibling by subtraction, both children's scans
    (the scan kernel on the card, merged with the categorical search
    when the dataset has a categorical feature, whose split relabels
    the rows of its bitset's bins), one host read of the scan tables
    per split. A dataset with a categorical feature always takes this
    loop.

Both loops write the same state through the same bookkeeping and build
the histograms to the same float64-then-round rule, so they grow the
same trees. ``leaf_id`` is returned as the loop kept it.

An EFB dataset trains here on its ``[N, G_dense]`` group matrix
through the per-phase loop (the fused kernels refuse bundled data, as
the JAX package's compiled bodies do): ``hist_rows`` sums the group
columns (u8, or u16 when a dense column keeps more than 256 bins), the
split feature's bins are its group column decoded, and each leaf's
group histograms are debundled before its scan (``LeafwiseLearner.
_scan``). A multi-val dataset (``create_tree_learner`` sends it here)
adds its pseudo-groups' histograms from the slot matrix
(``ops/hist_multival_cuda.py``: the ``hist_multival`` kernel on the
card, over the slots' compact layout, built once here), concatenated
after the dense groups' on the group axis (JAX serial.py:786-800).

The per-phase loop also runs extra_trees, by-node sampling, CEGB
(with the lazy penalty: its ``[N, F]`` charged matrix lives here, on the
device), forced splits and, when the histogram cache does not fit
``histogram_pool_size``, both children rebuilt every split
(``cache_hists=False`` of the JAX package; ``learner/grow_extras.py``).
Past 1024 bins (the fused leaf kernel's cap) every tree takes the
per-phase loop, even with ``fused_split_kernel="on"``: ``hist_rows`` and
the scan kernel take up to 65,536 bins.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data.dataset import Dataset
from ..ops.hist_cuda import histogram_rows, rows_partial
from ..ops.hist_multival_cuda import (hist_multival, hist_multival_plain,
                                      multival_partial)
from ..ops.histogram import build_histogram, make_ghc
from ..ops.split_step_cuda import (LeafScratch, LeafStep,
                                   fused_split_step_leaf_plain,
                                   leaf_split_ops)
from .partitioned import LeafwiseLearner
from .split_step import grown_tree, root_state


class SerialTreeLearner(LeafwiseLearner):
    """The port's leaf-id learner.

    ``train(grad, hess)`` grows one tree and returns ``(Tree, leaf_id)``
    with ``leaf_id`` [N] int32 on the device. ``fused`` says which grow
    loop it runs (decided here, before training)."""

    LAYOUT = "leaf"
    SI_PREFIX = ()
    # the u16 bins' widest feature; past MAX_BINS["leaf"] (1024, the
    # fused leaf kernel's) a tree runs per-phase
    MAX_LEARNER_BINS = 65536
    BIN_NOTE = "takes up to 65,536 bins per feature, got {n}"
    # the JAX serial learner rebuilds both children when the cache does
    # not fit (no pool), and keeps the lazy CEGB penalty: its rows stay
    # where they are
    POOL = False
    LAZY_CEGB = True

    def __init__(self, dataset: Dataset, config: Config,
                 device: torch.device, ops: str = "kernel"):
        super().__init__(dataset, config, device, ops)
        self.binned = self._device_bins(dataset)
        # the matrix the histograms read (a feature-parallel rank's
        # shard of the columns; parallel/learners.py)
        self.binned_hist = self._hist_bins()
        # multi-val pseudo-groups: no column, their values in the slots
        self.mv_groups = self.num_groups - self.num_cols
        # the slots and their compact layout (the histograms read it; the
        # node walks decode the slots)
        self.mv_slots, self.mv_layout = self._mv_device(dataset)
        self._mv_partial = multival_partial(
            self.mv_groups, self.num_bins_max, self.device) \
            if self.mv_groups and not self.plain else None
        self.leaf_id = torch.zeros(self.num_data, dtype=torch.int32,
                                   device=self.device)
        self._scratch = LeafScratch(self.binned, self.num_bins_max) \
            if self.fused and not self.plain else None
        # the hist_rows kernel's float64 partials: the fused step's when
        # it has them (the same shape), else allocated once here
        self._partial = None if self.plain else (
            self._scratch.partial if self._scratch is not None
            else rows_partial(self.binned_hist, self.num_bins_max))

    def _hist_bins(self) -> torch.Tensor:
        return self.binned

    def _mv_device(self, dataset: Dataset):
        """The multi-val slots on the device and their layout (a
        row-split parallel learner's block: parallel/learners.py), or
        (None, None)."""
        return (dataset.mv_slots_device(self.device),
                dataset.mv_layout_device(self.device))

    def _hist_reduce(self):
        """A data-parallel recipe's reduce of float64 histograms, else
        None (the histograms are rounded where they are built)."""
        return self.comm.reduce_hist \
            if self.comm is not None and self.comm.float64_hist else None

    def _histogram(self, ghc: torch.Tensor) -> torch.Tensor:
        """The root histogram: the hist_rows kernel on the card, the plain
        ``build_histogram`` on the CPU or with ``ops="plain"``; then the
        multi-val groups' (``hist_multival``, or its plain version). With
        a data-parallel recipe both come as float64 sums, unrounded, and
        the recipe reduces them across ranks and rounds once."""
        b = self.num_bins_max
        reduce = self._hist_reduce()
        f64 = reduce is not None
        if self.plain:
            h = build_histogram(self.binned_hist, ghc, b, float64=f64)
        else:
            h = histogram_rows(self.binned_hist, ghc, b,
                               partial=self._partial, float64=f64)
        if self.mv_groups:
            hm = hist_multival_plain(self.mv_layout, ghc, b, float64=f64) \
                if self.plain else hist_multival(
                    self.mv_layout, ghc, b, partial=self._mv_partial,
                    float64=f64)
            h = torch.cat([h, hm])
        return reduce(h) if f64 else h

    # ------------------------------------------------------------------
    def train(self, grad: torch.Tensor, hess: torch.Tensor,
              feature_mask: Optional[np.ndarray] = None,
              bag_weight: Optional[torch.Tensor] = None):
        meta_t, tables, imeta, fmeta = self._tree_meta(feature_mask)
        # an out-of-bag row carries zero g/h and count 0; its leaf_id
        # follows the splits all the same
        ghc = make_ghc(grad.to(torch.float32), hess.to(torch.float32),
                       bag_weight)
        self.leaf_id.zero_()
        if self.cegb is not None:
            used = torch.ones(self.num_data, dtype=torch.bool,
                              device=self.device) if bag_weight is None \
                else bag_weight > 0
            self.cegb.start_tree(self.num_leaves, self.leaf_id, used)
        table, root = self._root_scan(self._histogram(ghc), meta_t, tables)
        st = root_state(self.pack, table, *root, self.num_data,
                        self.params, self.num_leaves)
        if self.fused:
            k = torch.ones((1,), dtype=torch.int32, device=self.device)
            self._launch_fused(k, st["S"], st["T"], ghc, imeta, fmeta)
            # the tree's one host read
            st = {"S": st["S"].cpu(), "T": st["T"].cpu()}
            k = int(k.cpu()[0])
            # the root's histogram and scan, L - 1 steps; one read
            self._count_tree(self.num_leaves + 1, 1)
        else:
            # the per-phase loop keeps S, T and the bitsets on the host
            st = {key: val.cpu() for key, val in st.items()}
            k = self._grow_per_phase(st, ghc, meta_t, tables, imeta)
        return grown_tree(self.pack, st, k, self.dataset)[0], self.leaf_id

    def _launch_fused(self, k, S, T, ghc, imeta, fmeta) -> None:
        """The split loop of one tree: L - 1 fused steps, enqueued with
        no host read in between. The kernel's launch is prepared (and
        its operands checked) once a tree."""
        kw = dict(params=self.params, big_l=self.num_leaves,
                  max_depth=self.max_depth, b=self.num_bins_max,
                  has_monotone=self.has_monotone)
        args = (k, S, T, self.leaf_id, self.hist, self.binned, ghc, imeta,
                fmeta)
        if self.plain:
            for _ in range(self.num_leaves - 1):
                fused_split_step_leaf_plain(*args, **kw)
            return
        step = LeafStep(*args, scratch=self._scratch, **kw)
        for _ in range(self.num_leaves - 1):
            step()

    def _grow_per_phase(self, st, ghc, meta_t, tables, imeta) -> int:
        """S and T on the host; one host read of the scan tables per
        split (inside ``split_step_host``)."""
        im = imeta.cpu().numpy()
        ops = leaf_split_ops(
            self.leaf_id, self.binned, ghc, im, self.num_bins_max,
            lambda hists, leaves, salts: self._scan(hists, leaves, meta_t,
                                                    tables, salts),
            partial=self._partial, bundled=self.bundled,
            mv=(self.mv_slots, self.mv_layout, self._mv_partial)
            if self.mv_groups else None, hist_binned=self.binned_hist,
            reduce=self._hist_reduce())
        return self._grow_host(st, ops, im)
