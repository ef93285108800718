"""The fused split steps of both grow loops (port of
``lightgbm_tpu/ops/split_step_pallas.py``, segment and leaf layouts).

One call is one whole split: pick the best open leaf from the packed
state ``S``, move its rows to its children (segment layout: a stable
partition of its segment of the training matrix; leaf layout: the
right-going rows get the new leaf's id in ``leaf_id``), build the
smaller child's histogram, get the sibling as parent - child, scan both
children and write both ``S`` columns, the ``T`` column and both rows of
the histogram cache. ``k`` is a device int32 [1] tensor that the step
reads and increments; when the grow loop's condition fails (``k < L``
and the best open gain > 0) the step changes nothing, so a caller
enqueues all L - 1 steps of a tree without reading anything.

**Leaf layout.** ``fused_split_step_leaf`` launches
``csrc/split_step_leaf.cu`` for CUDA tensors and runs
``fused_split_step_leaf_plain`` for CPU ones. The plain version is the
JAX package's interpret twin (``_leaf_kernel_ref``) in torch: the
serial learner's per-phase bookkeeping (``learner/split_step.py:
split_step_host``) with the plain ops ``split_leaf``,
``build_histogram`` over masked ghc and ``per_feature_numerical_plain``
(``leaf_split_ops``). The kernel takes u8 bins up to 256 and u16 bins
(held as int16 bit patterns) up to 1024, where the TPU body stops at
u8 bins and 192 features (Mosaic limits). ``LeafStep`` is the same
launch prepared once for a tree's operands (checked once, one ctypes
call per split), which the serial learner's split loop uses.

**Segment layout.**

``fused_split_step_segment`` launches ``csrc/split_step_segment.cu``
for CUDA tensors and runs ``fused_split_step_segment_plain`` for CPU
ones. The plain version is the JAX package's interpret twin
(``_segment_kernel_ref``) in torch: the partitioned learner's per-phase
bookkeeping (``split_step_host``) with the plain ops
``partition_segment_plain``, ``histogram_segment_plain`` and
``per_feature_numerical_plain`` (``segment_split_ops``, which the
per-phase loop runs with the kernels). ``SegmentStep`` is the launch
prepared once for a tree's operands, which the partitioned learner's
split loop uses.

The 192-feature cap of the TPU kernel (``MAX_FUSED_F``, a Mosaic
program-size limit) is not carried over: the kernel tiles features as
the histogram kernel does.

**Model-batched leaf step** (multiboost, ``learner/batched.py``).
``fused_split_step_leaf_batched`` does split ``k[m]`` of each of M
models (stacked ``S``, ``T``, ``leaf_id``, caches and ghc, a ``SplitParams``
a model) over one shared bin matrix: one launch of the kernel's
model-batched export on CUDA tensors (``LeafBatchStep``, scratch
``LeafBatchScratch``), else ``fused_split_step_leaf_batched_plain``, a
loop of ``fused_split_step_leaf_plain`` over the models.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import numpy as np
import torch

from . import _native
from .hist_cuda import (histogram_rows, histogram_segment,
                        histogram_segment_plain, leaf_bin_bytes,
                        leaf_feat_tile, matrix_cols, max_chunks,
                        payload_offset)
from .partition_cuda import (PART_THREADS, partition_decision_lut,
                             partition_segment, partition_segment_plain)
from .histogram import build_histogram
from .partition import split_leaf
from .split import (IM_DEFBIN, IM_GROUP, IM_ISCAT, IM_MISS,  # noqa: F401
                    IM_MONO, IM_MOSTFREQ, IM_NBINS, IM_OFFSET,
                    FeatureMeta, SplitParams)
from .split_scan_cuda import per_feature_numerical_plain

# the leaf kernel's histogram tile and chunk rule are hist_cuda's LEAF_*
# (csrc/hist_ids.cuh); the scan planes reuse the tile's shared memory
LEAF_TIMES = 32         # clock reads per split of the timed build
SEGMENT_TIMES = 32      # the same, csrc/split_step_segment.cu kTimes
# int rows of the merged pack: the JAX package's GROW_SI less the
# derived leaf_parent (7), after the segment layout's leaf_begin,
# leaf_cnt
STATE_INT_ROWS = {"segment": 9, "leaf": 7}
TREE_ROWS = 9
# bins per feature each layout's kernel takes
MAX_BINS = {"segment": 256, "leaf": 1024}


def state_rows(has_monotone: bool, layout: str = "segment") -> int:
    """Ks of the merged pack of one layout: 10 float rows (12 with the
    monotone bounds) + the layout's int rows."""
    return (12 if has_monotone else 10) + STATE_INT_ROWS[layout]


def pack_meta_tables(meta: FeatureMeta, feature_mask=None, device="cpu"):
    """FeatureMeta + feature mask -> (imeta [F, 8] i32, fmeta [F, 2]
    f32) tensors: num_bins, missing, default_bin, most_freq_bin,
    monotone, group, offset, is_categorical; penalty, numerical and in
    the mask. Built once per tree (once per learner without a mask)."""
    f = len(meta.num_bins)
    is_cat = np.asarray(meta.is_categorical, bool)
    mask = ~is_cat
    if feature_mask is not None:
        mask = mask & np.asarray(feature_mask, bool)
    group = np.arange(f) if meta.group is None else meta.group
    offset = np.zeros(f) if meta.offset is None else meta.offset
    imeta = np.stack([meta.num_bins, meta.missing, meta.default_bin,
                      meta.most_freq_bin, meta.monotone, group, offset,
                      is_cat], axis=1).astype(np.int32)
    fmeta = np.stack([meta.penalty, mask], axis=1).astype(np.float32)
    return (torch.as_tensor(imeta, device=device),
            torch.as_tensor(fmeta, device=device))


def meta_from_tables(imeta: torch.Tensor, fmeta: torch.Tensor) -> dict:
    """The scans' metadata dict (``ops/split.py:meta_tensors``) from the
    two tables."""
    return dict(num_bins=imeta[:, IM_NBINS], missing=imeta[:, IM_MISS],
                default_bin=imeta[:, IM_DEFBIN], monotone=imeta[:, IM_MONO],
                penalty=fmeta[:, 0], fmask=fmeta[:, 1])


def fused_compiled_ok(params, *, bundled: bool, num_bins_max: int,
                      layout: str = "segment") -> bool:
    """Static scope of one layout's CUDA kernel: numerical splits,
    unbundled columns, bins that fit a byte (segment) or 1024 bins in
    u16 (leaf)."""
    return (not getattr(params, "has_categorical", False) and not bundled
            and num_bins_max <= MAX_BINS[layout])


def learner_fused_kernel_on(mode: str, *, eligible: bool,
                            device: torch.device, params,
                            num_bins_max: int,
                            layout: str = "segment",
                            bundled: bool = False) -> bool:
    """The fused-step gate of one learner, decided before training from
    the resolved mode ("on" / "off" / "auto"), the learner's static
    eligibility, and for "auto" a CUDA device within
    ``fused_compiled_ok``'s scope ("auto" is off on the CPU). A dataset
    with categorical features, or an EFB-bundled one, always takes the
    per-phase loop, even with "on": the JAX package's compiled fused
    bodies refuse such data (split_step_pallas.py:470-475, 584-589,
    642-649), and the kernels here do the same. So does a dataset wider
    than the layout's kernel (``MAX_BINS``: past 1024 bins the leaf
    kernel is ineligible, and its trees run per-phase)."""
    if mode == "off" or not eligible or bundled \
            or getattr(params, "has_categorical", False) \
            or num_bins_max > MAX_BINS[layout]:
        return False
    if mode == "on":
        return True
    return torch.device(device).type == "cuda" and fused_compiled_ok(
        params, bundled=bundled, num_bins_max=num_bins_max, layout=layout)


class FusedScratch:
    """Device scratch of the fused kernel, allocated once per learner
    (never per split): float64 histogram partials [max_chunks(F), F, B,
    3] (a split writes as many as its smaller child has chunks,
    ``child_chunks``), the partition's per-tile and per-block left
    counts, both children's scan tables and the count of blocks past
    their scans."""

    def __init__(self, mat: torch.Tensor, num_features: int, num_bins: int):
        dev = mat.device
        self.shape = launch_shape(num_bins)
        self.partial = torch.empty(
            (max_chunks(num_features), num_features, num_bins, 3),
            dtype=torch.float64, device=dev)
        self.tiles = torch.empty((max(1, -(-mat.shape[0] // PART_THREADS)),),
                                 dtype=torch.int32, device=dev)
        self.counts = torch.empty((self.shape["grid"],), dtype=torch.int32,
                                  device=dev)
        self.table = torch.empty((2, num_features, 8), dtype=torch.float32,
                                 device=dev)
        # blocks past their scans; the launch that counts last resets it
        self.done = torch.zeros((1,), dtype=torch.int32, device=dev)


def launch_shape(num_bins: int) -> dict:
    """The cooperative grid the kernel takes on the current card."""
    out = (ctypes.c_int * 3)()
    lib = _native.library()
    err = lib.ltt_split_step_shape(num_bins, ctypes.addressof(out))
    _native.check(err, "fused_split_step_segment")
    return dict(blocks_per_sm=out[0], grid=out[1], smem_bytes=out[2])


def segment_histogram(mat, begin, count, b: int, f: int, *, plain: bool,
                      max_count=None) -> torch.Tensor:
    """One segment's histogram: the ``hist_segment`` kernel (``begin`` a
    host int, or an int32 [2] device tensor of (begin, count) with
    ``count`` None and ``max_count`` a bound the host knows), or with
    ``plain`` its plain version (bounds read on the host)."""
    if plain:
        if isinstance(begin, torch.Tensor):
            begin, count = (int(v) for v in begin.tolist())
        return histogram_segment_plain(mat, int(begin), int(count), b, f)
    return histogram_segment(mat, begin, count, b, f, max_count=max_count)


def segment_split_ops(mat, ws, imeta: np.ndarray, b: int, f: int, scan, *,
                      plain: bool, histogram: Optional[Callable] = None,
                      bundled: bool = False):
    """``SplitOps`` of the segment layout: the split is a stable
    partition of the leaf's segment (``partition_segment``, or with
    ``plain`` its plain version; the column and route come from
    ``partition_cuda.partition_decision_lut``: a categorical
    split, and with ``bundled`` a numerical split of a feature sharing
    its EFB group, go through the LUT route on the group's column), the
    smaller child's histogram comes from its segment (sized by the
    parent's row count; the kernel cuts its chunks from the child's own
    count on the device), and the child segments travel as the extra
    int state fields. ``f`` is the matrix's bin columns (the groups).
    ``histogram(mat, begin, count, max_count)`` replaces the child's
    histogram when given (host bounds). ``imeta`` is the host [F, 8]
    metadata table."""
    from ..learner.split_step import SplitOps
    part_fn = partition_segment_plain if plain else partition_segment

    def partition(site, leaf, new):
        feat, cnt = int(site["bs_feat"]), int(site["leaf_cnt"])
        thr, dleft = int(site["bs_thr"]), bool(site["bs_dleft"])
        col, use_lut, lut = partition_decision_lut(
            imeta, feat, thr, dleft, bool(site["bs_iscat"]),
            site["bs_bitset"], bundled)
        seg = part_fn(mat, ws, int(site["leaf_begin"]), cnt, col, thr,
                      dleft, int(imeta[feat, IM_MISS]),
                      int(imeta[feat, IM_DEFBIN]),
                      int(imeta[feat, IM_NBINS]), use_lut,
                      None if lut is None else lut.to(mat.device))
        return seg, cnt

    def child_histogram(part, left):
        seg, cnt = part
        bounds = seg[0:2] if left else seg[2:4]
        if histogram is not None:
            begin, count = (int(v) for v in bounds.tolist())
            return histogram(mat, begin, count, cnt)
        return segment_histogram(mat, bounds, None, b, f, plain=plain,
                                 max_count=cnt)

    def leaf_histogram(leaf, site):
        cnt = int(site["leaf_cnt"])
        if histogram is not None:
            return histogram(mat, int(site["leaf_begin"]), cnt, cnt)
        return segment_histogram(mat, int(site["leaf_begin"]), cnt, b, f,
                                 plain=plain, max_count=cnt)

    def extra_i(part):
        sg = part[0].cpu().numpy()
        return tuple(dict(leaf_begin=int(sg[i]), leaf_cnt=int(sg[i + 1]))
                     for i in (0, 2))

    return SplitOps(partition=partition, histogram=child_histogram,
                    scan=scan, extra_i=extra_i,
                    leaf_histogram=leaf_histogram)


def fused_split_step_segment_plain(k, S, T, mat, ws, hist, imeta, fmeta, *,
                                   params: SplitParams, big_l: int,
                                   max_depth: int, b: int, f: int,
                                   has_monotone: bool,
                                   histogram: Optional[Callable] = None):
    """Plain version of one fused split (the JAX package's interpret
    twin ``_segment_kernel_ref``), in place on ``k``, ``S``, ``T``,
    ``mat`` and ``hist``: the partitioned learner's per-phase
    bookkeeping (``split_step_host``) with the plain ``segment_split_ops``
    and ``per_feature_numerical_plain``. ``S``, ``T`` and ``k`` are read
    on the host and written back. ``histogram(mat, begin, count,
    max_count)`` replaces ``histogram_segment_plain`` for the smaller
    child when given (the card's check feeds it the per-phase kernel, so
    the rest of the step can be held bit for bit)."""
    from ..learner.grow_extras import HistMemory
    from ..learner.split_step import (SEG_SI_PREFIX, make_grow_pack,
                                      split_step_host)
    pack = make_grow_pack(SEG_SI_PREFIX, has_monotone=has_monotone,
                          big_l=big_l)
    st = {"S": S.cpu().clone(), "T": T.cpu().clone()}
    im = imeta.cpu().numpy()
    meta_t = meta_from_tables(imeta, fmeta)
    ops = segment_split_ops(
        mat, ws, im, b, f,
        lambda hists, leaves, salts: per_feature_numerical_plain(
            hists, leaves, meta_t, params), plain=True, histogram=histogram)
    if split_step_host(pack, st, HistMemory("cache", hist), int(k[0]), ops,
                       imeta=im,
                       params=params, big_l=big_l, max_depth=max_depth,
                       has_monotone=has_monotone):
        S.copy_(st["S"])
        T.copy_(st["T"])
        k.add_(1)


class SegmentStep:
    """A prepared launch of the segment kernel over one tree's operands:
    the checks run once, here, and each call is one ctypes call with the
    arguments already converted (the partitioned learner's split loop
    calls it L - 1 times a tree). Arguments as
    ``fused_split_step_segment``."""

    def __init__(self, k, S, T, mat, ws, hist, imeta, fmeta, *,
                 params: SplitParams, big_l: int, max_depth: int, b: int,
                 f: int, has_monotone: bool,
                 scratch: Optional[FusedScratch] = None):
        dev = mat.device
        if dev.type != "cuda":
            raise ValueError(f"the segment kernel runs on CUDA, not {dev}")
        if not 1 <= b <= 256:
            raise ValueError(f"num_bins must be in [1, 256], got {b}")
        req = _native.require
        req(k, device=dev, dtype=torch.int32, shape=(1,), name="k")
        req(S, device=dev, dtype=torch.float32,
            shape=(state_rows(has_monotone), big_l), name="S")
        req(T, device=dev, dtype=torch.float32,
            shape=(TREE_ROWS, big_l - 1), name="T")
        req(mat, device=dev, dtype=torch.uint8, name="mat")
        req(ws, device=dev, dtype=torch.uint8, shape=mat.shape, name="ws")
        req(hist, device=dev, dtype=torch.float32, shape=(big_l, f, b, 3),
            name="hist")
        req(imeta, device=dev, dtype=torch.int32, shape=(f, 8),
            name="imeta")
        req(fmeta, device=dev, dtype=torch.float32, shape=(f, 2),
            name="fmeta")
        cols = mat.shape[1]
        if cols != matrix_cols(f) or mat.data_ptr() % 16 \
                or ws.data_ptr() % 16:
            raise ValueError(f"mat is not a {f}-feature training matrix "
                             "(stride or alignment)")
        if scratch is None:
            scratch = FusedScratch(mat, f, b)
        if scratch.tiles.numel() * PART_THREADS < mat.shape[0] \
                or tuple(scratch.partial.shape) != (max_chunks(f), f, b, 3):
            raise ValueError("scratch does not fit this matrix")
        # the tensors stay referenced while their pointers are held
        self._keep = (k, S, T, mat, ws, hist, imeta, fmeta, scratch)
        self.big_l = big_l
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        p = params
        self._args = (
            *(P(t.data_ptr()) for t in (k, S, T, mat, ws)),
            I(cols), I(payload_offset(f)),
            *(P(t.data_ptr()) for t in (
                hist, imeta, fmeta, scratch.partial, scratch.tiles,
                scratch.counts, scratch.table, scratch.done)),
            *(I(v) for v in (big_l, f, b, scratch.counts.numel(),
                             int(bool(has_monotone)), int(max_depth))),
            *(Fl(v) for v in (p.lambda_l1, p.lambda_l2, p.max_delta_step,
                              p.min_data_in_leaf, p.min_sum_hessian_in_leaf,
                              p.min_gain_to_split)))
        self._stream = P(_native.stream_of(mat))
        self._lib = _native.library()

    def __call__(self) -> None:
        _native.check(self._lib.ltt_split_step_segment(*self._args,
                                                       self._stream),
                      "fused_split_step_segment")
        _native.LAUNCHES["fused_split_step_segment"] += 1

    def timed(self, times: torch.Tensor) -> None:
        """The same split through the kernel's timed instantiation (for
        ``chip_profile.py``; not counted in ``LAUNCHES``): block 0 writes
        ``%globaltimer`` and ``clock64`` at the kernel's entry and after
        each phase of split k into ``times[k - 1]`` (int64
        [L - 1, SEGMENT_TIMES]: nanoseconds in columns 0-6, cycles in
        16-22, column 15 from the block that writes the state, block
        0's histogram cycles by part in 24-26 and 28-29 and its virtual
        blocks in 27; see ``csrc/split_step_segment.cu`` ``stamp``)."""
        _native.require(times, device=self._keep[0].device,
                        dtype=torch.int64,
                        shape=(self.big_l - 1, SEGMENT_TIMES), name="times")
        _native.check(self._lib.ltt_split_step_segment_timed(
            *self._args, ctypes.c_void_p(times.data_ptr()), self._stream),
            "fused_split_step_segment (timed)")


def fused_split_step_segment(k, S, T, mat, ws, hist, imeta, fmeta, *,
                             params: SplitParams, big_l: int,
                             max_depth: int, b: int, f: int,
                             has_monotone: bool,
                             scratch: Optional[FusedScratch] = None):
    """One whole split of the partitioned grow loop, in place on ``k``
    (int32 [1]), ``S`` [Ks, L] and ``T`` [9, L-1] (the merged
    ``StatePack`` of ``learner/split_step.py``), ``mat``/``ws`` (the
    training matrix and its workspace) and ``hist`` [L, F, B, 3].
    ``imeta``/``fmeta`` come from ``pack_meta_tables``. ``scratch``
    (``FusedScratch``) is allocated here when not given; a grow loop
    passes its own so that no split allocates, and prepares its launch
    once a tree (``SegmentStep``)."""
    if mat.device.type == "cpu":
        return fused_split_step_segment_plain(
            k, S, T, mat, ws, hist, imeta, fmeta, params=params,
            big_l=big_l, max_depth=max_depth, b=b, f=f,
            has_monotone=has_monotone)
    SegmentStep(k, S, T, mat, ws, hist, imeta, fmeta, params=params,
                big_l=big_l, max_depth=max_depth, b=b, f=f,
                has_monotone=has_monotone, scratch=scratch)()


# ---- leaf layout ------------------------------------------------------

def leaf_launch_shape(bin_bytes: int, n: int, num_features: int,
                      num_bins: int) -> dict:
    """The cooperative grid the leaf kernel takes on the current card,
    and the most histogram chunks of one split (the partials' leading
    dimension; it depends on the feature tiles, not on the card)."""
    out = (ctypes.c_int * 4)()
    err = _native.library().ltt_split_step_leaf_shape(
        bin_bytes, n, num_features, num_bins,
        leaf_feat_tile(num_features, num_bins, bin_bytes),
        ctypes.addressof(out))
    _native.check(err, "fused_split_step_leaf")
    return dict(blocks_per_sm=out[0], grid=out[1], smem_bytes=out[2],
                max_chunks=out[3])


class LeafScratch:
    """Device scratch of the leaf kernel, allocated once per learner
    (never per split): float64 histogram partials [max_chunks, F, B, 3]
    (a split writes as many as its smaller child has chunks), the
    smaller child's membership bits [ceil(N / 32)] and row ids [N], the
    per-block member counts [grid], both children's scan tables and the
    count of blocks past their scans."""

    def __init__(self, binned: torch.Tensor, num_bins: int):
        n, f = binned.shape
        dev = binned.device
        self.shape = leaf_launch_shape(leaf_bin_bytes(binned), n, f,
                                       num_bins)
        self.partial = torch.empty(
            (self.shape["max_chunks"], f, num_bins, 3), dtype=torch.float64,
            device=dev)
        self.mask = torch.empty((-(-n // 32),), dtype=torch.int32,
                                device=dev)
        self.ids = torch.empty((n,), dtype=torch.int32, device=dev)
        self.counts = torch.empty((self.shape["grid"],), dtype=torch.int32,
                                  device=dev)
        self.table = torch.empty((2, f, 8), dtype=torch.float32, device=dev)
        # blocks past their scans; the launch that counts last resets it
        self.done = torch.zeros((1,), dtype=torch.int32, device=dev)


def leaf_split_ops(lid, binned, ghc, imeta: np.ndarray, b: int, scan,
                   partial: Optional[torch.Tensor] = None, *,
                   bundled: bool = False, mv: Optional[tuple] = None,
                   hist_binned: Optional[torch.Tensor] = None,
                   reduce: Optional[Callable] = None):
    """``SplitOps`` of the leaf layout: the split relabels ``lid`` in
    place (``split_leaf``) from the split feature's bins: its column, or
    with ``bundled`` its EFB group's column decoded
    (``decode_feature_bin``), or for a multi-val feature its bins read
    from the slots of the leaf's rows (``multival_feature_bins``; JAX
    serial.py:1084-1108 decodes every row).
    A child's (or a leaf's) histogram is, with ``partial`` (the kernel's
    float64 scratch: the card), the ``hist_rows`` kernel over the child's
    row ids in row order, else ``build_histogram`` over masked ghc (the
    plain version, the JAX twin's formulation; rows with zero ghc add
    nothing, so the two are the same function); with ``mv`` = (slots,
    their layout, the kernel's multi-val partials or None for the plain
    version) the multi-val groups' histogram of the same rows
    (``hist_multival`` over the slots' ``MultivalLayout``) follows on
    the group axis. ``scan`` is given (the scan kernel or its plain
    version). ``imeta`` is the host [F, 8]
    metadata table. ``hist_binned`` (default ``binned``) is the matrix
    the histograms read (the feature-parallel learner's shard of the
    columns); ``reduce`` takes each histogram's float64 sums, unrounded
    (the multi-val groups' too), and returns the histogram (the
    data-parallel learners' all-reduce)."""
    from ..learner.split_step import SplitOps
    from ..data.bundling import MV_SLOT_STRIDE, decode_feature_bin
    from .hist_multival_cuda import hist_multival, hist_multival_plain
    from .histogram import multival_feature_bins
    g_dense = binned.shape[1]

    def bin_column(f: int, leaf: int) -> torch.Tensor:
        if not bundled:
            return binned[:, f]
        grp, off = int(imeta[f, IM_GROUP]), int(imeta[f, IM_OFFSET])
        nbf = int(imeta[f, IM_NBINS])
        if grp < g_dense:
            return decode_feature_bin(binned[:, grp].long(), off, nbf)
        # a multi-val feature's bins from the slots of the leaf's rows
        # only: split_leaf reads no other row's bin
        rows = torch.nonzero(lid == leaf).flatten()
        col = torch.zeros(lid.shape[0], dtype=torch.int64,
                          device=lid.device)
        col[rows] = multival_feature_bins(
            mv[0].index_select(0, rows),
            (grp - g_dense) * MV_SLOT_STRIDE + off, nbf)
        return col

    def partition(site, leaf, new):
        f = int(site["bs_feat"])
        lid.copy_(split_leaf(lid, bin_column(f, leaf), leaf, new,
                             int(site["bs_thr"]), bool(site["bs_dleft"]),
                             int(imeta[f, IM_MISS]),
                             int(imeta[f, IM_DEFBIN]),
                             int(imeta[f, IM_NBINS]),
                             bool(site["bs_iscat"]), site["bs_bitset"]))
        return leaf, new

    def histogram(part, left):
        return rows_histogram(part[0] if left else part[1])

    hb = binned if hist_binned is None else hist_binned
    f64 = reduce is not None

    def rows_histogram(leaf):
        in_small = lid == leaf
        if partial is not None:
            ids = torch.nonzero(in_small).flatten().to(torch.int32)
            h = histogram_rows(hb, ghc, b, ids, partial=partial,
                               float64=f64)
        else:
            ids = None
            h = build_histogram(hb, ghc * in_small.to(ghc.dtype)[:, None],
                                b, float64=f64)
        if mv is not None:
            _, layout, mv_partial = mv
            if mv_partial is not None:
                hm = hist_multival(layout, ghc, b, ids, partial=mv_partial,
                                   float64=f64)
            else:
                hm = hist_multival_plain(layout, ghc, b, torch.nonzero(
                    in_small).flatten(), float64=f64)
            h = torch.cat([h, hm])
        return reduce(h) if f64 else h

    return SplitOps(partition=partition, histogram=histogram, scan=scan,
                    extra_i=lambda part: ({}, {}),
                    leaf_histogram=lambda leaf, site: rows_histogram(leaf))


def fused_split_step_leaf_plain(k, S, T, lid, hist, binned, ghc, imeta,
                                fmeta, *, params: SplitParams, big_l: int,
                                max_depth: int, b: int, has_monotone: bool):
    """Plain version of one fused split on the leaf layout (the JAX
    package's interpret twin ``_leaf_kernel_ref``), in place on ``k``,
    ``S``, ``T``, ``lid`` and ``hist``: the serial learner's per-phase
    bookkeeping (``split_step_host``) with ``leaf_split_ops``. ``S``,
    ``T`` and ``k`` are read on the host and written back."""
    from ..learner.grow_extras import HistMemory
    from ..learner.split_step import make_grow_pack, split_step_host
    pack = make_grow_pack((), has_monotone=has_monotone, big_l=big_l)
    st = {"S": S.cpu().clone(), "T": T.cpu().clone()}
    im = imeta.cpu().numpy()
    meta_t = meta_from_tables(imeta, fmeta)
    ops = leaf_split_ops(
        lid, binned, ghc, im, b,
        lambda hists, leaves, salts: per_feature_numerical_plain(
            hists, leaves, meta_t, params))
    if split_step_host(pack, st, HistMemory("cache", hist), int(k[0]), ops,
                       imeta=im,
                       params=params, big_l=big_l, max_depth=max_depth,
                       has_monotone=has_monotone):
        S.copy_(st["S"])
        T.copy_(st["T"])
        k.add_(1)


class LeafStep:
    """A prepared launch of the leaf kernel over one tree's operands: the
    checks run once, here, and each call is one ctypes call with the
    arguments already converted (the serial learner's split loop calls
    it L - 1 times a tree). Arguments as ``fused_split_step_leaf``."""

    def __init__(self, k, S, T, lid, hist, binned, ghc, imeta, fmeta, *,
                 params: SplitParams, big_l: int, max_depth: int, b: int,
                 has_monotone: bool, scratch: Optional[LeafScratch] = None):
        dev = binned.device
        if dev.type != "cuda":
            raise ValueError(f"the leaf kernel runs on CUDA, not {dev}")
        bin_bytes = leaf_bin_bytes(binned)
        if not 1 <= b <= (256 if bin_bytes == 1 else MAX_BINS["leaf"]):
            raise ValueError(f"num_bins {b} out of range for "
                             f"{8 * bin_bytes}-bit bins")
        n, f = binned.shape
        req = _native.require
        req(k, device=dev, dtype=torch.int32, shape=(1,), name="k")
        req(S, device=dev, dtype=torch.float32,
            shape=(state_rows(has_monotone, "leaf"), big_l), name="S")
        req(T, device=dev, dtype=torch.float32,
            shape=(TREE_ROWS, big_l - 1), name="T")
        req(lid, device=dev, dtype=torch.int32, shape=(n,), name="lid")
        req(hist, device=dev, dtype=torch.float32, shape=(big_l, f, b, 3),
            name="hist")
        req(binned, device=dev, dtype=binned.dtype, name="binned")
        req(ghc, device=dev, dtype=torch.float32, shape=(n, 3), name="ghc")
        req(imeta, device=dev, dtype=torch.int32, shape=(f, 8),
            name="imeta")
        req(fmeta, device=dev, dtype=torch.float32, shape=(f, 2),
            name="fmeta")
        if scratch is None:
            scratch = LeafScratch(binned, b)
        if tuple(scratch.partial.shape[1:]) != (f, b, 3) \
                or scratch.mask.numel() * 32 < n or scratch.ids.numel() < n:
            raise ValueError("scratch does not fit this matrix")
        # the tensors stay referenced while their pointers are held
        self._keep = (k, S, T, lid, hist, binned, ghc, imeta, fmeta,
                      scratch)
        self.big_l = big_l
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        p = params
        self._args = (
            I(bin_bytes), *(P(t.data_ptr()) for t in (
                k, S, T, lid, hist, binned, ghc, imeta, fmeta,
                scratch.partial, scratch.mask, scratch.ids, scratch.counts,
                scratch.table, scratch.done)),
            *(I(v) for v in (n, big_l, f, b,
                             leaf_feat_tile(f, b, bin_bytes),
                             scratch.counts.numel(), int(bool(has_monotone)),
                             int(max_depth))),
            *(Fl(v) for v in (p.lambda_l1, p.lambda_l2, p.max_delta_step,
                              p.min_data_in_leaf, p.min_sum_hessian_in_leaf,
                              p.min_gain_to_split)))
        self._stream = P(_native.stream_of(binned))
        self._lib = _native.library()

    def __call__(self) -> None:
        _native.check(self._lib.ltt_split_step_leaf(*self._args,
                                                    self._stream),
                      "fused_split_step_leaf")
        _native.LAUNCHES["fused_split_step_leaf"] += 1

    def timed(self, times: torch.Tensor) -> None:
        """The same split through the kernel's timed instantiation (for
        ``chip_profile.py``; not counted in ``LAUNCHES``): block 0 writes
        ``%globaltimer`` and ``clock64`` at the kernel's entry and after
        each phase of split k into ``times[k - 1]`` (int64
        [L - 1, LEAF_TIMES]: nanoseconds in columns 0-7, cycles in 8-14,
        column 7 from the block that writes the state, block 0's
        histogram cycles by part in 16-19 and clock reads inside its
        first scan in 20-24; see ``csrc/split_step_leaf.cu`` ``stamp``)."""
        _native.require(times, device=self._keep[0].device,
                        dtype=torch.int64,
                        shape=(self.big_l - 1, LEAF_TIMES), name="times")
        _native.check(self._lib.ltt_split_step_leaf_timed(
            *self._args, ctypes.c_void_p(times.data_ptr()), self._stream),
            "fused_split_step_leaf (timed)")


def fused_split_step_leaf(k, S, T, lid, hist, binned, ghc, imeta, fmeta, *,
                          params: SplitParams, big_l: int, max_depth: int,
                          b: int, has_monotone: bool,
                          scratch: Optional[LeafScratch] = None):
    """One whole split of the serial grow loop, in place on ``k`` (int32
    [1]), ``S`` [Ks, L] and ``T`` [9, L-1] (the merged ``StatePack`` of
    ``learner/split_step.py``, leaf layout), ``lid`` [N] int32 and
    ``hist`` [L, F, B, 3]. ``binned`` [N, F] is uint8 (B <= 256) or the
    int16 bits of uint16 bins (B <= 1024), ``ghc`` [N, 3] float32.
    ``imeta``/``fmeta`` come from ``pack_meta_tables``. ``scratch``
    (``LeafScratch``) is allocated here when not given; a grow loop
    passes its own so that no split allocates, and prepares its launch
    once a tree (``LeafStep``)."""
    dev = binned.device
    if dev.type == "cpu":
        return fused_split_step_leaf_plain(
            k, S, T, lid, hist, binned, ghc, imeta, fmeta, params=params,
            big_l=big_l, max_depth=max_depth, b=b,
            has_monotone=has_monotone)
    LeafStep(k, S, T, lid, hist, binned, ghc, imeta, fmeta, params=params,
             big_l=big_l, max_depth=max_depth, b=b,
             has_monotone=has_monotone, scratch=scratch)()


# ---- the model-batched leaf step ---------------------------------------

# shared bytes a model of the batched kernel past the single kernel's
# (csrc/split_step_leaf.cu kModelSmem: the model's site, cut and child
# row count, and its entry in the list of going models)
LEAF_BATCHED_MODEL_BYTES = 144


# the batched compaction's staging (kCompactBytes: a mask word and an
# offset a thread, for up to 8 models of 256 threads), which takes the
# histogram's shared bytes while they are free
LEAF_BATCHED_COMPACT_BYTES = 2 * 8 * 256 * 4


def leaf_batched_smem_bytes(single_smem: int, models: int) -> int:
    """Dynamic shared bytes of a batched launch of ``models`` models:
    the single kernel's (``leaf_launch_shape``'s; at least
    ``LEAF_BATCHED_COMPACT_BYTES``), rounded up to 16, then
    ``LEAF_BATCHED_MODEL_BYTES`` a model."""
    return -(-max(single_smem, LEAF_BATCHED_COMPACT_BYTES) // 16) * 16 \
        + models * LEAF_BATCHED_MODEL_BYTES


def params_table(params, device) -> torch.Tensor:
    """[M, 6] float32 of each model's ``SplitParams`` as the kernels take
    them (l1, l2, max_delta_step, min_data_in_leaf, min_sum_hessian_in_leaf,
    min_gain_to_split), each rounded to float32 as the single launch's
    ``c_float`` arguments are."""
    return torch.tensor([[p.lambda_l1, p.lambda_l2, p.max_delta_step,
                          p.min_data_in_leaf, p.min_sum_hessian_in_leaf,
                          p.min_gain_to_split] for p in params],
                        dtype=torch.float32, device=device)


def leaf_batched_launch_shape(bin_bytes: int, n: int, num_features: int,
                              num_bins: int, models: int) -> dict:
    """``leaf_launch_shape`` of the model-batched kernel for ``models``
    models (its own grid; ``leaf_batched_smem_bytes``)."""
    out = (ctypes.c_int * 4)()
    err = _native.library().ltt_split_step_leaf_batched_shape(
        bin_bytes, n, num_features, num_bins,
        leaf_feat_tile(num_features, num_bins, bin_bytes), models,
        ctypes.addressof(out))
    _native.check(err, "fused_split_step_leaf_batched")
    return dict(blocks_per_sm=out[0], grid=out[1], smem_bytes=out[2],
                max_chunks=out[3])


class LeafBatchScratch:
    """Device scratch of the model-batched leaf kernel for ``models``
    models, allocated once per bucket: each model's ``LeafScratch``
    (float64 partials [max_chunks, F, B, 3], which the batched root
    histogram shares, membership bits, row ids, per-block counts, both
    scan tables, the done count).
    ``layout`` lists every tensor it allocates; ``nbytes`` sizes a
    bucket's memory gate from the same list."""

    @staticmethod
    def layout(n: int, num_features: int, num_bins: int, models: int,
               max_chunks: int, grid: int) -> dict:
        """name -> (shape, dtype) of each tensor of the scratch."""
        return {
            "partial": ((models, max_chunks, num_features, num_bins, 3),
                        torch.float64),
            "mask": ((models, -(-n // 32)), torch.int32),
            "ids": ((models, n), torch.int32),
            "counts": ((models, grid), torch.int32),
            "table": ((models, 2, num_features, 8), torch.float32),
            # each model's scans past their count; the launch that counts
            # a model's last resets it
            "done": ((models,), torch.int32)}

    @classmethod
    def nbytes(cls, *args) -> int:
        """Device bytes of ``layout(*args)``."""
        return sum(int(np.prod(shape)) * dtype.itemsize
                   for shape, dtype in cls.layout(*args).values())

    def __init__(self, binned: torch.Tensor, num_bins: int, models: int):
        n, f = binned.shape
        dev = binned.device
        self.models = models
        self.shape = leaf_batched_launch_shape(leaf_bin_bytes(binned), n, f,
                                               num_bins, models)
        for name, (shape, dtype) in self.layout(
                n, f, num_bins, models, self.shape["max_chunks"],
                self.shape["grid"]).items():
            alloc = torch.zeros if name == "done" else torch.empty
            setattr(self, name, alloc(shape, dtype=dtype, device=dev))


def fused_split_step_leaf_batched_plain(k, S, T, lid, hist, binned, ghc,
                                        imeta, fmeta, *, params,
                                        big_l: int, max_depth: int, b: int,
                                        has_monotone: bool):
    """Plain version of the model-batched step: for each model m in turn,
    ``fused_split_step_leaf_plain`` on its views ``k[m:m+1]``, ``S[m]``,
    ``T[m]``, ``lid[m]``, ``hist[m]`` and ``ghc[m]`` under ``params[m]``
    (a ``SplitParams`` a model), over the shared ``binned``."""
    for m, p in enumerate(params):
        fused_split_step_leaf_plain(
            k[m:m + 1], S[m], T[m], lid[m], hist[m], binned, ghc[m], imeta,
            fmeta, params=p, big_l=big_l, max_depth=max_depth, b=b,
            has_monotone=has_monotone)


class LeafBatchStep:
    """A prepared launch of the model-batched leaf kernel over one
    iteration's operands (checked once; each call is one ctypes call,
    split k[m] of every model m). Arguments as
    ``fused_split_step_leaf_batched``."""

    def __init__(self, k, S, T, lid, hist, binned, ghc, imeta, fmeta,
                 ptable, *, big_l: int, max_depth: int, b: int,
                 has_monotone: bool,
                 scratch: Optional[LeafBatchScratch] = None):
        dev = binned.device
        if dev.type != "cuda":
            raise ValueError(f"the leaf kernel runs on CUDA, not {dev}")
        bin_bytes = leaf_bin_bytes(binned)
        if not 1 <= b <= (256 if bin_bytes == 1 else MAX_BINS["leaf"]):
            raise ValueError(f"num_bins {b} out of range for "
                             f"{8 * bin_bytes}-bit bins")
        n, f = binned.shape
        models = k.shape[0]
        req = _native.require
        req(k, device=dev, dtype=torch.int32, shape=(models,), name="k")
        req(S, device=dev, dtype=torch.float32,
            shape=(models, state_rows(has_monotone, "leaf"), big_l), name="S")
        req(T, device=dev, dtype=torch.float32,
            shape=(models, TREE_ROWS, big_l - 1), name="T")
        req(lid, device=dev, dtype=torch.int32, shape=(models, n), name="lid")
        req(hist, device=dev, dtype=torch.float32,
            shape=(models, big_l, f, b, 3), name="hist")
        req(binned, device=dev, dtype=binned.dtype, name="binned")
        req(ghc, device=dev, dtype=torch.float32, shape=(models, n, 3),
            name="ghc")
        req(imeta, device=dev, dtype=torch.int32, shape=(f, 8),
            name="imeta")
        req(fmeta, device=dev, dtype=torch.float32, shape=(f, 2),
            name="fmeta")
        req(ptable, device=dev, dtype=torch.float32, shape=(models, 6),
            name="params")
        if scratch is None:
            scratch = LeafBatchScratch(binned, b, models)
        if scratch.models != models \
                or tuple(scratch.partial.shape[2:]) != (f, b, 3) \
                or scratch.mask.shape[1] * 32 < n \
                or scratch.ids.shape[1] < n:
            raise ValueError("scratch does not fit this matrix")
        # the tensors stay referenced while their pointers are held
        self._keep = (k, S, T, lid, hist, binned, ghc, imeta, fmeta, ptable,
                      scratch)
        self.big_l = big_l
        P, I = ctypes.c_void_p, ctypes.c_int
        self._args = (
            I(bin_bytes), I(models), *(P(t.data_ptr()) for t in (
                k, S, T, lid, hist, binned, ghc, imeta, fmeta, ptable,
                scratch.partial, scratch.mask, scratch.ids, scratch.counts,
                scratch.table, scratch.done)),
            *(I(v) for v in (n, big_l, f, b,
                             leaf_feat_tile(f, b, bin_bytes),
                             scratch.counts.shape[1],
                             int(bool(has_monotone)), int(max_depth))))
        self._stream = P(_native.stream_of(binned))
        self._lib = _native.library()

    def __call__(self) -> None:
        _native.check(self._lib.ltt_split_step_leaf_batched(*self._args,
                                                            self._stream),
                      "fused_split_step_leaf_batched")
        _native.LAUNCHES["fused_split_step_leaf_batched"] += 1

    def timed(self, times: torch.Tensor, row: int) -> None:
        """The same launch through the kernel's timed instantiation (for
        ``chip_profile.py``; not counted in ``LAUNCHES``): block 0 writes
        ``%globaltimer`` and ``clock64`` at the kernel's entry and after
        each phase into ``times[row]`` (int64 [L - 1, LEAF_TIMES]:
        nanoseconds in columns 0-6, cycles in 8-14, column 7 the latest
        state write of any model, block 0's histogram cycles by part in
        16-19, cycles inside the lid pass and the compaction in 20-23;
        see ``csrc/split_step_leaf.cu`` ``bstamp``)."""
        _native.require(times, device=self._keep[0].device,
                        dtype=torch.int64,
                        shape=(self.big_l - 1, LEAF_TIMES), name="times")
        if not 0 <= row < self.big_l - 1:
            raise ValueError(f"row {row} out of range")
        _native.check(self._lib.ltt_split_step_leaf_batched_timed(
            *self._args, ctypes.c_void_p(times.data_ptr() + row * LEAF_TIMES
                                         * times.element_size()),
            self._stream), "fused_split_step_leaf_batched (timed)")


def fused_split_step_leaf_batched(k, S, T, lid, hist, binned, ghc, imeta,
                                  fmeta, *, params, big_l: int,
                                  max_depth: int, b: int,
                                  has_monotone: bool,
                                  scratch: Optional[LeafBatchScratch] = None):
    """Split ``k[m]`` of each of M models in one call, in place on ``k``
    (int32 [M]), ``S`` [M, Ks, L], ``T`` [M, 9, L-1], ``lid`` [M, N]
    int32 and ``hist`` [M, L, F, B, 3], with ``ghc`` [M, N, 3] and
    ``params`` (a ``SplitParams`` a model) over one shared ``binned``
    [N, F] (as ``fused_split_step_leaf``). Each model's split is exactly
    ``fused_split_step_leaf``'s on its own state, and a model whose grow
    condition fails is left as it was. On CUDA tensors it launches the
    model-batched kernel (``csrc/split_step_leaf.cu``,
    ``ltt_split_step_leaf_batched``) once; on CPU tensors it runs
    ``fused_split_step_leaf_batched_plain``."""
    if binned.device.type == "cpu":
        return fused_split_step_leaf_batched_plain(
            k, S, T, lid, hist, binned, ghc, imeta, fmeta, params=params,
            big_l=big_l, max_depth=max_depth, b=b, has_monotone=has_monotone)
    LeafBatchStep(k, S, T, lid, hist, binned, ghc, imeta, fmeta,
                  params_table(params, binned.device), big_l=big_l,
                  max_depth=max_depth, b=b, has_monotone=has_monotone,
                  scratch=scratch)()
