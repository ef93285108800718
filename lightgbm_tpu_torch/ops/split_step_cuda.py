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
(``_segment_kernel_ref``) written with the port's plain ops
(``partition_segment_plain``, ``histogram_segment_plain``,
``per_feature_numerical_plain``, ``assemble_split``) and the tensor
bookkeeping of ``learner/split_step.py``; the per-phase loop's host
bookkeeping grows the same trees byte for byte. ``SegmentStep`` is the
launch prepared once for a tree's operands, which the partitioned
learner's split loop uses.

The 192-feature cap of the TPU kernel (``MAX_FUSED_F``, a Mosaic
program-size limit) is not carried over: the kernel tiles features as
the histogram kernel does.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import numpy as np
import torch

from . import _native
from .hist_cuda import (histogram_segment_plain, matrix_cols, max_chunks,
                        payload_offset)
from .partition_cuda import PART_THREADS, partition_segment_plain
from .histogram import build_histogram
from .partition import split_leaf
from .split import FeatureMeta, SplitParams, assemble_split
from .split_scan_cuda import per_feature_numerical_plain

# imeta table columns (one [F, 8] i32 operand)
IM_NBINS, IM_MISS, IM_DEFBIN, IM_MOSTFREQ, IM_MONO, IM_GROUP, \
    IM_OFFSET, IM_ISCAT = range(8)

# the leaf kernel's dynamic shared memory: a float64 histogram tile and
# LEAF_STAGE_ROWS staged rows (ghc and the tile's bins), two blocks per
# SM; the scan planes reuse the same memory
LEAF_SMEM_BYTES = 110 * 1024
LEAF_STAGE_ROWS = 512   # csrc/split_step_leaf.cu kStageRows
LEAF_MAX_TILE = 16      # csrc/split_step_leaf.cu kMaxTile
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
    imeta = np.stack([meta.num_bins, meta.missing, meta.default_bin,
                      meta.most_freq_bin, meta.monotone, np.arange(f),
                      np.zeros(f), is_cat], axis=1).astype(np.int32)
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
                            layout: str = "segment") -> bool:
    """The fused-step gate of one learner, decided before training from
    the resolved mode ("on" / "off" / "auto"), the learner's static
    eligibility, and for "auto" a CUDA device within
    ``fused_compiled_ok``'s scope ("auto" is off on the CPU)."""
    if mode == "off" or not eligible:
        return False
    if mode == "on":
        return True
    return torch.device(device).type == "cuda" and fused_compiled_ok(
        params, bundled=False, num_bins_max=num_bins_max, layout=layout)


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


def fused_split_step_segment_plain(k, S, T, mat, ws, hist, imeta, fmeta, *,
                                   params: SplitParams, big_l: int,
                                   max_depth: int, b: int, f: int,
                                   has_monotone: bool,
                                   histogram: Optional[Callable] = None):
    """Plain version of one fused split (the JAX package's interpret
    twin ``_segment_kernel_ref``), in place on ``k``, ``S``, ``T``,
    ``mat`` and ``hist``. The state stays where ``S`` lies and the
    bookkeeping runs on 0-dim tensors, as in the kernel; the plain ops
    read the segment bounds, the split feature and the scan inputs on
    the host. ``histogram(mat, begin, count, max_count)`` replaces
    ``histogram_segment_plain`` for the smaller child when given (the
    card's check feeds it the per-phase kernel, so the rest of the step
    can be held bit for bit)."""
    from ..learner.split_step import (SEG_SI_PREFIX, child_columns,
                                      child_constraints, make_grow_pack,
                                      order_child_pair_t,
                                      split_node_updates_t)
    pack = make_grow_pack(SEG_SI_PREFIX, has_monotone=has_monotone,
                          big_l=big_l)
    st = {"S": S, "T": T}
    dev = S.device
    kk = k[0].long()
    open_gain = torch.where(torch.arange(big_l, device=dev) < kk,
                            pack.row_f(st, "bs_gain"), float("-inf"))
    # the grow loop's condition (lightgbm_tpu/learner/partitioned.py:
    # 563-568); when it fails the step changes nothing
    if not bool((kk < big_l) & (open_gain.max() > 0.0)):
        return
    leaf = torch.argmax(open_gain)   # first index of the maximum
    new, s = kk, kk - 1
    site = pack.read_site(st, leaf)
    feat, thr, dleft = site["bs_feat"], site["bs_thr"], site["bs_dleft"]
    lg, lh, lc = site["bs_lg"], site["bs_lh"], site["bs_lc"]
    pg, ph, pc = site["leaf_g"], site["leaf_h"], site["leaf_c"]
    rg, rh, rc = pg - lg, ph - lh, pc - lc
    lout, rout = site["bs_lout"], site["bs_rout"]
    inf = torch.tensor(np.inf, dtype=torch.float32, device=dev)
    pcmin, pcmax = site.get("leaf_cmin", -inf), site.get("leaf_cmax", inf)
    begin, cnt = site["leaf_begin"], site["leaf_cnt"]

    # stable partition of [begin, begin + cnt), then the smaller child's
    # histogram and the sibling as parent - child
    fi = int(feat)
    im = imeta[fi].tolist()
    seg = partition_segment_plain(
        mat, ws, int(begin), int(cnt), fi, int(thr), bool(dleft),
        im[IM_MISS], im[IM_DEFBIN], im[IM_NBINS], False, None)
    small_left = lc <= rc
    sb = torch.where(small_left, seg[0], seg[2])
    sc = torch.where(small_left, seg[1], seg[3])
    if histogram is None:
        hist_small = histogram_segment_plain(mat, int(sb), int(sc), b, f)
    else:
        hist_small = histogram(mat, int(sb), int(sc), int(cnt))
    hist_other = hist[leaf] - hist_small
    idx_a = torch.where(small_left, leaf, new)
    idx_b = torch.where(small_left, new, leaf)

    # both children's scans and state columns, the node's tree column
    depth = site["leaf_depth"] + 1
    cmin_l, cmax_l, cmin_r, cmax_r = child_constraints(
        imeta[fi, IM_MONO], lout, rout, pcmin, pcmax, has_monotone)
    o = order_child_pair_t(small_left, kk, lg, lh, lc, rg, rh, rc, lout,
                           rout, cmin_l, cmax_l, cmin_r, cmax_r)
    leaves = [tuple(float(o[x + ch]) for x in ("g", "h", "c", "cmin_",
                                                "cmax_"))
              for ch in ("a", "b")]
    table = per_feature_numerical_plain(
        [hist_small, hist_other], leaves, meta_from_tables(imeta, fmeta),
        params).cpu().numpy()
    blocked = max_depth > 0 and int(depth) >= max_depth
    segs = {"a": (sb, sc),
            "b": (torch.where(small_left, seg[2], seg[0]), cnt - sc)}
    cols = {}
    for i, ch in enumerate(("a", "b")):
        split = assemble_split(table[i])
        if blocked:
            split = split._replace(gain=-np.inf)
        cols[ch] = child_columns(
            split, o["g" + ch], o["h" + ch], o["c" + ch], o["out_" + ch],
            o["cmin_" + ch], o["cmax_" + ch], s, o["side_" + ch], depth,
            extra_i=dict(leaf_begin=segs[ch][0], leaf_cnt=segs[ch][1]))
    treef, treei, pnode, upd = split_node_updates_t(
        params, site["bs_gain"], feat, thr, dleft, False, pg, ph, pc,
        site["ref_node"], leaf, new)
    pack.set_state_cols(st, idx_a, idx_b, cols["a"][0], cols["b"][0],
                        cols["a"][1], cols["b"][1])
    pack.set_tree_col(st, s, treef, treei, pnode, upd, site["ref_side"])
    hist[idx_a] = hist_small
    hist[idx_b] = hist_other
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

def leaf_feat_tile(num_features: int, num_bins: int,
                   bin_bytes: Optional[int] = None) -> int:
    """Features per histogram tile of the leaf kernel (float64 sums and
    the staged rows' bins; ``bin_bytes`` defaults to the narrowest type
    that holds ``num_bins``)."""
    if bin_bytes is None:
        bin_bytes = 1 if num_bins <= 256 else 2
    fit = (LEAF_SMEM_BYTES - 12 * LEAF_STAGE_ROWS) \
        // (num_bins * 3 * 8 + LEAF_STAGE_ROWS * bin_bytes)
    return max(1, min(num_features, fit, LEAF_MAX_TILE))


def leaf_bin_bytes(binned: torch.Tensor) -> int:
    """1 for u8 bins, 2 for u16 bins held as int16 bit patterns."""
    if binned.dtype == torch.uint8:
        return 1
    if binned.dtype == torch.int16:
        return 2
    raise TypeError(f"binned has dtype {binned.dtype}, expected uint8 or "
                    "int16 (the bits of uint16 bins)")


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


def leaf_split_ops(lid, binned, ghc, imeta: np.ndarray, b: int, scan):
    """``SplitOps`` of the leaf layout over plain torch ops: the split
    relabels ``lid`` in place (``split_leaf``), the smaller child's
    histogram is ``build_histogram`` over masked ghc, ``scan`` is given
    (the scan kernel or its plain version). ``imeta`` is the host
    [F, 8] metadata table."""
    from ..learner.split_step import SplitOps

    def partition(site, leaf, new):
        f = int(site["bs_feat"])
        lid.copy_(split_leaf(lid, binned[:, f], leaf, new,
                             int(site["bs_thr"]), bool(site["bs_dleft"]),
                             int(imeta[f, IM_MISS]),
                             int(imeta[f, IM_DEFBIN]),
                             int(imeta[f, IM_NBINS])))
        return leaf, new

    def histogram(part, small_left):
        small = part[0] if small_left else part[1]
        return build_histogram(binned, ghc * (lid == small).to(
            ghc.dtype)[:, None], b)

    return SplitOps(partition=partition, histogram=histogram, scan=scan,
                    extra_i=lambda part: ({}, {}))


def fused_split_step_leaf_plain(k, S, T, lid, hist, binned, ghc, imeta,
                                fmeta, *, params: SplitParams, big_l: int,
                                max_depth: int, b: int, has_monotone: bool):
    """Plain version of one fused split on the leaf layout (the JAX
    package's interpret twin ``_leaf_kernel_ref``), in place on ``k``,
    ``S``, ``T``, ``lid`` and ``hist``: the serial learner's per-phase
    bookkeeping (``split_step_host``) with ``leaf_split_ops``. ``S``,
    ``T`` and ``k`` are read on the host and written back."""
    from ..learner.split_step import make_grow_pack, split_step_host
    pack = make_grow_pack((), has_monotone=has_monotone, big_l=big_l)
    st = {"S": S.cpu().clone(), "T": T.cpu().clone()}
    im = imeta.cpu().numpy()
    meta_t = meta_from_tables(imeta, fmeta)
    ops = leaf_split_ops(
        lid, binned, ghc, im, b,
        lambda hists, leaves: per_feature_numerical_plain(
            hists, leaves, meta_t, params))
    if split_step_host(pack, st, hist, int(k[0]), ops, imeta=im,
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
