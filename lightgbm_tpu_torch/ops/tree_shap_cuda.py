"""TreeSHAP contributions on the card (``csrc/tree_shap.cu``).

The JAX package computes SHAP values with the reference's recursive
TreeSHAP (src/io/tree.cpp:631-737) on the host, in C++
(``lightgbm_tpu/native/treeshap.cpp``, ctypes) with ``_tree_shap`` of
``lightgbm_tpu/predictor.py:593`` as its Python twin; no TPU kernel
lies on that path. The port's kernel follows GPUTreeShap (Mitchell,
Frank, Wilson, Holmes, Fouché, PeerJ CS 2022) instead of the recursion,
whose arena of ``(D + 1)(D + 2) / 2`` path elements a row does not fit a
thread at the depths of a 255-leaf leaf-wise tree.

``shap_paths`` splits each tree of a model once, on the host, into its
root-to-leaf paths. A path's repeated features merge into one element,
as the recursion's unwind merges them: its zero fraction is the product
of the cover ratios along the path, its one fraction (per row, on the
card) the AND of the row's decisions at each of its nodes. A path is
then at most F + 1 elements (the bias element first). ``pack_bins``
packs the paths of at most 32 elements into 32-lane bins, first-fit
decreasing by length, and ``bin_lanes`` lays out each lane's data once a
model: its place in its path, feature, zero fraction, leaf value, class,
its one-fraction test (an interval of numerical thresholds and the
answer for a missing value, or the element's node list), and which
lanes of the bin add to the same (class, feature) slot; ``shap_tables``
holds the ratios the recursion divides by. ``tree_shap`` launches the
kernel for a CUDA tensor: a warp owns up to 16 rows (fewer when
k (F + 1) is wide) and walks every bin in order, the bin's lanes in
registers across the rows, extend and unwound sums in float64 with the
tables' ratios in place of divisions, each slot's lanes summed in lane
order by the lowest of them and added once; a path of more than 32
elements (F >= 32) goes to a second kernel that gives a path to a
block, its weights in shared memory. For a CPU tensor it runs the plain
version,
``predictor.tree_shap_plain``. The wrapper counts its launches in
``_native.LAUNCHES["tree_shap"]`` (one a call that launches).
"""

from __future__ import annotations

import heapq
from typing import Dict, List

import numpy as np
import torch

from . import _native

WARP = 32
WARPS_PER_BLOCK = 4          # csrc/tree_shap.cu kWarps
ROWS_PER_WARP = 16           # kMaxRows: rows a warp, at most
PHI_BYTES = 24 * 1024        # a block's phi rows: rows a warp fit this
SHARED_BYTES = 96 * 1024     # kMaxSmem: a block's phi rows at most
TABLE_SIDE = 33              # kTab
LONG_THREADS_MAX = 1024      # the long-path kernel: a thread an element
# a bin lane's flag bits (csrc/tree_shap.cu): missing code in bits 0-1
FLAG_ONE_MISSING = 4
FLAG_GENERAL = 8
FLAG_LEADER = 16


def shap_paths(models: List, k: int) -> Dict[str, np.ndarray]:
    """The model's root-to-leaf paths in the kernel's flat layout:

    - nodes, numbered over the model: ``nfeat`` i32, ``nthr`` f64,
      ``nflags`` i32 (bit 0 categorical, bit 1 default left, bits 2-3
      the missing code), ``ncat_off`` / ``ncat_len`` i32 into ``cats``
      u32 (a categorical node's left categories as a bitset);
    - paths: ``pbegin`` i32 [P + 1] into the elements, ``pvalue`` f64
      (the leaf value), ``pcls`` i32 (the tree's class);
    - elements: ``efeat`` i32 (-1 for the bias element), ``ezero`` f64,
      ``ecbegin`` i32 [E + 1] into the conditions;
    - conditions: ``cnode`` i32, ``cleft`` i32 (1: the path goes left);
    - ``expected`` f64 [k]: each class's sum of its trees' expected
      values, in tree order; ``max_len``: the longest path.
    """
    from ..predictor import _node_count, expected_value
    from ..models.tree import kCategoricalMask, kDefaultLeftMask
    nfeat, nthr, nflags, ncat_off, ncat_len, cats = [], [], [], [], [], []
    pbegin, pvalue, pcls = [0], [], []
    efeat, ezero, ecbegin, cnode, cleft = [], [], [0], [], []
    expected = np.zeros(k, np.float64)
    for t, tree in enumerate(models):
        cls = t % k
        expected[cls] += expected_value(tree)
        if tree.num_leaves <= 1:
            continue
        base = len(nfeat)
        m = tree.num_leaves - 1
        for j in range(m):
            dt = int(tree.decision_type[j])
            nfeat.append(int(tree.split_feature[j]))
            nthr.append(float(tree.threshold[j]))
            nflags.append((dt & kCategoricalMask)
                          | (dt & kDefaultLeftMask)
                          | (int(tree.missing_code[j]) << 2))
            words = []
            if dt & kCategoricalMask:
                cv = np.asarray(tree.cat_threshold[j], np.int64)
                cv = cv[cv >= 0]
                words = np.zeros(int(cv.max(initial=-1)) // 32 + 1,
                                 np.uint32)
                np.bitwise_or.at(words, cv // 32,
                                 np.left_shift(1, cv % 32).astype(np.uint32))
            ncat_off.append(len(cats))
            ncat_len.append(len(words))
            cats.extend(int(w) for w in words)
        parent = {}
        for j in range(m):
            parent[int(tree.left_child[j])] = (j, 1)
            parent[int(tree.right_child[j])] = (j, 0)
        for leaf in range(tree.num_leaves):
            steps = []
            node = ~leaf
            while node in parent:
                j, went_left = parent[node]
                steps.append((j, node, went_left))
                node = j
            steps.reverse()
            # merge a feature's nodes into one element, in the order of
            # its first node from the root; zero fractions multiply in
            # path order, as the recursion's inc_zero does
            order, zero, conds = [], {}, {}
            for j, child, went_left in steps:
                f = int(tree.split_feature[j])
                frac = _node_count(tree, child) / _node_count(tree, j)
                if f not in zero:
                    order.append(f)
                    zero[f] = frac
                    conds[f] = []
                else:
                    zero[f] = frac * zero[f]
                conds[f].append((base + j, went_left))
            efeat.append(-1)
            ezero.append(1.0)
            ecbegin.append(len(cnode))
            for f in order:
                efeat.append(f)
                ezero.append(zero[f])
                for g, went_left in conds[f]:
                    cnode.append(g)
                    cleft.append(went_left)
                ecbegin.append(len(cnode))
            pbegin.append(len(efeat))
            pvalue.append(float(tree.leaf_value[leaf]))
            pcls.append(cls)
    lens = np.diff(np.asarray(pbegin, np.int64))
    i32 = np.int32
    return dict(
        nfeat=np.asarray(nfeat, i32), nthr=np.asarray(nthr, np.float64),
        nflags=np.asarray(nflags, i32), ncat_off=np.asarray(ncat_off, i32),
        ncat_len=np.asarray(ncat_len, i32),
        cats=np.asarray(cats, np.uint32),
        pbegin=np.asarray(pbegin, i32), pvalue=np.asarray(pvalue),
        pcls=np.asarray(pcls, i32), efeat=np.asarray(efeat, i32),
        ezero=np.asarray(ezero), ecbegin=np.asarray(ecbegin, i32),
        cnode=np.asarray(cnode, i32), cleft=np.asarray(cleft, i32),
        expected=expected, max_len=int(lens.max(initial=0)),
        lens=lens.astype(i32))


def pack_bins(lens: np.ndarray, ids: np.ndarray) -> List[List[int]]:
    """First-fit decreasing: the paths ``ids`` (each at most 32
    elements long) in order of length, longest first (ties by id), each
    into the first bin with room for it, a new bin of 32 lanes when none
    has. Returns the bins' paths in the order placed; the same paths
    always give the same bins."""
    order = sorted((int(p) for p in ids), key=lambda p: (-int(lens[p]), p))
    bins: List[List[int]] = []
    free: List[List[int]] = [[] for _ in range(WARP + 1)]  # heaps of bins
    for p in order:
        need = int(lens[p])
        best, room = None, None
        for c in range(need, WARP + 1):
            if free[c] and (best is None or free[c][0] < best):
                best, room = free[c][0], c
        if best is None:
            best, room = len(bins), WARP
            bins.append([])
        else:
            heapq.heappop(free[room])
        bins[best].append(p)
        if room - need:
            heapq.heappush(free[room - need], best)
    return bins


def element_tests(paths: Dict[str, np.ndarray]):
    """Each element's one-fraction test: (general, missing code, one when
    missing, lo, hi). A numerical element whose nodes share one missing
    code is the interval lo < v <= hi (the thresholds of the nodes the
    path leaves to the right and to the left) and, for a missing value,
    the AND of its nodes' default directions against the path's; an
    element with a categorical node, or mixed missing codes, is general
    (its node list is walked on the card)."""
    e_n = len(paths["efeat"])
    elem = np.repeat(np.arange(e_n), np.diff(paths["ecbegin"]))
    node = paths["cnode"]
    left = paths["cleft"] != 0
    flags = paths["nflags"][node]
    thr = paths["nthr"][node]
    code = (flags >> 2) & 3
    general = np.zeros(e_n, bool)
    np.logical_or.at(general, elem, (flags & 1) != 0)
    lo_code = np.full(e_n, 4, np.int32)
    miss = np.zeros(e_n, np.int32)
    np.minimum.at(lo_code, elem, code)
    np.maximum.at(miss, elem, code)
    general |= (lo_code != miss) & (lo_code < 4)
    one_missing = np.ones(e_n, bool)
    np.logical_and.at(one_missing, elem, ((flags & 2) != 0) == left)
    lo = np.full(e_n, -np.inf)
    hi = np.full(e_n, np.inf)
    np.minimum.at(hi, elem[left], thr[left])
    np.maximum.at(lo, elem[~left], thr[~left])
    return general, miss, one_missing, lo, hi


def shap_tables() -> np.ndarray:
    """The ratios the recursion divides by, float64, each rounded once:
    ext [33, 33, 2] = ((d - i) / (d + 1), i / (d + 1)) for the extend of
    element d (weight i), then unw [33, 33, 4] = ((D + 1) / (j + 1),
    (D - j) / (D + 1), (D + 1) / (D - j), 0) for step j of the unwound
    sum of a path of D + 1 elements (0 where undefined)."""
    t = TABLE_SIDE
    d = np.arange(t, dtype=np.float64)[:, None]
    i = np.arange(t, dtype=np.float64)[None, :]
    ext = np.stack(np.broadcast_arrays((d - i) / (d + 1), i / (d + 1)), -1)
    with np.errstate(divide="ignore"):
        u3 = np.where(d > i, (d + 1) / np.maximum(d - i, 1), 0.0)
    unw = np.stack(np.broadcast_arrays((d + 1) / (i + 1), (d - i) / (d + 1),
                                       u3, np.zeros((t, t))), -1)
    return np.concatenate([ext.reshape(-1), unw.reshape(-1)])


def rows_per_warp(stride: int) -> int:
    """Rows a warp of the bin kernel owns for a ``stride`` = k (F + 1)
    wide phi row: as many as keep a block's phi within ``PHI_BYTES`` (so
    that many warps fit an SM), 1 to 16."""
    return max(1, min(ROWS_PER_WARP,
                      PHI_BYTES // (WARPS_PER_BLOCK * stride * 8)))


def bin_lanes(paths: Dict[str, np.ndarray], bins: List[List[int]]):
    """The bins' lane data for ``csrc/tree_shap.cu`` (see its note):
    ``lint`` int32 [bins, 32, 8], ``ldbl`` float64 [bins, 32, 4],
    ``blen`` int32 [bins] (the longest path of each)."""
    nb = len(bins)
    lint = np.zeros((nb, WARP, 8), np.int32)
    lint[:, :, 1] = -1
    ldbl = np.zeros((nb, WARP, 4))
    ldbl[:, :, 0] = 1.0
    blen = np.zeros(nb, np.int32)
    if nb == 0:
        return lint, ldbl, blen
    general, miss, one_missing, lo, hi = element_tests(paths)
    pbegin = paths["pbegin"].astype(np.int64)
    # the placed paths in bin order, each path's first lane in its bin
    path = np.concatenate([np.asarray(b, np.int64) for b in bins])
    pbin = np.repeat(np.arange(nb), [len(b) for b in bins])
    plen = pbegin[path + 1] - pbegin[path]
    ends = np.cumsum(plen)
    first = np.r_[0, np.flatnonzero(np.diff(pbin)) + 1]
    start = ends - plen - np.repeat(ends[first] - plen[first],
                                    np.diff(np.r_[first, len(path)]))
    np.maximum.at(blen, pbin, plen)
    # every element of the placed paths: its bin, lane and place
    r = np.arange(int(plen.sum())) - np.repeat(ends - plen, plen)
    e = np.repeat(pbegin[path], plen) + r
    b = np.repeat(pbin, plen)
    lane = np.repeat(start, plen) + r
    cls = np.repeat(paths["pcls"][path], plen)
    feat = paths["efeat"][e]
    flags = miss[e] | FLAG_ONE_MISSING * one_missing[e] \
        | FLAG_GENERAL * general[e]
    # the lanes of a bin that add to one (class, feature) slot: the lowest
    # leads, its peers' bits beside it
    key = np.flatnonzero(r >= 1)
    key = key[np.lexsort((lane[key], feat[key], cls[key], b[key]))]
    same = (b[key][1:] == b[key][:-1]) & (cls[key][1:] == cls[key][:-1]) \
        & (feat[key][1:] == feat[key][:-1])
    head = np.r_[0, np.flatnonzero(~same) + 1]
    bits = np.left_shift(np.uint64(1), lane[key].astype(np.uint64))
    peers = np.bitwise_or.reduceat(bits, head) ^ bits[head]
    leader = np.zeros(len(e), bool)
    leader[key[head]] = True
    peer = np.zeros(len(e), np.uint64)
    peer[key[head]] = peers
    lint[b, lane] = np.stack([
        r | (lane - r) << 8 | np.repeat(plen, plen) << 16, feat,
        flags | FLAG_LEADER * leader, e, cls,
        peer.astype(np.uint32).view(np.int32), np.zeros_like(e),
        np.zeros_like(e)], 1)
    ldbl[b, lane] = np.stack([paths["ezero"][e], lo[e], hi[e],
                              np.repeat(paths["pvalue"][path], plen)], 1)
    return lint, ldbl, blen


def shap_work(paths: Dict[str, np.ndarray], n: int, f: int, k: int):
    """(bytes, float64 operations) that TreeSHAP needs for ``n`` rows of
    ``f`` features: the rows read and the contributions written once;
    per row and path of D + 1 elements, the D extends (7 operations an
    element updated) and each element's unwound sum (8 a step), a
    decision per condition and 3 more per element."""
    d = paths["lens"].astype(np.float64) - 1.0
    per_row = (7.0 * (d * (d + 3.0) / 2.0) + 8.0 * d * d + 3.0 * d).sum() \
        + len(paths["cnode"])
    return n * f * 8 + n * k * (f + 1) * 8, n * per_row


class ShapModel:
    """A model's paths on one device, uploaded once."""

    def __init__(self, models: List, k: int, device):
        self.k = k
        self.paths = shap_paths(models, k)
        p = self.paths
        self.max_feature = int(p["nfeat"].max(initial=-1))
        lens = p["lens"]
        short = np.nonzero(lens <= WARP)[0].astype(np.int32)
        long_ = np.nonzero(lens > WARP)[0].astype(np.int32)
        if len(long_) and int(lens.max()) > LONG_THREADS_MAX:
            raise ValueError(
                f"a path of {int(lens.max())} elements is longer than "
                f"the long-path kernel's {LONG_THREADS_MAX} threads")
        self.num_long = len(long_)
        self.bins = pack_bins(lens, short)
        self.lint, self.ldbl, self.blen = bin_lanes(p, self.bins)
        self.long_threads = max(WARP, -(-int(lens.max(initial=0))
                                        // WARP) * WARP)

        def up(a):
            a = np.ascontiguousarray(a)
            if a.size == 0:
                a = np.zeros(1, a.dtype)
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            return torch.from_numpy(a).to(device)
        self.dev = {name: up(p[name]) for name in (
            "nfeat", "nthr", "nflags", "ncat_off", "ncat_len", "cats",
            "pbegin", "pvalue", "pcls", "efeat", "ezero", "ecbegin",
            "cnode", "cleft", "expected")}
        for name in ("lint", "ldbl", "blen"):
            self.dev[name] = up(getattr(self, name))
        self.dev["tabs"] = up(shap_tables())
        self.dev["long"] = up(long_)


def tree_shap_cuda(model: ShapModel, x: torch.Tensor,
                   times: torch.Tensor = None) -> torch.Tensor:
    """The kernel: float64 [N, k * (F + 1)] for the float64 CUDA rows
    ``x`` [N, F]. ``times`` (for ``chip_profile.py``; not counted in
    ``LAUNCHES``): int64 [shap_warps(N, k (F + 1)), 7] on the card,
    filled by the bin kernel's timed instantiation."""
    _native.require(x, device=x.device, dtype=torch.float64, name="x")
    if x.dim() != 2:
        raise ValueError(f"x must be [N, F], got {tuple(x.shape)}")
    n, f = x.shape
    if model.max_feature >= f:
        raise ValueError(f"the model splits on feature {model.max_feature}"
                         f" but the data has {f} columns")
    k = model.k
    out = torch.empty((n, k * (f + 1)), dtype=torch.float64,
                      device=x.device)
    if n == 0:
        return out
    stride = k * (f + 1)
    rows = rows_per_warp(stride)
    smem = WARPS_PER_BLOCK * rows * stride * 8
    use_smem = 1 if smem <= SHARED_BYTES else 0
    sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    long_blocks = max(1, min(n, sm * 8)) if model.num_long else 0
    d = model.dev
    if times is not None:
        _native.require(times, device=x.device, dtype=torch.int64,
                        shape=(shap_warps(n, stride), 7), name="times")
    err = _native.library().ltt_tree_shap(
        x.data_ptr(), n, f,
        d["nfeat"].data_ptr(), d["nthr"].data_ptr(), d["nflags"].data_ptr(),
        d["ncat_off"].data_ptr(), d["ncat_len"].data_ptr(),
        d["cats"].data_ptr(), d["pbegin"].data_ptr(),
        d["pvalue"].data_ptr(), d["pcls"].data_ptr(), d["efeat"].data_ptr(),
        d["ezero"].data_ptr(), d["ecbegin"].data_ptr(),
        d["cnode"].data_ptr(), d["cleft"].data_ptr(),
        d["expected"].data_ptr(), k, d["lint"].data_ptr(),
        d["ldbl"].data_ptr(), d["blen"].data_ptr(), len(model.bins),
        d["tabs"].data_ptr(), rows, d["long"].data_ptr(), model.num_long,
        model.long_threads,
        out.data_ptr(), use_smem, smem if use_smem else 0, long_blocks,
        None if times is None else times.data_ptr(), _native.stream_of(x))
    _native.check(err, "tree_shap")
    if times is None:
        _native.LAUNCHES["tree_shap"] += 1
    return out


def shap_warps(n: int, stride: int) -> int:
    """The bin kernel's warps for ``n`` rows of phi rows ``stride`` wide
    (a warp a tile of ``rows_per_warp`` rows, whole blocks of 4): the rows
    of its timed build's ``times``."""
    tiles = -(-int(n) // rows_per_warp(stride))
    return -(-tiles // WARPS_PER_BLOCK) * WARPS_PER_BLOCK


def tree_shap(models: List, x: torch.Tensor, k: int) -> torch.Tensor:
    """SHAP contributions, float64 [N, k * (F + 1)]: the kernel for a
    CUDA ``x``, the plain version for a CPU one."""
    if x.device.type == "cpu":
        from ..predictor import tree_shap_plain
        return tree_shap_plain(models, x, k)
    return tree_shap_cuda(ShapModel(models, k, x.device), x)
