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
then at most F + 1 elements (the bias element first). ``tree_shap``
launches the kernel for a CUDA tensor: one warp a row, several paths
at a time, each to a group of lanes as wide as the longest path
(rounded up to a power of two), its elements one a lane, extend and
unwound sums by shuffles in float64, the row's contributions summed in
shared memory and written once with each class's expected value; a
path of more than 32 elements
(F >= 32) goes to a second kernel that gives a path to a block, its
weights in shared memory. For a CPU tensor it runs the plain version,
``predictor.tree_shap_plain``. The wrapper counts its launches in
``_native.LAUNCHES["tree_shap"]`` (one a call that launches).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import _native

WARP = 32
WARPS_PER_BLOCK = 4          # csrc/tree_shap.cu kWarps
SHARED_BYTES = 48 * 1024     # a block's phi rows in shared memory at most
LONG_THREADS_MAX = 1024      # the long-path kernel: a thread an element


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
        self.num_short, self.num_long = len(short), len(long_)
        # lanes a short path: its longest, rounded up to a power of two
        short_max = int(lens[short].max(initial=1))
        self.group = 1 << max(short_max - 1, 0).bit_length()
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
        self.dev["short"] = up(short)
        self.dev["long"] = up(long_)


def tree_shap_cuda(model: ShapModel, x: torch.Tensor) -> torch.Tensor:
    """The kernel: float64 [N, k * (F + 1)] for the float64 CUDA rows
    ``x`` [N, F]."""
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
    smem = WARPS_PER_BLOCK * stride * 8
    use_smem = 1 if smem <= SHARED_BYTES else 0
    sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = max(1, min(-(-n // WARPS_PER_BLOCK), sm * 16))
    long_blocks = max(1, min(n, sm * 8)) if model.num_long else 0
    d = model.dev
    lib = _native.library()
    err = lib.ltt_tree_shap(
        x.data_ptr(), n, f,
        d["nfeat"].data_ptr(), d["nthr"].data_ptr(), d["nflags"].data_ptr(),
        d["ncat_off"].data_ptr(), d["ncat_len"].data_ptr(),
        d["cats"].data_ptr(), d["pbegin"].data_ptr(),
        d["pvalue"].data_ptr(), d["pcls"].data_ptr(), d["efeat"].data_ptr(),
        d["ezero"].data_ptr(), d["ecbegin"].data_ptr(),
        d["cnode"].data_ptr(), d["cleft"].data_ptr(),
        d["expected"].data_ptr(), k, d["short"].data_ptr(),
        model.num_short, model.group, d["long"].data_ptr(), model.num_long,
        model.long_threads, out.data_ptr(), blocks, use_smem,
        smem if use_smem else 0, long_blocks, _native.stream_of(x))
    _native.check(err, "tree_shap")
    _native.LAUNCHES["tree_shap"] += 1
    return out


def tree_shap(models: List, x: torch.Tensor, k: int) -> torch.Tensor:
    """SHAP contributions, float64 [N, k * (F + 1)]: the kernel for a
    CUDA ``x``, the plain version for a CPU one."""
    if x.device.type == "cpu":
        from ..predictor import tree_shap_plain
        return tree_shap_plain(models, x, k)
    return tree_shap_cuda(ShapModel(models, k, x.device), x)
