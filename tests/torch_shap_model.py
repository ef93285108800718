"""Models for the TreeSHAP tests, with no JAX: a numpy model of the
kernel's arithmetic over the host's paths (``csrc/tree_shap.cu``,
``ops/tree_shap_cuda.py:shap_paths``), one of the bin kernel's lanes
over the packed bins (``pack_bins``, ``bin_lanes``), and deep chain
trees built by hand (a feature repeated on every node; more distinct
features than a warp has lanes)."""

import numpy as np
import torch

from lightgbm_tpu_torch.models.tree import Tree, TreeArrays
from lightgbm_tpu_torch.ops.tree_shap_cuda import (FLAG_GENERAL,
                                                   FLAG_LEADER,
                                                   FLAG_ONE_MISSING,
                                                   TABLE_SIDE, bin_lanes,
                                                   pack_bins, shap_paths,
                                                   shap_tables)


def kernel_model(models, x, k, min_len=0):
    """The kernel's arithmetic in numpy: per row and path, the elements'
    one fractions, the extend of every element in path order and each
    element's unwound sum (csrc/tree_shap.cu); with ``min_len``, the
    paths of at least that many elements alone."""
    from lightgbm_tpu_torch.predictor import node_go_left
    p = shap_paths(models, k)
    n, f = x.shape
    out = np.zeros((n, k * (f + 1)))
    trees = [(t, j) for t in models if t.num_leaves > 1
             for j in range(t.num_leaves - 1)]
    xt = torch.from_numpy(x)
    left = np.stack([node_go_left(t, j, xt[:, int(t.split_feature[j])])
                     .numpy() for t, j in trees], axis=1) if trees \
        else np.zeros((n, 0), bool)
    for c in range(k):
        out[:, c * (f + 1) + f] = p["expected"][c]
    for q in range(len(p["pvalue"])):
        b, e1 = p["pbegin"][q], p["pbegin"][q + 1]
        if e1 - b < min_len:
            continue
        zero = p["ezero"][b:e1]
        one = np.ones((n, e1 - b))
        for i, e in enumerate(range(b, e1)):
            for cc in range(p["ecbegin"][e], p["ecbegin"][e + 1]):
                ok = left[:, p["cnode"][cc]] == (p["cleft"][cc] != 0)
                one[:, i] = np.where(ok, one[:, i], 0.0)
        length = e1 - b
        pw = np.zeros((n, length))
        pw[:, 0] = 1.0
        for d in range(1, length):
            old = pw.copy()
            for i in range(d + 1):
                a = zero[d] * old[:, i] * (d - i) / (d + 1) if i < d else 0
                bb = one[:, d] * old[:, i - 1] * i / (d + 1) if i else 0
                pw[:, i] = a + bb
        dd = length - 1
        for i in range(1, length):
            nxt = pw[:, dd].copy()
            tot = np.zeros(n)
            for j in range(dd - 1, -1, -1):
                nz = one[:, i] != 0
                safe = np.where(nz, one[:, i], 1.0)
                tmp = nxt * (dd + 1) / ((j + 1) * safe)
                with np.errstate(divide="ignore", invalid="ignore"):
                    alt = (pw[:, j] / zero[i]) / ((dd - j) / (dd + 1))
                tot += np.where(nz, tmp, alt)
                nxt = np.where(nz, pw[:, j] - tmp * zero[i] * (dd - j)
                               / (dd + 1), nxt)
            col = p["pcls"][q] * (f + 1) + p["efeat"][b + i]
            out[:, col] += tot * (one[:, i] - zero[i]) * p["pvalue"][q]
    return out


def _node_left(models, x):
    """[n, nodes] the row's decision at every node of the model, in
    ``shap_paths``' node numbering (predictor.py decides)."""
    from lightgbm_tpu_torch.predictor import node_go_left
    xt = torch.from_numpy(x)
    cols = [node_go_left(t, j, xt[:, int(t.split_feature[j])]).numpy()
            for t in models if t.num_leaves > 1
            for j in range(t.num_leaves - 1)]
    return np.stack(cols, axis=1) if cols else np.zeros((len(x), 0), bool)


def bins_model(models, x, k):
    """The bin kernel's arithmetic (csrc/tree_shap.cu tree_shap_bins) in
    numpy, every row at once: the short paths packed into 32-lane bins,
    each lane's one fraction from its interval (or its node list), the
    extend and unwound loops to the bin's longest path with the ratio
    tables (``shap_tables``) in place of divisions and lane gathers for
    the shuffles and shared copies, each slot's lanes summed in lane
    order by the lowest and added once, bins in order. Paths longer
    than a warp take ``kernel_model``'s loop, added after, as the
    long-path kernel adds after the bin kernel."""
    p = shap_paths(models, k)
    n, f = x.shape
    lens = p["lens"]
    short = np.nonzero(lens <= 32)[0]
    bins = pack_bins(lens, short)
    lint, ldbl, blen = bin_lanes(p, bins)
    left = _node_left(models, x)
    t = TABLE_SIDE
    tabs = shap_tables()
    ext = tabs[:2 * t * t].reshape(t, t, 2)
    unw = tabs[2 * t * t:].reshape(t, t, 4)
    out = np.zeros((n, k * (f + 1)))
    lanes = np.arange(32)
    for b in range(len(bins)):
        meta = lint[b, :, 0]
        r, s, ln = meta & 255, (meta >> 8) & 255, (meta >> 16) & 255
        feat, flags, elem, cls = (lint[b, :, i] for i in range(1, 5))
        peers = lint[b, :, 5].view(np.uint32)
        zero, lo, hi, val = (ldbl[b, :, i] for i in range(4))
        maxlen = int(blen[b])
        one = np.ones((n, 32))
        for q in np.nonzero(feat >= 0)[0]:
            if flags[q] & FLAG_GENERAL:
                e = elem[q]
                ok = np.ones(n, bool)
                for cc in range(p["ecbegin"][e], p["ecbegin"][e + 1]):
                    ok &= left[:, p["cnode"][cc]] == (p["cleft"][cc] != 0)
                one[:, q] = ok
                continue
            v = x[:, feat[q]].copy()
            miss = flags[q] & 3
            nan = np.isnan(v)
            if miss != 2:
                v[nan] = 0.0
            missing = np.abs(v) <= 1e-35 if miss == 1 else (
                nan if miss == 2 else np.zeros(n, bool))
            with np.errstate(invalid="ignore"):
                inside = (v > lo[q]) & (v <= hi[q])
            one[:, q] = np.where(missing,
                                 float(bool(flags[q] & FLAG_ONE_MISSING)),
                                 inside)
        ones = (ln > 0) & (one != 0)
        pw = np.where(r == 0, 1.0, 0.0)[None, :].repeat(n, 0)
        for d in range(1, maxlen):
            src = np.minimum(s + d, 31)
            zd = zero[src]
            leftw = np.concatenate([pw[:, :1], pw[:, :-1]], axis=1)
            act = (d < ln) & (r <= d)
            q = ext[d, np.minimum(r, t - 1)]
            a = np.where(r < d, zd * pw * q[:, 0], 0.0)
            bb = np.where((r >= 1) & ones[:, src], leftw * q[:, 1], 0.0)
            pw = np.where(act, a + bb, pw)
        dd = ln - 1
        u = unw[np.maximum(dd, 0)]
        with np.errstate(divide="ignore"):
            invz = 1.0 / zero
        nxt = pw[:, np.minimum(s + np.maximum(dd, 0), 31)]
        tot = np.zeros((n, 32))
        for j in range(maxlen - 2, -1, -1):
            pwj = pw[:, np.minimum(s + j, 31)]
            act = j < dd
            tmp = nxt * u[:, j, 0]
            with np.errstate(invalid="ignore"):
                alt = pwj * invz * u[:, j, 2]
            on = one != 0
            tot = np.where(act, tot + np.where(on, tmp, alt), tot)
            nxt = np.where(act & on, pwj - tmp * zero * u[:, j, 1], nxt)
        v = np.where((ln > 0) & (r >= 1), tot * (one - zero) * val, 0.0)
        for q in np.nonzero(flags & FLAG_LEADER)[0]:
            acc = v[:, q].copy()
            for src in lanes[(peers[q] >> lanes) & 1 == 1]:
                acc += v[:, src]
            out[:, cls[q] * (f + 1) + feat[q]] += acc
    for c in range(k):
        out[:, c * (f + 1) + f] = p["expected"][c]
    if (lens > 32).any():
        extra = kernel_model(models, x, k, min_len=33)
        for c in range(k):
            extra[:, c * (f + 1) + f] = 0.0
        out += extra
    return out


def chain_tree(features, thresholds, seed=0, nan_default_left=True):
    """A chain: node j splits ``features[j]`` at ``thresholds[j]``, its
    left child a leaf and its right child node j + 1 (the last node's
    both children leaves). Leaf counts are random, internal counts their
    sums; NaN goes left where ``nan_default_left``."""
    m = len(features)
    rng = np.random.RandomState(seed)
    lc = np.asarray([~j for j in range(m)], np.int32)
    rc = np.asarray([j + 1 for j in range(m - 1)] + [~m], np.int32)
    leaf_count = rng.randint(5, 50, m + 1).astype(np.float64)
    internal = np.zeros(m)
    below = leaf_count[m]
    for j in range(m - 1, -1, -1):
        below = below + leaf_count[j]
        internal[j] = below
    dt = np.full(m, 2 if nan_default_left else 0, np.int32)
    tree = Tree(TreeArrays(
        num_leaves=m + 1, split_feature=np.asarray(features, np.int32),
        threshold_bin=np.zeros(m, np.int32), decision_type=dt,
        left_child=lc, right_child=rc, split_gain=np.zeros(m),
        internal_value=np.zeros(m), internal_weight=np.zeros(m),
        internal_count=internal, leaf_value=rng.randn(m + 1),
        leaf_weight=np.zeros(m + 1), leaf_count=leaf_count,
        leaf_parent=np.zeros(m + 1, np.int32),
        leaf_depth=np.zeros(m + 1, np.int32)))
    tree.threshold = np.asarray(thresholds, np.float64)
    tree.missing_code = np.full(m, 2, np.int32)
    tree.ensure_leaf_depth()
    return tree


def chain_rows(f, n=40, seed=1):
    x = np.random.RandomState(seed).randn(n, f)
    x[::7, 0] = np.nan
    return x
