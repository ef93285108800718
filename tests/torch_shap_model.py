"""Models for the TreeSHAP tests, with no JAX: a numpy model of the
kernel's arithmetic over the host's paths (``csrc/tree_shap.cu``,
``ops/tree_shap_cuda.py:shap_paths``) and deep chain trees built by
hand (a feature repeated on every node; more distinct features than a
warp has lanes)."""

import numpy as np
import torch

from lightgbm_tpu_torch.models.tree import Tree, TreeArrays
from lightgbm_tpu_torch.ops.tree_shap_cuda import shap_paths


def kernel_model(models, x, k):
    """The kernel's arithmetic in numpy: per row and path, the elements'
    one fractions, the extend of every element in path order and each
    element's unwound sum (csrc/tree_shap.cu)."""
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
