"""Piecewise-linear leaves: a ridge fit per leaf (port of
``lightgbm_tpu/models/linear.py``; the reference's ``linear_tree``,
src/treelearner/linear_tree_learner.cpp).

After a tree is grown, each leaf gets a linear model over the numerical
features on its root-to-leaf path (deepest split first, at most
``linear_max_features``), fit from the leaf's second-order statistics:

    min_beta  sum_{i in leaf} [ g_i f(x_i) + 1/2 h_i f(x_i)^2 ]
              + 1/2 linear_lambda ||w||^2,     f(x) = w . x + b

whose normal equations are ``(X~^T H X~ + Lam) beta = -X~^T g`` with a
bias column in ``X~``. The sums are taken per leaf on the training
device in float64, in a fixed order (``leaf_sums``): chunk by chunk in
row order, each chunk's products ``[rows, P]`` (the upper triangle of
``X~^T H X~``, then ``X~^T g`` and the row count) reduced by leaf as one
float64 matrix product with the chunk's ``[L, rows]`` leaf one-hot
(cuBLAS's GEMM gives the same bits run after run) and added to the
leaf totals in chunk order; no ``[N, C+1, C+1]`` (or ``[N, P]``)
product materializes, and no atomic add is involved. The JAX package sums in float32 (``segment_sum``), so the
coefficients agree with it within float32 rounding of the sums, not to
the bit. The ``[L, C+1, C+1]`` systems solve as one batched float64
``torch.linalg.solve`` (the JAX package's ``jnp.linalg.solve``, outside
any kernel), and the solution is kept as float32.

Gating, as in the JAX package: a leaf keeps its constant output when its
path has no numerical feature, when its in-bag rows without a
non-finite model feature number no more than its features, or when the
solve is not finite or a coefficient reaches 1e8. ``linear_lambda``
regularizes each coefficient and ``lambda_l2`` (+1e-15) the bias.

Prediction (``linear_values``) evaluates ``const + w . x`` over the
leaf's raw features as an explicit left-to-right float32 add chain, the
JAX host route's order, so the port predicts its bits; a row with a NaN
in any of its leaf's features takes the constant leaf value.
"""

from __future__ import annotations

import numpy as np
import torch

kLinEps = 1e-15
kCoeffBound = 1e8
# one-hot cells of a chunk of the per-leaf sums ([L, rows] float64)
SUM_CHUNK_CELLS = 1 << 24


def node_parents(left_child: np.ndarray,
                 right_child: np.ndarray) -> np.ndarray:
    """Parent internal node of each internal node (-1 for the root)."""
    parent = np.full(len(left_child), -1, np.int32)
    for s in range(len(left_child)):
        for child in (int(left_child[s]), int(right_child[s])):
            if child >= 0:
                parent[child] = s
    return parent


def leaf_path_features(tree, is_numeric: np.ndarray, big_l: int,
                       cap: int) -> np.ndarray:
    """Per leaf, the distinct numerical inner features on its path to
    the root, deepest split first, at most ``cap``, -1 padded:
    int32 [big_l, cap] (rows past the tree's leaves all -1)."""
    cap = max(int(cap), 1)
    feats = np.full((big_l, cap), -1, np.int32)
    if tree.num_leaves <= 1:
        return feats
    tree.ensure_leaf_depth()
    parent = node_parents(tree.left_child, tree.right_child)
    split_feat = tree.split_feature_inner
    for leaf in range(tree.num_leaves):
        node = int(tree.leaf_parent[leaf])
        seen = set()
        k = 0
        while node >= 0 and k < cap:
            f = int(split_feat[node])
            if f not in seen and 0 <= f < len(is_numeric) \
                    and bool(is_numeric[f]):
                feats[leaf, k] = f
                seen.add(f)
                k += 1
            node = int(parent[node])
    return feats


def _model_inputs(raw: torch.Tensor, leaf_id: torch.Tensor,
                  feats: torch.Tensor, bad_fn):
    """Each row's leaf-model inputs: x [N, C] float32 with masked-out
    slots 0, and the rows whose model features are all fine."""
    ft = feats[leaf_id]                                   # [N, C]
    m = ft >= 0
    x = torch.gather(raw, 1, ft.clamp(min=0).long()) if raw.shape[1] \
        else torch.zeros(ft.shape, dtype=torch.float32, device=raw.device)
    bad = bad_fn(x) & m
    xz = torch.where(m & ~bad, x, torch.zeros_like(x))
    return xz, ~bad.any(dim=1)


def leaf_sums(rows_of, leaf: torch.Tensor, big_l: int, width: int):
    """Per-leaf float64 sums over ``leaf`` [N] of the rows that
    ``rows_of(lo, hi)`` makes ([hi - lo, width] float64 for rows
    ``lo:hi``): [big_l, width], in a fixed order (see the module note).
    Chunk by chunk in row order, each chunk's sums are one float64
    product of its [big_l, rows] leaf one-hot and its rows."""
    out = torch.zeros((big_l, width), dtype=torch.float64,
                      device=leaf.device)
    leaves = torch.arange(big_l, device=leaf.device)[:, None]
    step = max(SUM_CHUNK_CELLS // big_l, 1)
    for lo in range(0, leaf.shape[0], step):
        hi = min(lo + step, leaf.shape[0])
        onehot = (leaf[None, lo:hi] == leaves).to(torch.float64)
        out += onehot @ rows_of(lo, hi)
    return out


def fit_linear(raw: torch.Tensor, leaf_id: torch.Tensor, grad, hess, bag,
               feats: np.ndarray, leaf_value: np.ndarray, *,
               lam: float, l2: float):
    """Every leaf's ridge solve (JAX ``_fit_linear_jit``): ``raw``
    float32 [N, F] (NaN kept), ``leaf_id`` [N], ``grad``/``hess`` [N]
    float32, ``bag`` [N] float32 or None (every row in the bag),
    ``feats`` [L, C] -1-padded, ``leaf_value`` [L] the constant
    fallback. Returns host (coeff float32 [L, C], const float32 [L],
    ok bool [L])."""
    lv = torch.as_tensor(np.asarray(leaf_value, np.float32),
                         device=raw.device)
    return tuple(t.cpu().numpy() for t in fit_linear_device(
        raw, leaf_id, grad, hess, bag, feats, lv, lam=lam, l2=l2))


def fit_linear_device(raw: torch.Tensor, leaf_id: torch.Tensor, grad, hess,
                      bag, feats: np.ndarray, lv: torch.Tensor, *,
                      lam: float, l2: float):
    """``fit_linear`` with the constant fallback ``lv`` (float32 [L]) and
    the results (coeff, const, ok) left on the device: refit reads them
    once, after its last tree."""
    dev = raw.device
    big_l, c = feats.shape
    ft = torch.as_tensor(feats, device=dev)
    lid = leaf_id.long()
    xz, row_ok = _model_inputs(raw, lid, ft, lambda x: ~torch.isfinite(x))
    if bag is None:
        bag = torch.ones_like(grad)
    w = hess * bag * row_ok
    gw = grad * bag * row_ok
    iu, ju = torch.triu_indices(c + 1, c + 1, device=dev)
    npair = iu.shape[0]
    counted = row_ok & (bag > 0)

    def rows_of(lo, hi):
        """Rows lo:hi's products: the upper triangle of x~ x~^T h, x~ g
        and the row count, float64."""
        xb = torch.cat([xz[lo:hi].double(),
                        torch.ones((hi - lo, 1), dtype=torch.float64,
                                   device=dev)], dim=1)
        return torch.cat([xb[:, iu] * xb[:, ju] * w[lo:hi].double()[:, None],
                          xb * gw[lo:hi].double()[:, None],
                          counted[lo:hi].double()[:, None]], dim=1)
    sums = leaf_sums(rows_of, lid, big_l, npair + c + 2)
    a_mat = torch.zeros((big_l, c + 1, c + 1), dtype=torch.float64,
                        device=dev)
    a_mat[:, iu, ju] = sums[:, :npair]
    a_mat[:, ju, iu] = sums[:, :npair]
    b_vec = sums[:, npair:npair + c + 1]
    cnt = sums[:, -1]
    active = ft >= 0
    diag = torch.cat([
        torch.where(active, torch.tensor(float(lam), dtype=torch.float64,
                                         device=dev),
                    torch.tensor(1.0, dtype=torch.float64, device=dev)),
        torch.full((big_l, 1), float(l2) + kLinEps, dtype=torch.float64,
                   device=dev)], dim=1)
    a_mat = a_mat + torch.diag_embed(diag)
    # a singular system (a feature constant over its leaf with
    # linear_lambda 0) is no error: its leaf keeps its constant, as the
    # JAX solve's non-finite result does there
    sol, info = torch.linalg.solve_ex(a_mat, b_vec[..., None])
    sol = -sol[..., 0]
    ca = active.sum(dim=1).double()
    ok = ((info == 0) & torch.isfinite(sol).all(dim=1)
          & (sol.abs() < kCoeffBound).all(dim=1) & (cnt > ca) & (ca > 0))
    sol = sol.float()
    coeff = torch.where(ok[:, None], sol[:, :c], torch.zeros_like(sol[:, :c]))
    const = torch.where(ok, sol[:, c], lv)
    return coeff, const, ok


def fit_linear_leaves(tree, dataset, config, leaf_id, grad, hess,
                      bag=None) -> bool:
    """Fit every leaf of ``tree`` on its rows (``leaf_id``, on the
    training device) and attach the models (JAX
    ``LinearLeafFitMixin.fit_linear_leaves``); True when a leaf got one."""
    if dataset.raw_numeric is None or dataset.num_features == 0 \
            or tree.num_leaves <= 1:
        return False
    from ..data.binning import BIN_TYPE_CATEGORICAL
    numeric = np.asarray(
        [dataset.feature_mapper(i).bin_type != BIN_TYPE_CATEGORICAL
         for i in range(dataset.num_features)], bool)
    big_l = int(config.num_leaves)
    cap = min(int(config.linear_max_features), dataset.num_features)
    feats = leaf_path_features(tree, numeric, big_l, cap)
    if not (feats >= 0).any():
        return False
    lv = np.zeros(big_l, np.float32)
    lv[:tree.num_leaves] = np.asarray(tree.leaf_value, np.float32)
    coeff, const, ok = fit_linear(
        dataset.raw_numeric_device(leaf_id.device), leaf_id,
        grad.float(), hess.float(), None if bag is None else bag.float(),
        feats, lv, lam=float(config.linear_lambda),
        l2=float(config.lambda_l2))
    if not ok.any():
        return False
    nl = tree.num_leaves
    tree.set_linear(feats[:nl], coeff[:nl], const[:nl], dataset=dataset)
    return True


def linear_values(leaf: torch.Tensor, raw: torch.Tensor, leaf_value,
                  const, coeff, feats) -> torch.Tensor:
    """Per row, its leaf's ``const + w . x`` over the raw features
    ``raw`` (float32 [N, F'] or float64: cast to float32), as an
    explicit left-to-right float32 add chain (JAX
    ``linear_leaf_values``), or the constant ``leaf_value`` when one of
    the leaf's features is NaN. ``leaf`` [N]; the leaf-indexed arrays
    ``const`` [L], ``coeff`` [L, C] float32, ``feats`` [L, C] int (-1
    padded) and ``leaf_value`` [L] are tensors on ``raw``'s device.
    Returns [N] of ``leaf_value``'s type: float32 for the train and
    valid scores (the JAX device route), float64 for prediction (the
    JAX host route widens the chain and takes the float64 constant)."""
    lid = leaf.long()
    xz, ok = _model_inputs(raw.float(), lid, feats, torch.isnan)
    co = coeff[lid]
    lin = const[lid]
    for j in range(xz.shape[1]):
        lin = lin + co[:, j] * xz[:, j]
    return torch.where(ok, lin.to(leaf_value.dtype), leaf_value[lid])


def tree_linear_args(tree, device, inner: bool):
    """A linear tree's leaf-indexed leaf values (float32 with ``inner``,
    float64 otherwise), float32 const and coeff, and its feature indices
    (inner features with ``inner``, the raw columns otherwise) as
    tensors on ``device``."""
    as_t = lambda a, dt: torch.as_tensor(np.asarray(a, dt),  # noqa: E731
                                         device=device)
    feats = tree.leaf_features_inner if inner else tree.leaf_features
    return (as_t(tree.leaf_value, np.float32 if inner else np.float64),
            as_t(tree.leaf_const, np.float32),
            as_t(tree.leaf_coeff, np.float32), as_t(feats, np.int64))


def linear_leaf_values(tree, leaf: torch.Tensor, raw: torch.Tensor,
                       inner: bool = True) -> torch.Tensor:
    """``linear_values`` of one tree for rows in leaves ``leaf``: over a
    dataset's inner features (the scores, float32) or, with ``inner``
    False, over raw rows (prediction, float64)."""
    return linear_values(leaf, raw, *tree_linear_args(tree, raw.device,
                                                      inner))
