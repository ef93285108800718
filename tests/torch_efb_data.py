"""Shared inputs and checks of the port's EFB, multi-val, sparse and
two-round tests (``tests/test_torch_bundling.py``,
``test_torch_multival.py``, ``test_torch_sparse.py``,
``test_torch_two_round.py``): the JAX tests' data shapes, made from a
seed with numpy, and the tree comparison up to a logged tie.

Tree structure is exact up to a threshold tie (ROADMAP.md Queue 3): the
port sums histograms in float64 and rounds once, the JAX serial learner
sums in float32, so two thresholds whose gains agree within 1e-5
relative may be picked apart; the trees after such a tie grow from
other scores and are not compared. Leaf values are held within 1e-5
(rtol and atol).
"""

import numpy as np


def sparse_problem(n=4000, f=60, informative=4, block=12, seed=0):
    """JAX ``tests/test_bundling.py:_sparse_problem``: a few dense
    informative columns and one-hot-style blocks (each row activates at
    most one feature of a block, values 1-3)."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, f))
    for j in range(informative):
        X[:, j] = rng.randn(n)
    j = informative
    while j < f:
        width = min(block, f - j)
        which = rng.randint(0, width + 1, n)
        rows = np.nonzero(which < width)[0]
        X[rows, j + which[rows]] = rng.randint(1, 4, len(rows))
        j += width
    logit = (2 * X[:, 0] - 1.5 * X[:, 1]
             + 3.0 * (X[:, informative] > 0)
             + 2.0 * (X[:, informative + 1] > 0))
    y = (logit + rng.randn(n) * 0.3 > 0.5).astype(np.float32)
    return X, y


def bosch_like(n=2500, f=150, density=0.04, seed=3):
    """JAX ``tests/test_multival.py:_bosch_like``: >= 95% sparse,
    conflicting nonzeros, so no exclusive bundles and the planner goes
    multi-val."""
    rng = np.random.RandomState(seed)
    X = np.where(rng.rand(n, f) < density,
                 rng.randint(1, 9, size=(n, f)) * 0.5, 0.0)
    logit = (3.0 * X[:, 0] - 2.0 * X[:, 1] + X[:, 2] - X[:, 3]
             + 0.5 * X[:, 4])
    y = (logit + 0.3 * rng.randn(n) > 0.2).astype(np.float32)
    return X, y


def node(t, s):
    cat = bool(t.decision_type[s] & 1)
    return (int(t.split_feature_inner[s]),
            -1 if cat else int(t.threshold_bin[s]),
            int(t.decision_type[s]), int(t.left_child[s]),
            int(t.right_child[s]))


def same_tree(a, b):
    return a.num_leaves == b.num_leaves and all(
        node(a, s) == node(b, s) for s in range(a.num_leaves - 1))


def compare_trees(port_models, jax_models, leaf_tol=1e-5):
    """Tree by tree: equal structure and leaf values within ``leaf_tol``
    up to the first threshold tie (same feature, gains within 1e-5
    relative), which must be one. Returns (index of the first tree not
    compared or None, the number of trees compared)."""
    assert len(port_models) == len(jax_models)
    for i, (a, b) in enumerate(zip(port_models, jax_models)):
        if same_tree(a, b):
            np.testing.assert_allclose(a.leaf_value, b.leaf_value,
                                       rtol=leaf_tol, atol=leaf_tol)
            continue
        s = next(s for s in range(min(a.num_leaves, b.num_leaves) - 1)
                 if node(a, s) != node(b, s))
        ga, gb = float(a.split_gain[s]), float(b.split_gain[s])
        assert int(a.split_feature_inner[s]) == int(
            b.split_feature_inner[s]), (i, s)
        assert abs(ga - gb) <= 1e-5 * abs(gb), (i, s, ga, gb)
        return i, i
    return None, len(port_models)


def auc(y, s):
    order = np.argsort(s, kind="stable")
    r = np.empty(len(s))
    r[order] = np.arange(1, len(s) + 1)
    pos = y > 0.5
    return (r[pos].sum() - pos.sum() * (pos.sum() + 1) / 2) / (
        pos.sum() * (~pos).sum())
