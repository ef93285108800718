"""Per-node randomness of extra_trees and by-node feature sampling (port
of ``lightgbm_tpu/learner/serial.py:327-425``: ``bynode_feature_count``,
``NodeRandMixin``, ``make_node_rand``).

Every learner keeps two ``np.random.RandomState`` streams, seeded by
``extra_seed`` and ``feature_fraction_seed``; each tree draws one int
from each (both, whenever either option is on) and makes a key of it.
A scan's draws are ``jax.random``'s under ``fold_in(key, salt)``: the
salt is 0 at the root and ``2k+1`` / ``2k+2`` for the left / right child
of split ``k`` (``learner/split_step.py:order_child_pair``), so a node
draws the same numbers whichever child is scanned first. The bits come
from ``utils/threefry.py``, here vectorized over every salt of a tree
at once on the host (a [2L + 1, F] draw a tree), so no split waits on a
draw:

  * extra_trees: ``u`` from the first key, the rand bin
    ``floor(u * max(num_bins - 2, 1))`` in float32 (the reference's
    ``NextInt(0, num_bin - 2)``);
  * by-node: ``u`` from the second key, -1 outside the tree's feature
    mask, and the node keeps the features with ``u`` at or above the
    ``bynode_count``-th largest (``jax.lax.top_k``), within the mask.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..utils.threefry import MASK, Key, prng_key, threefry2x32


def bynode_feature_count(num_features: int, feature_fraction: float,
                         ff_bynode: float) -> int:
    """Features sampled a node (GetUsedFeatures,
    serial_tree_learner.cpp:226-275): ``round(used * ff_bynode)`` of the
    tree's ``used`` features, at least ``min(2, used)``."""
    used = num_features if feature_fraction >= 1.0 \
        else max(1, int(round(num_features * feature_fraction)))
    return max(min(2, used), int(round(used * ff_bynode)))


def salted_uniform(key: Key, salts: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.uniform(jax.random.fold_in(key, s), (n,))`` for every
    salt ``s``: float32 [S, n], on host int64 arrays."""
    salts = np.asarray(salts, np.int64) & MASK
    k0, k1 = threefry2x32(key, np.zeros_like(salts), salts)
    i = np.arange(n, dtype=np.int64)
    b0, b1 = threefry2x32((k0[:, None], k1[:, None]), i >> 32, i & MASK)
    bits = (((b0 ^ b1) >> 9) | 0x3F800000).astype(np.uint32)
    return bits.view(np.float32) - np.float32(1.0)


class NodeRand:
    """A learner's per-tree node randomness (``NodeRandMixin``)."""

    def __init__(self, config, num_bins: np.ndarray):
        self.extra_trees = bool(config.extra_trees)
        self.ff_bynode = float(config.feature_fraction_bynode)
        self.on = self.extra_trees or self.ff_bynode < 1.0
        self.num_bins = np.asarray(num_bins, np.int32)
        self.count = bynode_feature_count(
            len(self.num_bins), float(config.feature_fraction),
            self.ff_bynode)
        self._extra_rng = np.random.RandomState(config.extra_seed)
        self._bynode_rng = np.random.RandomState(
            config.feature_fraction_seed)

    def next_tree_keys(self) -> Optional[Tuple[Key, Key]]:
        """The tree's key pair (extra_trees, by-node); None when neither
        option is on (no stream advances then)."""
        if not self.on:
            return None
        return (prng_key(self._extra_rng.randint(0, 2**31 - 1)),
                prng_key(self._bynode_rng.randint(0, 2**31 - 1)))

    def tables(self, keys: Tuple[Key, Key], feature_mask, num_salts: int,
               num_bins: Optional[np.ndarray] = None,
               count: Optional[int] = None, cap: Optional[int] = None,
               width: Optional[int] = None):
        """(rand_bins int32 [S, F] or None, node_mask bool [S, F] or
        None) of salts ``0 .. num_salts - 1`` (``make_node_rand``'s
        ``node_rand(salt)`` for each). A feature shard of a parallel
        learner (JAX ``ShardScanCtx``) passes its features' ``num_bins``,
        its slice ``count`` of the by-node budget and the budget's
        ``cap``, and ``width``, its padded slot count: the draws are
        over ``width`` slots (the shard's features first, the padding
        never in the mask) and cut to the shard's features."""
        num_bins = self.num_bins if num_bins is None \
            else np.asarray(num_bins, np.int32)
        f = len(num_bins)
        width = f if width is None else int(width)
        count = self.count if count is None else int(count)
        cap = count if cap is None else int(cap)
        salts = np.arange(num_salts)
        fm = np.zeros(width, bool)
        fm[:f] = True if feature_mask is None \
            else np.asarray(feature_mask, bool)
        rb = nm = None
        if self.extra_trees:
            u = salted_uniform(keys[0], salts, f)
            span = np.maximum(num_bins - 2, 1).astype(np.float32)
            rb = np.floor(u * span).astype(np.int32)
        if self.ff_bynode < 1.0:
            u2 = np.where(fm, salted_uniform(keys[1], salts, width),
                          np.float32(-1.0))
            cap = min(max(cap, 1), width)
            cnt = min(max(count, 0), cap)
            if cnt > 0:
                kth = -np.sort(-u2, axis=1)[:, cnt - 1:cnt]
            else:
                kth = np.full((num_salts, 1), 2.0, np.float32)
            nm = ((u2 >= kth) & fm)[:, :f]
        return rb, nm
