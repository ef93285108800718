"""Which tensor of each parallel mode is split by rows, which by
features and which is replicated, and the one balanced plan of feature
shards (port of ``lightgbm_tpu/parallel/partition_rules.py``).

The JAX package names a ``PartitionSpec`` for every training array of a
mesh mode and places it with ``device_put``; the specs are JAX means.
What the port keeps is the rule itself (``MODE_RULES``, read through
``role_of``): a rank holds a row block of a "rows" tensor, its feature
shard of a "features" tensor, and all of a "replicated" one. The
learners (``parallel/learners.py``) place their tensors by it.

``plan_feature_shards`` is the JAX plan unchanged: EFB groups (a feature
a group when unbundled) go largest first to the least-loaded shard by
feature count, each shard's features sorted by global id, so the serial
learner's first-index tie rule holds inside a shard and the winner
exchange breaks ties across shards by the lower global id
(``learner/comm.py``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np

ROWS, FEATURES, REPLICATED = "rows", "features", "replicated"

# JAX partition_rules.py MODE_RULES, as roles: the binned matrix, the
# per-row vectors (gradients, hessians, bagging weights, leaf ids), the
# multi-val slots, the feature-shard metadata, the per-split histograms
# and the tree (every mode's tree is replicated)
_ROW_VECTORS = ("grad", "hess", "bag_weight", "leaf_id")
MODE_RULES: Dict[str, Dict[str, str]] = {
    "data": dict({k: ROWS for k in _ROW_VECTORS}, binned=ROWS,
                 mv_slots=ROWS, meta_local=FEATURES, hist=REPLICATED,
                 feature_mask=REPLICATED, tree=REPLICATED),
    "feature": dict({k: REPLICATED for k in _ROW_VECTORS},
                    binned=REPLICATED, binned_hist=FEATURES,
                    meta_local=FEATURES, hist=FEATURES,
                    feature_mask=REPLICATED, tree=REPLICATED),
    "voting": dict({k: ROWS for k in _ROW_VECTORS}, binned=ROWS,
                   mv_slots=ROWS, hist=ROWS, feature_mask=REPLICATED,
                   tree=REPLICATED),
    "partitioned-data": dict({k: ROWS for k in _ROW_VECTORS}, mat=ROWS,
                             ws=ROWS, meta_local=FEATURES, hist=REPLICATED,
                             feature_mask=REPLICATED, tree=REPLICATED),
    "partitioned-voting": dict({k: ROWS for k in _ROW_VECTORS}, mat=ROWS,
                               ws=ROWS, hist=ROWS, feature_mask=REPLICATED,
                               tree=REPLICATED),
}


def role_of(mode: str, name: str) -> str:
    """How tensor ``name`` of ``mode`` is placed: ``ROWS``,
    ``FEATURES`` or ``REPLICATED`` (a name the table does not list is
    replicated, as the JAX ``spec_for`` defaults to ``P()``)."""
    if mode not in MODE_RULES:
        raise ValueError(f"unknown parallel mode {mode!r}")
    return MODE_RULES[mode].get(name, REPLICATED)


class FeatureShardPlan(NamedTuple):
    """Static (host) plan of the column-sharded scan axis (JAX
    ``FeatureShardPlan``, without the traced meta)."""
    d: int                 # shard count
    f_local: int           # feature slots per shard
    f_pad: int             # d * f_local (padded scan axis)
    g_local: int           # group slots per shard
    g_pad: int             # d * g_local (padded histogram axis)
    col_perm: np.ndarray   # [g_pad] int64 global group of each slot
    col_live: np.ndarray   # [g_pad] bool live slots
    feat_perm: np.ndarray  # [f_pad] int64 global feature (-1 = pad)

    def local_features(self, shard: int) -> np.ndarray:
        """Shard ``shard``'s global feature ids, ascending."""
        fp = self.feat_perm[shard * self.f_local:(shard + 1) * self.f_local]
        return fp[fp >= 0]

    def local_groups(self, shard: int) -> np.ndarray:
        """Shard ``shard``'s global group ids, in its slot order."""
        sl = slice(shard * self.g_local, (shard + 1) * self.g_local)
        return self.col_perm[sl][self.col_live[sl]]

    def local_columns(self, shard: int, groups: np.ndarray) -> np.ndarray:
        """[F_local] each of the shard's features' column in the shard's
        group slice (``groups`` the global group of every feature)."""
        lg = {int(g): j for j, g in enumerate(self.local_groups(shard))}
        return np.asarray([lg[int(groups[f])]
                           for f in self.local_features(shard)], np.int32)


def plan_feature_shards(groups: np.ndarray, num_features: int,
                        num_groups: int, d: int) -> FeatureShardPlan:
    """Balanced group -> shard assignment (JAX ``plan_feature_shards``):
    ``groups`` [F] each feature's global group."""
    groups = np.asarray(groups)
    feat_of_group = [np.where(groups == g)[0] for g in range(num_groups)]
    order = np.argsort([-len(fg) for fg in feat_of_group], kind="stable")
    shard_groups: List[List[int]] = [[] for _ in range(d)]
    load = [0] * d
    for g in order:
        s = min(range(d), key=lambda i: (load[i], i))
        shard_groups[s].append(int(g))
        load[s] += len(feat_of_group[int(g)])
    g_local = max(1, max(len(sg) for sg in shard_groups))
    f_local = max(1, max(load))
    g_pad, f_pad = d * g_local, d * f_local
    col_perm = np.zeros(g_pad, np.int64)
    col_live = np.zeros(g_pad, bool)
    for s, sg in enumerate(shard_groups):
        for j, g in enumerate(sg):
            col_perm[s * g_local + j] = g
            col_live[s * g_local + j] = True
    perm = np.full(f_pad, -1, np.int64)
    for s, sg in enumerate(shard_groups):
        fl = np.sort(np.concatenate(
            [feat_of_group[g] for g in sg]).astype(np.int64)) \
            if sg else np.zeros(0, np.int64)
        perm[s * f_local:s * f_local + len(fl)] = fl
    return FeatureShardPlan(d=d, f_local=f_local, f_pad=f_pad,
                            g_local=g_local, g_pad=g_pad, col_perm=col_perm,
                            col_live=col_live, feat_perm=perm)


def split_bynode_budget(count: int, d: int) -> Tuple[int, int, int]:
    """Each shard's slice of the by-node feature budget (JAX
    ``split_bynode_budget``): ``count // d`` a shard plus one for the
    first ``count % d`` shards, so the slices add up to ``count``.
    Returns (floor, remainder, the per-shard cap)."""
    floor, rem = divmod(int(count), d)
    return floor, rem, floor + (1 if rem else 0)
