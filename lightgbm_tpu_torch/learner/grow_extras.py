"""What the per-phase grow loop adds to a split beyond the scan: the
bounded histogram memory, forced splits and cost-effective gradient
boosting (ports of ``lightgbm_tpu/learner/serial.py:131-317, 427-560``
and the pool of ``lightgbm_tpu/learner/partitioned.py:342-356,
526-560``). ``split_step_host`` (``learner/split_step.py``) calls them;
all of their state lives on the host but the histograms and the lazy
penalty's charged matrix, which stay on the learner's device.

**Histogram memory** (``histogram_pool_size`` in MB; HistogramPool,
serial_tree_learner.cpp:313-353). ``hist_pool_slots`` counts whole
``[G, B, 3]`` float32 slots in the budget. With a slot for every leaf
the cache holds each leaf's histogram and the sibling is the parent
less the smaller child. The partitioned learner bounds it to an LRU
pool of 2 or more slots: slot 0 holds the root, the left child takes
its parent's slot, the right child the least recently touched one, and
a split whose parent was evicted builds both children from their
segments. Fewer than 2 slots, and the serial learner whenever the cache
does not fit, rebuild both children of every split.

**Forced splits** (``forcedsplits_filename``; ForceSplits,
serial_tree_learner.cpp:465-634). ``build_forced_plan`` resolves the
JSON's BFS walk into (leaf, feature, bin threshold, ...) steps on the
host; the grow loop splits those leaves first, in order, with the left
sums read off the leaf's histogram (``forced_sums``), and the first
step whose side would be empty aborts the rest.

**CEGB** (cost_effective_gradient_boosting.hpp). After the scan, each
feature's score loses ``tradeoff * (penalty_split * leaf rows +
coupled penalty while the feature is unused + lazy penalty * the leaf's
rows not yet charged for it)`` in float32, in the JAX order
(``cegb_delta``). The loop keeps every leaf's raw (unpenalized) table
(``splits_per_leaf_``); the first use of a feature refunds its coupled
penalty to every cached row and may upgrade another leaf's best split
(``CegbState.after_split``). The used set persists across trees; the
lazy penalty's [N, F] charged matrix lives on the serial learner.
"""

from __future__ import annotations

import json
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.split import (MAX_CAT_WORDS, MISSING_NAN_CODE, MISSING_ZERO_CODE,
                         O_BITS, O_DLEFT, O_ISCAT, O_LC, O_LG, O_LH, O_SCORE,
                         O_THR, O_WL, O_WR, kEpsilon)
from ..utils.log import log_fatal, log_warning

f32 = np.float32


# ---- histogram memory --------------------------------------------------

def hist_pool_slots(config, num_leaves: int, num_groups: int,
                    num_bins: int) -> int:
    """Slots of the histogram memory (JAX ``hist_pool_slots``):
    ``num_leaves`` when the full cache fits ``histogram_pool_size`` MB
    (<= 0: unlimited, the default), else the whole ``[G, B, 3]`` float32
    slots that fit, or 0 when fewer than 2 do (rebuild on demand)."""
    pool = float(config.histogram_pool_size)
    if pool <= 0:
        return num_leaves
    slots = int(pool * 1024 * 1024 // (num_groups * num_bins * 3 * 4))
    if slots >= num_leaves:
        return num_leaves
    return slots if slots >= 2 else 0


class HistMemory:
    """The histograms a grow loop keeps: ``mode`` "cache" (``hist``
    [L, G, B, 3], a row a leaf), "pool" (``pool`` [slots, G, B, 3] with
    its LRU bookkeeping on the host) or "rebuild" (nothing kept).
    ``builds`` counts the child histograms built beyond the cache's one
    a split (what the bounded modes cost)."""

    def __init__(self, mode: str, store: Optional[torch.Tensor]):
        self.mode = mode
        self.hist = store if mode == "cache" else None
        self.pool = store if mode == "pool" else None
        self.builds = 0

    @classmethod
    def for_learner(cls, slots: int, big_l: int, shape, device,
                    pool_ok: bool) -> "HistMemory":
        """The memory of ``slots`` slots of ``shape`` ([G, B, 3]):
        the cache at ``big_l`` slots, an LRU pool at 2 or more when
        ``pool_ok``, else rebuild."""
        if slots >= big_l:
            return cls("cache", torch.zeros((big_l,) + tuple(shape),
                                            dtype=torch.float32,
                                            device=device))
        if pool_ok and slots >= 2:
            return cls("pool", torch.zeros((slots,) + tuple(shape),
                                           dtype=torch.float32,
                                           device=device))
        return cls("rebuild", None)

    def start_tree(self, root_hist: torch.Tensor, big_l: int) -> None:
        if self.mode == "cache":
            self.hist[0] = root_hist
        elif self.mode == "pool":
            slots = self.pool.shape[0]
            self.pool[0] = root_hist
            self.slot_of_leaf = np.full(big_l, -1, np.int64)
            self.leaf_of_slot = np.full(slots, -1, np.int64)
            self.slot_used = np.full(slots, -1, np.int64)
            self.slot_of_leaf[0] = self.leaf_of_slot[0] = 0
            self.slot_used[0] = 0

    def leaf_hist(self, leaf: int, site: dict, ops) -> torch.Tensor:
        """One leaf's histogram (a forced split's): cached or pooled,
        else rebuilt from the leaf's rows."""
        if self.mode == "cache":
            return self.hist[leaf]
        if self.mode == "pool" and self.slot_of_leaf[leaf] >= 0:
            return self.pool[int(self.slot_of_leaf[leaf])]
        self.builds += 1
        return ops.leaf_histogram(leaf, site)

    def children(self, leaf: int, new: int, k: int, part, small_left: bool,
                 ops):
        """Both children's histograms after the partition: returns
        (a_is_left, hist_a, hist_b). The cache builds the smaller child
        and subtracts it from the cached parent (a = the smaller); the
        pool does the same while the parent is pooled, else it builds
        both, and the bounded modes return (left, right)."""
        if self.mode == "cache":
            small = ops.histogram(part, small_left)
            other = self.hist[leaf] - small
            idx_a, idx_b = (leaf, new) if small_left else (new, leaf)
            self.hist[idx_a] = small
            self.hist[idx_b] = other
            return small_left, small, other
        slot = int(self.slot_of_leaf[leaf]) if self.mode == "pool" else -1
        if slot >= 0:
            small = ops.histogram(part, small_left)
            other = self.pool[slot] - small
            left, right = (small, other) if small_left else (other, small)
        else:
            left = ops.histogram(part, True)
            right = ops.histogram(part, False)
            self.builds += 1
        if self.mode == "pool":
            self._claim(leaf, new, k, slot, left, right)
        return True, left, right

    def _claim(self, leaf, new, tick, slot, left, right) -> None:
        """The children take their slots (HistogramPool::Move): the left
        child its parent's slot when pooled, else the least recently
        used one; the right child the least recently used one after
        that. An evicted slot's owner falls back to a rebuild."""
        sol, los, used = self.slot_of_leaf, self.leaf_of_slot, \
            self.slot_used
        slot_l = slot if slot >= 0 else int(np.argmin(used))
        if los[slot_l] >= 0:
            sol[los[slot_l]] = -1
        used[slot_l] = tick
        slot_r = int(np.argmin(used))
        if los[slot_r] >= 0:
            sol[los[slot_r]] = -1
        sol[leaf], sol[new] = slot_l, slot_r
        los[slot_l], los[slot_r] = leaf, new
        used[slot_r] = tick
        self.pool[slot_l] = left
        self.pool[slot_r] = right


# ---- forced splits -----------------------------------------------------

class ForcedStep(NamedTuple):
    """One forced split: leaf ``leaf`` splits on inner feature ``feat``,
    bins ``<= thr`` left; the feature's missing code, default bin and
    bin count route its missing bins as the partition does."""
    leaf: int
    feat: int
    thr: int
    default_left: bool
    missing: int
    default_bin: int
    num_bin: int


def build_forced_plan(dataset, config, missing_code) -> tuple:
    """``forcedsplits_filename`` as a tuple of ``ForcedStep`` (JAX
    ``build_forced_plan``): the JSON walked breadth first, the i-th step
    creating leaf i + 1, each threshold taken to the bin it falls in
    (left: bin < ValueToBin(threshold)). A step on an unused or a
    categorical feature, or with a threshold below all data, ends the
    plan with a warning. ``missing_code`` maps a mapper's missing type
    to the scan's code."""
    fn = config.forcedsplits_filename
    if not fn:
        return ()
    from ..data.binning import BIN_TYPE_CATEGORICAL, MISSING_NAN
    with open(fn) as f:
        root = json.load(f)
    num_leaves = int(config.num_leaves)
    plan = []
    q = deque([(root, 0)])
    k = 1
    while q and k < num_leaves:
        node, leaf = q.popleft()
        if not node:
            continue
        feat_real = int(node["feature"])
        thr = float(node["threshold"])
        try:
            inner = dataset.used_feature_map[feat_real]
        except IndexError:
            inner = -1
        if inner is None or inner < 0:
            log_warning(f"forced split on unused feature {feat_real} "
                        "ignored; aborting remaining forced splits")
            break
        mapper = dataset.feature_mapper(inner)
        if mapper.bin_type == BIN_TYPE_CATEGORICAL:
            log_warning("forced splits on categorical features are not "
                        "supported; aborting remaining forced splits")
            break
        tbin = int(np.asarray(
            mapper.values_to_bins(np.asarray([thr], np.float64)))[0])
        if tbin == 0:
            log_warning(
                f"forced split threshold {thr} on feature {feat_real} "
                "is below all data (empty left side); aborting "
                "remaining forced splits")
            break
        plan.append(ForcedStep(
            leaf, int(inner), tbin - 1, mapper.missing_type == MISSING_NAN,
            missing_code[mapper.missing_type], int(mapper.default_bin),
            int(mapper.num_bin)))
        if node.get("left"):
            q.append((node["left"], leaf))
        if node.get("right"):
            q.append((node["right"], k))
        k += 1
    return tuple(plan)


def forced_sums(feat_hist: torch.Tensor, step: ForcedStep):
    """Left (g, h, c) of a forced split from its feature's [B, 3]
    histogram (GatherInfoForThreshold; JAX ``forced_left_sums``): bins
    up to the threshold, the NaN bin added when it goes left, the
    zero-missing default bin taken out when it goes right; summed in
    float64 and rounded once."""
    h = feat_hist.double()
    cum = h[:step.thr + 1].sum(dim=0)
    if step.missing == MISSING_NAN_CODE and step.default_left \
            and step.num_bin - 1 > step.thr:
        cum = cum + h[step.num_bin - 1]
    if step.missing == MISSING_ZERO_CODE and not step.default_left \
            and step.default_bin <= step.thr:
        cum = cum - h[step.default_bin]
    g, hh, c = cum.float().cpu().numpy()
    return f32(g), f32(hh), f32(c)


def _threshold_l1(s, l1):
    return np.sign(s) * np.maximum(np.abs(s) - f32(l1), f32(0.0))


def _leaf_output(g, h, p, cmin, cmax):
    out = -_threshold_l1(g, p.lambda_l1) / (h + f32(p.lambda_l2))
    if p.max_delta_step > 0.0:
        out = np.clip(out, -f32(p.max_delta_step), f32(p.max_delta_step))
    return f32(np.minimum(np.maximum(out, cmin), cmax))


def _gain_given_output(g, h, w, p):
    sg = _threshold_l1(g, p.lambda_l1)
    return f32(-(f32(2.0) * sg * w + (h + f32(p.lambda_l2)) * w * w))


def forced_split(step: ForcedStep, lg, lh, lc, pg, ph, cmin, cmax,
                 params) -> dict:
    """The split-site fields of a forced split (JAX
    ``forced_split_override``), float32 host scalars in its order:
    the gain above the parent's shift and min_gain_to_split, and both
    constrained outputs. ``lh`` is eps-free."""
    p = params
    inf = f32(np.inf)
    lh_e = lh + f32(kEpsilon)
    rh_e = ph + f32(2 * kEpsilon) - lh_e
    rg = pg - lg
    lout = _leaf_output(lg, lh_e, p, cmin, cmax)
    rout = _leaf_output(rg, rh_e, p, cmin, cmax)
    ph_e = ph + f32(2 * kEpsilon)
    shift = _gain_given_output(pg, ph_e, _leaf_output(pg, ph_e, p, -inf,
                                                      inf), p)
    gain = f32(_gain_given_output(lg, lh_e, lout, p)
               + _gain_given_output(rg, rh_e, rout, p)
               - shift - f32(p.min_gain_to_split))
    return dict(bs_feat=step.feat, bs_thr=step.thr,
                bs_dleft=step.default_left, bs_iscat=False,
                bs_bitset=np.zeros(MAX_CAT_WORDS, np.uint32), bs_gain=gain,
                bs_lg=lg, bs_lh=lh, bs_lc=lc, bs_lout=lout, bs_rout=rout)


# ---- CEGB ---------------------------------------------------------------

def cegb_on(config, lazy_ok: bool = True) -> tuple:
    """(cegb_on, cegb_lazy_on) of a config (JAX
    ``split_params_from_config``); without ``lazy_ok`` the lazy
    penalties count for nothing (a learner that drops them)."""
    t = float(config.cegb_tradeoff)
    lazy = lazy_ok and t > 0.0 and any(
        float(c) > 0.0 for c in config.cegb_penalty_feature_lazy)
    on = lazy or (t > 0.0 and (
        float(config.cegb_penalty_split) > 0.0
        or any(float(c) > 0.0 for c in config.cegb_penalty_feature_coupled)))
    return on, lazy


def cegb_penalties(dataset, config):
    """The coupled and lazy penalties by inner feature (float32 [F]
    each), checked against the dataset's feature count."""
    f = dataset.num_features
    out = []
    for name in ("cegb_penalty_feature_coupled", "cegb_penalty_feature_lazy"):
        cfg = list(getattr(config, name))
        if cfg and len(cfg) != dataset.num_total_features:
            log_fatal(f"{name} should be the same size as feature number "
                      f"({len(cfg)} vs {dataset.num_total_features})")
        arr = np.zeros(f, np.float32)
        for inner, orig in enumerate(dataset.real_feature_idx):
            if orig < len(cfg):
                arr[inner] = float(cfg[orig])
        out.append(arr)
    return tuple(out)


def cegb_delta(params, coupled: np.ndarray, lazy: np.ndarray, parent_c,
               used: np.ndarray, uncharged=None) -> np.ndarray:
    """Each feature's CEGB penalty of one leaf (DetlaGain,
    cost_effective_gradient_boosting.hpp:50-61), float32 [F] in the JAX
    package's order (``per_feature_splits``)."""
    t = f32(params.cegb_tradeoff)
    delta = f32(params.cegb_tradeoff * params.cegb_penalty_split) \
        * f32(parent_c)
    delta = delta + t * coupled * (~used).astype(np.float32)
    if params.cegb_lazy_on and uncharged is not None:
        delta = delta + t * lazy * np.asarray(uncharged, np.float32)
    return delta.astype(np.float32)


def penalized(table: np.ndarray, delta: np.ndarray) -> np.ndarray:
    """A [F, C] scan table with the finite scores less ``delta``."""
    out = table.copy()
    s = out[:, O_SCORE]
    out[:, O_SCORE] = np.where(np.isfinite(s), s - delta, s)
    return out


class CegbState:
    """A learner's CEGB state: the used features (across trees), the
    lazy penalty's charged matrix (the serial learner's device; None
    otherwise) and, per tree, every leaf's raw table and blocked flag."""

    def __init__(self, params, coupled, lazy, num_data: int, device,
                 lazy_on: bool):
        self.params = params
        self.coupled, self.lazy = coupled, lazy
        self.used = np.zeros(len(coupled), bool)
        self.charged = torch.zeros((num_data, len(coupled)),
                                   dtype=torch.bool, device=device) \
            if lazy_on else None
        self.lid = None
        self.used_rows = None
        # first uses refunded and best splits upgraded (over all trees)
        self.refunds = 0
        self.upgrades = 0

    def start_tree(self, big_l: int, lid=None, used_rows=None) -> None:
        """A tree's raw-table cache (reset every tree, as the JAX
        package does); ``lid`` and ``used_rows`` (the in-bag rows) feed
        the lazy penalty."""
        self.pf = None
        self.blocked = np.zeros(big_l, bool)
        self.lid, self.used_rows = lid, used_rows

    def _uncharged(self, member: torch.Tensor) -> torch.Tensor:
        m = member & self.used_rows
        return m.sum().float() - (self.charged & m[:, None]).sum(
            dim=0).float()

    def root(self, table: np.ndarray, root_c) -> np.ndarray:
        """The root's penalized table; keeps the raw one as row 0."""
        unch = None
        if self.charged is not None:
            unch = self._uncharged(
                torch.ones_like(self.used_rows)).cpu().numpy()
        self.pf = np.zeros((len(self.blocked),) + table.shape, np.float32)
        self.pf[:, :, O_SCORE] = -np.inf
        self.pf[0] = table
        return penalized(table, cegb_delta(
            self.params, self.coupled, self.lazy, root_c, self.used, unch))

    def children(self, tables: np.ndarray, counts, leaf: int, new: int,
                 feat: int, lefts) -> np.ndarray:
        """Both fresh children's penalized tables ([2, F, C], in the
        order of ``counts`` and ``lefts``: a child's row count and
        whether it is the left child), with ``feat`` acquired; the lazy
        penalty first charges the parent's in-bag rows for ``feat``,
        then counts each child's rows not yet charged per feature, over
        the parent's rows only (one gather of their charged rows)."""
        used = self.used.copy()
        used[feat] = True
        unch = [None, None]
        if self.charged is not None:
            lid = self.lid
            rows = torch.nonzero(((lid == leaf) | (lid == new))
                                 & self.used_rows).flatten()
            self.charged[rows, feat] = True
            sub = self.charged[rows]
            left = (lid[rows] == leaf)[:, None]
            n_left = left.sum().float()
            ch_left = (sub & left).sum(dim=0).float()
            ch_all = sub.sum(dim=0).float()
            per = {True: n_left - ch_left,
                   False: (rows.numel() - n_left) - (ch_all - ch_left)}
            unch = torch.stack([per[bool(x)] for x in lefts]).cpu().numpy()
        return np.stack([penalized(t, cegb_delta(
            self.params, self.coupled, self.lazy, c, used, u))
            for t, c, u in zip(tables, counts, unch)])

    def after_split(self, pack, st: dict, raw_left: np.ndarray,
                    raw_right: np.ndarray, blocked: bool, feat: int,
                    leaf: int, new: int) -> None:
        """The split's CEGB bookkeeping on the host state, in the JAX
        order: on the first use of ``feat`` the coupled penalty is
        refunded to every cached row, the children's raw rows are
        stored, then another leaf's best split is upgraded to its
        (refunded) candidate on ``feat`` where that one wins
        (UpdateLeafBestSplits, :63-80; higher gain, ties to the smaller
        feature)."""
        was_used = bool(self.used[feat])
        self.used[feat] = True
        if not was_used:
            self.refunds += 1
            col = self.pf[:, feat, O_SCORE]
            refund = f32(self.params.cegb_tradeoff) * self.coupled[feat]
            self.pf[:, feat, O_SCORE] = np.where(np.isfinite(col),
                                                 col + refund, col)
        self.pf[leaf], self.pf[new] = raw_left, raw_right
        self.blocked[leaf] = self.blocked[new] = blocked
        if was_used:
            return
        sn = st["S"].numpy()
        nf = len(pack.sf_fields)
        si = sn[nf:].view(np.int32)

        def frow(name):
            return sn[pack.sf_idx[name]]

        def irow(name):
            return si[pack.si_idx[name]]
        cand = self.pf[:, feat, O_SCORE]
        gain, bfeat = frow("bs_gain"), irow("bs_feat")
        rows = np.arange(len(cand))
        beats = (cand > gain) | ((cand == gain) & (feat < bfeat))
        do = (rows != leaf) & (rows != new) & ~self.blocked \
            & np.isfinite(gain) & np.isfinite(cand) & beats
        if not do.any():
            return
        self.upgrades += int(do.sum())
        cf = self.pf[do, feat]
        gain[do] = cf[:, O_SCORE]
        bfeat[do] = feat
        irow("bs_thr")[do] = cf[:, O_THR].astype(np.int32)
        irow("bs_dleft")[do] = (cf[:, O_DLEFT] > 0.5).astype(np.int32)
        frow("bs_lg")[do] = cf[:, O_LG]
        frow("bs_lh")[do] = cf[:, O_LH] - f32(kEpsilon)
        frow("bs_lc")[do] = cf[:, O_LC]
        frow("bs_lout")[do] = cf[:, O_WL]
        frow("bs_rout")[do] = cf[:, O_WR]
        if cf.shape[1] > O_ISCAT:
            irow("bs_iscat")[do] = (cf[:, O_ISCAT] > 0.5).astype(np.int32)
            st["bs_bitset"].numpy()[do] = np.ascontiguousarray(
                cf[:, O_BITS:O_BITS + MAX_CAT_WORDS]).view(np.int32)
