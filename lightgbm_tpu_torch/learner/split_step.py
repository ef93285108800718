"""Per-split state and bookkeeping of both grow loops, the partitioned
(segment) and the serial (``leaf_id``) layouts (port of
``lightgbm_tpu/learner/split_step.py``, merged packing).

**Packed state.** As in the JAX package, all per-leaf state rides ONE
``S`` [Ks, L] float32 matrix (column = leaf; int rows bit-cast into
float32, so their bit patterns round-trip exactly) and the tree arrays
ONE ``T`` [Kt, L-1] matrix (column = internal node). The layout is the
JAX package's merged ``StatePack`` field for field: the same field
order, and the same rows dropped and synthesized by ``view()``
(``leaf_weight`` = ``leaf_h``, ``leaf_count`` = ``leaf_c``,
``leaf_parent`` = ``ref_node``; ``leaf_cmin``/``leaf_cmax`` without
monotone constraints). The segment layout's int rows start with its
segment bounds (``make_grow_pack(SEG_SI_PREFIX)``), the leaf layout has
none (``make_grow_pack(())``). A dataset with categorical features
carries the bin bitsets beside ``S`` and ``T``, as the JAX package's
``make_grow_pack(has_cat=True)`` does: ``bs_bitset`` [L, MAX_CAT_WORDS]
(each leaf's best split) and ``cat_bitsets`` [L-1, MAX_CAT_WORDS] (each
node's), int32 bit patterns of the uint32 words; without them
``view()`` synthesizes zeros. The fused split-step kernels
(``csrc/split_step_segment.cu``, ``csrc/split_step_leaf.cu``) read and
write the numerical layout on the device; the per-phase loops keep the
state on the host. ``pack`` and ``view`` are functions on tensors;
``read_site`` reads, and ``set_state_cols``, ``set_tree_col`` and
``set_bitsets`` write, host scalars of the host state.

**The per-split bookkeeping** (``order_child_pair``,
``child_constraints``, ``child_columns``, ``split_node_updates``) runs
in the JAX package's float32 expression order on host numpy scalars in
``split_step_host``, which both layouts' per-phase loops and both plain
fused steps call (``SplitOps`` carries what differs). The kernels
repeat the same expressions in float32 on the device, so all write the
same bits.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops.split import MAX_CAT_WORDS, O_BITS, O_ISCAT, assemble_split, \
    kEpsilon
from ..ops.split_step_cuda import IM_MONO

f32 = np.float32

# the partitioned loop's int state starts with its physical segment
# bounds (lightgbm_tpu/learner/partitioned.py SEG_SI_PREFIX)
SEG_SI_PREFIX = ("leaf_begin", "leaf_cnt")


def leaf_output_host(g, h, l1, l2, max_delta_step) -> np.float32:
    """``leaf_output_no_constraint`` on float32 host scalars."""
    g, h = f32(g), f32(h)
    reg = np.maximum(np.abs(g) - f32(l1), f32(0.0))
    out = -(np.sign(g) * reg) / (h + f32(l2))
    if max_delta_step > 0.0:
        out = np.clip(out, -f32(max_delta_step), f32(max_delta_step))
    return f32(out)


def fused_split_kernel_mode(config_value: str = "auto") -> str:
    """Resolve the fused split-step gate to "on" / "off" / "auto". The
    ``LGBM_TPU_FUSED_SPLIT_KERNEL`` environment variable overrides the
    config value: 0/false/off force the per-phase loop, 1/on/force the
    fused step (its plain version on the CPU), auto keeps the default
    (on for a CUDA device)."""
    env = os.environ.get("LGBM_TPU_FUSED_SPLIT_KERNEL", "").lower()
    if env in ("0", "false", "off"):
        return "off"
    if env in ("1", "on", "force"):
        return "on"
    if env in ("auto",):
        return "auto"
    return config_value if config_value in ("on", "off") else "auto"


def fused_split_eligible(params, *, cache_hists: bool, merged: bool,
                         extra_trees: bool, ff_bynode: float,
                         mv_groups: int = 0, serial_comm: bool = True,
                         num_leaves: int = 0) -> bool:
    """Static eligibility of the fused split step for one learner: the
    step owns the whole split, so anything that injects per-split work
    it does not model keeps the per-phase loop (CEGB, per-node RNG,
    pool-bounded histogram memory, multi-val groups, collectives)."""
    return (merged and cache_hists and serial_comm
            and not getattr(params, "cegb_on", False) and not extra_trees
            and ff_bynode >= 1.0 and mv_groups == 0 and num_leaves >= 2)


def _as_f32_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous().view(torch.float32)


class StatePack:
    """Merged packed grow-loop state: ``S`` [len(sf) + len(si), L] and
    ``T`` [len(tf) + len(ti), L-1] float32, int rows bit-cast. Fields in
    ``derived`` are not carried; ``view()`` synthesizes them."""

    # field layouts of the JAX package (learner/split_step.py)
    GROW_SF = ("leaf_g", "leaf_h", "leaf_c", "bs_gain", "bs_lg",
               "bs_lh", "bs_lc", "bs_lout", "bs_rout", "leaf_cmin",
               "leaf_cmax", "leaf_value", "leaf_weight", "leaf_count")
    GROW_SI = ("bs_feat", "bs_thr", "bs_dleft", "bs_iscat", "ref_node",
               "ref_side", "leaf_parent", "leaf_depth")
    GROW_TF = ("split_gain_arr", "internal_value", "internal_weight",
               "internal_count")
    # left_child/right_child stay adjacent (the parent-pointer fixup)
    GROW_TI = ("split_feature", "threshold_bin", "decision_type",
               "left_child", "right_child")

    def __init__(self, sf, si, tf, ti, bools=("bs_dleft", "bs_iscat"),
                 derived=None):
        self.sf_fields, self.si_fields = tuple(sf), tuple(si)
        self.tf_fields, self.ti_fields = tuple(tf), tuple(ti)
        self.sf_idx = {k: i for i, k in enumerate(self.sf_fields)}
        self.si_idx = {k: i for i, k in enumerate(self.si_fields)}
        self.tf_idx = {k: i for i, k in enumerate(self.tf_fields)}
        self.ti_idx = {k: i for i, k in enumerate(self.ti_fields)}
        self.bools = frozenset(bools)
        self.derived = dict(derived or {})
        self._packed = set(sf) | set(si) | set(tf) | set(ti)

    # ---- pack / view -------------------------------------------------
    def pack(self, fields: dict) -> dict:
        """Per-field dict of [L] / [L-1] tensors -> {"S", "T"} plus the
        unpacked keys; derived fields are dropped."""
        st = {k: v for k, v in fields.items()
              if k not in self._packed and k not in self.derived}
        sfm = torch.stack([fields[k].to(torch.float32)
                           for k in self.sf_fields])
        sim = torch.stack([fields[k].to(torch.int32)
                           for k in self.si_fields])
        tfm = torch.stack([fields[k].to(torch.float32)
                           for k in self.tf_fields])
        tim = torch.stack([fields[k].to(torch.int32)
                           for k in self.ti_fields])
        st["S"] = torch.cat([sfm, _as_f32_bits(sim)])
        st["T"] = torch.cat([tfm, _as_f32_bits(tim)])
        return st

    def view(self, st: dict) -> dict:
        """Packed state -> per-field dict of row views plus the
        synthesized derived fields."""
        v = {k: val for k, val in st.items() if k not in ("S", "T")}
        nf, nt = len(self.sf_fields), len(self.tf_fields)
        sfm, sim = st["S"][:nf], st["S"][nf:].view(torch.int32)
        tfm, tim = st["T"][:nt], st["T"][nt:].view(torch.int32)
        for k, i in self.sf_idx.items():
            v[k] = sfm[i]
        for k, i in self.si_idx.items():
            v[k] = sim[i].to(torch.bool) if k in self.bools else sim[i]
        for k, i in self.tf_idx.items():
            v[k] = tfm[i]
        for k, i in self.ti_idx.items():
            v[k] = tim[i]
        for k, fn in self.derived.items():
            v[k] = fn(v)
        return v

    def row_f(self, st: dict, name: str) -> torch.Tensor:
        """One float state row [L]."""
        return st["S"][self.sf_idx[name]]

    def read_site(self, st: dict, leaf: int) -> dict:
        """All carried state of one leaf of a host ``S`` as numpy
        scalars (float32, int32, bool): one column read, int rows
        reinterpreted, never converted."""
        col = st["S"][:, int(leaf)].numpy()
        nf = len(self.sf_fields)
        colf, coli = col[:nf], col[nf:].view(np.int32)
        site = {k: colf[i] for k, i in self.sf_idx.items()}
        for k, i in self.si_idx.items():
            site[k] = bool(coli[i]) if k in self.bools else coli[i]
        return site

    # ---- writes of host scalars into the host state (the per-phase
    # loop and the plain fused steps: a few microseconds a split)
    @staticmethod
    def _column_np(fvals, ivals) -> np.ndarray:
        return np.concatenate([np.array(fvals, np.float32),
                               np.array(ivals, np.int32).view(np.float32)])

    def set_state_cols(self, st: dict, idx_a: int, idx_b: int, fa: dict,
                       fb: dict, ia: dict, ib: dict) -> None:
        """Write both fresh children's state columns into the host
        ``st["S"]`` in place (keys outside the layout are ignored)."""
        sn = st["S"].numpy()
        for idx, fv, iv in ((idx_a, fa, ia), (idx_b, fb, ib)):
            sn[:, int(idx)] = self._column_np(
                [fv[k] for k in self.sf_fields],
                [iv[k] for k in self.si_fields])

    def set_tree_col(self, st: dict, s: int, tf: dict, ti: dict, pnode: int,
                     upd: bool, pside: int) -> None:
        """Write internal node ``s``'s column into the host ``st["T"]`` in
        place and, when ``upd``, point the parent's ``left_child``
        (pside 0) or ``right_child`` (pside 1) at ``s``."""
        tn = st["T"].numpy()
        tn[:, int(s)] = self._column_np([tf[k] for k in self.tf_fields],
                                        [ti[k] for k in self.ti_fields])
        if upd:
            r0 = len(self.tf_fields) + self.ti_idx["left_child"]
            tn[r0 + int(pside), int(pnode)] = np.int32(s).view(np.float32)

    def set_bitsets(self, st: dict, idx_a: int, idx_b: int, bits_a, bits_b,
                    s: int, site_bitset) -> None:
        """The bitset updates of one split (``set_bitsets`` of the JAX
        package): both children's best-split bitsets and node ``s``'s,
        the split leaf's; nothing when the pack derives them (no
        categorical feature)."""
        if "bs_bitset" in self.derived:
            return
        bs = st["bs_bitset"].numpy().view(np.uint32)
        bs[int(idx_a)] = bits_a
        bs[int(idx_b)] = bits_b
        st["cat_bitsets"].numpy().view(np.uint32)[int(s)] = site_bitset


def make_grow_pack(si_prefix=(), *, has_monotone: bool, big_l: int,
                   has_cat: bool = False) -> StatePack:
    """The merged grow-loop pack of one configuration
    (``make_grow_pack(..., merged=True)`` of the JAX package): derivable
    rows, without monotone constraints the constraint bounds and
    without categorical features the bitsets are dropped and
    synthesized by ``view()``."""
    sf = list(StatePack.GROW_SF)
    si = list(si_prefix) + list(StatePack.GROW_SI)
    derived = {}
    for name, src in (("leaf_weight", "leaf_h"), ("leaf_count", "leaf_c"),
                      ("leaf_parent", "ref_node")):
        (sf if name in sf else si).remove(name)
        derived[name] = (lambda src_: lambda v: v[src_])(src)
    if not has_monotone:
        sf.remove("leaf_cmin")
        sf.remove("leaf_cmax")
        derived["leaf_cmin"] = lambda v: torch.full(
            (big_l,), -np.inf, dtype=torch.float32, device=v["leaf_g"].device)
        derived["leaf_cmax"] = lambda v: torch.full(
            (big_l,), np.inf, dtype=torch.float32, device=v["leaf_g"].device)
    if not has_cat:
        derived["bs_bitset"] = lambda v: torch.zeros(
            (big_l, MAX_CAT_WORDS), dtype=torch.int32,
            device=v["leaf_g"].device)
        derived["cat_bitsets"] = lambda v: torch.zeros(
            (big_l - 1, MAX_CAT_WORDS), dtype=torch.int32,
            device=v["leaf_g"].device)
    return StatePack(sf, si, StatePack.GROW_TF, StatePack.GROW_TI,
                     derived=derived)


# ---- per-split scalar bookkeeping (float32 numpy scalars) ------------

def child_constraints_mono(mono, is_cat, lout, rout, pcmin, pcmax):
    """Monotone constraint propagation to both children on one
    feature's direction (LeafConstraints::UpdateConstraints,
    monotone_constraints.hpp:44)."""
    mid = (f32(lout) + f32(rout)) * f32(0.5)
    numerical = not bool(is_cat)
    cmin_l = np.maximum(pcmin, mid) if numerical and mono < 0 else pcmin
    cmax_l = np.minimum(pcmax, mid) if numerical and mono > 0 else pcmax
    cmin_r = np.maximum(pcmin, mid) if numerical and mono > 0 else pcmin
    cmax_r = np.minimum(pcmax, mid) if numerical and mono < 0 else pcmax
    return f32(cmin_l), f32(cmax_l), f32(cmin_r), f32(cmax_r)


def child_constraints(monotone, is_cat, lout, rout, pcmin, pcmax,
                      has_monotone: bool):
    """Parent bounds pass through when no feature is constrained."""
    if not has_monotone:
        return pcmin, pcmax, pcmin, pcmax
    return child_constraints_mono(monotone, is_cat, lout, rout, pcmin,
                                  pcmax)


def order_child_pair(a_is_left, k, lg, lh, lc, rg, rh, rc, lout, rout,
                     cmin_l, cmax_l, cmin_r, cmax_r) -> dict:
    """(left, right) child scalars -> (a, b) storage order; ``side_a``
    is a's ref_side (0 = left child), the salts carry the child
    identity (left 2k+1, right 2k+2)."""
    a = bool(a_is_left)

    def w(x, y):
        return x if a else y

    side_a = 0 if a else 1
    return dict(
        ga=w(lg, rg), ha=w(lh, rh), ca=w(lc, rc),
        gb=w(rg, lg), hb=w(rh, lh), cb=w(rc, lc),
        out_a=w(lout, rout), out_b=w(rout, lout),
        cmin_a=w(cmin_l, cmin_r), cmax_a=w(cmax_l, cmax_r),
        cmin_b=w(cmin_r, cmin_l), cmax_b=w(cmax_r, cmax_l),
        salt_a=w(2 * k + 1, 2 * k + 2), salt_b=w(2 * k + 2, 2 * k + 1),
        side_a=side_a, side_b=1 - side_a)


def defined_split_fields(gain, lg, lh, lc, lout, rout):
    """The split fields ``bs_lg``, ``bs_lh``, ``bs_lc``, ``bs_lout``,
    ``bs_rout`` of a leaf as the state stores them. A leaf without a
    valid split (gain -inf) holds its scan's sums and outputs at an
    invalid threshold, where the right side can be empty (an output of
    0/0 or x/0, NaN in the JAX twins, -inf or NaN here): a field that is
    not finite there is stored as 0, the others as the JAX twins store
    them (``csrc/split_state.cuh`` ``write_child`` does the same). Host
    scalars or tensors."""
    fields = (lg, lh, lc, lout, rout)
    if isinstance(gain, torch.Tensor):
        dead = ~(gain > float("-inf"))
        return tuple(torch.where(dead & ~torch.isfinite(x),
                                 torch.zeros_like(x), x) for x in fields)
    if gain > -np.inf:
        return fields
    return tuple(x if np.isfinite(x) else np.float32(0.0) for x in fields)


def child_columns(split, g, h, c, out, cmin, cmax, s, side, depth,
                  extra_i=None):
    """One fresh child's state-column field dicts (float, int) for
    ``StatePack.set_state_cols``."""
    lg, lh, lc, lout, rout = defined_split_fields(
        split.gain, split.left_g, split.left_h, split.left_c,
        split.left_output, split.right_output)
    f = dict(leaf_g=g, leaf_h=h, leaf_c=c, bs_gain=split.gain,
             bs_lg=lg, bs_lh=lh, bs_lc=lc, bs_lout=lout, bs_rout=rout,
             leaf_cmin=cmin, leaf_cmax=cmax, leaf_value=out,
             leaf_weight=h, leaf_count=c)
    i = dict(bs_feat=split.feature, bs_thr=split.threshold,
             bs_dleft=split.default_left,
             bs_iscat=getattr(split, "is_cat", False),
             ref_node=s, ref_side=side, leaf_parent=s, leaf_depth=depth)
    if extra_i:
        i.update(extra_i)
    return f, i


def split_node_updates(params, gain, feat, thr, dleft, is_cat, pg, ph, pc,
                       ref_node, leaf, new):
    """Tree-array column dicts and the parent-pointer fixup of one
    split (``set_tree_col`` consumes them)."""
    dec = (1 if is_cat else 0) + (2 if dleft else 0)
    upd = int(ref_node) >= 0
    pnode = int(ref_node) if upd else 0
    parent_out = leaf_output_host(
        pg, f32(ph) + f32(2 * kEpsilon), params.lambda_l1,
        params.lambda_l2, params.max_delta_step)
    treef = dict(split_gain_arr=gain, internal_value=parent_out,
                 internal_weight=ph, internal_count=pc)
    treei = dict(split_feature=feat, threshold_bin=thr, decision_type=dec,
                 left_child=~int(leaf), right_child=~int(new))
    return treef, treei, pnode, upd


# ---- the root state and one split, driven from the host --------------

def root_state(pack: StatePack, table: torch.Tensor, root_g, root_h,
               root_c, n: int, params, big_l: int) -> dict:
    """``{"S", "T"}`` of a tree that has only its root, on ``table``'s
    device (JAX partitioned.py:474-542, serial.py:961-1025), with the
    bitsets ``bs_bitset`` and ``cat_bitsets`` when ``pack`` carries
    them. ``table`` is the root's [F, 8] scan table ([F, CAT_TABLE_COLS]
    with categorical features); it is read where it lies, so no host
    read happens here. The root sums are host float32 scalars. The
    segment bounds are packed only when ``pack`` carries them."""
    from ..ops.split import (O_DLEFT, O_LC, O_LG, O_LH, O_SCORE, O_THR,
                             O_WL, O_WR)
    dev = table.device
    best = torch.argmax(table[:, O_SCORE])   # first index of the maximum
    row = table[best]
    i32, fl = torch.int32, torch.float32

    def at0(fill, val, dtype, size=big_l):
        t = torch.full((size,), fill, dtype=dtype, device=dev)
        t[0] = val
        return t

    def zeros(dtype, size=big_l):
        return torch.zeros((size,), dtype=dtype, device=dev)

    root_out = leaf_output_host(root_g, f32(root_h) + f32(2 * kEpsilon),
                                params.lambda_l1, params.lambda_l2,
                                params.max_delta_step)
    m = big_l - 1
    lg, lh, lc, lout, rout = defined_split_fields(
        row[O_SCORE], row[O_LG], row[O_LH] - kEpsilon, row[O_LC], row[O_WL],
        row[O_WR])
    fields = dict(
        leaf_begin=zeros(i32), leaf_cnt=at0(0, int(n), i32),
        leaf_g=at0(0.0, float(root_g), fl),
        leaf_h=at0(0.0, float(root_h), fl),
        leaf_c=at0(0.0, float(root_c), fl),
        bs_gain=at0(-np.inf, row[O_SCORE], fl),
        bs_feat=at0(0, best, i32), bs_thr=at0(0, row[O_THR], i32),
        bs_dleft=at0(0, row[O_DLEFT] > 0.5, i32),
        bs_lg=at0(0.0, lg, fl), bs_lh=at0(0.0, lh, fl),
        bs_lc=at0(0.0, lc, fl), bs_lout=at0(0.0, lout, fl),
        bs_rout=at0(0.0, rout, fl),
        bs_iscat=at0(0, row[O_ISCAT] > 0.5, i32) if table.shape[1] > O_ISCAT
        else zeros(i32),
        ref_node=torch.full((big_l,), -1, dtype=i32, device=dev),
        ref_side=zeros(i32),
        leaf_cmin=torch.full((big_l,), -np.inf, dtype=fl, device=dev),
        leaf_cmax=torch.full((big_l,), np.inf, dtype=fl, device=dev),
        leaf_value=at0(0.0, float(root_out), fl), leaf_depth=zeros(i32),
        split_feature=zeros(i32, m), threshold_bin=zeros(i32, m),
        decision_type=zeros(i32, m), left_child=zeros(i32, m),
        right_child=zeros(i32, m), split_gain_arr=zeros(fl, m),
        internal_value=zeros(fl, m), internal_weight=zeros(fl, m),
        internal_count=zeros(fl, m))
    if "leaf_begin" not in pack.si_idx:
        del fields["leaf_begin"], fields["leaf_cnt"]
    if "bs_bitset" not in pack.derived:
        bits = torch.zeros((big_l, MAX_CAT_WORDS), dtype=i32, device=dev)
        bits[0] = row[O_BITS:O_BITS + MAX_CAT_WORDS].view(i32)
        fields["bs_bitset"] = bits
        fields["cat_bitsets"] = torch.zeros((m, MAX_CAT_WORDS), dtype=i32,
                                            device=dev)
    return pack.pack(fields)


def count_tree_telemetry(learner, dispatches: int, syncs: int) -> None:
    """Per-tree learner counters (JAX ``learner/serial.py:562``): tree
    and row totals, the planned histogram builds (1 root + 1 a split
    with the sibling subtraction, 2 a split without the cache) and
    splits, and the tree's ``host.dispatches`` (its kernel wrappers'
    calls, or their plain versions', counted alike) and ``host.syncs``
    (its host reads). Free when telemetry is off."""
    from ..observability.telemetry import get_telemetry
    tel = get_telemetry()
    if not tel.enabled:
        return
    big_l = learner.num_leaves
    cache = learner.mem.mode == "cache"
    tel.count_iter("host.dispatches", dispatches)
    tel.count_iter("host.syncs", syncs)
    tel.count("learner.trees", 1)
    tel.count("learner.rows_scanned", learner.num_data)
    tel.count("learner.hist_builds_planned",
              1 + (big_l - 1) * (1 if cache else 2))
    tel.count("learner.splits_planned", big_l - 1)


def grown_tree(pack: StatePack, st: dict, k: int, dataset):
    """The host ``Tree`` of a grown state ({"S", "T"} on the host) with
    ``k`` leaves, and the state's per-field numpy view (the caller may
    need the layout's extra fields)."""
    from ..models.tree import Tree, TreeArrays
    v = {key: val.numpy() for key, val in pack.view(st).items()}
    cat_bitsets = v["cat_bitsets"].view(np.uint32) \
        if "bs_bitset" not in pack.derived else None
    tree = Tree(TreeArrays(
        num_leaves=k, split_feature=v["split_feature"],
        threshold_bin=v["threshold_bin"],
        decision_type=v["decision_type"], left_child=v["left_child"],
        right_child=v["right_child"], split_gain=v["split_gain_arr"],
        internal_value=v["internal_value"],
        internal_weight=v["internal_weight"],
        internal_count=v["internal_count"], leaf_value=v["leaf_value"],
        leaf_weight=v["leaf_weight"], leaf_count=v["leaf_count"],
        leaf_parent=v["leaf_parent"], leaf_depth=v["leaf_depth"],
        cat_bitsets=cat_bitsets), dataset=dataset)
    return tree, v


class SplitOps(NamedTuple):
    """The per-split ops ``split_step_host`` calls (the per-phase
    kernels, or their plain versions), for either layout.

    partition(site, leaf, new) -> ``part``, the layout's record of the
    two children: moves the leaf's rows (the segment layout: a stable
    partition of its segment, ``part`` holds the child segments on the
    device) or relabels them (the leaf layout: ``leaf_id`` in place);
    histogram(part, left) -> [G, B, 3] of the left (or right) child;
    scan(hists, leaves, salts) -> [2, F, 8] tables (``salts`` the
    leaves' node-randomness salts);
    extra_i(part) -> (left, right) dicts of the layout's extra int state
    fields (the segment bounds ``leaf_begin``/``leaf_cnt``; none for the
    leaf layout), read on the host after the scans are enqueued;
    leaf_histogram(leaf, site) -> [G, B, 3] of an existing leaf, built
    from its rows (the bounded histogram memory's forced splits)."""
    partition: Callable
    histogram: Callable
    scan: Callable
    extra_i: Callable
    leaf_histogram: Optional[Callable] = None


def split_step_host(pack: StatePack, st: dict, mem, k: int,
                    ops: SplitOps, *, imeta: np.ndarray, params,
                    big_l: int, max_depth: int, has_monotone: bool,
                    cegb=None, forced=None) -> bool:
    """Split ``k`` (the new leaf's id) of the packed state ``st``
    ({"S", "T"}) and the histogram memory ``mem``
    (``grow_extras.HistMemory``), in place. Returns False, and changes
    nothing, when the grow loop's condition fails: ``k < L`` and the
    best open gain > 0 (lightgbm_tpu/learner/partitioned.py:563-568,
    serial.py:1035-1041). ``imeta`` is the host [F, 8] metadata table.
    The host reads the scan tables (and the layout's child records)
    once, after every op of the split is enqueued. One bookkeeping
    serves both layouts; ``ops`` carries what differs.

    ``forced`` = (``ForcedStep``, feature_hist) splits the step's leaf
    as the plan says (feature_hist(hist, leaf sums) gives a leaf's
    per-feature histograms), or returns False when a side would be
    empty (the caller then drops the rest of the plan; JAX
    partitioned.py:790-810). ``cegb`` (``CegbState``) penalizes the
    children's tables and keeps its bookkeeping."""
    if k >= big_l:
        return False
    if forced is None:
        gains = pack.row_f(st, "bs_gain")[:k].cpu().numpy()
        if not gains.max() > 0.0:
            return False
        leaf = int(np.argmax(gains))
    else:
        leaf = int(forced[0].leaf)
    new, s = k, k - 1
    site = pack.read_site(st, leaf)
    site["bs_bitset"] = st["bs_bitset"][leaf].numpy().view(np.uint32).copy() \
        if "bs_bitset" in st else np.zeros(MAX_CAT_WORDS, np.uint32)
    inf = f32(np.inf)
    pcmin = site.get("leaf_cmin", -inf)
    pcmax = site.get("leaf_cmax", inf)
    if forced is not None:
        from .grow_extras import forced_split, forced_sums
        step, feature_hist = forced
        fh = feature_hist(mem.leaf_hist(leaf, site, ops),
                          (site["leaf_g"], site["leaf_h"], site["leaf_c"]))
        lg, lh, lc = forced_sums(fh[step.feat], step)
        kEps = f32(kEpsilon)
        if not (lh > kEps and site["leaf_h"] - lh > kEps):
            return False
        site.update(forced_split(step, lg, lh, lc, site["leaf_g"],
                                 site["leaf_h"], pcmin, pcmax, params))
    feat, thr = int(site["bs_feat"]), int(site["bs_thr"])
    dleft, is_cat = bool(site["bs_dleft"]), bool(site["bs_iscat"])
    lg, lh, lc = site["bs_lg"], site["bs_lh"], site["bs_lc"]
    pg, ph, pc = site["leaf_g"], site["leaf_h"], site["leaf_c"]
    rg, rh, rc = pg - lg, ph - lh, pc - lc
    lout, rout = site["bs_lout"], site["bs_rout"]

    # the leaf's rows to its children, then their histograms (the
    # smaller child's, the sibling by subtraction from the cached parent)
    part = ops.partition(site, leaf, new)
    a_is_left, hist_a, hist_b = mem.children(leaf, new, k, part,
                                             bool(lc <= rc), ops)
    idx_a, idx_b = (leaf, new) if a_is_left else (new, leaf)

    depth = int(site["leaf_depth"]) + 1
    cmin_l, cmax_l, cmin_r, cmax_r = child_constraints(
        int(imeta[feat, IM_MONO]), is_cat, lout, rout, pcmin, pcmax,
        has_monotone)
    o = order_child_pair(a_is_left, k, lg, lh, lc, rg, rh, rc, lout, rout,
                         cmin_l, cmax_l, cmin_r, cmax_r)
    out = ops.scan([hist_a, hist_b],
                   [(o["ga"], o["ha"], o["ca"], o["cmin_a"], o["cmax_a"]),
                    (o["gb"], o["hb"], o["cb"], o["cmin_b"], o["cmax_b"])],
                   (o["salt_a"], o["salt_b"]))
    # the split's one host read: both scan tables (+ the child records)
    table = out.cpu().numpy()
    extra = ops.extra_i(part)
    raw = table
    if cegb is not None:
        table = cegb.children(raw, (o["ca"], o["cb"]), leaf, new, feat,
                              (a_is_left, not a_is_left))
    blocked = max_depth > 0 and depth >= max_depth
    cols, bits = [], []
    for tab, ch, side in ((table[0], "a", o["side_a"]),
                          (table[1], "b", o["side_b"])):
        split = assemble_split(tab)
        if blocked:
            split = split._replace(gain=-inf)
        bits.append(split.cat_bitset)
        cols.append(child_columns(
            split, o["g" + ch], o["h" + ch], o["c" + ch], o["out_" + ch],
            o["cmin_" + ch], o["cmax_" + ch], s, side, depth,
            extra_i=extra[side]))
    treef, treei, pnode, upd = split_node_updates(
        params, site["bs_gain"], feat, thr, dleft, is_cat, pg, ph, pc,
        site["ref_node"], leaf, new)
    pack.set_state_cols(st, idx_a, idx_b, cols[0][0], cols[1][0],
                        cols[0][1], cols[1][1])
    pack.set_tree_col(st, s, treef, treei, pnode, upd, site["ref_side"])
    pack.set_bitsets(st, idx_a, idx_b, bits[0], bits[1], s,
                     site["bs_bitset"])
    if cegb is not None:
        left, right = (raw[0], raw[1]) if a_is_left else (raw[1], raw[0])
        cegb.after_split(pack, st, left, right, blocked, feat, leaf, new)
    return True
