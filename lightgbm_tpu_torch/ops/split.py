"""Numerical best-split search over feature histograms, in PyTorch.

Port of the numerical subset of ``lightgbm_tpu/ops/split.py``
(reference ``FeatureHistogram::FindBestThreshold*``,
feature_histogram.hpp:84-709): the gain algebra, both missing-value
scan directions, min_data / min_hessian validity, monotone bounds,
the per-feature penalty and the reference's tie rules.

``per_feature_numerical`` is the plain version of the split-scan
kernel (``ops/split_scan_cuda.py``); both write the same ``[F, 8]``
table (``scan_table``). One deliberate difference from the JAX
formulation: prefix sums accumulate in float64 and round once per bin
(``_cumsum``), and the right-to-left totals are the last prefix, as in
``split_scan_pallas.scan_core``. ``_cumsum`` adds in the kernel's
fixed order (``csrc/scan_core.cuh:block_prefix6``: 32-bin segments,
then their totals; past 1024 bins windows of 1024 with a float64 carry,
``plane_prefix_carry``) with elementwise float64 adds, so the kernel and
this version round the same double on every device and agree bit for
bit; against the JAX package they differ by float32 rounding only.

Categorical features (``SplitParams.has_categorical``) take their split
from ``ops/split_categorical.py``: ``per_feature_splits`` merges it into
the numerical table per feature, as the JAX ``per_feature_splits``
does, and widens the table by the flag and the left-side bin bitset
(``CAT_TABLE_COLS``), so one host read still brings the whole choice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

kEpsilon = 1e-15
NEG_INF = float("-inf")

MISSING_NONE_CODE = 0
MISSING_ZERO_CODE = 1
MISSING_NAN_CODE = 2

# columns of the [F, 8] i32 per-feature metadata table (imeta,
# ``split_step_cuda.pack_meta_tables``)
IM_NBINS, IM_MISS, IM_DEFBIN, IM_MOSTFREQ, IM_MONO, IM_GROUP, \
    IM_OFFSET, IM_ISCAT = range(8)

# column slots of the [F, 8] per-feature result table
O_SCORE, O_THR, O_LG, O_LH, O_LC, O_DLEFT, O_WL, O_WR = range(8)
# a dataset with categorical features widens it: is_cat, then the
# left-side bin bitset's MAX_CAT_WORDS words as int32 bit patterns
MAX_CAT_WORDS = 8    # categorical features up to 256 bins
O_ISCAT, O_BITS = 8, 9
CAT_TABLE_COLS = O_BITS + MAX_CAT_WORDS


class FeatureMeta(NamedTuple):
    """Static per-feature metadata, numpy arrays of shape [F]."""
    num_bins: np.ndarray       # int32
    missing: np.ndarray        # int32 code
    default_bin: np.ndarray    # int32
    most_freq_bin: np.ndarray  # int32
    monotone: np.ndarray       # int32 in {-1, 0, +1}
    penalty: np.ndarray        # float32
    is_categorical: np.ndarray  # bool
    # EFB: each feature's histogram group and value offset (0 = raw
    # bins); None means unbundled (the identity)
    group: Optional[np.ndarray] = None   # int32
    offset: Optional[np.ndarray] = None  # int32
    # CEGB per-feature penalties (float32 [F]; zeros when unset)
    cegb_coupled_penalty: Optional[np.ndarray] = None
    cegb_lazy_penalty: Optional[np.ndarray] = None


class SplitParams(NamedTuple):
    """Split hyperparameters (python scalars)."""
    lambda_l1: float
    lambda_l2: float
    max_delta_step: float
    min_data_in_leaf: float
    min_sum_hessian_in_leaf: float
    min_gain_to_split: float
    # True when any feature has a missing-value convention: only then
    # can the left-to-right scan win (the reference's one-scan path for
    # MissingType::None otherwise)
    any_missing: bool = True
    # categorical search (ops/split_categorical.py), run only when the
    # dataset has a categorical feature
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    min_data_per_group: float = 100.0
    has_categorical: bool = False
    # cost-effective gradient boosting (``cegb_delta``): on when
    # cegb_tradeoff > 0 and a penalty is set; the lazy penalty alone
    # needs the serial learner's [N, F] charged matrix
    cegb_on: bool = False
    cegb_lazy_on: bool = False
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0


class PerFeatureSplits(NamedTuple):
    """Best split per feature (tensors of shape [F])."""
    score: torch.Tensor       # f32 penalized gain above shift, -inf invalid
    threshold: torch.Tensor   # i64
    left_g: torch.Tensor
    left_h: torch.Tensor      # eps-free
    left_c: torch.Tensor
    default_left: torch.Tensor  # bool
    left_output: torch.Tensor
    right_output: torch.Tensor


class SplitResult(NamedTuple):
    """Best split of one leaf, as host scalars (numpy float32 / int)."""
    gain: np.float32
    feature: int
    threshold: int
    default_left: bool
    left_g: np.float32
    left_h: np.float32
    left_c: np.float32
    left_output: np.float32
    right_output: np.float32
    # a categorical split sends the bins of ``cat_bitset`` ([MAX_CAT_WORDS]
    # uint32) left
    is_cat: bool = False
    cat_bitset: np.ndarray = np.zeros(MAX_CAT_WORDS, np.uint32)


def threshold_l1(s, l1):
    reg = torch.clamp(torch.abs(s) - l1, min=0.0)
    return torch.sign(s) * reg


def leaf_output_no_constraint(g, h, l1, l2, max_delta_step):
    """CalculateSplittedLeafOutput (feature_histogram.hpp:497-504)."""
    out = -threshold_l1(g, l1) / (h + l2)
    if max_delta_step > 0.0:
        out = torch.clamp(out, -max_delta_step, max_delta_step)
    return out


def leaf_output(g, h, l1, l2, max_delta_step, cmin, cmax):
    """Constrained variant (feature_histogram.hpp:527-537)."""
    out = leaf_output_no_constraint(g, h, l1, l2, max_delta_step)
    return torch.minimum(torch.maximum(out, cmin), cmax)


def gain_given_output(g, h, w, l1, l2):
    """GetLeafSplitGainGivenOutput (feature_histogram.hpp:550-553)."""
    sg_l1 = threshold_l1(g, l1)
    return -(2.0 * sg_l1 * w + (h + l2) * w * w)


def leaf_split_gain(g, h, l1, l2, max_delta_step):
    """GetLeafSplitGain (feature_histogram.hpp:545-548)."""
    w = leaf_output_no_constraint(g, h, l1, l2, max_delta_step)
    return gain_given_output(g, h, w, l1, l2)


def _split_gains(gl, hl, gr, hr, p: SplitParams, monotone, cmin, cmax):
    """GetSplitGains (feature_histogram.hpp:507-519)."""
    wl = leaf_output(gl, hl, p.lambda_l1, p.lambda_l2, p.max_delta_step,
                     cmin, cmax)
    wr = leaf_output(gr, hr, p.lambda_l1, p.lambda_l2, p.max_delta_step,
                     cmin, cmax)
    gain = gain_given_output(gl, hl, wl, p.lambda_l1, p.lambda_l2) \
        + gain_given_output(gr, hr, wr, p.lambda_l1, p.lambda_l2)
    violates = ((monotone > 0) & (wl > wr)) | ((monotone < 0) & (wl < wr))
    return torch.where(violates, torch.zeros_like(gain), gain)


def _argmax_first(x, dim=-1):
    """First index of the maximum (jnp.argmax / torch.argmax rule)."""
    return torch.argmax(x, dim=dim)


def _argmax_last(x, dim=-1):
    """Last index of the maximum: the right-to-left scan records the
    LARGEST winning threshold."""
    n = x.shape[dim]
    return n - 1 - torch.argmax(torch.flip(x, dims=(dim,)), dim=dim)


def _warp_scan(v):
    """Inclusive scan over the last axis of 32 lanes: lane i adds lane
    i - o for o = 1, 2, 4, 8, 16 (the kernel's ``warp_scan``)."""
    lane = torch.arange(32, device=v.device)
    for o in (1, 2, 4, 8, 16):
        y = torch.nn.functional.pad(v[..., :-o], (o, 0))
        v = torch.where(lane >= o, v + y, v)
    return v


def _cumsum(x):
    """Prefix sums over the bin axis, accumulated in float64 and
    rounded once per bin (see the module note), in the order of the
    kernel's ``block_prefix6``: 32-bin segments (the last padded with
    zeros) each summed in bin order from 0.0, a warp scan of the segment
    totals, and each bin's running sum plus its segment's exclusive
    offset. Past 1024 bins the segments go in windows of 32 segments
    (the kernel's ``plane_prefix_carry``): window 0 as above, window w > 0
    adds its carry to each exclusive offset, and the carry after a
    window is its total (window 0) or the carry plus its total.
    Elementwise float64 adds only, so every device rounds the same."""
    b = x.shape[-1]
    nseg = -(-b // 32)
    nwin = -(-nseg // 32)
    v = torch.nn.functional.pad(x.double(), (0, nwin * 1024 - b))
    v = v.reshape(*x.shape[:-1], nwin, 32, 32)
    acc = torch.zeros(v.shape[:-1], dtype=torch.float64, device=x.device)
    run = []
    for i in range(32):
        acc = acc + v[..., i]
        run.append(acc)
    run = torch.stack(run, dim=-1)
    incl = _warp_scan(run[..., 31])                     # [..., nwin, 32]
    off = torch.nn.functional.pad(incl[..., :31], (1, 0))
    offs = [off[..., 0, :]]
    carry = incl[..., 0, 31]
    for w in range(1, nwin):
        offs.append(carry[..., None] + off[..., w, :])
        carry = carry + incl[..., w, 31]
    off = torch.stack(offs, dim=-2)
    out = run + off[..., None]
    return out.reshape(*x.shape[:-1], nwin * 1024)[..., :b].float()


def _rand_ok(bins, rand_bins):
    """[F, B]: the bins a feature may split at under extra_trees (its
    rand bin; every bin where it is -1)."""
    rb = rand_bins.to(bins.device).long()[:, None]
    return (rb < 0) | (bins == rb)


def _f32(v, device):
    return torch.as_tensor(np.float32(v), device=device)


def per_feature_numerical(hist: torch.Tensor, parent_g, parent_h, parent_c,
                          meta_t: dict, params: SplitParams,
                          constraint_min=NEG_INF,
                          constraint_max=float("inf"),
                          rand_bins: Optional[torch.Tensor] = None,
                          node_mask: Optional[torch.Tensor] = None
                          ) -> PerFeatureSplits:
    """Per-feature best numerical split of one leaf (plain version of
    the split-scan kernel; ``ops/split.py:per_feature_numerical`` of the
    JAX package).

    ``rand_bins`` [F] (extra_trees, the reference's IS_RAND paths): a
    numerical feature's only candidate threshold in both scan
    directions, -1 for every threshold. ``node_mask`` [F] bool (by-node
    feature sampling) narrows the feature mask for this leaf.

    hist: [F, B, 3] (sum_grad, sum_hess, count) per bin. Parent sums
    and constraints are float32 scalars. ``meta_t`` holds the per-feature
    metadata as tensors on ``hist``'s device (``meta_tensors``):
    num_bins, missing, default_bin, monotone (int) and penalty, fmask
    (fmask = numerical & in the feature mask)."""
    f, b, _ = hist.shape
    dev = hist.device
    p = params
    pg, ph, pc = (_f32(parent_g, dev), _f32(parent_h, dev),
                  _f32(parent_c, dev))
    cmin, cmax = _f32(constraint_min, dev), _f32(constraint_max, dev)
    eps = _f32(kEpsilon, dev)

    bins = torch.arange(b, device=dev)[None, :]                # [1,B]
    nb = meta_t["num_bins"][:, None]                           # [F,1]
    missing = meta_t["missing"][:, None]
    default_bin = meta_t["default_bin"][:, None]
    monotone = meta_t["monotone"][:, None]

    parent_h_eps = ph + _f32(2.0 * kEpsilon, dev)
    gain_shift = leaf_split_gain(pg, parent_h_eps, p.lambda_l1,
                                 p.lambda_l2, p.max_delta_step)
    min_gain_shift = gain_shift + _f32(p.min_gain_to_split, dev)
    min_data = _f32(p.min_data_in_leaf, dev)
    min_hess = _f32(p.min_sum_hessian_in_leaf, dev)
    g, h, c = hist[..., 0], hist[..., 1], hist[..., 2]
    zero = torch.zeros((), dtype=hist.dtype, device=dev)
    ninf = torch.full((), NEG_INF, dtype=hist.dtype, device=dev)

    if p.any_missing:
        two_scan = (missing != MISSING_NONE_CODE) & (nb > 2)
        skip_default = two_scan & (missing == MISSING_ZERO_CODE) \
            & (bins == default_bin)
        na_excl = two_scan & (missing == MISSING_NAN_CODE)
        is_na_bin = na_excl & (bins == nb - 1)

        # ---- dir=+1: left-to-right; default/NaN implicitly go right ----
        lg_p = _cumsum(torch.where(skip_default, zero, g))
        hl_p = _cumsum(torch.where(skip_default, zero, h)) + eps
        lc_p = _cumsum(torch.where(skip_default, zero, c))
        hr_p = parent_h_eps - hl_p
        gr_p = pg - lg_p
        cr_p = pc - lc_p
        valid_p = two_scan & (bins <= nb - 2) & ~skip_default
        if rand_bins is not None:
            valid_p &= _rand_ok(bins, rand_bins)
        valid_p &= (lc_p >= min_data) & (cr_p >= min_data)
        valid_p &= (hl_p >= min_hess) & (hr_p >= min_hess)
        gains_p = _split_gains(lg_p, hl_p, gr_p, hr_p, p, monotone,
                               cmin, cmax)
        score_p = torch.where(valid_p & (gains_p > min_gain_shift),
                              gains_p, ninf)
        mask_m = skip_default | is_na_bin
        g_m = torch.where(mask_m, zero, g)
        h_m = torch.where(mask_m, zero, h)
        c_m = torch.where(mask_m, zero, c)
    else:
        g_m, h_m, c_m = g, h, c

    # ---- dir=-1: right-to-left; default/NaN implicitly go left ---------
    cs_g, cs_h, cs_c = _cumsum(g_m), _cumsum(h_m), _cumsum(c_m)
    rg_m = cs_g[:, b - 1:b] - cs_g
    hr_m = (cs_h[:, b - 1:b] - cs_h) + eps
    rc_m = cs_c[:, b - 1:b] - cs_c
    gl_m = pg - rg_m
    hl_m = parent_h_eps - hr_m
    cl_m = pc - rc_m
    if p.any_missing:
        valid_m = bins <= nb - 2 - na_excl.to(nb.dtype)
        # zero-missing skips threshold default_bin-1
        # (feature_histogram.hpp:577)
        valid_m = valid_m & ~(two_scan & (missing == MISSING_ZERO_CODE)
                              & (bins == default_bin - 1))
    else:
        valid_m = bins <= nb - 2
    if rand_bins is not None:
        valid_m = valid_m & _rand_ok(bins, rand_bins)
    valid_m = valid_m & (cl_m >= min_data) & (rc_m >= min_data)
    valid_m = valid_m & (hl_m >= min_hess) & (hr_m >= min_hess)
    gains_m = _split_gains(gl_m, hl_m, rg_m, hr_m, p, monotone, cmin, cmax)
    score_m = torch.where(valid_m & (gains_m > min_gain_shift), gains_m,
                          ninf)

    # ---- per-feature best with reference iteration-order tie-breaks ----
    t_m = _argmax_last(score_m, dim=1)                         # [F]
    v_m = torch.gather(score_m, 1, t_m[:, None])[:, 0]
    lf = torch.stack([torch.gather(x, 1, t_m[:, None])[:, 0]
                      for x in (gl_m, hl_m, cl_m)])            # [3, F]
    if p.any_missing:
        t_p = _argmax_first(score_p, dim=1)
        v_p = torch.gather(score_p, 1, t_p[:, None])[:, 0]
        use_m = v_m >= v_p
        feat_gain = torch.where(use_m, v_m, v_p)
        feat_t = torch.where(use_m, t_m, t_p)
        lf_p = torch.stack([torch.gather(x, 1, t_p[:, None])[:, 0]
                            for x in (lg_p, hl_p, lc_p)])
        lf = torch.where(use_m[None, :], lf, lf_p)
    else:
        use_m = torch.ones((f,), dtype=torch.bool, device=dev)
        feat_gain = v_m
        feat_t = t_m
    lg_f, lh_f, lc_f = lf[0], lf[1], lf[2]

    feat_valid = torch.isfinite(feat_gain) & (meta_t["fmask"] > 0)
    if node_mask is not None:
        feat_valid = feat_valid & node_mask
    feat_score = torch.where(
        feat_valid, (feat_gain - min_gain_shift) * meta_t["penalty"], ninf)
    # default direction: -1 scan => left; 2-bin NaN fix goes right
    # (feature_histogram.hpp:127-130)
    dleft_f = use_m & ~((meta_t["num_bins"] <= 2)
                        & (meta_t["missing"] == MISSING_NAN_CODE))
    wl_f = leaf_output(lg_f, lh_f, p.lambda_l1, p.lambda_l2,
                       p.max_delta_step, cmin, cmax)
    wr_f = leaf_output(pg - lg_f, parent_h_eps - lh_f, p.lambda_l1,
                       p.lambda_l2, p.max_delta_step, cmin, cmax)
    return PerFeatureSplits(
        score=feat_score, threshold=feat_t, left_g=lg_f,
        left_h=lh_f - eps, left_c=lc_f, default_left=dleft_f,
        left_output=wl_f, right_output=wr_f)


def scan_table(pf: PerFeatureSplits) -> torch.Tensor:
    """PerFeatureSplits -> the kernel's [F, 8] table (left_h stored with
    its kEpsilon seed, as ``split_scan_pallas`` stores it)."""
    eps = _f32(kEpsilon, pf.score.device)
    return torch.stack([
        pf.score, pf.threshold.float(), pf.left_g, pf.left_h + eps,
        pf.left_c, pf.default_left.float(), pf.left_output,
        pf.right_output], dim=1)


def table_splits(table) -> PerFeatureSplits:
    """[F, 8] table (tensor) -> PerFeatureSplits, undoing the seed."""
    eps = _f32(kEpsilon, table.device)
    return PerFeatureSplits(
        score=table[:, O_SCORE], threshold=table[:, O_THR].long(),
        left_g=table[:, O_LG], left_h=table[:, O_LH] - eps,
        left_c=table[:, O_LC], default_left=table[:, O_DLEFT] > 0.5,
        left_output=table[:, O_WL], right_output=table[:, O_WR])


def assemble_split(table: np.ndarray) -> SplitResult:
    """Best feature of one leaf from its host [F, 8] (or, with categorical
    features, [F, CAT_TABLE_COLS]) table: first-index argmax over scores
    (``_argmax_first``), then that feature's row."""
    best_f = int(np.argmax(table[:, O_SCORE]))
    row = table[best_f]
    cat = {}
    if table.shape[1] > O_ISCAT:
        cat = dict(is_cat=bool(row[O_ISCAT] > 0.5),
                   cat_bitset=np.ascontiguousarray(
                       row[O_BITS:O_BITS + MAX_CAT_WORDS]).view(np.uint32))
    return SplitResult(
        gain=np.float32(row[O_SCORE]), feature=best_f,
        threshold=int(row[O_THR]), default_left=bool(row[O_DLEFT] > 0.5),
        left_g=np.float32(row[O_LG]),
        left_h=np.float32(row[O_LH]) - np.float32(kEpsilon),
        left_c=np.float32(row[O_LC]),
        left_output=np.float32(row[O_WL]),
        right_output=np.float32(row[O_WR]), **cat)


def per_feature_splits(table: torch.Tensor, hists, leaves, meta_t: dict,
                       params: SplitParams,
                       node_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The numerical scan's [K, F, 8] ``table`` of K leaves merged, per
    feature, with the categorical search of the same leaves
    (``per_feature_splits`` of the JAX package): a categorical feature
    takes its categorical score, left sums and outputs, default_left
    False and keeps the scan's threshold; every feature gets the is_cat
    flag and the left bin bitset. Returns [K, F, CAT_TABLE_COLS] on the
    table's device; the table itself when no feature is categorical.
    ``node_mask`` [K, F] bool narrows each leaf's categorical features
    (by-node sampling; the numerical ones are narrowed by the scan)."""
    if not params.has_categorical:
        return table
    from .split_categorical import per_feature_categorical
    cat = per_feature_categorical(hists, leaves, meta_t, params, node_mask)
    use = meta_t["is_cat"][None, :]
    cols = []
    for col, key in ((O_SCORE, "score"), (O_THR, None), (O_LG, "left_g"),
                     (O_LH, "left_h_eps"), (O_LC, "left_c"),
                     (O_DLEFT, "default_left"), (O_WL, "left_output"),
                     (O_WR, "right_output")):
        cols.append(table[..., col] if key is None
                    else torch.where(use, cat[key], table[..., col]))
    cols.append((use & torch.isfinite(cat["score"])).to(torch.float32))
    bits = torch.where(use[..., None], cat["bitset"], 0).to(
        torch.int32).view(torch.float32)
    return torch.cat([torch.stack(cols, dim=-1), bits], dim=-1)


def best_split_numerical(hist, parent_g, parent_h, parent_c, meta_t,
                         params, constraint_min=NEG_INF,
                         constraint_max=float("inf")) -> SplitResult:
    """Best numerical split over all features of one leaf."""
    pf = per_feature_numerical(hist, parent_g, parent_h, parent_c, meta_t,
                               params, constraint_min, constraint_max)
    return assemble_split(scan_table(pf).cpu().numpy())


def meta_tensors(meta: FeatureMeta, device, feature_mask=None) -> dict:
    """Per-feature metadata as tensors for the scans (and, ``group`` and
    ``offset``, for the debundle). ``fmask`` is
    numerical-and-in-mask as float (the kernel's fmeta column);
    ``is_cat`` the categorical flag and ``catmask`` categorical, in the
    mask and at most 256 bins (the widest bitset), both bool, for the
    categorical search."""
    is_cat = np.asarray(meta.is_categorical, bool)
    inmask = np.ones(len(is_cat), bool) if feature_mask is None \
        else np.asarray(feature_mask, bool)
    fmask = ~is_cat & inmask
    catmask = is_cat & inmask & (np.asarray(meta.num_bins)
                                 <= 32 * MAX_CAT_WORDS)
    as_t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,  # noqa: E731
                                         device=device)
    f = len(is_cat)
    return dict(
        group=as_t(np.arange(f) if meta.group is None else meta.group,
                   torch.int64),
        offset=as_t(np.zeros(f) if meta.offset is None else meta.offset,
                    torch.int64),
        num_bins=as_t(meta.num_bins, torch.int32),
        missing=as_t(meta.missing, torch.int32),
        default_bin=as_t(meta.default_bin, torch.int32),
        monotone=as_t(meta.monotone, torch.int32),
        penalty=as_t(meta.penalty, torch.float32),
        fmask=as_t(fmask.astype(np.float32), torch.float32),
        is_cat=as_t(is_cat, torch.bool), catmask=as_t(catmask, torch.bool))
