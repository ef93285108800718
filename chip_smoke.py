#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``. It needs a
CUDA device and ``nvcc`` (the kernels are built from
``lightgbm_tpu_torch/csrc`` at first use) and imports nothing of JAX or
of the JAX package. Phases, each fatal on failure:

1. build the kernel library and report the build time;
2. hold every kernel against its plain PyTorch version on the card at
   the main paths' shapes and time both, beside the least time the card
   could take and one PyTorch library call computing the same function
   where there is one: the histogram, partition, scan and segment fused
   step on the 2M x 28 u8 training matrix (256 bins; the fused step at
   the root, at a mid-tree split whose smaller child has several
   histogram chunks and at a late one whose smaller child has one, and
   a whole tree's average launch), then the scan at 1023 bins and the leaf fused step's
   root split of the 2M x 28 bin matrix at 1023 bins (u16) and at 255
   (u8);
3. train the Higgs-shaped binary model at full width (2M x 28,
   max_bin=255, num_leaves=255, lr=0.1, 8 iterations) through
   ``lightgbm_tpu_torch.train`` twice: the fused path (the default,
   the partitioned learner) and the per-phase path
   (``fused_split_kernel="off"``). Both must grow trees of the same
   structure; one more fused tree runs its L - 1 launches under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync in the
   split loop); the launch counters show that every kernel of each
   path ran;
4. the same at ``max_bin=1023``, which ``create_tree_learner`` gives to
   the serial (leaf_id) learner: fused (one leaf-kernel launch per
   split) and per-phase, the same trees, one more fused tree under the
   sync checker, and the launch counters;
5. leaf against segment: at max_bin=255, 3 trees through a
   ``SerialTreeLearner`` constructed directly (the leaf kernel) and
   through the default ``PartitionedTreeLearner`` (the segment kernel):
   bitwise the same trees on gradients whose sums are exact, and on
   binary gradients, tree by tree from one score, the same structure up
   to the first tie within float rounding of a tree;
6. the fixed quality config (50k x 28, 63 leaves, 100 iterations)
   must reach in-sample AUC >= 0.97906 - 0.002
   (BENCH_QUALITY_BASELINE.json) on the partitioned fused path at
   max_bin=255 and on the serial fused path at max_bin=1023;
7. a 100k-row, 3-tree run through the kernels (fused path) must grow the
   same trees as the same run through the plain versions on the card,
   at max_bin=255 and at max_bin=1023.

The second-to-last line of output is the per-kernel JSON record; the
last line is ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

F, B = 28, 256
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores


def higgs_like(n: int, f: int = F, seed: int = 42):
    """The synthetic Higgs-shaped problem of bench.py (seed 42)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)

    def c(i):
        return X[:, i % f]

    logit = (2.0 * c(0) - 1.5 * c(1) + c(2) * c(3)
             + 0.8 * c(4) * c(5) - c(6))
    y = (logit + rng.randn(n).astype(np.float32) > 0).astype(np.float32)
    return X, y


def auc(y: np.ndarray, s: np.ndarray) -> float:
    """Rank AUC with average ranks for ties."""
    from scipy.stats import rankdata
    r = rankdata(s)
    pos = y > 0
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((r[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def time_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events),
    after one warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check_hist(mat, n, reps):
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    worst = 0.0
    # the whole matrix, a large inner segment, and segments at the chunk
    # rule's edges: one chunk exactly, one row over, past the chunk cap
    cap = hc.max_chunks(F) * hc.CHUNK_ROWS + 1
    for begin, count in ((0, n), (n // 16 + 7, n // 2 + 3),
                         (0, hc.CHUNK_ROWS), (5, hc.CHUNK_ROWS + 1),
                         (3, min(cap, n - 3))):
        ref = hc.histogram_segment_plain(mat, begin, count, B, F)
        scale = hc.histogram_segment_plain(mat, begin, count, B, F,
                                           absolute=True)
        for variant in hc.VARIANTS:
            out = hc.histogram_segment(mat, begin, count, B, F,
                                       variant=variant)
            again = hc.histogram_segment(mat, begin, count, B, F,
                                         variant=variant)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                fail(f"histogram not bitwise repeatable ({variant})")
            err = (out - ref).abs()
            if not torch.equal(out[..., 2], ref[..., 2]):
                fail(f"histogram counts differ ({variant}, {begin})")
            tol = 1e-5 * scale + 1e-6
            if bool((err > tol).any()):
                fail(f"histogram off by {float(err.max())} ({variant})")
            worst = max(worst, float(err.max()))
        # the same segment on the device, launched for a larger bound (a
        # child sized by its parent): the chunks come from its own count
        seg = torch.tensor([begin, count], dtype=torch.int32,
                           device=mat.device)
        bound = hc.histogram_segment(mat, seg, None, B, F, max_count=n)
        if not torch.equal(bound.view(torch.int32), out.view(torch.int32)):
            fail(f"histogram of a device segment ({begin}+{count}) differs "
                 "with a larger bound")
    # timings on the full segment: kernel, plain, one index_add_ call
    ms = time_ms(lambda: hc.histogram_segment(mat, 0, n, B, F), reps)
    plain_ms = time_ms(
        lambda: hc.histogram_segment_plain(mat, 0, n, B, F), 3)
    g, h, c = hc.decode_payload(mat, F)
    keys = (mat[:, :F].long()
            + torch.arange(F, device=mat.device) * B).reshape(-1)
    vals = torch.stack([g, h, c], 1).repeat_interleave(F, 0)
    lib_out = torch.zeros((F * B, 3), device=mat.device)
    library_ms = time_ms(lambda: lib_out.index_add_(0, keys, vals), reps)
    del keys, vals
    nbytes = n * (F + 9) + F * B * 3 * 4
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")


def check_partition(mat, n, reps):
    import torch
    from lightgbm_tpu_torch.ops import partition_cuda as pc
    from lightgbm_tpu_torch.ops.partition import rows_go_left
    ws = torch.empty_like(mat)
    bits = np.zeros(8, np.uint32)
    for cat in (1, 7, 13, 40, 100, 200, 254):
        bits[cat // 32] |= np.uint32(1 << (cat % 32))
    lut = pc.bitset_to_lut(bits).to(mat.device)
    cases = [  # (feat, thr, dleft, missing code, default bin, is_cat)
        (3, 127, 0, 0, 0, False), (5, 90, 1, 1, 128, False),
        (7, 160, 1, 2, 0, False), (9, 40, 0, 2, 0, False),
        (11, 0, 0, 0, 0, True)]
    for begin, count in ((0, n), (n // 16 + 7, n // 2 + 3)):
        for feat, thr, dl, miss, dbin, is_cat in cases:
            m1, m2 = mat.clone(), mat.clone()
            s1 = pc.partition_segment(m1, ws, begin, count, feat, thr, dl,
                                      miss, dbin, B, is_cat, lut)
            s2 = pc.partition_segment_plain(m2, None, begin, count, feat,
                                            thr, dl, miss, dbin, B, is_cat,
                                            lut)
            torch.cuda.synchronize()
            if not torch.equal(s1, s2) or not torch.equal(m1, m2):
                fail(f"partition differs (feat {feat}, missing {miss}, "
                     f"lut {is_cat}, segment {begin}+{count})")
            del m1, m2
    work = mat.clone()
    args = (0, n, 3, 127, 0, 0, 0, B, False, None)
    ms = time_ms(lambda: pc.partition_segment(work, ws, *args), reps)
    plain_ms = time_ms(lambda: pc.partition_segment_plain(work, ws, *args),
                       3)
    right = ~rows_go_left(work[:, 3], 127, 0, 0, 0, B)

    def library():
        order = torch.argsort(right.to(torch.uint8), stable=True)
        work.copy_(work[order])
    library_ms = time_ms(library, reps)
    # a stable partition reads the segment once and writes it once
    nbytes = 2 * n * mat.shape[1]
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")


def check_scan(hists, dataset, b, reps):
    """The scan kernel on two children's [F, b, 3] histograms against its
    plain version, with every missing convention, monotone bounds, L1,
    max_delta_step and a masked feature."""
    import torch
    from lightgbm_tpu_torch.learner.partitioned import (
        feature_meta_from_dataset, split_params_from_config)
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops import split_scan_cuda as sc
    from lightgbm_tpu_torch.ops.split import O_SCORE, O_THR, O_DLEFT, \
        meta_tensors
    dev = hists[0].device
    leaves = []
    for h in hists:
        s = h[0].sum(0).cpu().numpy().astype(np.float32)
        leaves.append((s[0], s[1], s[2], np.float32(-np.inf),
                       np.float32(np.inf)))
    base = feature_meta_from_dataset(dataset)
    cfg = Config.from_params({"objective": "binary", "verbosity": -1})
    nomiss = (base, split_params_from_config(cfg, any_missing=False),
              leaves)
    # a feature mix with every missing convention, monotone bounds,
    # L1 and max_delta_step, one feature masked off
    miss = np.arange(F, dtype=np.int32) % 3
    meta2 = base._replace(
        missing=miss, default_bin=np.full(F, b // 2, np.int32),
        monotone=np.asarray([(i % 5 == 0) - (i % 7 == 0)
                             for i in range(F)], np.int32))
    p2 = split_params_from_config(Config.from_params({
        "objective": "binary", "verbosity": -1, "lambda_l1": 0.5,
        "lambda_l2": 1.0, "max_delta_step": 0.7}), any_missing=True)
    leaves2 = [leaves[0], leaves[1][:3] + (np.float32(-0.05),
                                           np.float32(0.05))]
    worst = 0.0
    for meta, params, lv in (nomiss, (meta2, p2, leaves2)):
        mask = np.ones(F, bool)
        mask[4] = meta is not meta2
        meta_t = meta_tensors(meta, dev, mask)
        k = sc.per_feature_numerical_cuda(hists, lv, meta_t, params)
        p = sc.per_feature_numerical_plain(hists, lv, meta_t, params)
        k, p = k.cpu().numpy(), p.cpu().numpy()
        fin = np.isfinite(p[..., O_SCORE])
        if not np.array_equal(fin, np.isfinite(k[..., O_SCORE])):
            fail(f"scan ({b} bins): valid features differ")
        for col in (O_THR, O_DLEFT):
            if not np.array_equal(k[..., col][fin], p[..., col][fin]):
                fail(f"scan ({b} bins): column {col} differs")
        kv, pv = k[fin], p[fin]
        if not np.allclose(kv, pv, rtol=1e-5, atol=1e-6):
            fail(f"scan ({b} bins) values differ by {np.abs(kv - pv).max()}")
        worst = max(worst, float(np.abs(kv - pv).max()))
    meta_t = meta_tensors(base, dev)
    tables = sc.scan_meta_tables(meta_t)
    params = nomiss[1]
    ms = time_ms(lambda: sc.per_feature_numerical_cuda(
        hists, leaves, meta_t, params, tables), reps)
    plain_ms = time_ms(lambda: sc.per_feature_numerical_plain(
        hists, leaves, meta_t, params), reps)
    nbytes = 2 * F * b * 3 * 4 + 2 * F * 8 * 4
    # per bin and direction: ~4 prefix adds, ~40 flops of gain algebra
    ops = 2 * F * b * 2 * 44
    bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / F32_FLOPS else "operations")


def check_fused(mat, n, dataset, reps):
    """The segment fused kernel against its plain version fed the
    per-phase histogram kernel, at three splits of one tree grown by the
    kernel from the matrix: the root (k = 1), a mid-tree split whose
    smaller child has more than one histogram chunk, and a late split
    whose smaller child is one chunk (a direct cache write). At each:
    S, T, k, the matrix and the histogram cache bitwise equal to the
    plain version's, and the kernel bitwise repeatable. The root's
    child histograms are also held against the float64 plain
    histograms. Then the root split's time, and one whole tree of L - 1
    launches from the root between two CUDA events (the tree-average
    time per launch)."""
    import torch
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.learner.partitioned import (
        dataset_any_missing, feature_meta_from_dataset,
        split_params_from_config)
    from lightgbm_tpu_torch.learner.split_step import (SEG_SI_PREFIX,
                                                       make_grow_pack,
                                                       root_state)
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import split_scan_cuda as sc
    from lightgbm_tpu_torch.ops import split_step_cuda as ss
    from lightgbm_tpu_torch.ops.split import meta_tensors
    dev, big_l = mat.device, 255
    meta = feature_meta_from_dataset(dataset)
    params = split_params_from_config(
        Config.from_params({"objective": "binary", "verbosity": -1}),
        dataset_any_missing(dataset))
    pack = make_grow_pack(SEG_SI_PREFIX, has_monotone=False, big_l=big_l)
    meta_t = meta_tensors(meta, dev)
    imeta, fmeta = ss.pack_meta_tables(meta, None, dev)
    hist0 = torch.zeros((big_l, F, B, 3), device=dev)
    hist0[0] = hc.histogram_segment(mat, 0, n, B, F)
    sums = hist0[0, 0].sum(0).cpu().numpy()
    root = tuple(np.float32(v) for v in sums)
    table = sc.per_feature_numerical_cuda(
        [hist0[0]], [root + (np.float32(-np.inf), np.float32(np.inf))],
        meta_t, params)[0]
    st0 = root_state(pack, table, *root, n, params, big_l)
    k0 = torch.ones((1,), dtype=torch.int32, device=dev)
    kw = dict(params=params, big_l=big_l, max_depth=-1, b=B, f=F,
              has_monotone=False)
    scratch = ss.FusedScratch(mat, F, B)
    ws = torch.empty_like(mat)
    start = [k0, st0["S"], st0["T"], mat, hist0]
    state = [t.clone() for t in start]

    def restore(src):
        for dst, t in zip(state, src):
            dst.copy_(t)

    def kernel():
        k, S, T, m, h = state
        ss.fused_split_step_segment(k, S, T, m, ws, h, imeta, fmeta,
                                    scratch=scratch, **kw)

    def plain(per_phase_hist):
        k, S, T, m, h = state
        fn = (lambda mm, bg, ct, mc: hc.histogram_segment(
            mm, bg, ct, B, F, max_count=mc)) if per_phase_hist else None
        ss.fused_split_step_segment_plain(k, S, T, m, ws, h, imeta, fmeta,
                                          histogram=fn, **kw)

    names = ("k", "S", "T", "mat", "hist")

    dead_rows = [pack.sf_idx[f] for f in ("bs_lg", "bs_lh", "bs_lc",
                                           "bs_lout", "bs_rout")]

    def agree(src, what):
        """One split from src through the kernel twice and through the
        plain version fed the per-phase histogram kernel: all bitwise
        equal, except the split fields of a leaf without a valid split
        (bs_gain -inf in both; ROADMAP Queue 3: the scan's outputs at an
        invalid threshold, 0/0 or x/0, which nothing reads), as
        ``check_fused_leaf`` skips them. Returns the kernel's state."""
        restore(src)
        kernel()
        torch.cuda.synchronize()
        got = [t.clone() for t in state]
        for again in (True, False):
            restore(src)
            if again:
                kernel()
            else:
                plain(True)
            torch.cuda.synchronize()
            for name, a, b in zip(names, got, state):
                a, b = a.view(torch.uint8), b.view(torch.uint8)
                if name == "S" and not again:
                    gain = pack.sf_idx["bs_gain"]
                    dead = torch.isneginf(got[1][gain]) \
                        & torch.isneginf(state[1][gain])
                    a, b = got[1].clone(), state[1].clone()
                    for row in dead_rows:
                        a[row, dead] = 0.0
                        b[row, dead] = 0.0
                    a, b = a.view(torch.uint8), b.view(torch.uint8)
                if not torch.equal(a, b):
                    fail(f"fused split step ({what}): {name} "
                         + ("not bitwise repeatable" if again else
                            "differs from its plain version"))
        if int(got[0][0]) != int(src[0][0]) + 1:
            fail(f"fused split step did not split ({what})")
        return got

    def next_small(st):
        """The smaller child's rows of the split the kernel takes next
        (from S on the host: the first open leaf of the largest gain)."""
        v = pack.view({"S": st[1].cpu(), "T": st[2].cpu()})
        k = int(st[0][0])
        gain = np.asarray(v["bs_gain"])[:k]
        leaf = int(np.argmax(gain))
        lc = float(v["bs_lc"][leaf])
        return k, float(gain[leaf]), int(min(lc, float(v["leaf_c"][leaf])
                                             - lc))

    got = agree(start, "root split")
    # the root's child histograms against the float64 plain histograms.
    # Leaf 0 holds the left child, leaf 1 the right; the smaller one is
    # built from its own rows and held to its own sum of |values|, the
    # sibling is parent - child and so to the parent's.
    v = pack.view({"S": got[1], "T": got[2]})
    segs = [(int(v["leaf_begin"][i]), int(v["leaf_cnt"][i])) for i in (0, 1)]
    small = 0 if segs[0][1] <= segs[1][1] else 1
    scales = [hc.histogram_segment_plain(got[3], bg, ct, B, F, absolute=True)
              for bg, ct in segs]
    scales[1 - small] = scales[0] + scales[1]
    worst = 0.0
    for leaf, (bg, ct) in enumerate(segs):
        ref = hc.histogram_segment_plain(got[3], bg, ct, B, F)
        err = (got[4][leaf] - ref).abs()
        if bool((err > 1e-5 * scales[leaf] + 1e-6).any()):
            fail(f"fused child histogram {leaf} off by {float(err.max())}")
        worst = max(worst, float(err.max()))

    def timed(fn, count, src):
        times = []
        for _ in range(count):
            restore(src)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    restore(start)
    kernel()   # warm-up
    ms = timed(kernel, reps, start)
    plain_ms = timed(lambda: plain(False), 3, start)
    # one whole tree from the root, its launches between two events
    restore(start)
    a = torch.cuda.Event(enable_timing=True)
    c = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(big_l - 1):
        kernel()
    c.record()
    torch.cuda.synchronize()
    splits = int(state[0][0]) - 1
    tree_ms = a.elapsed_time(c) / (big_l - 1)
    # the same tree split by split: the state before the first split
    # from 100 on whose smaller child has more than one chunk, and
    # before the first from 200 on whose smaller child is one chunk (or,
    # if none is, the smallest such child from 150 on)
    restore(start)
    snaps, best_late = {}, None
    while len(snaps) < 2:
        k, gain, n_small = next_small(state)
        if k >= big_l or gain <= 0:
            break
        if "mid" not in snaps and k >= 101 \
                and hc.child_chunks(n_small, F) > 1:
            snaps["mid"] = ([t.clone() for t in state], n_small)
        if "late" not in snaps and k >= 201 \
                and hc.child_chunks(n_small, F) == 1:
            snaps["late"] = ([t.clone() for t in state], n_small)
        elif "late" not in snaps and k >= 151 and (
                best_late is None or n_small < best_late[1]):
            best_late = ([t.clone() for t in state], n_small)
        kernel()
    snaps.setdefault("late", best_late)
    split_ms = {}
    for name, snap in snaps.items():
        if snap is None:
            fail(f"no {name} split in the tree")
        src, n_small = snap
        what = f"split {int(src[0][0])}, smaller child {n_small} rows"
        agree(src, what)
        split_ms[name] = dict(split=int(src[0][0]), n_small=n_small,
                              chunks=hc.child_chunks(n_small, F),
                              ms=timed(kernel, reps, src))
    # the parent's segment read once and written once (the smaller
    # child's histogram can come from rows already being read), the
    # parent's cache row read and both children's written
    nbytes = 2 * n * mat.shape[1] + 3 * F * B * 3 * 4
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes", launch_shape=scratch.shape,
                root_small=segs[small][1], tree_avg_ms=tree_ms,
                tree_splits=splits, splits=split_ms)


def segment_summary(r):
    parts = ", ".join(f"{name} split {d['split']} {d['ms']:.4f} ms "
                      f"(smaller child {d['n_small']} rows, {d['chunks']} "
                      "chunks)" for name, d in r["splits"].items())
    return (f"root split {r['ms']:.4f} ms (smaller child "
            f"{r['root_small']} rows), {parts}, tree average "
            f"{r['tree_avg_ms']:.4f} ms per launch over "
            f"{r['tree_splits']} splits;")


def leaf_bound_ms(n, n_leaf, n_right, n_small, f, b, bin_bytes):
    """Least time of one leaf split: leaf_id read once and the
    right-going rows' ids written, the split feature's bin of the leaf's
    rows, the smaller child's bins and ghc (12 B), the parent's cache
    row read and both children's written."""
    nbytes = (4 * n + 4 * n_right + bin_bytes * n_leaf
              + n_small * (f * bin_bytes + 12) + 3 * f * b * 3 * 4)
    return nbytes / HBM_BYTES_PER_S * 1e3


def check_fused_leaf(binned, ghc, dataset, b, reps):
    """The root split (k = 1) of the [n, F] bin matrix (u8, or the int16
    bits of u16 bins) through the leaf kernel and through its plain
    version from the same state: k, leaf_id and the int rows of S and T
    bitwise equal, the float rows at rtol 1e-5 / atol 1e-5, and both
    child histograms within 1e-5 x sum|x| of the float64 plain
    histograms (the smaller child's own rows for it, the parent's for
    the sibling, which is parent - child). Then one whole tree of L - 1
    launches from the root between two CUDA events (the tree-average
    time per launch), and a small split: the state after 200 splits is
    kept, and the 201st split is held against its plain version and
    timed from it."""
    import torch
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.learner.partitioned import (
        dataset_any_missing, feature_meta_from_dataset,
        split_params_from_config)
    from lightgbm_tpu_torch.learner.split_step import (make_grow_pack,
                                                       root_state)
    from lightgbm_tpu_torch.ops import split_scan_cuda as sc
    from lightgbm_tpu_torch.ops import split_step_cuda as ss
    from lightgbm_tpu_torch.ops.histogram import build_histogram
    from lightgbm_tpu_torch.ops.split import meta_tensors
    dev, big_l = binned.device, 255
    n = binned.shape[0]
    meta = feature_meta_from_dataset(dataset)
    params = split_params_from_config(
        Config.from_params({"objective": "binary", "verbosity": -1}),
        dataset_any_missing(dataset))
    pack = make_grow_pack((), has_monotone=False, big_l=big_l)
    imeta, fmeta = ss.pack_meta_tables(meta, None, dev)
    hist0 = torch.zeros((big_l, F, b, 3), device=dev)
    hist0[0] = build_histogram(binned, ghc, b)
    root = tuple(np.float32(v) for v in hist0[0, 0].sum(0).cpu().numpy())
    table = sc.per_feature_numerical_cuda(
        [hist0[0]], [root + (np.float32(-np.inf), np.float32(np.inf))],
        meta_tensors(meta, dev), params)[0]
    st0 = root_state(pack, table, *root, n, params, big_l)
    k0 = torch.ones((1,), dtype=torch.int32, device=dev)
    lid0 = torch.zeros(n, dtype=torch.int32, device=dev)
    kw = dict(params=params, big_l=big_l, max_depth=-1, b=b,
              has_monotone=False)
    scratch = ss.LeafScratch(binned, b)
    start = [k0, st0["S"], st0["T"], lid0, hist0]
    state = [t.clone() for t in start]

    def restore(src):
        for dst, t in zip(state, src):
            dst.copy_(t)

    def kernel():
        ss.fused_split_step_leaf(*state, binned, ghc, imeta, fmeta,
                                 scratch=scratch, **kw)

    def plain():
        ss.fused_split_step_leaf_plain(*state, binned, ghc, imeta, fmeta,
                                       **kw)

    def agree(src, what, gain_size=False):
        """One split from src through the kernel twice (bitwise the
        same) and through the plain version; returns the kernel's state
        and the worst child-histogram error. With ``gain_size`` the gain
        rows (S bs_gain, T split gain) are held to 1e-5 x (|gain| + the
        leaf's g**2 / h) + 1e-5, as tests/test_torch_fused_leaf.py holds
        them: a gain is a difference of terms of that size, so it
        carries their float32 rounding (ROADMAP Queue 3); and a leaf
        whose gain is -inf in both has no split, so its split fields
        are not compared."""
        restore(src)
        kernel()
        torch.cuda.synchronize()
        got = [t.clone() for t in state]
        restore(src)
        kernel()
        torch.cuda.synchronize()
        for name, a, c in zip(("k", "S", "T", "lid", "hist"), got, state):
            if not torch.equal(a.view(torch.uint8), c.view(torch.uint8)):
                fail(f"leaf kernel ({b} bins, {what}): {name} not bitwise "
                     "repeatable")
        restore(src)
        plain()
        torch.cuda.synchronize()
        if int(got[0][0]) != int(src[0][0]) + 1:
            fail(f"leaf kernel ({b} bins) did not split ({what})")
        nf = len(pack.sf_fields)
        if not torch.equal(got[0], state[0]) or not torch.equal(got[3],
                                                                state[3]):
            fail(f"leaf kernel ({b} bins, {what}): k or leaf_id differs "
                 "from plain")
        S_, T_ = state[1], state[2]
        g = S_[pack.sf_idx["leaf_g"]]
        h = torch.clamp(S_[pack.sf_idx["leaf_h"]], min=1e-3)
        v = T_[pack.tf_idx["internal_value"]]
        w = T_[pack.tf_idx["internal_weight"]]
        sizes = {"S": (pack.sf_idx["bs_gain"], g * g / h),
                 "T": (pack.tf_idx["split_gain_arr"], v * v * w.abs())}
        for name, a, c, nfl in (("S", got[1], S_, nf), ("T", got[2], T_, 4)):
            if not torch.equal(a[nfl:].view(torch.int32),
                               c[nfl:].view(torch.int32)):
                fail(f"leaf kernel ({b} bins, {what}): int rows of {name} "
                     "differ")
            fa, fc = a[:nfl].clone(), c[:nfl].clone()
            if gain_size:
                row, size = sizes[name]
                ga, gc = fa[row], fc[row]
                fin = torch.isfinite(gc)
                if not torch.equal(torch.isfinite(ga), fin) \
                        or not torch.equal(ga[~fin], gc[~fin]) \
                        or bool(((ga - gc).abs()[fin] > 1e-5 * (
                            gc.abs() + size)[fin] + 1e-5).any()):
                    fail(f"leaf kernel ({b} bins, {what}): the gain row of "
                         f"{name} differs beyond its gain size")
                fa[row] = fc[row]
                if name == "S":
                    # a leaf without a valid split (gain -inf in both)
                    # keeps split fields that nothing reads: its scan's
                    # outputs at an invalid threshold (0/0 or x/0)
                    dead = torch.isneginf(gc)
                    for field in ("bs_lg", "bs_lh", "bs_lc", "bs_lout",
                                  "bs_rout"):
                        i = pack.sf_idx[field]
                        fa[i, dead] = 0.0
                        fc[i, dead] = 0.0
            close = torch.isclose(fa, fc, rtol=1e-5, atol=1e-5) \
                | (torch.isinf(fa) & (fa == fc))
            if not bool(close.all()):
                r, col = (int(x) for x in (~close).nonzero()[0])
                fail(f"leaf kernel ({b} bins, {what}): float rows of "
                     f"{name} differ (row {r}, leaf {col}: "
                     f"{float(fa[r, col])!r} vs plain "
                     f"{float(fc[r, col])!r})")
        # the two children: the leaf split and the new one
        lid_old, lid = src[3], got[3]
        moved = lid != lid_old
        new = int(src[0][0])
        parent = int(lid_old[moved][0]) if bool(moved.any()) else new
        n_leaf = int((lid_old == parent).sum())
        n_right = int(moved.sum())
        small = parent if n_leaf - n_right <= n_right else new
        refs, scales = {}, {}
        for leaf in (parent, new):
            m = (lid == leaf).to(torch.float32)[:, None]
            refs[leaf] = build_histogram(binned, ghc * m, b)
            scales[leaf] = build_histogram(binned, ghc.abs() * m, b)
        other = new if small == parent else parent
        scales[other] = scales[parent] + scales[new]
        worst = 0.0
        for leaf in (parent, new):
            err = (got[4][leaf] - refs[leaf]).abs()
            if bool((err > 1e-5 * scales[leaf] + 1e-6).any()):
                fail(f"leaf kernel ({b} bins, {what}): child histogram "
                     f"{leaf} off by {float(err.max())}")
            worst = max(worst, float(err.max()))
        sizes = dict(n_leaf=n_leaf, n_right=n_right,
                     n_small=min(n_right, n_leaf - n_right))
        return got, worst, sizes

    def timed(fn, count, src):
        times = []
        for _ in range(count):
            restore(src)
            a = torch.cuda.Event(enable_timing=True)
            c = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            c.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(c))
        return float(np.median(times))

    _, worst, root_sizes = agree(start, "root split")
    ms = timed(kernel, reps, start)
    plain_ms = timed(plain, 3, start)
    bin_bytes = binned.element_size()
    bound = leaf_bound_ms(n, n, root_sizes["n_right"], root_sizes["n_small"],
                          F, b, bin_bytes)
    # one whole tree from the root, its launches between two events
    restore(start)
    a = torch.cuda.Event(enable_timing=True)
    c = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(big_l - 1):
        kernel()
    c.record()
    torch.cuda.synchronize()
    splits = int(state[0][0]) - 1
    tree_ms = a.elapsed_time(c) / (big_l - 1)
    # a small split: the state after 200 splits (fewer if the tree
    # stopped early), then the next one
    restore(start)
    for _ in range(min(200, splits - 1)):
        kernel()
    snap = [t.clone() for t in state]
    _, small_err, small_sizes = agree(snap, f"split {int(snap[0][0])}",
                                      gain_size=True)
    small_ms = timed(kernel, reps, snap)
    small_bound = leaf_bound_ms(n, small_sizes["n_leaf"],
                                small_sizes["n_right"],
                                small_sizes["n_small"], F, b, bin_bytes)
    return dict(max_abs_err=max(worst, small_err), ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bound, bound_by="bytes",
                launch_shape=scratch.shape, root=root_sizes,
                tree_avg_ms=tree_ms, tree_splits=splits,
                small_split_ms=small_ms, small_split=small_sizes,
                small_split_bound_ms=small_bound)


def leaf_summary(r):
    return (f"root split {r['ms']:.4f} ms (smaller child "
            f"{r['root']['n_small']} rows), small split "
            f"{r['small_split_ms']:.4f} ms (smaller child "
            f"{r['small_split']['n_small']} rows, bound "
            f"{r['small_split_bound_ms']:.5f} ms), tree average "
            f"{r['tree_avg_ms']:.4f} ms per launch over "
            f"{r['tree_splits']} splits;")


def tree_sig(t):
    return (t.num_leaves, t.split_feature_inner.tolist(),
            t.threshold_bin.tolist(), t.decision_type.tolist(),
            t.left_child.tolist(), t.right_child.tolist())


def first_divergence(a, b):
    """The first node (in split order) where two trees differ in
    feature, threshold or default direction, or None."""
    k = min(a.num_leaves, b.num_leaves) - 1
    for s in range(k):
        if (a.split_feature_inner[s], a.threshold_bin[s],
                a.decision_type[s] & 2) != (b.split_feature_inner[s],
                                            b.threshold_bin[s],
                                            b.decision_type[s] & 2):
            return s
    return None


def node_rows(t, s, lid):
    """Mask of the rows that ``lid`` (tree ``t``'s final leaves) puts
    under node ``s``: the rows of the leaf that node ``s`` splits."""
    import torch
    leaves, stack = [], [s]
    while stack:
        node = stack.pop()
        for c in (int(t.left_child[node]), int(t.right_child[node])):
            if c >= 0:
                stack.append(c)
            else:
                leaves.append(~c)
    return torch.isin(lid.long(), torch.as_tensor(leaves, device=lid.device))


def exact_gain(rows, bins, grad, hess, f, thr):
    """Float64 split gain G_L^2/H_L + G_R^2/H_R - G^2/H (the split_gain
    of lambda_l1 = lambda_l2 = 0, no missing values) of splitting the
    masked rows at bin ``thr`` of feature ``f``."""
    g, h = grad[rows].double(), hess[rows].double()
    left = bins[rows, f].long() <= thr
    gl, hl, gs, hs = g[left].sum(), h[left].sum(), g.sum(), h.sum()
    return float(gl ** 2 / hl + (gs - gl) ** 2 / (hs - hl) - gs ** 2 / hs)


def leaf_vs_segment(binned, params, dev, trees=3):
    """The leaf kernel (a ``SerialTreeLearner`` constructed directly, as
    the JAX package's benchmark leg does) against the segment kernel
    (the default ``PartitionedTreeLearner``) at max_bin=255.

    Exact: gradients and hessians in multiples of 1/8 (|g| <= 1), so
    every histogram sum of 2M rows is exact in float32 in any order;
    the segment kernel's float32 sums and the leaf kernel's float64 sums
    are then equal, and so must be every tree, bit for bit (3 trees,
    boosted with lr 0.1). Then binary logloss gradients, tree by tree
    from one shared score (boosted with the segment learner's trees), so
    every tree is compared from the same inputs: where two trees
    differ, the two splits chosen at the first differing node (of one
    leaf, or of two leaves whose gains tie) must be a tie within float
    rounding: their exact float64 gains, each on its leaf's rows,
    within 1e-3 of each other, and each kernel's gain within 1e-3 of
    its split's exact gain (relative). A deep leaf's histogram comes
    from float32 subtractions of its ancestors', so its rounding is at
    the ancestors' scale: the segment kernel's gains were seen 1.0e-4
    off the exact gains at 2M rows. The nodes of that tree after such a
    tie are not compared (the two trees go on from different leaves)."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.learner import (PartitionedTreeLearner,
                                            SerialTreeLearner)
    cfg = lt.Config.from_params(params)
    y = torch.as_tensor(binned.metadata.label, device=dev,
                        dtype=torch.float32)
    lrns = {"segment": PartitionedTreeLearner(binned, cfg, dev),
            "leaf": SerialTreeLearner(binned, cfg, dev)}
    for name, lrn in lrns.items():
        if not lrn.fused:
            fail(f"the {name} learner is not on its fused path")
    grown = {}
    for name, lrn in lrns.items():
        score = torch.zeros(binned.num_data, device=dev)
        grown[name] = []
        for _ in range(trees):
            p = torch.sigmoid(score)
            grad = torch.round((p - y) * 8) / 8
            hess = torch.clamp(torch.round(p * (1 - p) * 8) / 8, min=0.125)
            tree, lid = lrn.train(grad, hess)
            vals = torch.as_tensor(tree.leaf_value, device=dev)
            score += 0.1 * vals[lid.long()]
            grown[name].append(tree)
    same = [tree_sig(a) == tree_sig(b)
            and a.leaf_value.tobytes() == b.leaf_value.tobytes()
            for a, b in zip(grown["segment"], grown["leaf"])]
    print(f"[leaf vs segment] exact gradients, {binned.num_data} x {F}, "
          f"max_bin 255, {trees} trees of "
          f"{[t.num_leaves for t in grown['leaf']]} leaves: identical "
          f"{same}")
    if not all(same):
        fail("the leaf and segment kernels grew different trees from "
             "exact gradients")
    p0 = float(y.mean())
    score = torch.full((binned.num_data,), float(np.log(p0 / (1 - p0))),
                       device=dev)
    bins = binned.binned_device(dev)
    for i in range(trees):
        p = torch.sigmoid(score)
        grad, hess = p - y, p * (1 - p)
        a, lid = lrns["segment"].train(grad, hess)
        b, lid_b = lrns["leaf"].train(grad, hess)
        s = first_divergence(a, b)
        if s is None and tree_sig(a) == tree_sig(b):
            print(f"[leaf vs segment] binary gradients from one score, "
                  f"tree {i}: same structure, all {a.num_leaves - 1} "
                  "nodes compared")
        elif s is None:
            fail(f"leaf and segment trees {i} differ in their children")
        else:
            ga, gb = float(a.split_gain[s]), float(b.split_gain[s])
            rows_a, rows_b = node_rows(a, s, lid), node_rows(b, s, lid_b)
            ea, eb = (exact_gain(r, bins, grad, hess,
                                 int(t.split_feature_inner[s]),
                                 int(t.threshold_bin[s]))
                      for r, t in ((rows_a, a), (rows_b, b)))
            leaf = "the same leaf" if torch.equal(rows_a, rows_b) \
                else "different leaves"
            print(f"[leaf vs segment] binary gradients from one score, "
                  f"tree {i}: first differs at node {s} of "
                  f"{a.num_leaves - 1} (nodes {s}-{a.num_leaves - 2} not "
                  f"compared), {leaf}: gains {ga!r} (segment) and "
                  f"{gb!r} (leaf); exact float64 gains of the two splits "
                  f"{ea!r} and {eb!r}; relative: segment error "
                  f"{abs(ga - ea) / abs(ea):.3g}, leaf error "
                  f"{abs(gb - eb) / abs(eb):.3g}, exact gap "
                  f"{abs(ea - eb) / abs(ea):.3g}")
            if not max(abs(ga - ea) / abs(ea), abs(gb - eb) / abs(eb),
                       abs(ea - eb) / abs(ea)) <= 1e-3:
                fail(f"leaf and segment trees {i} differ at node {s}, not "
                     "at a tie within float rounding")
        vals = torch.as_tensor(a.leaf_value, device=dev)
        score += 0.1 * vals[lid.long()]


def train_paths(label, params, ds, iters, dev, on_path, fused_kernel):
    """Full-width training through the fused and the per-phase grow
    paths, each driven with the launch counts set to 0 just before it
    and read just after; the two must grow the same trees, and one more
    fused tree runs its split loop under the sync checker. Returns the
    fused run's launch counts and the per-phase run's."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _native
    runs = {}
    for path, extra in (("fused", {}),
                        ("per-phase", {"fused_split_kernel": "off"})):
        _native.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = lt.train(dict(params, **extra), ds, iters, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_native.LAUNCHES)
        splits = sum(t.num_leaves - 1 for t in bst.models)
        runs[path] = (bst, launches)
        lrn = bst._gbdt.learner
        print(f"[train {label}] {path}: {type(lrn).__name__}, "
              f"num_bins_max {lrn.num_bins_max}, {len(bst.models)} trees, "
              f"{splits} splits in {wall:.2f} s = "
              f"{wall / max(splits, 1) * 1e3:.3f} ms/split; "
              f"launches {launches}")
        for name in on_path[path]:
            if launches[name] <= 0:
                fail(f"kernel {name} was not launched on the {label} "
                     f"{path} path")
    fused_bst, per_bst = runs["fused"][0], runs["per-phase"][0]
    if not fused_bst._gbdt.learner.fused or per_bst._gbdt.learner.fused:
        fail(f"the default {label} path is not the fused one")
    same = [tree_sig(a) == tree_sig(b)
            for a, b in zip(fused_bst.models, per_bst.models)]
    rel = max(float(np.max(np.abs(a.leaf_value - b.leaf_value)
                           / np.maximum(np.abs(b.leaf_value), 1e-30)))
              for a, b in zip(fused_bst.models, per_bst.models))
    print(f"[train {label}] fused vs per-phase: structure equal {same}, "
          f"max relative leaf value diff {rel:.3g}")
    if len(same) != iters or not all(same) or rel > 1e-5:
        fail(f"the {label} fused and per-phase paths grew different trees")
    # one more fused tree, its split loop under the sync checker and
    # between two CUDA events
    lrn = fused_bst._gbdt.learner
    launch_loop = lrn._launch_fused
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def checked(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            events[0].record()
            launch_loop(*a, **kw)
            events[1].record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    lrn._launch_fused = checked
    fused_bst.update()
    lrn._launch_fused = launch_loop
    torch.cuda.synchronize()
    loop_ms = events[0].elapsed_time(events[1])
    tree = fused_bst.models[-1]
    print(f"[train {label}] tree {len(fused_bst.models)}: "
          f"{lrn.num_leaves - 1} {fused_kernel} launches ran under "
          f"set_sync_debug_mode('error'), {loop_ms:.3f} ms between the "
          f"events = {loop_ms / (lrn.num_leaves - 1):.4f} ms per launch "
          f"({tree.num_leaves - 1} splits); average-split bound "
          f"{avg_split_bound_ms(fused_bst, lrn):.5f} ms over the "
          f"{len(fused_bst.models)} trees")
    return fused_bst, runs["fused"][1], runs["per-phase"][1]


def avg_split_bound_ms(bst, lrn):
    """The fused kernel's bound (chip_smoke's byte counts, per split)
    averaged over every split of the booster's trees, from the trees'
    node and leaf counts: segment, the parent's segment read and written
    once plus three cache rows; leaf, ``leaf_bound_ms``."""
    from lightgbm_tpu_torch.learner import SerialTreeLearner
    from lightgbm_tpu_torch.ops.hist_cuda import matrix_cols
    n, f, b = lrn.num_data, F, lrn.num_bins_max
    total, splits = 0.0, 0
    for t in bst.models:
        def count(c):
            return int(t.internal_count[c]) if c >= 0 \
                else int(t.leaf_count[~c])
        for s in range(t.num_leaves - 1):
            n_leaf = int(t.internal_count[s])
            n_right = count(int(t.right_child[s]))
            n_small = min(n_right, n_leaf - n_right)
            if isinstance(lrn, SerialTreeLearner):
                total += leaf_bound_ms(n, n_leaf, n_right, n_small, f, b,
                                       lrn.binned.element_size())
            else:
                total += (2 * n_leaf * matrix_cols(f) + 3 * f * b * 3 * 4) \
                    / HBM_BYTES_PER_S * 1e3
            splits += 1
    return total / max(splits, 1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--quality-iters", type=int, default=100)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.learner import SerialTreeLearner
    from lightgbm_tpu_torch.ops import _native
    from lightgbm_tpu_torch.ops.histogram import build_histogram, make_ghc
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")
    t_all = time.perf_counter()

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    _native.library()
    print(f"[build] {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_native.BUILD_INFO['seconds']:.2f} s)")
    for line in _native.BUILD_INFO["ptxas"].splitlines():
        if "Used" in line or line.startswith("=="):
            print("  " + line.strip())

    # ---- 2. kernels against their plain versions -----------------------
    n = args.rows
    t0 = time.perf_counter()
    X, y = higgs_like(n)
    params = {"objective": "binary", "num_leaves": 255,
              "learning_rate": 0.1, "max_bin": 255, "verbosity": -1}
    params_wide = dict(params, max_bin=1023)
    ds = lt.Dataset(X, label=y)
    binned = ds.construct(lt.Config.from_params(params))
    ds_wide = lt.Dataset(X, label=y)
    binned_wide = ds_wide.construct(lt.Config.from_params(params_wide))
    b_wide = int(binned_wide.num_bins_array().max())
    print(f"[data] {n} x {F} binned at max_bin 255 and 1023 "
          f"(num_bins_max {int(binned.num_bins_array().max())} and "
          f"{b_wide}) in {time.perf_counter() - t0:.1f} s")
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    mat = hc.build_matrix(binned.binned_device(dev))
    gen = torch.Generator(device=dev).manual_seed(7)
    grad = torch.randn(n, generator=gen, device=dev)
    hess = torch.rand(n, generator=gen, device=dev) * 0.25 + 1e-3
    hc.pack_gh(mat, F, grad, hess, torch.ones(n, device=dev))
    t0 = time.perf_counter()
    rec = {"hist_segment": check_hist(mat, n, args.reps)}
    print(f"[check] hist_segment ok {time.perf_counter() - t0:.1f} s "
          f"{rec['hist_segment']}")
    t0 = time.perf_counter()
    hists = [hc.histogram_segment(mat, 0, n // 3, B, F),
             hc.histogram_segment(mat, n // 3, n - n // 3, B, F)]
    scan256 = check_scan(hists, binned, B, args.reps)
    print(f"[check] split_scan ({B} bins) ok {time.perf_counter() - t0:.1f} "
          f"s {scan256}")
    t0 = time.perf_counter()
    rec["partition_segment"] = check_partition(mat, n, args.reps)
    print(f"[check] partition_segment ok {time.perf_counter() - t0:.1f} s "
          f"{rec['partition_segment']}")
    t0 = time.perf_counter()
    rec["fused_split_step_segment"] = check_fused(mat, n, binned, args.reps)
    print(f"[check] fused_split_step_segment ok "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{segment_summary(rec['fused_split_step_segment'])} "
          f"{rec['fused_split_step_segment']}")
    del mat, hists
    torch.cuda.empty_cache()
    # the serial learner's inputs: the bin matrices and ghc
    ghc = make_ghc(grad, hess)
    bins_wide = binned_wide.binned_device(dev)
    t0 = time.perf_counter()
    hists = [build_histogram(bins_wide[:n // 3], ghc[:n // 3], b_wide),
             build_histogram(bins_wide[n // 3:], ghc[n // 3:], b_wide)]
    rec["split_scan"] = check_scan(hists, binned_wide, b_wide, args.reps)
    print(f"[check] split_scan ({b_wide} bins) ok "
          f"{time.perf_counter() - t0:.1f} s {rec['split_scan']}")
    del hists
    t0 = time.perf_counter()
    rec["fused_split_step_leaf"] = check_fused_leaf(
        bins_wide, ghc, binned_wide, b_wide, args.reps)
    print(f"[check] fused_split_step_leaf ({b_wide} bins, u16) ok "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{leaf_summary(rec['fused_split_step_leaf'])} "
          f"{rec['fused_split_step_leaf']}")
    t0 = time.perf_counter()
    b_u8 = int(binned.num_bins_array().max())
    leaf_u8 = check_fused_leaf(binned.binned_device(dev), ghc, binned, b_u8,
                               args.reps)
    print(f"[check] fused_split_step_leaf ({b_u8} bins, u8) ok "
          f"{time.perf_counter() - t0:.1f} s: {leaf_summary(leaf_u8)} "
          f"{leaf_u8}")
    del ghc, bins_wide, grad, hess
    torch.cuda.empty_cache()

    # ---- 3. the partitioned learner at full width, fused and per-phase -
    fused_bst, part_fused, part_per = train_paths(
        "max_bin 255", params, ds, args.iters, dev,
        {"fused": ("hist_segment", "split_scan", "fused_split_step_segment"),
         "per-phase": ("hist_segment", "split_scan", "partition_segment")},
        "fused_split_step_segment")
    pred = fused_bst.predict(X[:100_000], raw_score=True)
    if pred.shape != (100_000,) or not np.isfinite(pred).all():
        fail("full-width predictions are not finite")
    del fused_bst
    torch.cuda.empty_cache()

    # ---- 4. the serial learner at full width (1023 bins) ---------------
    serial_bst, serial_fused, _ = train_paths(
        "max_bin 1023", params_wide, ds_wide, args.iters, dev,
        {"fused": ("split_scan", "fused_split_step_leaf"),
         "per-phase": ("split_scan",)}, "fused_split_step_leaf")
    if not isinstance(serial_bst._gbdt.learner, SerialTreeLearner):
        fail("max_bin 1023 did not train through the SerialTreeLearner")
    pred = serial_bst.predict(X[:100_000], raw_score=True)
    if pred.shape != (100_000,) or not np.isfinite(pred).all():
        fail("full-width serial predictions are not finite")
    del serial_bst, ds_wide, binned_wide
    torch.cuda.empty_cache()
    launches = {name: 0 for name in _native.LAUNCHES}
    launches.update(hist_segment=part_fused["hist_segment"],
                    fused_split_step_segment=part_fused[
                        "fused_split_step_segment"],
                    partition_segment=part_per["partition_segment"],
                    split_scan=serial_fused["split_scan"],
                    fused_split_step_leaf=serial_fused[
                        "fused_split_step_leaf"])

    # ---- 5. leaf kernel against segment kernel at 255 bins -------------
    t0 = time.perf_counter()
    leaf_vs_segment(binned, params, dev)
    print(f"[leaf vs segment] done in {time.perf_counter() - t0:.1f} s")
    del ds, binned
    torch.cuda.empty_cache()

    # ---- 6. quality ----------------------------------------------------
    Xq, yq = higgs_like(50_000)
    for max_bin in (255, 1023):
        t0 = time.perf_counter()
        qparams = {"objective": "binary", "num_leaves": 63,
                   "learning_rate": 0.1, "max_bin": max_bin,
                   "verbosity": -1}
        bq = lt.train(qparams, lt.Dataset(Xq, label=yq), args.quality_iters,
                      device=dev)
        q_auc = auc(yq, bq.predict(Xq, raw_score=True))
        lrn = bq._gbdt.learner
        print(f"[quality] 50000 x {F}, 63 leaves, max_bin {max_bin}, "
              f"{args.quality_iters} iters ({type(lrn).__name__}, fused "
              f"{lrn.fused}): AUC {q_auc:.5f} in "
              f"{time.perf_counter() - t0:.1f} s")
        if not lrn.fused:
            fail("the quality config did not run the fused path")
        if args.quality_iters >= 100 and q_auc < 0.97906 - 0.002:
            fail(f"AUC {q_auc} below 0.97706 at max_bin {max_bin}")

    # ---- 7. parity: kernels against plain versions, end to end --------
    Xp, yp = higgs_like(100_000, seed=3)
    for max_bin in (255, 1023):
        t0 = time.perf_counter()
        pp = dict(params, max_bin=max_bin)
        kb = lt.train(pp, lt.Dataset(Xp, label=yp), 3, device=dev)
        pb = lt.train(pp, lt.Dataset(Xp, label=yp), 3, device=dev,
                      ops="plain")
        same = [tree_sig(a) == tree_sig(b) for a, b in zip(kb.models,
                                                           pb.models)]
        leaf_err = max(float(np.abs(a.leaf_value - b.leaf_value).max())
                       for a, b in zip(kb.models, pb.models))
        print(f"[parity] 100000 x {F}, max_bin {max_bin}, 3 trees, "
              f"{type(kb._gbdt.learner).__name__} fused path (kernel "
              f"{kb._gbdt.learner.fused}, plain {pb._gbdt.learner.fused}): "
              f"structure equal {same}, "
              f"max leaf value diff {leaf_err:.3g} "
              f"in {time.perf_counter() - t0:.1f} s")
        if len(kb.models) != 3 or not all(same):
            for i, (a, b) in enumerate(zip(kb.models, pb.models)):
                s = first_divergence(a, b)
                if s is not None:
                    print(f"[parity] tree {i} first differs at node {s}: "
                          f"kernel feature {int(a.split_feature_inner[s])}"
                          f" bin {int(a.threshold_bin[s])} gain "
                          f"{float(a.split_gain[s])!r}, plain feature "
                          f"{int(b.split_feature_inner[s])} bin "
                          f"{int(b.threshold_bin[s])} gain "
                          f"{float(b.split_gain[s])!r}")
                    break
            fail(f"kernel and plain runs grew different trees "
                 f"(max_bin {max_bin})")

    sources = {
        "hist_segment": ("lightgbm_tpu_torch/csrc/hist_segment.cu",
                         "lightgbm_tpu/ops/hist_pallas.py:322"),
        "partition_segment": (
            "lightgbm_tpu_torch/csrc/partition_segment.cu",
            "lightgbm_tpu/ops/partition_pallas.py:51"),
        "split_scan": ("lightgbm_tpu_torch/csrc/split_scan.cu",
                       "lightgbm_tpu/ops/split_scan_pallas.py:56"),
        "fused_split_step_segment": (
            "lightgbm_tpu_torch/csrc/split_step_segment.cu",
            "lightgbm_tpu/ops/split_step_pallas.py:531"),
        "fused_split_step_leaf": (
            "lightgbm_tpu_torch/csrc/split_step_leaf.cu",
            "lightgbm_tpu/ops/split_step_pallas.py:413"),
    }
    kernels = []
    for name, (src, rep) in sources.items():
        r = rec[name]
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=rep, launches=launches[name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"]))
    print(f"[total] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
