#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``. It needs a
CUDA device and ``nvcc`` (the kernels are built from
``lightgbm_tpu_torch/csrc`` at first use) and imports nothing of JAX or
of the JAX package. Phases, each fatal on failure:

1. build the kernel library and report the build time;
2. hold every kernel against its plain PyTorch version on the card at
   the slice's shapes (2M rows x 28 features x 256 bins) and time both,
   beside the least time the card could take and one PyTorch library
   call computing the same function where there is one; the fused
   split step runs the root split of the 2M-row matrix;
3. train the Higgs-shaped binary model at full width (2M x 28,
   max_bin=255, num_leaves=255, lr=0.1, 8 iterations) through
   ``lightgbm_tpu_torch.train`` twice: the fused path (the default) and
   the per-phase path (``fused_split_kernel="off"``). Both must grow
   trees of the same structure; one more fused tree runs its L - 1
   launches under ``torch.cuda.set_sync_debug_mode("error")`` (no host
   sync in the split loop); the launch counters show that every kernel
   of each path ran;
4. the fixed quality config (50k x 28, 63 leaves, 100 iterations,
   fused path) must reach in-sample AUC >= 0.97906 - 0.002
   (BENCH_QUALITY_BASELINE.json);
5. a 100k-row, 3-tree run through the kernels (fused path) must grow the
   same trees as the same run through the plain versions on the card.

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
    for begin, count in ((0, n), (n // 16 + 7, n // 2 + 3)):
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


def check_scan(mat, n, dataset, reps):
    import torch
    from lightgbm_tpu_torch.learner.partitioned import (
        feature_meta_from_dataset, split_params_from_config)
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import split_scan_cuda as sc
    from lightgbm_tpu_torch.ops.split import O_SCORE, O_THR, O_DLEFT, \
        meta_tensors
    dev = mat.device
    hists = [hc.histogram_segment(mat, 0, n // 3, B, F),
             hc.histogram_segment(mat, n // 3, n - n // 3, B, F)]
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
        missing=miss, default_bin=np.full(F, 128, np.int32),
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
            fail("scan: valid features differ")
        for col in (O_THR, O_DLEFT):
            if not np.array_equal(k[..., col][fin], p[..., col][fin]):
                fail(f"scan: column {col} differs")
        kv, pv = k[fin], p[fin]
        if not np.allclose(kv, pv, rtol=1e-5, atol=1e-6):
            fail(f"scan values differ by {np.abs(kv - pv).max()}")
        worst = max(worst, float(np.abs(kv - pv).max()))
    meta_t = meta_tensors(base, dev)
    tables = sc.scan_meta_tables(meta_t)
    params = nomiss[1]
    ms = time_ms(lambda: sc.per_feature_numerical_cuda(
        hists, leaves, meta_t, params, tables), reps)
    plain_ms = time_ms(lambda: sc.per_feature_numerical_plain(
        hists, leaves, meta_t, params), reps)
    nbytes = 2 * F * B * 3 * 4 + 2 * F * 8 * 4
    # per bin and direction: ~4 prefix adds, ~40 flops of gain algebra
    ops = 2 * F * B * 2 * 44
    bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / F32_FLOPS else "operations")


def check_fused(mat, n, dataset, reps):
    """The root split (k = 1) of the matrix through the fused kernel and
    through its plain version fed the per-phase histogram kernel: S, T,
    k, the matrix and the histogram cache must be bitwise equal (so the
    fused histogram equals the per-phase kernel's). Both child
    histograms are also held against the float64 plain histograms."""
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
    state = [k0.clone(), st0["S"].clone(), st0["T"].clone(), mat.clone(),
             hist0.clone()]

    def restore():
        for dst, src in zip(state, (k0, st0["S"], st0["T"], mat, hist0)):
            dst.copy_(src)

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

    kernel()
    torch.cuda.synchronize()
    got = [t.clone() for t in state]
    restore()
    plain(True)
    torch.cuda.synchronize()
    names = ("k", "S", "T", "mat", "hist")
    for name, a, b in zip(names, got, state):
        if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
            fail(f"fused split step: {name} differs from its plain version")
    if int(got[0][0]) != 2:
        fail("fused split step did not split the root")
    # the fused child histograms against the float64 plain histograms.
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

    def timed(fn, count):
        times = []
        for _ in range(count):
            restore()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    kernel()   # warm-up
    ms = timed(kernel, reps)
    plain_ms = timed(lambda: plain(False), 3)
    # the parent's segment read once and written once (the smaller
    # child's histogram can come from rows already being read), the
    # parent's cache row read and both children's written
    nbytes = 2 * n * mat.shape[1] + 3 * F * B * 3 * 4
    shape = ss.launch_shape(F, B)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes", launch_shape=shape)


def tree_sig(t):
    return (t.num_leaves, t.split_feature_inner.tolist(),
            t.threshold_bin.tolist(), t.decision_type.tolist(),
            t.left_child.tolist(), t.right_child.tolist())


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
    from lightgbm_tpu_torch.ops import _native
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
    ds = lt.Dataset(X, label=y)
    binned = ds.construct(lt.Config.from_params(params))
    print(f"[data] {n} x {F} binned in {time.perf_counter() - t0:.1f} s")
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
    rec["split_scan"] = check_scan(mat, n, binned, args.reps)
    print(f"[check] split_scan ok {time.perf_counter() - t0:.1f} s "
          f"{rec['split_scan']}")
    t0 = time.perf_counter()
    rec["partition_segment"] = check_partition(mat, n, args.reps)
    print(f"[check] partition_segment ok {time.perf_counter() - t0:.1f} s "
          f"{rec['partition_segment']}")
    t0 = time.perf_counter()
    rec["fused_split_step_segment"] = check_fused(mat, n, binned, args.reps)
    print(f"[check] fused_split_step_segment ok "
          f"{time.perf_counter() - t0:.1f} s "
          f"{rec['fused_split_step_segment']}")
    del mat
    torch.cuda.empty_cache()

    # ---- 3. the slice at full width, fused and per-phase --------------
    runs = {}
    for path, extra in (("fused", {}),
                        ("per-phase", {"fused_split_kernel": "off"})):
        _native.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = lt.train(dict(params, **extra), ds, args.iters, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_native.LAUNCHES)
        splits = sum(t.num_leaves - 1 for t in bst.models)
        runs[path] = (bst, launches)
        print(f"[train] {path}: {n} x {F}, {len(bst.models)} trees, "
              f"{splits} splits in {wall:.2f} s = "
              f"{wall / max(splits, 1) * 1e3:.3f} ms/split; "
              f"launches {launches}")
        on_path = ("hist_segment", "split_scan") + (
            ("fused_split_step_segment",) if path == "fused"
            else ("partition_segment",))
        for name in on_path:
            if launches[name] <= 0:
                fail(f"kernel {name} was not launched on the {path} path")
    fused_bst, per_bst = runs["fused"][0], runs["per-phase"][0]
    if not fused_bst._gbdt.learner.fused or per_bst._gbdt.learner.fused:
        fail("the default path is not the fused one")
    same = [tree_sig(a) == tree_sig(b)
            for a, b in zip(fused_bst.models, per_bst.models)]
    rel = max(float(np.max(np.abs(a.leaf_value - b.leaf_value)
                           / np.maximum(np.abs(b.leaf_value), 1e-30)))
              for a, b in zip(fused_bst.models, per_bst.models))
    print(f"[train] fused vs per-phase: structure equal {same}, "
          f"max relative leaf value diff {rel:.3g}")
    if len(same) != args.iters or not all(same) or rel > 1e-5:
        fail("the fused and per-phase paths grew different trees")
    # one more fused tree, its split loop under the sync checker
    lrn = fused_bst._gbdt.learner
    launch_loop = lrn._launch_fused

    def checked(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return launch_loop(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    lrn._launch_fused = checked
    fused_bst.update()
    lrn._launch_fused = launch_loop
    print(f"[train] tree {len(fused_bst.models)}: {lrn.num_leaves - 1} "
          "fused launches ran under set_sync_debug_mode('error')")
    pred = fused_bst.predict(X[:100_000], raw_score=True)
    if pred.shape != (100_000,) or not np.isfinite(pred).all():
        fail("full-width predictions are not finite")
    launches = {name: runs["per-phase" if name == "partition_segment"
                           else "fused"][1][name]
                for name in _native.LAUNCHES}
    del fused_bst, per_bst, runs, lrn, ds, binned
    torch.cuda.empty_cache()

    # ---- 4. quality ----------------------------------------------------
    t0 = time.perf_counter()
    Xq, yq = higgs_like(50_000)
    qparams = {"objective": "binary", "num_leaves": 63,
               "learning_rate": 0.1, "max_bin": 255, "verbosity": -1}
    bq = lt.train(qparams, lt.Dataset(Xq, label=yq), args.quality_iters,
                  device=dev)
    q_auc = auc(yq, bq.predict(Xq, raw_score=True))
    print(f"[quality] 50000 x {F}, 63 leaves, {args.quality_iters} iters "
          f"(fused {bq._gbdt.learner.fused}): AUC {q_auc:.5f} in "
          f"{time.perf_counter() - t0:.1f} s")
    if args.quality_iters >= 100 and q_auc < 0.97906 - 0.002:
        fail(f"AUC {q_auc} below 0.97706")

    # ---- 5. parity: kernels against plain versions, end to end --------
    t0 = time.perf_counter()
    Xp, yp = higgs_like(100_000, seed=3)
    kb = lt.train(params, lt.Dataset(Xp, label=yp), 3, device=dev)
    pb = lt.train(params, lt.Dataset(Xp, label=yp), 3, device=dev,
                  ops="plain")
    same = [tree_sig(a) == tree_sig(b) for a, b in zip(kb.models,
                                                       pb.models)]
    leaf_err = max(float(np.abs(a.leaf_value - b.leaf_value).max())
                   for a, b in zip(kb.models, pb.models))
    print(f"[parity] 100000 x {F}, 3 trees, fused path (kernel "
          f"{kb._gbdt.learner.fused}, plain {pb._gbdt.learner.fused}): "
          f"structure equal {same}, "
          f"max leaf value diff {leaf_err:.3g} "
          f"in {time.perf_counter() - t0:.1f} s")
    if len(kb.models) != 3 or not all(same):
        fail("kernel and plain runs grew different trees")

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
