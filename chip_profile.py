#!/usr/bin/env python3
"""Where the time of full-width training goes, on one CUDA card.

Run from the repository root: ``python3 chip_profile.py [--trees N]
[--paths fused,per-phase,serial-fused,serial-per-phase]
[--leaf-phases] [--segment-phases] [--hist-rows-phases]
[--hist-rows] [--scan-phases] [--partition] [--multival-phases]
[--shap-phases] [--batched-phases] [--batched] [--package DIR]
[--codegen SRC[,SRC]]``. Trains the
Higgs-shaped binary model of ``chip_smoke.py`` (2M x 28,
num_leaves=255, lr=0.1) through ``lightgbm_tpu_torch``, once per grow
path: at max_bin=255 the partitioned learner's ``fused`` (the default
``fused_split_kernel="auto"``: one segment fused-step launch per split)
and ``per-phase`` (``fused_split_kernel="off"``: partition, histogram
and scan launches and one host read per split); at max_bin=1023 the
serial learner's ``serial-fused`` (one leaf fused-step launch per split)
and ``serial-per-phase`` (torch histogram ops and the scan kernel, one
host read per split); the default is all four. Per path: two warm-up
trees, then ``--trees`` trees under ``torch.profiler``; it prints the
wall time, the summed device time of every CUDA kernel, the device's
busy and idle shares of the wall time, and the kernels and
host ops by time. The full tables go to ``chiprun_out/profile.txt``.
One section per path.

``--leaf-phases`` (alone, or as a path name in ``--paths``) times the
phases inside the leaf kernel: after two warm-up trees of the
serial-fused path, one tree's L - 1 splits run through the kernel's
timed instantiation (``LeafStep.timed``: block 0 reads ``clock64`` and
``%globaltimer`` after each grid barrier), each launch between two CUDA
events. It prints the mean time of each phase (site read, ``lid`` pass,
compaction, histogram, reduce, scans, finish) and of the launch itself
(event time less the in-kernel span), for all splits, the root, and the
splits whose smaller child has at most 10,000 rows and more.
``--segment-phases`` does the same for the segment kernel over one
max_bin 255 partitioned fused tree (its timed instantiation,
``SegmentStep.timed``), with block 0's cycles inside the histogram
phase, then times the root histogram (``hist_segment``) of the whole
matrix. ``--hist-rows-phases`` times the full-range histogram
(``hist_rows``) on the 2M x 28 bin matrices at max_bin 255 (u8) and
1023 (u16), over all rows (the serial root) and over a random third of
the rows (a per-phase child): the median of 20 launches, then one
launch of its timed instantiation (every block's thread 0 reads
``clock64`` around the first fetch, the stores of each staged step, the
accumulation and the write-out), printed as mean cycles a block and as
cycles per 32-row feature group of a busy warp and of an SM;
``--hist-rows`` prints the launch medians alone (it runs on a tree
without the timed build too, to compare with a parent).
``--scan-phases`` times the standalone scan kernel (``split_scan``) on
two children's histograms of the 2M-row matrices at max_bin 255 and
1023, at its own block size and (through the profile-only entry
``per_feature_numerical_profile``) others, and its timed build's
sub-phases (``scan_feature``'s clock64 reads: load planes, prefix sums,
candidates, argmax and row); ``--partition`` times ``partition_segment``
on the whole 2M-row u8 training matrix, then (through
``partition_segment_profile``) its compaction with rows held in
registers against rows loaded after the look-back, at 32-, 48- and
64-byte rows. Both run on a parent tree too (the launch times alone
where it lacks the profile-only entries). A
path's profile also prints each wrapper's in-training device time a
call. A phases flag alone runs only that; with ``--paths`` it runs after
the named paths.

``--batched-phases`` times the two model-batched kernels of the
multiboost learner at B 4 and B 8 (``batched_phases``): the first B
models of ``chip_smoke.py`` phase 17's bucket 0 at iteration 0 over the
2M x 28 u8 rows (255 leaves); ``hist_rows_batched`` against the loop of
B ``hist_rows`` launches at the same shape and its timed build's cycles
a block (first fetch, stage, peers, adds, write-out), then a whole tree
of ``fused_split_step_leaf_batched`` launches between CUDA events (the
root and the tree's average launch) and the same tree through its timed
build (block 0's phases: site, lid pass, compaction, histogram, reduce,
scan, finish). ``--batched`` prints both kernels' device time at those
shapes, each in a profiler session of its own (``batched_device``).

``--codegen SRC[,SRC]`` (e.g. ``split_step_leaf.cu,hist_rows.cu``)
prints, for each kernel those sources compile to, what ``ptxas -v``
reported when the kernel library was built in this process (registers,
stack frame, spill stores and loads) and the kernel's SASS instruction
count from ``cuobjdump``; with ``--package`` it reads the parent tree's
build, so two trees' code can be compared in one call.
"""

import argparse
import os
import subprocess
import sys
import time

from chip_smoke import KERNEL_NAMES, device_us, higgs_like, merged_us


PATHS = {"fused": {"max_bin": 255},
         "per-phase": {"max_bin": 255, "fused_split_kernel": "off"},
         "serial-fused": {"max_bin": 1023},
         "serial-per-phase": {"max_bin": 1023, "fused_split_kernel": "off"}}


def profile_path(path: str, ds, trees: int) -> str:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import lightgbm_tpu_torch as lt
    params = {"objective": "binary", "num_leaves": 255,
              "learning_rate": 0.1, "verbosity": -1, **PATHS[path]}
    from lightgbm_tpu_torch.ops import _native
    bst = lt.Booster(params, ds, device="cuda")
    for _ in range(2):
        bst.update()
    torch.cuda.synchronize()
    _native.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(trees):
            bst.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    splits = sum(t.num_leaves - 1 for t in bst.models[-trees:])
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    tag = f"[profile {path}]"
    lrn = bst._gbdt.learner
    print(f"{tag} {type(lrn).__name__} fused={lrn.fused} "
          f"num_bins_max={lrn.num_bins_max} {len(ds.label)} rows, "
          f"{trees} trees, {splits} splits: wall {wall * 1e3:.1f} ms = "
          f"{wall * 1e3 / splits:.4f} ms/split")
    print(f"{tag} device kernel time {dev_us / 1e3:.1f} ms = "
          f"{dev_us / 1e3 / splits:.4f} ms/split; device busy "
          f"{dev_us / 1e6 / wall:.3f} of wall, idle "
          f"{1 - dev_us / 1e6 / wall:.3f}")
    by_dev = sorted((e for e in events if e.self_device_time_total > 0),
                    key=lambda e: -e.self_device_time_total)
    for e in by_dev[:12]:
        print(f"  device {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.count:7d} x  {e.key[:70]}")
    print(f"{tag} {per_wrapper(prof, dict(_native.LAUNCHES))}")
    by_cpu = sorted(events, key=lambda e: -e.self_cpu_time_total)
    for e in by_cpu[:12]:
        print(f"  host   {e.self_cpu_time_total / 1e3:9.2f} ms "
              f"{e.count:7d} x  {e.key[:70]}")
    if lrn.fused:
        for line in fused_timeline(prof, lrn.num_leaves - 1, trees):
            print(f"{tag} {line}")
    else:
        print(f"{tag} {split_bounds(lrn, bst.models[-trees:])}")
    tables = (f"== {path}\n"
              + events.table(sort_by="self_cuda_time_total", row_limit=60)
              + "\n"
              + events.table(sort_by="self_cpu_time_total", row_limit=60))
    del bst
    torch.cuda.empty_cache()
    return tables


# which wrapper launches a CUDA kernel, by a part of its name
KERNEL_OF = tuple((part, name) for name, parts in KERNEL_NAMES.items()
                  for part in parts)


def per_wrapper(prof, launches: dict) -> str:
    """Device time of each wrapper's kernels over its calls in the
    window: the in-training time a call. A call's kernels are merged as
    intervals on the card's timeline, so kernels that overlap (the
    partition's copy back launches while its compaction runs) count
    once."""
    from torch.autograd import DeviceType
    spans = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for part, name in KERNEL_OF:
            if part in e.name:
                spans.setdefault(name, []).append(
                    (e.time_range.start, e.time_range.end))
                break
    ms = {name: merged_us(iv) / 1e3 for name, iv in spans.items()}
    return "per wrapper call, device us: " + ", ".join(
        f"{name} {t:.2f} ms / {launches.get(name, 0)} = "
        f"{t * 1e3 / max(launches.get(name, 0), 1):.2f}"
        for name, t in sorted(ms.items()))


def split_bounds(lrn, trees) -> str:
    """The byte bound (each input byte read once, each output written
    once, at chip_smoke.HBM_BYTES_PER_S) of a per-phase path's average
    launch of each kernel over ``trees``: the partition moves the
    parent's rows of the training matrix (read and written); the child's
    histogram reads the smaller child's rows (``hist_segment``: matrix
    rows; ``hist_rows``: bins, ghc and an id) and writes [F, B, 3] f32;
    the scan reads both children's histograms."""
    import numpy as np

    from chip_smoke import HBM_BYTES_PER_S
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    f, b = lrn.num_features, lrn.num_bins_max
    parent = np.concatenate([t.internal_count[:t.num_leaves - 1]
                             for t in trees]).astype(np.float64)
    small = np.concatenate([smaller_child_rows(t, t.num_leaves - 1)
                            for t in trees]).astype(np.float64)
    hist_out = f * b * 3 * 4
    if hasattr(lrn, "mat"):
        cols = hc.matrix_cols(f)
        launches = {"partition_segment": 2 * parent.mean() * cols,
                    "hist_segment": small.mean() * cols + hist_out}
    else:
        row = f * (1 if b <= 256 else 2) + 12 + 4
        launches = {"hist_rows": small.mean() * row + hist_out}
    launches["split_scan"] = 2 * hist_out + 2 * f * 8 * 4

    def ms(nbytes):
        return f"{nbytes / HBM_BYTES_PER_S * 1e3:.6f}"
    return (f"average split over {len(parent)} splits: parent "
            f"{parent.mean():.0f} rows, smaller child {small.mean():.0f}; "
            "byte bound of the average launch, ms: "
            + ", ".join(f"{k} {ms(v)}" for k, v in launches.items()))


def fused_timeline(prof, launches: int, trees: int) -> list:
    """Where a fused path's tree spends its wall time, from the
    profiler's timeline: each tree enqueues ``launches`` fused-step
    launches (``cudaLaunchCooperativeKernel`` on the host, one kernel
    each on the card). Per tree, mean ms: the host's enqueue of the
    split loop (first launch call to last), the card's split loop (first
    fused kernel's start to last one's end), how long the card runs on
    after the host's last enqueue, and the rest of the tree ("outside":
    the card's last split kernel of one tree to the host's first launch
    call of the next: the state read, the tree build, the score update,
    the gradients, the root histogram and scan) with the card's busy
    time inside it."""
    from torch.autograd import DeviceType
    evs = prof.events()
    calls = sorted((e.time_range.start, e.time_range.end) for e in evs
                   if e.device_type == DeviceType.CPU
                   and e.name == "cudaLaunchCooperativeKernel")
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in evs
                 if e.device_type == DeviceType.CUDA)
    steps = [d for d in dev if "split_step" in d[2]]
    if len(calls) != launches * trees or len(steps) != launches * trees:
        return [f"timeline: {len(calls)} launch calls and {len(steps)} "
                f"fused kernels, expected {launches * trees}; not split"]
    host, card, tail, outside, busy = [], [], [], [], []
    for t in range(trees):
        c0, c1 = calls[t * launches], calls[(t + 1) * launches - 1]
        k0, k1 = steps[t * launches], steps[(t + 1) * launches - 1]
        host.append(c1[1] - c0[0])
        card.append(k1[1] - k0[0])
        tail.append(k1[1] - c1[1])
        if t + 1 < trees:
            a, b = k1[1], calls[(t + 1) * launches][0]
            outside.append(b - a)
            busy.append(sum(max(0.0, min(e, b) - max(s, a))
                            for s, e, _ in dev))

    def ms(x):
        return f"{sum(x) / max(len(x), 1) / 1e3:.3f}"
    return [f"timeline per tree: host enqueue of the split loop {ms(host)} "
            f"ms, card's split loop {ms(card)} ms, card after the last "
            f"enqueue {ms(tail)} ms; outside the loop {ms(outside)} ms, "
            f"card busy {ms(busy)} ms of it"]


PHASES = ("site", "lid pass", "compaction", "histogram", "reduce", "scan",
          "finish")


def leaf_phases(ds, warm: int = 2) -> str:
    """Phase times of the leaf kernel over one serial-fused tree (see
    the module note)."""
    import numpy as np
    import torch

    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops.split_step_cuda import LEAF_TIMES, LeafStep
    params = {"objective": "binary", "num_leaves": 255,
              "learning_rate": 0.1, "verbosity": -1, **PATHS["serial-fused"]}
    bst = lt.Booster(params, ds, device="cuda")
    lrn = bst._gbdt.learner
    big_l = lrn.num_leaves
    times = torch.zeros((big_l - 1, LEAF_TIMES), dtype=torch.int64,
                        device="cuda")
    events = []

    def timed_loop(k, S, T, ghc, imeta, fmeta):
        step = LeafStep(k, S, T, lrn.leaf_id, lrn.hist, lrn.binned, ghc,
                        imeta, fmeta, params=lrn.params, big_l=big_l,
                        max_depth=lrn.max_depth, b=lrn.num_bins_max,
                        has_monotone=lrn.has_monotone,
                        scratch=lrn._scratch)
        for _ in range(big_l - 1):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            step.timed(times)
            b.record()
            events.append((a, b))

    # the warm-up trees run the timed build too (its first launch in a
    # process sets the kernel up), then one tree is kept
    lrn._launch_fused = timed_loop
    for _ in range(warm):
        bst.update()
    torch.cuda.synchronize()
    events.clear()
    times.zero_()
    bst.update()
    torch.cuda.synchronize()
    del lrn._launch_fused
    tree = bst.models[-1]
    t = times.cpu().numpy()
    ev_us = np.asarray([a.elapsed_time(b) * 1e3 for a, b in events])
    nsplit = tree.num_leaves - 1
    t, ev_us = t[:nsplit], ev_us[:nsplit]
    if not (t[:, 7] > 0).all():
        raise SystemExit("chip_profile: a split wrote no clock reads")
    # slots 0-6 are block 0's (clock64 and ns); slot 7 is the ns at which
    # the last block wrote the state
    lines, groups = phase_lines(
        "leaf phases", f"{type(lrn).__name__} num_bins_max "
        f"{lrn.num_bins_max}, {len(ds.label)} rows, one tree of {nsplit} "
        f"splits (after {warm} warm-up trees)", PHASES,
        t[:, :7], t[:, 8:15], t[:, 7], ev_us, tree)
    from lightgbm_tpu_torch.ops.split_step_cuda import leaf_launch_shape
    lines.append("[leaf phases] launch shape: " + str(leaf_launch_shape(
        lrn.binned.element_size(), len(ds.label), lrn.num_features,
        lrn.num_bins_max)))
    # inside the histogram phase (block 0's virtual blocks) and inside
    # block 0's first scan, in us at each split's own clock rate
    rate = (t[:, 14] - t[:, 8]).astype(np.float64) \
        / np.maximum(t[:, 6] - t[:, 0], 1)               # cycles per ns
    hist_us = t[:, 16:20].astype(np.float64) / rate[:, None] / 1e3
    scan_us = np.diff(t[:, 20:25].astype(np.float64), axis=1) \
        / rate[:, None] / 1e3
    for label, m in groups:
        if not m.any():
            continue
        h = ", ".join(f"{name} {hist_us[m, i].mean():.2f}" for i, name in
                      enumerate(("first fetch", "stores", "accumulate",
                                 "write-out")))
        sc = ", ".join(f"{name} {scan_us[m, i].mean():.2f}" for i, name in
                       enumerate(("load planes", "prefix sums",
                                  "candidates", "argmax + row")))
        lines.append(f"[leaf phases] {label}: block 0 histogram us: {h}; "
                     f"block 0 scan us: {sc}")
    print("\n".join(lines))
    del bst
    torch.cuda.empty_cache()
    return "\n".join(lines)


def smaller_child_rows(tree, nsplit: int):
    """Row count of the smaller child of each of a tree's splits."""
    import numpy as np

    def count(c):
        return int(tree.internal_count[c]) if c >= 0 \
            else int(tree.leaf_count[~c])
    return np.asarray([min(count(tree.left_child[s]),
                           count(tree.right_child[s]))
                       for s in range(nsplit)])


def phase_lines(tag, head, names, ns, cyc, finish_ns, ev_us, tree):
    """Mean us per phase of a timed kernel over one tree's splits.
    ``ns``/``cyc`` [splits, P + 1]: block 0's %globaltimer and clock64
    at the kernel's entry and after each of its P phases; ``finish_ns``:
    when the state was written. Phases 1..P get their share of block 0's
    cycles, scaled to its ns span; "finish" is the ns from block 0's
    last read to the state write; "launch" the CUDA-event time less the
    in-kernel span. Grouped by the smaller child's size."""
    import numpy as np
    ns, cyc = ns.astype(np.float64), cyc.astype(np.float64)
    dc = np.diff(cyc, axis=1)
    phase_us = dc / np.maximum(dc.sum(1, keepdims=True), 1) \
        * ((ns[:, -1] - ns[:, 0]) / 1e3)[:, None]
    phase_us = np.concatenate(
        [phase_us, ((finish_ns - ns[:, -1]) / 1e3)[:, None]], 1)
    launch_us = ev_us - (finish_ns - ns[:, 0]) / 1e3
    nsplit = len(ev_us)
    small = smaller_child_rows(tree, nsplit)
    lines = [f"[{tag}] {head}; mean us per split (share of the launch's "
             "event time)"]
    groups = (("all splits", np.ones(nsplit, bool)),
              ("root split", np.arange(nsplit) == 0),
              ("smaller child <= 10000 rows", small <= 10_000),
              ("smaller child > 10000 rows", small > 10_000))
    for label, m in groups:
        if not m.any():
            continue
        total = ev_us[m].mean()
        parts = [f"{name} {phase_us[m, i].mean():.2f} "
                 f"({phase_us[m, i].mean() / total:.3f})"
                 for i, name in enumerate(names)]
        parts.append(f"launch {launch_us[m].mean():.2f} "
                     f"({launch_us[m].mean() / total:.3f})")
        lines.append(f"[{tag}] {label} ({int(m.sum())} splits, "
                     f"smaller child {int(small[m].mean())} rows on "
                     f"average): event {total:.2f} us = "
                     + ", ".join(parts))
    return lines, groups


SEGMENT_PHASES = ("site", "count pass", "scatter", "histogram", "reduce",
                  "scans", "finish")


def segment_phases(ds, warm: int = 2) -> str:
    """Phase times of the segment kernel over one partitioned fused tree
    at max_bin 255 (see the module note)."""
    import numpy as np
    import torch

    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops.split_step_cuda import (SEGMENT_TIMES,
                                                        SegmentStep)
    params = {"objective": "binary", "num_leaves": 255,
              "learning_rate": 0.1, "verbosity": -1, **PATHS["fused"]}
    bst = lt.Booster(params, ds, device="cuda")
    lrn = bst._gbdt.learner
    big_l = lrn.num_leaves
    times = torch.zeros((big_l - 1, SEGMENT_TIMES), dtype=torch.int64,
                        device="cuda")
    events = []

    def timed_loop(k, S, T, imeta, fmeta):
        step = SegmentStep(k, S, T, lrn.mat, lrn.ws, lrn.hist, imeta, fmeta,
                           params=lrn.params, big_l=big_l,
                           max_depth=lrn.max_depth, b=lrn.num_bins_max,
                           f=lrn.num_features,
                           has_monotone=lrn.has_monotone,
                           scratch=lrn._scratch)
        for _ in range(big_l - 1):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            step.timed(times)
            b.record()
            events.append((a, b))

    # the warm-up trees run the timed build too, then one tree is kept
    lrn._launch_fused = timed_loop
    for _ in range(warm):
        bst.update()
    torch.cuda.synchronize()
    events.clear()
    times.zero_()
    bst.update()
    torch.cuda.synchronize()
    del lrn._launch_fused
    tree = bst.models[-1]
    nsplit = tree.num_leaves - 1
    t = times.cpu().numpy()[:nsplit]
    ev_us = np.asarray([a.elapsed_time(b) * 1e3
                        for a, b in events])[:nsplit]
    if not (t[:, 15] > 0).all():
        raise SystemExit("chip_profile: a split wrote no clock reads")
    nph = len(SEGMENT_PHASES) - 1   # phases block 0 reads, then finish
    from lightgbm_tpu_torch.ops.split_step_cuda import launch_shape
    shape = launch_shape(lrn.num_bins_max)
    lines, groups = phase_lines(
        "segment phases", f"{type(lrn).__name__} num_bins_max "
        f"{lrn.num_bins_max}, {len(ds.label)} rows, one tree of {nsplit} "
        f"splits (after {warm} warm-up trees)", SEGMENT_PHASES,
        t[:, :nph + 1], t[:, 16:17 + nph], t[:, 15], ev_us, tree)
    lines.append(f"[segment phases] launch shape: {shape}")
    # inside the histogram phase: block 0's cycles (zeroing, rows and
    # their staging and accumulation, write-out) in us at each split's
    # own clock rate, and its virtual blocks
    rate = (t[:, 16 + nph] - t[:, 16]).astype(np.float64) \
        / np.maximum(t[:, nph] - t[:, 0], 1)             # cycles per ns
    hist_us = t[:, 24:30].astype(np.float64) / rate[:, None] / 1e3
    for label, m in groups:
        if not m.any():
            continue
        h = ", ".join(f"{name} {hist_us[m, i].mean():.2f}" for i, name in
                      ((0, "zeroing"), (1, "rows"), (4, "of which staging"),
                       (5, "accumulation"), (2, "write-out")))
        lines.append(f"[segment phases] {label}: block 0 histogram us: {h}; "
                     f"its virtual blocks {t[m, 27].mean():.2f}")
    # the root histogram (hist_segment.cu) of the whole matrix
    n, f, b = lrn.num_data, lrn.num_features, lrn.num_bins_max
    hist_ms = []
    for _ in range(21):
        a = torch.cuda.Event(enable_timing=True)
        c = torch.cuda.Event(enable_timing=True)
        a.record()
        hc.histogram_segment(lrn.mat, 0, n, b, f)
        c.record()
        torch.cuda.synchronize()
        hist_ms.append(a.elapsed_time(c))
    lines.append(f"[segment phases] root histogram ({n} rows, hist_segment)"
                 f": median {np.median(hist_ms[1:]):.4f} ms over 20")
    print("\n".join(lines))
    del bst
    torch.cuda.empty_cache()
    return "\n".join(lines)


def hist_rows_phases(sets, timed: bool = True) -> str:
    """``hist_rows`` over the 2M x 28 bin matrices, u8 (max_bin 255) and
    u16 (max_bin 1023), over all rows and over a random third in row
    order: the median of 20 launches between CUDA events and, with
    ``timed``, one launch of the timed instantiation (see the module
    note), whose blocks' cycles give the cycles per 32-row feature group
    of a busy warp, and of an SM (two blocks an SM)."""
    import numpy as np
    import torch

    import lightgbm_tpu_torch as lt
    from chip_smoke import hist_rows_work, time_ms
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops.histogram import make_ghc
    dev = torch.device("cuda")
    n = len(sets[255].label)
    gen = torch.Generator(device=dev).manual_seed(7)
    ghc = make_ghc(torch.randn(n, generator=gen, device=dev),
                   torch.rand(n, generator=gen, device=dev) * 0.25 + 1e-3)
    gen.manual_seed(11)
    third = torch.nonzero(torch.rand(n, generator=gen, device=dev) < 1 / 3) \
        .flatten().to(torch.int32)
    lines = []
    for width, mb in (("u8", 255), ("u16", 1023)):
        binned = sets[mb]._construct(lt.Config.from_params(
            {"objective": "binary", "max_bin": mb}))
        bins = binned.binned_device(dev)
        b = int(binned.num_bins_array().max())
        f, bb = bins.shape[1], bins.element_size()
        partial = hc.rows_partial(bins, b)
        for mode, ids in (("all rows", None), ("a third", third)):
            rows = n if ids is None else ids.numel()
            work = hist_rows_work(rows, f, b, bb)
            ms = time_ms(lambda: hc.histogram_rows(bins, ghc, b, ids,
                                                   partial=partial), 20)
            line = (f"[hist_rows phases] {width} ({b} bins), {mode} ({rows} "
                    f"rows): {ms:.4f} ms median of 20; {work['blocks']} "
                    f"blocks, {work['busy_warps']} busy warps a block, "
                    f"{work['groups_per_warp']} groups a busy warp")
            if timed:
                times = torch.zeros((work["blocks"], 4), dtype=torch.int64,
                                    device=dev)
                hc.histogram_rows(bins, ghc, b, ids, partial=partial,
                                  times=times)
                torch.cuda.synchronize()
                cyc = times.cpu().numpy().astype(np.float64)
                mean = cyc.mean(0)
                per = mean / work["groups_per_warp"]
                sm = per / (2 * work["busy_warps"])
                line += ("; timed build, mean cycles a block: " + ", ".join(
                    f"{name} {mean[i]:.0f}" for i, name in enumerate(
                        ("first fetch", "stores", "accumulation",
                         "write-out")))
                    + f" (slowest block's accumulation "
                    f"{cyc[:, 2].max():.0f}); per 32-row feature group: "
                    f"a busy warp {per[1]:.1f} stores + {per[2]:.1f} "
                    f"accumulation cycles, an SM {sm[1]:.1f} + {sm[2]:.1f}")
            lines.append(line)
            print(line)
        del partial, bins
    torch.cuda.empty_cache()
    return "\n".join(lines)


SCAN_POINTS = ("load planes", "prefix sums", "candidates", "argmax + row")


def _sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         stdout=subprocess.PIPE, text=True, check=True)
    return float(out.stdout.strip().splitlines()[0])


def scan_phases(sets) -> str:
    """The standalone scan kernel on two children's [28, B, 3] histograms
    of the 2M-row matrices (a third of the rows and the rest) at max_bin
    255 and 1023: the mean device time of 100 launches (profiler) at the
    kernel's own block size and, through the profiling entry
    (``per_feature_numerical_profile``), at other block sizes; then one
    launch of its timed build (``times=``): each block's thread 0 reads
    clock64 at scan_feature's five points, printed as mean cycles of
    each sub-phase over the blocks, and us at the SM clock nvidia-smi
    reads just after. A tree without the profiling entry (a parent)
    prints the default launch time only."""
    import numpy as np
    import torch

    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.learner.partitioned import (
        feature_meta_from_dataset, split_params_from_config)
    from lightgbm_tpu_torch.ops import split_scan_cuda as sc
    from lightgbm_tpu_torch.ops.histogram import build_histogram, make_ghc
    from lightgbm_tpu_torch.ops.split import meta_tensors
    dev = torch.device("cuda")
    n = len(sets[255].label)
    gen = torch.Generator(device=dev).manual_seed(7)
    ghc = make_ghc(torch.randn(n, generator=gen, device=dev),
                   torch.rand(n, generator=gen, device=dev) * 0.25 + 1e-3)
    profiled = getattr(sc, "per_feature_numerical_profile", None)
    lines = []
    for mb in (255, 1023):
        cfg = lt.Config.from_params({"objective": "binary", "max_bin": mb,
                                     "verbosity": -1})
        binned = sets[mb]._construct(cfg)
        bins = binned.binned_device(dev)
        b = int(binned.num_bins_array().max())
        hists = [build_histogram(bins[:n // 3], ghc[:n // 3], b),
                 build_histogram(bins[n // 3:], ghc[n // 3:], b)]
        leaves = []
        for h in hists:
            t = h[0].sum(0).cpu().numpy().astype(np.float32)
            leaves.append((t[0], t[1], t[2], np.float32(-np.inf),
                           np.float32(np.inf)))
        meta_t = meta_tensors(feature_meta_from_dataset(binned), dev)
        tables = sc.scan_meta_tables(meta_t)
        params = split_params_from_config(cfg, any_missing=False)
        f = hists[0].shape[0]

        def launch():
            return sc.per_feature_numerical_cuda(hists, leaves, meta_t,
                                                 params, tables)

        def profile(**kw):
            return profiled(hists, leaves, meta_t, params, tables, **kw)
        line = (f"[scan phases] B {b}, K 2, F {f}: device us a launch "
                f"(profiler, 100 launches): default block "
                f"{device_us(launch, 100, 'split_scan_kernel'):.2f}")
        if profiled is not None:
            line += "; by block size:"
            for threads in (64, 128, 192, 256, 384, 512):
                us = device_us(lambda: profile(threads=threads), 100,
                               "split_scan_kernel")
                line += f" {threads} {us:.2f}"
            times = torch.zeros((2, f, 5), dtype=torch.int64, device=dev)
            profile(times=times)
            torch.cuda.synchronize()
            mhz = _sm_clock_mhz()
            cyc = np.diff(times.cpu().numpy().astype(np.float64),
                          axis=-1).reshape(-1, 4)
            mean = cyc.mean(0)
            line += (f"; timed build, mean cycles a block (us at "
                     f"{mhz:.0f} MHz): " + ", ".join(
                         f"{name} {mean[i]:.0f} ({mean[i] / mhz:.2f})"
                         for i, name in enumerate(SCAN_POINTS))
                     + f"; total {mean.sum():.0f} "
                     f"({mean.sum() / mhz:.2f})")
        lines.append(line)
        print(line)
        del hists, bins
    torch.cuda.empty_cache()
    return "\n".join(lines)


def partition_times(sets) -> str:
    """``partition_segment`` on the 2M x 28 u8 training matrix (the
    whole matrix as one segment, feature 3 at bin 127, as chip_smoke.py
    times it): the median of 20 calls between CUDA events (as
    chip_smoke.py times it) and the mean device time of its kernels
    (profiler)."""
    import torch

    import lightgbm_tpu_torch as lt
    from chip_smoke import time_ms
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import partition_cuda as pc
    dev = torch.device("cuda")
    binned = sets[255]._construct(lt.Config.from_params(
        {"objective": "binary", "max_bin": 255, "verbosity": -1}))
    mat = hc.build_matrix(binned.binned_device(dev))
    n, f = mat.shape[0], binned.num_features
    gen = torch.Generator(device=dev).manual_seed(7)
    hc.pack_gh(mat, f, torch.randn(n, generator=gen, device=dev),
               torch.rand(n, generator=gen, device=dev),
               torch.ones(n, device=dev))
    ws = torch.empty_like(mat)
    b = int(binned.num_bins_array().max())
    call = lambda: pc.partition_segment(mat, ws, 0, n, 3, 127, 0, 0,  # noqa: E731
                                        0, b, False)
    ms = time_ms(call, 20)
    us = device_us(call, 20, "part_")
    lines = [f"[partition] {n} rows x {mat.shape[1]} bytes: {ms:.4f} ms "
             f"median of 20 between CUDA events, {us / 1e3:.4f} ms device "
             "time a call (profiler)"]
    print(lines[-1])
    del mat, ws
    if hasattr(pc, "partition_segment_profile"):
        lines += partition_variants(n, b)
    torch.cuda.empty_cache()
    return "\n".join(lines)


def partition_variants(n: int, b: int) -> list:
    """The compaction's instantiations against each other: on random u8
    matrices of 32-, 48- and 64-byte rows, the mean device time of a
    call (profiler) on the per-phase path's average segment (60,169 rows)
    and on all ``n`` rows, with the rows held in registers over the
    look-back (vpr = row bytes / 16, the kernel's pick) and loaded after
    it (vpr 0), in the order held, loaded, loaded, held."""
    import torch

    from lightgbm_tpu_torch.ops import partition_cuda as pc
    dev = torch.device("cuda")
    lines = []
    for stride in (32, 48, 64):
        gen = torch.Generator(device=dev).manual_seed(stride)
        mat = torch.randint(0, 256, (n, stride), generator=gen,
                            device=dev, dtype=torch.uint8)
        ws = torch.empty_like(mat)
        for begin, count, reps in ((n // 3, 60_169, 200), (0, n, 20)):
            def call(vpr):
                return pc.partition_segment_profile(
                    mat, ws, begin, count, 3, 127, 0, 0, 0, b, False,
                    vpr=vpr)
            held, loaded = stride // 16, 0
            us = {held: [], loaded: []}
            for vpr in (held, loaded, loaded, held):
                us[vpr].append(device_us(lambda: call(vpr), reps, "part_"))
            lines.append(
                f"[partition] {stride}-byte rows, {count} rows: device us a"
                f" call (profiler, {reps} calls): rows held (vpr {held}) "
                + ", ".join(f"{u:.2f}" for u in us[held])
                + "; rows loaded after the look-back (vpr 0) "
                + ", ".join(f"{u:.2f}" for u in us[loaded]))
            print(lines[-1])
        del mat, ws
    return lines


BATCHED_MODELS = (4, 8)


def batched_launch_phases(tag, ns, cyc, finish_ns, ev_us):
    """Mean us per phase of the batched leaf step's timed launches:
    ``ns``/``cyc`` [launches, 7] block 0's %globaltimer and clock64 at
    the entry and after each of its 6 phases, ``finish_ns`` the latest
    state write. As ``phase_lines``, for the root launch and the tree's
    average launch."""
    import numpy as np
    ns, cyc = ns.astype(np.float64), cyc.astype(np.float64)
    dc = np.diff(cyc, axis=1)
    phase_us = dc / np.maximum(dc.sum(1, keepdims=True), 1) \
        * ((ns[:, -1] - ns[:, 0]) / 1e3)[:, None]
    phase_us = np.concatenate(
        [phase_us, ((finish_ns - ns[:, -1]) / 1e3)[:, None]], 1)
    launch_us = ev_us - (np.maximum(finish_ns, ns[:, -1]) - ns[:, 0]) / 1e3
    lines = []
    for label, m in (("root launch", np.arange(len(ev_us)) == 0),
                     ("tree average", np.ones(len(ev_us), bool))):
        total = ev_us[m].mean()
        parts = [f"{name} {phase_us[m, i].mean():.2f} "
                 f"({phase_us[m, i].mean() / total:.3f})"
                 for i, name in enumerate(PHASES)]
        parts.append(f"launch {launch_us[m].mean():.2f} "
                     f"({launch_us[m].mean() / total:.3f})")
        lines.append(f"[{tag}] {label}: timed event {total:.2f} us = "
                     + ", ".join(parts))
    return lines


def batched_phases(ds, dev, timed: bool = True) -> str:
    """Both model-batched kernels at B 4 and B 8: the first B models of
    ``chip_smoke.py`` phase 17's bucket 0 (``mb_sweep``) at iteration 0
    over the 2M x 28 u8 rows (255 leaves). Kernel B
    (``hist_rows_batched``): the median of 20 launches against the
    median of 20 loops of B ``hist_rows`` launches at the same shape,
    and with ``timed`` one launch of its timed build (mean cycles a
    block of each lap). Kernel A (``fused_split_step_leaf_batched``): a
    whole tree of L - 1 launches from the root, each between CUDA
    events (the root launch and the tree's average), then with
    ``timed`` the same tree through the timed build (block 0's phases,
    ``batched_launch_phases``). A tree without the timed builds (a
    parent) prints the event times alone."""
    import numpy as np
    import torch
    from chip_smoke import mb_ghc, mb_sweep, time_ms
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops.split_step_cuda import LEAF_TIMES
    lines = []
    params = mb_sweep(1)
    for models in BATCHED_MODELS:
        bb, ghc = mb_ghc(params[:models], ds, dev)
        lrn = bb.learner
        bins, nb = lrn.serial.binned, lrn.serial.num_bins_max
        n, f = bins.shape
        bb_ = bins.element_size()
        tag = f"batched phases B {models}"
        partial = lrn._scratch.partial
        single = hc.rows_partial(bins, nb)
        ghcs = [ghc[i].contiguous() for i in range(models)]
        k_ms = time_ms(lambda: hc.histogram_rows_batched(
            bins, ghc, nb, partial=partial), 20)
        loop_ms = time_ms(lambda: [hc.histogram_rows(bins, g, nb,
                                                     partial=single)
                                   for g in ghcs], 20)
        tile = hc.leaf_feat_tile(f, nb, bb_)
        line = (f"[{tag}] hist_rows_batched {n} x {f}, {nb} bins: "
                f"{k_ms:.4f} ms median of 20, {models} hist_rows launches "
                f"{loop_ms:.4f} ms; block "
                f"{hc.rows_batched_shape(bb_, nb, tile, models)}")
        if timed and hasattr(hc, "BATCHED_LAPS"):
            blocks = hc.rows_batched_blocks(n, f, nb, bb_, models)
            times = torch.zeros((blocks, len(hc.BATCHED_LAPS)),
                                dtype=torch.int64, device=dev)
            hc.histogram_rows_batched(bins, ghc, nb, partial=partial,
                                      times=times)
            torch.cuda.synchronize()
            cyc = times.cpu().numpy().astype(np.float64)
            line += f"; timed build, {blocks} blocks, mean cycles a block: " \
                + ", ".join(f"{name} {v:.0f}" for name, v in
                            zip(hc.BATCHED_LAPS, cyc.mean(0))) \
                + f" (slowest block {cyc.sum(1).max():.0f})"
        lines.append(line)
        print(line)
        del single, ghcs

        k, S, T, imeta, fmeta = lrn.root_states(ghc)
        start = [t.clone() for t in (k, S, T, lrn.lid, lrn.hist)]
        state = (k, S, T, lrn.lid, lrn.hist)
        step = lrn.split_step(k, S, T, ghc, imeta, fmeta)
        big_l = lrn.num_leaves

        def tree(launch):
            for dst, t in zip(state, start):
                dst.copy_(t)
            ev = []
            for i in range(big_l - 1):
                a = torch.cuda.Event(enable_timing=True)
                c = torch.cuda.Event(enable_timing=True)
                a.record()
                launch(i)
                c.record()
                ev.append((a, c))
            torch.cuda.synchronize()
            return np.asarray([a.elapsed_time(c) * 1e3 for a, c in ev])

        tree(lambda i: step())                          # warm-up
        ev_us = tree(lambda i: step())
        line = (f"[{tag}] fused_split_step_leaf_batched, {big_l - 1} "
                f"launches from the root: root {ev_us[0] / 1e3:.4f} ms, tree"
                f" average {ev_us.mean() / 1e3:.4f} ms a launch (CUDA "
                f"events); launch shape {lrn._scratch.shape}")
        lines.append(line)
        print(line)
        if timed and hasattr(step, "timed"):
            times = torch.zeros((big_l - 1, LEAF_TIMES), dtype=torch.int64,
                                device=dev)
            tree(lambda i: step.timed(times, i))        # warm-up
            times.zero_()
            ev_t = tree(lambda i: step.timed(times, i))
            t = times.cpu().numpy()
            if not (t[:, 7] > 0).all():
                raise SystemExit("chip_profile: a batched launch wrote no "
                                 "clock reads")
            for line in batched_launch_phases(tag, t[:, :7], t[:, 8:15],
                                              t[:, 7], ev_t):
                lines.append(line)
                print(line)
            rate = (t[:, 14] - t[:, 8]).astype(np.float64) \
                / np.maximum(t[:, 6] - t[:, 0], 1)
            hist_us = t[:, 16:20].astype(np.float64) / rate[:, None] / 1e3
            line = f"[{tag}] block 0 histogram us, tree average: " + ", ".join(
                f"{name} {hist_us[:, i].mean():.2f}" for i, name in
                enumerate(("first fetch", "stores", "accumulate",
                           "write-out")))
            if (t[:, 20:24] > 0).all():
                # inside the lid pass and the compaction: block 0's walk,
                # its block reduction, the wait at the grid sync
                c = t.astype(np.float64)
                marks = np.stack([c[:, 9], c[:, 20], c[:, 21], c[:, 10],
                                  c[:, 22], c[:, 23], c[:, 11]], 1)
                part = np.diff(marks, axis=1) / rate[:, None] / 1e3
                line += "; inside, tree average us: " + ", ".join(
                    f"{name} {part[:, i].mean():.2f}" for i, name in
                    enumerate(("lid walk", "lid counts", "lid sync wait",
                               "compaction offsets", "compaction words",
                               "compaction sync wait")))
            lines.append(line)
            print(line)
        del bb, lrn, ghc, start, state, step, partial
        torch.cuda.empty_cache()
    return "\n".join(lines)


def batched_device(ds, dev) -> str:
    """Both model-batched kernels' device time at B 4 and B 8 (the
    shapes of ``batched_phases``), each in its own profiler session: the
    root launch of kernel A (its state restored between calls, outside
    the kernel's intervals) and kernel B."""
    import torch
    from chip_smoke import device_us, mb_ghc, mb_sweep
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    lines = []
    params = mb_sweep(1)
    for models in BATCHED_MODELS:
        bb, ghc = mb_ghc(params[:models], ds, dev)
        lrn = bb.learner
        bins, nb = lrn.serial.binned, lrn.serial.num_bins_max
        partial = lrn._scratch.partial
        b_us = device_us(lambda: hc.histogram_rows_batched(
            bins, ghc, nb, partial=partial), 10, "hist_rows_batched",
            need=("hist_rows_batched_kernel",))
        k, S, T, imeta, fmeta = lrn.root_states(ghc)
        start = [t.clone() for t in (k, S, T, lrn.lid, lrn.hist)]
        state = (k, S, T, lrn.lid, lrn.hist)
        step = lrn.split_step(k, S, T, ghc, imeta, fmeta)

        def root():
            for dst, t in zip(state, start):
                dst.copy_(t)
            step()
        a_us = device_us(root, 10, "split_step_leaf_batched",
                         need=("split_step_leaf_batched",))
        line = (f"[batched device B {models}] device ms (profiler, mean of "
                f"10): hist_rows_batched "
                + (f"{b_us / 1e3:.4f}" if b_us else "not measured")
                + ", fused_split_step_leaf_batched root launch "
                + (f"{a_us / 1e3:.4f}" if a_us else "not measured"))
        lines.append(line)
        print(line)
        del bb, lrn, ghc, start, state, step, partial
        torch.cuda.empty_cache()
    return "\n".join(lines)


MV_ITERS = 4


def multival_sets():
    """The multi-val slot matrices of chip_smoke.py phase 12: (c) the
    Bosch-shaped 1M x 968 at 15% (max_bin 63; K ~200, 242 pseudo-groups)
    and (a) the Expo one-hot 2M x 674 (max_bin 255; K 2), binned on the
    host as the phase bins them. Returns {label: (Dataset, binned,
    params)}."""
    import lightgbm_tpu_torch as lt
    from chip_smoke import bosch_like, expo_one_hot
    base = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
            "verbosity": -1}
    out = {}
    for label, make, params in (
            ("c", lambda: bosch_like(1_000_000),
             dict(base, max_bin=63, learning_rate=0.015,
                  min_sum_hessian_in_leaf=5)),
            ("a", lambda: expo_one_hot(2_000_000, 42),
             dict(base, max_bin=255))):
        t0 = time.perf_counter()
        data, y = make()
        ds = lt.Dataset(data, label=y)
        binned = ds._construct(lt.Config.from_params(params))
        print(f"[multival] {label}: {data.shape[0]} x {data.shape[1]} "
              f"binned in {time.perf_counter() - t0:.1f} s, slots "
              f"{binned.mv_slots.shape}")
        out[label] = (ds, binned, params)
    return out


def multival_caller(binned, dev):
    """(call(ghc, b, ids, times=None), layout, b): the multi-val
    histogram of a binned dataset over its slots' compact layout (built
    here, its time printed)."""
    import torch
    from lightgbm_tpu_torch.ops import hist_multival_cuda as hm
    slots = binned.mv_slots_device(dev)
    g_mv = binned.num_groups - binned.num_dense_groups
    b = int(max(binned.num_bins_array().max(), binned.group_num_bins.max()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lay = binned.mv_layout_device(dev)
    torch.cuda.synchronize()
    print(f"[multival] layout of {tuple(slots.shape)} slots built on the "
          f"card in {(time.perf_counter() - t0) * 1e3:.1f} ms: "
          f"{lay.ent.numel()} entries, {lay.windows} windows")
    partial = hm.multival_partial(g_mv, b, dev)

    def call(ghc, bb, ids, times=None):
        return hm.hist_multival(lay, ghc, bb, ids, partial=partial,
                                times=times)
    return call, lay, b


MV_TIMED = ("staging", "pass loads + sort", "accumulation", "write-out",
            "entries")


def multival_phases(sets, dev) -> str:
    """``hist_multival`` on phase 12's (c) and (a) slots: over all rows
    and a random third in row order (chip_smoke.py check_hist_multival's
    ghc and third), the median of 20 launches between CUDA events and the
    mean device time of 5 (its own profiler session) against the byte
    bound, and one launch of the timed build (mean cycles a
    block of each of its laps); then ``MV_ITERS`` iterations of each
    run's training with CUDA events around every call (ms a call,
    calls)."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from chip_smoke import (DeviceTimer, HBM_BYTES_PER_S, device_us,
                            multival_bytes, time_ms)
    from lightgbm_tpu_torch.learner import serial as ls
    from lightgbm_tpu_torch.ops import hist_multival_cuda as hmc
    lines = []
    for label, (ds, binned, params) in sets.items():
        call, lay, b = multival_caller(binned, dev)
        n, k, g_mv = lay.n, lay.k, lay.g_mv
        gen = torch.Generator(device=dev).manual_seed(12)
        ghc = torch.stack([torch.randn(n, generator=gen, device=dev),
                           torch.rand(n, generator=gen, device=dev) * 0.25,
                           torch.ones(n, device=dev)], 1).contiguous()
        third = torch.nonzero(torch.rand(n, generator=gen, device=dev)
                              < 1 / 3).flatten().to(torch.int32)
        real = lay.ent.numel() / max(n, 1)
        for mode, ids in (("all rows", None), ("a third", third)):
            rows = n if ids is None else ids.numel()
            ms = time_ms(lambda: call(ghc, b, ids), 20)
            dev_ms = device_us(lambda: call(ghc, b, ids), 5,
                               ("hist_multival",),
                               need=("hist_multival_kernel",)) / 1e3
            nbytes = multival_bytes(lay, ids, b)
            line = (f"[multival phases] {label} {mode}: {rows} rows x K {k} "
                    f"({real:.1f} real slots a row), G_mv {g_mv}, B {b}: "
                    f"{ms:.4f} ms median of 20, device "
                    + (f"{dev_ms:.4f} ms (profiler, mean of 5)" if dev_ms
                       else "not measured (profiler records lost)")
                    + f", bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
            nb = hmc.child_chunks(rows, g_mv) * lay.windows
            times = torch.zeros((nb, len(MV_TIMED)), dtype=torch.int64,
                                device=dev)
            call(ghc, b, ids, times=times)
            torch.cuda.synchronize()
            cyc = times.cpu().numpy().astype(np.float64)
            mean = cyc.mean(0)
            line += f"; timed build, {nb} blocks, mean a block: " \
                + ", ".join(f"{name} {mean[i]:.0f}"
                            for i, name in enumerate(MV_TIMED)) \
                + f" (slowest block {cyc[:, :4].sum(1).max():.0f} cycles)"
            lines.append(line)
            print(line)
        del ghc, third
        timer = DeviceTimer()
        saved = (ls.hist_multival, hmc.hist_multival)
        ls.hist_multival = hmc.hist_multival = timer.wrap(saved[0])
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bst = lt.train(params, ds, MV_ITERS, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            ls.hist_multival, hmc.hist_multival = saved
        calls = len(timer.pairs)
        splits = sum(t.num_leaves - 1 for t in bst.models)
        line = (f"[multival training] {label}: {MV_ITERS} iterations, "
                f"{splits} splits in {wall:.2f} s = {wall / max(splits, 1) * 1e3:.4f}"
                f" ms/split; hist_multival {calls} calls, "
                f"{timer.ms() / max(calls, 1):.4f} ms a call (CUDA events)")
        lines.append(line)
        print(line)
        del bst
        torch.cuda.empty_cache()
    return "\n".join(lines)


SHAP_TIMED = ("bin loads", "one fractions", "extends", "unwound sums",
              "peer sums + phi adds", "phi zero + write-out",
              "(row, bin) steps")


def shap_models(X, y, dev):
    """The models chip_smoke.py phase 10 explains: the full-width binary
    model (2M x 28, 255 leaves, max_bin 255, 9 trees) and the 5-class
    model of phase 9's run c (8 iterations, 40 trees)."""
    import lightgbm_tpu_torch as lt
    from chip_smoke import higgs_latent, objective_labels
    base = {"num_leaves": 255, "learning_rate": 0.1, "max_bin": 255,
            "verbosity": -1}
    t0 = time.perf_counter()
    ds = lt.Dataset(X, label=y)
    binary = lt.train(dict(base, objective="binary"), ds, 9, device=dev)
    _, z = higgs_latent(len(y))
    mc = lt.train(dict(base, objective="multiclass", num_class=5),
                  lt.Dataset(X, label=objective_labels("multiclass", z)), 8,
                  device=dev)
    print(f"[shap] models trained in {time.perf_counter() - t0:.1f} s: "
          f"binary {len(binary.models)} trees, 5-class {len(mc.models)}")
    return {"binary": binary, "multiclass 5": mc}


def shap_phases(models, X, dev) -> str:
    """``tree_shap`` on 100k rows of each model: the median of CUDA
    events over 5 calls against the float64 operation bound, the mean
    device time in its own profiler session, and one launch of the timed
    build (the warp kernel's mean cycles a warp in each lap)."""
    import numpy as np
    import torch
    from chip_smoke import (F64_FLOPS, HBM_BYTES_PER_S, device_us,
                            time_ms)
    from lightgbm_tpu_torch.ops import tree_shap_cuda as ts
    rows = np.ascontiguousarray(X[:100_000], np.float64)
    xd = torch.from_numpy(rows).to(dev)
    lines = []
    for label, bst in models.items():
        k = bst.num_model_per_iteration()
        sm = ts.ShapModel(bst.models, k, dev)
        n, f = rows.shape
        ms = time_ms(lambda: ts.tree_shap_cuda(sm, xd), 5)
        dev_ms = device_us(lambda: ts.tree_shap_cuda(sm, xd), 3,
                           "tree_shap") / 1e3
        nbytes, ops = ts.shap_work(sm.paths, n, f, k)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / F64_FLOPS) * 1e3
        lens = sm.paths["lens"]
        busy = lens[lens <= 32].sum() / 32 / max(len(sm.bins), 1)
        line = (f"[shap phases] {label}: {n} rows, {len(bst.models)} trees, "
                f"{len(lens)} paths (mean {lens.mean():.2f}, longest "
                f"{lens.max()} elements), {len(sm.bins)} bins ({busy:.3f} of "
                f"their lanes busy): {ms:.3f} ms median of 5, device "
                f"{dev_ms:.3f} ms (profiler, mean of 3), bound "
                f"{bound:.4f} ms")
        nw = ts.shap_warps(n, k * (f + 1))
        times = torch.zeros((nw, len(SHAP_TIMED)), dtype=torch.int64,
                            device=dev)
        ts.tree_shap_cuda(sm, xd, times=times)
        torch.cuda.synchronize()
        mean = times.cpu().numpy().astype(np.float64).mean(0)
        line += "; timed build, mean a warp: " + ", ".join(
            f"{name} {mean[i]:.0f}" for i, name in enumerate(SHAP_TIMED))
        lines.append(line)
        print(line)
    return "\n".join(lines)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--trees", type=int, default=4)
    ap.add_argument("--paths", default=None,
                    help="comma-separated grow paths (default: all four, "
                    "or none with a phases flag)")
    ap.add_argument("--leaf-phases", action="store_true",
                    help="time the leaf kernel's phases only")
    ap.add_argument("--segment-phases", action="store_true",
                    help="time the segment kernel's phases only")
    ap.add_argument("--hist-rows-phases", action="store_true",
                    help="time hist_rows and its timed build only")
    ap.add_argument("--hist-rows", action="store_true",
                    help="time hist_rows only (no timed build)")
    ap.add_argument("--scan-phases", action="store_true",
                    help="time the standalone scan and its timed build")
    ap.add_argument("--multival-phases", action="store_true",
                    help="time hist_multival on phase 12's slots, its "
                    "timed build and its calls in training")
    ap.add_argument("--shap-phases", action="store_true",
                    help="time tree_shap on 100k rows and its timed build")
    ap.add_argument("--batched-phases", action="store_true",
                    help="time both model-batched kernels at B 4 and 8 "
                    "and their timed builds")
    ap.add_argument("--batched", action="store_true",
                    help="both model-batched kernels' device time, each "
                    "in its own profiler session")
    ap.add_argument("--package", default=None,
                    help="import lightgbm_tpu_torch from this directory "
                    "(a parent tree unpacked beside this one)")
    ap.add_argument("--partition", action="store_true",
                    help="time partition_segment on the 2M-row matrix")
    ap.add_argument("--codegen", default=None, metavar="SRC",
                    help="print ptxas's registers and spills and the SASS "
                    "size of each kernel of these sources (comma-"
                    "separated; first)")
    args = ap.parse_args()
    phase_flags = ["leaf-phases"] * args.leaf_phases \
        + ["segment-phases"] * args.segment_phases \
        + ["hist-rows-phases"] * args.hist_rows_phases \
        + ["hist-rows"] * args.hist_rows \
        + ["scan-phases"] * args.scan_phases \
        + ["partition"] * args.partition \
        + ["multival-phases"] * args.multival_phases \
        + ["shap-phases"] * args.shap_phases \
        + ["batched-phases"] * args.batched_phases \
        + ["batched"] * args.batched
    if args.package:
        sys.path.insert(0, os.path.abspath(args.package))
    paths = args.paths.split(",") if args.paths else \
        ([] if phase_flags or args.codegen else list(PATHS))
    paths += phase_flags
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    import lightgbm_tpu_torch as lt
    print(f"package: {os.path.dirname(lt.__file__)}")
    dev = torch.device("cuda")
    tables = [codegen(src) for src in args.codegen.split(",")] \
        if args.codegen else []
    if "multival-phases" in paths:
        tables.append(multival_phases(multival_sets(), dev))
    paths = [p for p in paths if p != "multival-phases"]
    if not paths:
        return write_tables(tables)
    X, y = higgs_like(args.rows)
    if "shap-phases" in paths:
        tables.append(shap_phases(shap_models(X, y, dev), X, dev))
    paths = [p for p in paths if p != "shap-phases"]
    if "batched-phases" in paths or "batched" in paths:
        mb_ds = lt.Dataset(X, label=y)
        if "batched-phases" in paths:
            tables.append(batched_phases(mb_ds, dev))
        if "batched" in paths:
            tables.append(batched_device(mb_ds, dev))
        del mb_ds
    paths = [p for p in paths if p not in ("batched-phases", "batched")]
    # binned once per max_bin (a Dataset keeps its first binning),
    # shared by the paths
    sets = {}
    phases = {"leaf-phases": ("serial-fused", leaf_phases),
              "segment-phases": ("fused", segment_phases)}
    for path in paths:
        if path in ("hist-rows-phases", "hist-rows", "scan-phases",
                    "partition"):
            for mb in (255, 1023):
                sets.setdefault(mb, lt.Dataset(X, label=y))
            if path == "scan-phases":
                tables.append(scan_phases(sets))
            elif path == "partition":
                tables.append(partition_times(sets))
            else:
                tables.append(hist_rows_phases(
                    sets, timed=path == "hist-rows-phases"))
            continue
        mb = PATHS[phases[path][0] if path in phases else path]["max_bin"]
        if mb not in sets:
            sets[mb] = lt.Dataset(X, label=y)
        tables.append(phases[path][1](sets[mb]) if path in phases
                      else profile_path(path, sets[mb], args.trees))
    return write_tables(tables)


def codegen(src: str) -> str:
    """``ptxas -v``'s report and the SASS instruction count of each
    kernel that ``src`` compiles to, from this process's library build."""
    import re
    import shutil
    from lightgbm_tpu_torch.ops import _native
    _native.library()
    log = _native.BUILD_INFO["ptxas"]
    if not log:
        return f"[codegen {src}] the library was not built in this process"
    block = log.split(f"== {src}\n", 1)[-1].split("\n== ", 1)[0]
    entries, cur = [], None
    for line in block.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"name": m.group(1)}
            entries.append(cur)
        elif cur is not None:
            for key, pat in (("regs", r"Used (\d+) registers"),
                             ("stack", r"(\d+) bytes stack frame"),
                             ("spill_st", r"(\d+) bytes spill stores"),
                             ("spill_ld", r"(\d+) bytes spill loads")):
                m = re.search(pat, line)
                if m:
                    cur[key] = int(m.group(1))
    nvcc = _native._find_nvcc()
    sass = {}
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if os.path.exists(tool):
        out = subprocess.run([tool, "-sass", _native.library_path(nvcc)],
                             stdout=subprocess.PIPE, text=True).stdout
        name = None
        for line in out.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = m.group(1)
                sass[name] = 0
            elif name and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
                sass[name] += 1
    names = [e["name"] for e in entries]
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               stdout=subprocess.PIPE,
                               text=True).stdout.splitlines()
    lines = []
    for e, pretty in zip(entries, names):
        short = re.sub(r"\(.*\)$", "", pretty.replace(
            "void (anonymous namespace)::", ""))
        line = (f"[codegen {src}] {short}: "
                f"{e.get('regs')} registers, stack {e.get('stack')} B, "
                f"spill stores {e.get('spill_st')} B, loads "
                f"{e.get('spill_ld')} B, SASS {sass.get(e['name'])} "
                "instructions")
        lines.append(line)
        print(line)
    return "\n".join(lines)


def write_tables(tables) -> int:
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile.txt"), "w") as fh:
        fh.write("\n".join(tables))
    return 0


if __name__ == "__main__":
    sys.exit(main())
