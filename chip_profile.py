#!/usr/bin/env python3
"""Where the time of full-width training goes, on one CUDA card.

Run from the repository root: ``python3 chip_profile.py [--trees N]
[--paths fused,per-phase,serial-fused,serial-per-phase]``. Trains the
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
"""

import argparse
import os
import subprocess
import sys
import time

from chip_smoke import higgs_like


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
    bst = lt.Booster(params, ds, device="cuda")
    for _ in range(2):
        bst.update()
    torch.cuda.synchronize()
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
    by_cpu = sorted(events, key=lambda e: -e.self_cpu_time_total)
    for e in by_cpu[:12]:
        print(f"  host   {e.self_cpu_time_total / 1e3:9.2f} ms "
              f"{e.count:7d} x  {e.key[:70]}")
    tables = (f"== {path}\n"
              + events.table(sort_by="self_cuda_time_total", row_limit=60)
              + "\n"
              + events.table(sort_by="self_cpu_time_total", row_limit=60))
    del bst
    torch.cuda.empty_cache()
    return tables


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
    cyc = np.diff(t[:, 8:15].astype(np.float64), axis=1)   # [splits, 6]
    ns = t[:, :8].astype(np.float64)
    # phases 1-6 by their share of block 0's cycles, scaled to its ns
    phase_us = cyc / cyc.sum(1, keepdims=True) \
        * ((ns[:, 6] - ns[:, 0]) / 1e3)[:, None]
    phase_us = np.concatenate([phase_us, (ns[:, 7:8] - ns[:, 6:7]) / 1e3], 1)
    span_us = (ns[:, 7] - ns[:, 0]) / 1e3
    launch_us = ev_us - span_us

    def count(c):
        return int(tree.internal_count[c]) if c >= 0 \
            else int(tree.leaf_count[~c])
    small = np.asarray([min(count(tree.left_child[s]),
                            count(tree.right_child[s]))
                        for s in range(nsplit)])
    lines = [f"[leaf phases] {type(lrn).__name__} num_bins_max "
             f"{lrn.num_bins_max}, {len(ds.label)} rows, one tree of "
             f"{nsplit} splits (after {warm} warm-up trees); mean us per "
             "split (share of the launch's event time)"]
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
                 for i, name in enumerate(PHASES)]
        parts.append(f"launch {launch_us[m].mean():.2f} "
                     f"({launch_us[m].mean() / total:.3f})")
        lines.append(f"[leaf phases] {label} ({int(m.sum())} splits, "
                     f"smaller child {int(small[m].mean())} rows on "
                     f"average): event {total:.2f} us = "
                     + ", ".join(parts))
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--trees", type=int, default=4)
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--leaf-phases", action="store_true",
                    help="time the leaf kernel's phases only")
    args = ap.parse_args()
    paths = ["leaf-phases"] if args.leaf_phases else args.paths.split(",")
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
    X, y = higgs_like(args.rows)
    # binned once per max_bin (a Dataset keeps its first binning),
    # shared by the paths
    sets = {}
    tables = []
    for path in paths:
        mb = PATHS["serial-fused" if path == "leaf-phases"
                   else path]["max_bin"]
        if mb not in sets:
            sets[mb] = lt.Dataset(X, label=y)
        tables.append(leaf_phases(sets[mb]) if path == "leaf-phases"
                      else profile_path(path, sets[mb], args.trees))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile.txt"), "w") as fh:
        fh.write("\n".join(tables))
    return 0


if __name__ == "__main__":
    sys.exit(main())
