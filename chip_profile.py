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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--trees", type=int, default=4)
    ap.add_argument("--paths", default=",".join(PATHS))
    args = ap.parse_args()
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
    for path in args.paths.split(","):
        mb = PATHS[path]["max_bin"]
        if mb not in sets:
            sets[mb] = lt.Dataset(X, label=y)
        tables.append(profile_path(path, sets[mb], args.trees))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile.txt"), "w") as fh:
        fh.write("\n".join(tables))
    return 0


if __name__ == "__main__":
    sys.exit(main())
