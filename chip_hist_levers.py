#!/usr/bin/env python3
"""What each lever of the row-list histogram's accumulation is worth, on
one CUDA card.

Run from the repository root: ``python3 chip_hist_levers.py [--reps N]``.
It builds ``chip_hist_levers.cu`` with nvcc (every lever a kernel of its
own; see the note there) into the git-ignored ``lightgbm_tpu_torch/
_build/``, makes a 2M x 28 problem on the card from a seed (uniform bins,
u8 at 255 bins and u16 at 1023; gradients, hessians and a 0/1 count
column), and times every lever and the shipped kernel
(``hist_cuda.histogram_rows``) over all rows and over a random third in
row order: the median of ``--reps`` launches between CUDA events. Each
lever's histogram is held against the shipped kernel's bit for bit (the
two diagnostic levers are expected to differ). Prints the card's name
and power limit first.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

LEVERS = {0: "before: match, three float64 a bin",
          1: "match, count an integer plane",
          2: "match, int count, (g, h) one double2",
          3: "match, int count, double2, own (g, h) in registers",
          4: "3 with the count by shared atomics",
          5: "3 with a feature's bins split across idle warps",
          6: "diagnostic: 3 without the match (wrong sums)",
          7: "diagnostic: 3 without the shared-memory adds (wrong sums)",
          8: "byte tags, match over the colliding lanes only",
          9: "peer words (shipped design)",
          10: "peer words, 2 groups loaded",
          11: "peer words, 8 groups loaded",
          12: "peer words, a feature's bins split across idle warps",
          13: "peer words, the first lane to set the word leads"}


def build(nvcc: str) -> ctypes.CDLL:
    out_dir = os.path.join(HERE, "lightgbm_tpu_torch", "_build")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libltt_levers.{os.getpid()}.so")
    t0 = time.perf_counter()
    r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                        os.path.join(HERE, "chip_hist_levers.cu"), "-o", lib],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if r.returncode:
        raise SystemExit("chip_hist_levers: nvcc failed:\n" + r.stdout)
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    so = ctypes.CDLL(lib)
    os.remove(lib)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    so.levers_hist.argtypes = [I, I, P, P, P, L, I, I, I, I, P, P]
    so.levers_hist.restype = I
    return so


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_hist_levers: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import time_ms
    from lightgbm_tpu_torch.ops import _native
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    so = build(_native._find_nvcc())
    dev = torch.device("cuda")
    n, f = 2_000_000, 28
    g = torch.Generator(device=dev).manual_seed(7)
    ghc = torch.stack([torch.randn(n, generator=g, device=dev),
                       torch.rand(n, generator=g, device=dev) * 0.25 + 1e-3,
                       (torch.rand(n, generator=g, device=dev) < 0.9)
                       .float()], 1)
    third = torch.nonzero(torch.rand(n, generator=g, device=dev) < 1 / 3) \
        .flatten().to(torch.int32)
    for width, b in (("u8", 255), ("u16", 1023)):
        bins = torch.randint(0, b, (n, f), generator=g, device=dev) \
            .to(torch.uint8 if b <= 256 else torch.int16)
        bb = bins.element_size()
        tile = hc.leaf_feat_tile(f, b, bb)
        partial = hc.rows_partial(bins, b)
        for mode, ids in (("all rows", None), ("a third", third)):
            count = n if ids is None else ids.numel()
            chunks = hc.leaf_child_chunks(count, f, tile)

            def shipped():
                return hc.histogram_rows(bins, ghc, b, ids, partial=partial)
            ref = shipped()
            line = [f"shipped {time_ms(shipped, args.reps):.4f}"]
            for v in LEVERS:
                out = torch.zeros((f, b, 3), device=dev)

                def lever(v=v, out=out):
                    err = so.levers_hist(
                        v, bb, bins.data_ptr(), ghc.data_ptr(),
                        None if ids is None else ids.data_ptr(), count, f, b,
                        tile, chunks, partial.data_ptr(), out.data_ptr())
                    if err:
                        raise SystemExit(f"chip_hist_levers: lever {v} "
                                         f"failed with CUDA error {err}")
                lever()
                torch.cuda.synchronize()
                same = torch.equal(out.view(torch.int32),
                                   ref.view(torch.int32))
                line.append(f"{v} {time_ms(lever, args.reps):.4f}"
                            f"{'' if same else ' (differs)'}")
            print(f"[levers] {width} ({b} bins), {mode} ({count} rows), "
                  f"median ms of {args.reps}: " + ", ".join(line))
        del bins, partial
    for v, what in LEVERS.items():
        print(f"[levers] {v}: {what}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
