"""Build and load the port's CUDA kernels.

The kernels live in ``lightgbm_tpu_torch/csrc/*.cu`` with a plain C
interface. At first use they are compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` per source,
all started together, then linked into one shared library under
``lightgbm_tpu_torch/_build/`` (git-ignored; the ``compile_cache_dir``
parameter moves it, ``maybe_enable_compile_cache``) and loaded with
``ctypes``.
The library name carries a digest of the sources and flags, so an
edited source rebuilds and an unchanged one is reused.

Nothing here runs at import time: the CPU test suite imports every
module, and a machine without ``nvcc`` only fails when a kernel is
actually asked for.

Each wrapper counts its launches in ``LAUNCHES`` (one per wrapper call
that launches its kernel), so a run can show which kernels its main path
went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# the build directory a config's ``compile_cache_dir`` named (None: the
# default BUILD_DIR)
_CACHE_DIR = {"path": None}

# per-source extra flags: the split scan and the fused split step
# reproduce the plain versions' float32 expression order (the scan, the
# leaf outputs, the sibling subtraction), so no multiply-add contraction
# there
_EXTRA_FLAGS = {"split_scan.cu": ["-fmad=false"],
                "split_step_segment.cu": ["-fmad=false"],
                "split_step_leaf.cu": ["-fmad=false"]}
_COMMON_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"hist_segment": 0, "partition_segment": 0, "split_scan": 0,
            "fused_split_step_segment": 0, "fused_split_step_leaf": 0,
            "hist_rows": 0, "tree_shap": 0, "hist_multival": 0,
            "fused_split_step_leaf_batched": 0, "hist_rows_batched": 0}
# launches of a kernel's route, counted beside LAUNCHES: the partition's
# LUT route (categorical splits)
ROUTE_LAUNCHES = {"partition_segment_lut": 0}
# the library's build in this process: nvcc's wall seconds (0.0 when a
# built library was reused), ptxas's report, and whether this process
# built it (None until loaded); the telemetry's ``compile`` record
BUILD_INFO = {"seconds": None, "ptxas": "", "built": None}

_LIB = None
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # mat, stride, pay_off, seg, F, B, max_chunks, partial, out, out64
    # (or null), stream
    "ltt_hist_segment": [_P, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P],
    # mat, ws, stride, begin, count, feat, thr, dleft, miss, defbin,
    # nbins, use_lut, lut, scratch, epoch, seg_out, stream
    "ltt_partition_segment": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _P, _P, _I, _P, _P],
    # the same, then vpr (the compaction's instantiation) before the
    # stream
    "ltt_partition_segment_profile": [_P, _P, _I, _I, _I, _I, _I, _I, _I,
                                      _I, _I, _I, _P, _P, _I, _P, _I, _P],
    # K, F, B, hist0, hist1, leaf scalars (2 x pg ph pc cmin cmax),
    # imeta, fmeta, l1, l2, mds, min_data, min_hess, min_gain, node0,
    # node1 (node table rows or null), out, stream
    "ltt_split_scan": [_I, _I, _I, _P, _P] + [_F] * 10
    + [_P, _P] + [_F] * 6 + [_P, _P, _P, _P],
    # the same with threads before out, then times (u64 [K, F, 5] or
    # null) before the stream
    "ltt_split_scan_profile": [_I, _I, _I, _P, _P] + [_F] * 10
    + [_P, _P] + [_F] * 6 + [_I, _P, _P, _P],
    # k, S, T, mat, ws, stride, pay_off, hist, imeta, fmeta, partial,
    # tiles, counts, table, done, L, F, B, grid_cap, has_monotone,
    # max_depth, l1, l2, mds, min_data, min_hess, min_gain, stream
    "ltt_split_step_segment": [_P] * 5 + [_I, _I] + [_P] * 8 + [_I] * 6
    + [_F] * 6 + [_P],
    # the same, then times (u64 [L - 1, 32]), stream
    "ltt_split_step_segment_timed": [_P] * 5 + [_I, _I] + [_P] * 8
    + [_I] * 6 + [_F] * 6 + [_P, _P],
    # B, out int32[3] (blocks per SM, grid, shared bytes)
    "ltt_split_step_shape": [_I, _P],
    # bin_bytes, k, S, T, lid, hist, bins, ghc, imeta, fmeta, partial,
    # mask, ids, counts, table, done, n, L, F, B, feat_tile, grid_cap,
    # has_monotone, max_depth, l1, l2, mds, min_data, min_hess, min_gain,
    # stream
    "ltt_split_step_leaf": [_I] + [_P] * 15 + [_I] * 8 + [_F] * 6 + [_P],
    # the same, then times (u64 [L - 1, 32]), stream
    "ltt_split_step_leaf_timed": [_I] + [_P] * 15 + [_I] * 8 + [_F] * 6
    + [_P, _P],
    # bin_bytes, n, F, B, feat_tile, out int32[4] (blocks per SM, grid,
    # shared bytes, most chunks of a split)
    "ltt_split_step_leaf_shape": [_I] * 5 + [_P],
    # the model-batched step's: the same arguments, then models, and out
    "ltt_split_step_leaf_batched_shape": [_I] * 6 + [_P],
    # bin_bytes, models, k, S, T, lid, hist, bins, ghc, imeta, fmeta,
    # params, partial, mask, ids, counts, table, done, n, L, F, B,
    # feat_tile, grid_cap, has_monotone, max_depth, stream
    "ltt_split_step_leaf_batched": [_I, _I] + [_P] * 16 + [_I] * 8 + [_P],
    # the same, then times (u64 [32]: this launch's clock reads), stream
    "ltt_split_step_leaf_batched_timed": [_I, _I] + [_P] * 16 + [_I] * 8
    + [_P, _P],
    # bin_bytes, bins, ghc, ids (or null: all rows), count, F, B,
    # feat_tile, max_chunks, partial, out, out64 (or null), stream
    "ltt_hist_rows": [_I, _P, _P, _P, _L, _I, _I, _I, _I, _P, _P, _P, _P],
    # the same, then times (u64 [grid, 4]), stream
    "ltt_hist_rows_timed": [_I, _P, _P, _P, _L, _I, _I, _I, _I, _P, _P,
                            _P, _P],
    # bin_bytes, B, feat_tile -> the bins one block takes
    "ltt_hist_rows_window": [_I, _I, _I],
    # bin_bytes, bins, ghc, n, models, F, B, feat_tile, max_chunks,
    # partial, out, stream
    "ltt_hist_rows_batched": [_I, _P, _P, _L, _I, _I, _I, _I, _I, _P, _P,
                              _P],
    # the same, then times (u64 [grid, 5]), stream
    "ltt_hist_rows_batched_timed": [_I, _P, _P, _L, _I, _I, _I, _I, _I, _P,
                                    _P, _P, _P],
    # bin_bytes, B, feat_tile, models, out int32[3] (features and models
    # a block, shared bytes)
    "ltt_hist_rows_batched_shape": [_I, _I, _I, _I, _P],
    # ent, off, n, npad, ghc, ids (or null: all rows), count, g_mv, B,
    # max_chunks, partial, out (f32, or null), out64 (f64 unrounded, or
    # null), times (or null; int64 [grid, 5]), stream
    "ltt_hist_multival": [_P, _P, _L, _P, _P, _P, _L, _I, _I, _I, _P, _P,
                          _P, _P, _P],
    # x, n, F, nfeat, nthr, nflags, ncat_off, ncat_len, cats, pbegin,
    # pvalue, pcls, efeat, ezero, ecbegin, cnode, cleft, expected, k,
    # lint, ldbl, blen, nbins, tabs, rows, long_paths, num_long,
    # long_threads, out, use_smem, smem_bytes, long_blocks, times (or
    # null), stream
    "ltt_tree_shap": [_P, _L, _I] + [_P] * 15
    + [_I, _P, _P, _P, _I, _P, _I, _P, _I, _I, _P, _I, _I, _I, _P, _P],
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[k] = 0


def build_dir() -> str:
    """Where the kernel library is built and looked for: the last
    ``compile_cache_dir`` a config named, else ``BUILD_DIR``."""
    return _CACHE_DIR["path"] or BUILD_DIR


def maybe_enable_compile_cache(config) -> None:
    """``compile_cache_dir`` (JAX ``models/gbdt.py:282-283``, which
    points XLA's compilation cache there): the port's one compile cache
    is its kernel library, so a set directory becomes the nvcc build
    directory. Builds nothing; the library is built there at first use
    (a library already loaded stays loaded)."""
    path = getattr(config, "compile_cache_dir", "") or ""
    if path:
        _CACHE_DIR["path"] = os.path.abspath(os.path.expanduser(path))


def _sources():
    return sorted(f for f in os.listdir(SRC_DIR) if f.endswith(".cu"))


def _digest(nvcc: str) -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(SRC_DIR)):
        with open(os.path.join(SRC_DIR, name), "rb") as fh:
            h.update(name.encode() + fh.read())
    h.update(repr((_COMMON_FLAGS, _EXTRA_FLAGS, nvcc)).encode())
    return h.hexdigest()[:16]


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from source at first use")
    return nvcc


def _build(nvcc: str, lib_path: str) -> None:
    out_dir = os.path.dirname(lib_path)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    objs = []
    for src in _sources():
        obj = os.path.join(out_dir, src[:-3] + f".{os.getpid()}.o")
        cmd = [nvcc, *_COMMON_FLAGS, *_EXTRA_FLAGS.get(src, []), "-c",
               os.path.join(SRC_DIR, src), "-o", obj]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        objs.append(obj)
    logs = []
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs))
    tmp = lib_path + f".{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         "-o", tmp, *objs], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    for obj in objs:
        os.remove(obj)
    if link.returncode != 0:
        raise RuntimeError("linking the kernel library failed:\n"
                           + link.stdout)
    os.replace(tmp, lib_path)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["ptxas"] = "\n".join(logs)


def library_path(nvcc: str) -> str:
    """The library file for the current sources, flags and ``nvcc``
    under ``build_dir()`` (its name carries their digest)."""
    return os.path.join(build_dir(), f"libltt_kernels_{_digest(nvcc)}.so")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        nvcc = _find_nvcc()
        lib_path = library_path(nvcc)
        if not os.path.exists(lib_path):
            _build(nvcc, lib_path)
            BUILD_INFO["built"] = True
        else:
            BUILD_INFO["seconds"] = 0.0
            BUILD_INFO["built"] = False
        lib = ctypes.CDLL(lib_path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ltt_error_string.argtypes = [_I]
        lib.ltt_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero CUDA error code from a launcher, naming it."""
    if err != 0:
        what = _LIB.ltt_error_string(err).decode() if _LIB else "?"
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"({what})")


def stream_of(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer int."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, *, device, dtype, shape=None, name="tensor") -> None:
    """Wrapper-side input checks: device, dtype, contiguity, shape."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
