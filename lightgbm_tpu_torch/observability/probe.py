"""One-shot per-phase probe: real hist/split/partition/grad/update cost
(port of ``lightgbm_tpu/observability/probe.py``).

A fused grow path enqueues a tree's splits as one loop of kernel
launches, so per-iteration host timing can only attribute whole phases
(grad / grow / tree / update). This probe times the port's own
components ONCE per train run, on the trained shapes, with CUDA events
on the card (host wall time around a synchronised loop on the CPU):

* ``grad`` — the objective's gradients;
* ``update`` — the score gather-add (``score[:, 0] += leaf_value[leaf]``);
* ``hist`` — the root histogram: ``hist_segment`` (PERF.md row 1) on the
  partitioned learner's matrix, ``hist_rows`` (row 8) on the serial
  learner's bins (their plain versions on the CPU or with
  ``ops="plain"``);
* ``partition`` — ``partition_segment`` (row 4) over a copy of the
  partitioned learner's matrix (the learner's row order is untouched),
  or the ``leaf_id`` split (``ops/partition.py:split_leaf``);
* ``split`` — the numerical scan ``split_scan`` (row 5) of the root.

Runs only when a JSONL telemetry sink is configured (never in ring-only
mode), once per booster, after the training loop has finished. Bundled
or multi-val data is skipped (its group histograms need the debundle
path), as in the JAX package. Every step is best-effort: any failure
skips the probe (logged) rather than failing training. Opt out with
``LGBM_TPU_TELEMETRY_NO_PROBE=1``.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np

from ..utils.log import log_info


def _timeit(fn, device, warmup: int = 1, iters: int = 2) -> float:
    """Seconds a call of ``fn``: CUDA events around ``iters`` calls on
    the card, the host clock around them on the CPU."""
    import torch
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def run_phase_probe(gbdt) -> Optional[Dict[str, float]]:
    """Measure grad/hist/split/partition/update seconds for one
    iteration-equivalent of work on ``gbdt``'s learner. Returns the
    phase dict, or None when the learner shape is not probeable."""
    if os.environ.get("LGBM_TPU_TELEMETRY_NO_PROBE"):
        return None
    try:
        return _probe(gbdt)
    except Exception as e:  # noqa: BLE001 - probe must never raise
        log_info(f"telemetry phase probe skipped: {e}")
        return None


def _probe(gbdt) -> Optional[Dict[str, float]]:
    import torch
    from ..learner.partitioned import PartitionedTreeLearner
    from ..learner.serial import SerialTreeLearner

    learner = getattr(gbdt, "learner", None)
    ds = getattr(gbdt, "train_data", None)
    if learner is None or ds is None or gbdt.objective is None:
        return None
    if getattr(learner, "bundled", False) or ds.has_multival:
        log_info("telemetry phase probe skipped: bundled or multi-val "
                 "data")
        return None
    if not isinstance(learner, (PartitionedTreeLearner,
                                SerialTreeLearner)) \
            or learner.comm is not None:
        log_info("telemetry phase probe skipped: "
                 f"{type(learner).__name__}")
        return None
    dev = gbdt.device
    n = gbdt.num_data
    b = learner.num_bins_max
    phases: Dict[str, float] = {}

    phases["grad"] = _timeit(gbdt.gradients, dev)
    grad, hess = gbdt.gradients()
    g, h = grad[:, 0].contiguous(), hess[:, 0].contiguous()

    # update: leaf-value gather + row add, on a copy of the scores
    score = gbdt.train_score[:, 0].clone()
    leaf_vals = torch.zeros(learner.num_leaves, dtype=torch.float32,
                            device=dev)
    leaf_id = torch.zeros(n, dtype=torch.int64, device=dev)

    def update():
        score.add_(leaf_vals[leaf_id])
    phases["update"] = _timeit(update, dev)

    if isinstance(learner, PartitionedTreeLearner):
        from ..ops.hist_cuda import pack_gh
        from ..ops.partition_cuda import (partition_segment,
                                          partition_segment_plain)
        from ..ops.split_step_cuda import segment_histogram
        f = learner.num_cols
        mat = learner.mat.clone()
        ws = torch.empty_like(mat)
        pack_gh(mat, f, g, h, torch.ones_like(g))
        phases["hist"] = _timeit(
            lambda: segment_histogram(mat, 0, n, b, f,
                                      plain=learner.plain, max_count=n),
            dev)
        hist = segment_histogram(mat, 0, n, b, f, plain=learner.plain,
                                 max_count=n)
        part = partition_segment_plain if learner.plain \
            else partition_segment
        phases["partition"] = _timeit(
            lambda: part(mat, ws, 0, n, 0, b // 2, False, 0, 0, b, False,
                         None), dev)
    else:
        from ..ops.hist_cuda import histogram_rows
        from ..ops.histogram import build_histogram, make_ghc
        from ..ops.partition import split_leaf
        ghc = make_ghc(g, h)
        if learner.plain:
            def hist_fn():
                return build_histogram(learner.binned_hist, ghc, b)
        else:
            def hist_fn():
                return histogram_rows(learner.binned_hist, ghc, b,
                                      partial=learner._partial)
        phases["hist"] = _timeit(hist_fn, dev)
        hist = hist_fn()
        lid = torch.zeros(n, dtype=torch.int32, device=dev)
        col = learner.binned[:, 0]
        phases["partition"] = _timeit(
            lambda: split_leaf(lid, col, 0, 1, b // 2, False, 0, 0, b),
            dev)

    sums = hist[0].double().sum(dim=0).cpu().numpy()
    root = tuple(np.float32(v) for v in sums) + (np.float32(-np.inf),
                                                np.float32(np.inf))
    phases["split"] = _timeit(
        lambda: learner.scan_table([hist], [root], learner._meta_all,
                                   learner._tables_all, learner.params),
        dev)
    return {kk: round(vv, 6) for kk, vv in phases.items()}
