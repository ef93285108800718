"""Closed- and open-loop load generation for the serving engine (port of
``lightgbm_tpu/serving/loadgen.py``; ``chip_smoke.py`` phase 19 drives
it on the card). Both loops drive an in-process :class:`ServingEngine`
and report the same block::

    {"mode", "duration_s", "requests", "rows", "errors",
     "throughput_rps", "rows_per_s",
     "p50_ms", "p95_ms", "p99_ms", "max_ms",
     "bucket_hit_rate", "shed", "timeouts", "fallbacks"}

* **closed loop** — N worker threads, each issuing the next request as
  soon as the previous answer lands. Measures the engine's saturated
  throughput and the latency under full concurrency.
* **open loop** — requests arrive on a Poisson process at a target
  QPS regardless of completions (the honest way to measure latency
  under a given offered load; a closed loop self-throttles and hides
  queueing).
* **soak** — a sustained open loop against one engine with chaos
  running alongside: periodic **reload storms** and a
  ``robustness/faults.py`` fault plan (``fail_read`` on model-file
  reads). The block it returns carries p99, throughput and shed rate
  plus an **availability** verdict: the non-shed error rate over the
  whole soak (sheds are *correct* degradation; any other error is an
  availability loss). The fleet's replica and process-kill storms come
  with the fleets (ROADMAP.md Queue 1 item 10.2).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from .engine import ServingEngine
from .errors import QueueFullError, QuotaExceededError, ServingError


def _percentiles(lat_ms: List[float]) -> Dict[str, float]:
    if not lat_ms:
        return {"p50_ms": None, "p95_ms": None, "p99_ms": None,
                "max_ms": None}
    a = np.asarray(lat_ms)
    return {"p50_ms": round(float(np.percentile(a, 50)), 3),
            "p95_ms": round(float(np.percentile(a, 95)), 3),
            "p99_ms": round(float(np.percentile(a, 99)), 3),
            "max_ms": round(float(a.max()), 3)}


def _block(mode: str, dur: float, lat_ms: List[float], rows: int,
           errors: int, engine: ServingEngine) -> Dict:
    stats = engine.stats()
    out = {"mode": mode, "duration_s": round(dur, 3),
           "requests": len(lat_ms), "rows": rows, "errors": errors,
           "throughput_rps": round(len(lat_ms) / dur, 2) if dur else 0.0,
           "rows_per_s": round(rows / dur, 2) if dur else 0.0}
    out.update(_percentiles(lat_ms))
    for key in ("bucket_hit_rate", "shed", "timeouts", "fallbacks",
                "queue_peak"):
        out[key] = stats.get(key)
    return out


def closed_loop(engine: ServingEngine, X: np.ndarray,
                batch_sizes: Sequence[int] = (1,),
                threads: int = 4, duration_s: float = 3.0,
                kind: str = "predict",
                seed: int = 0) -> Dict:
    """``threads`` workers issue back-to-back requests of rotating
    ``batch_sizes`` rows sampled from ``X`` for ``duration_s``."""
    stop_at = time.monotonic() + duration_s
    lat_lock = threading.Lock()
    lat_ms: List[float] = []
    rows_done = [0]
    errors = [0]

    def worker(tid: int) -> None:
        rng = random.Random(seed + tid)
        i = 0
        while time.monotonic() < stop_at:
            b = batch_sizes[i % len(batch_sizes)]
            i += 1
            lo = rng.randrange(max(len(X) - b, 1))
            t0 = time.monotonic()
            try:
                engine.predict(X[lo:lo + b], kind=kind)
            except ServingError:
                with lat_lock:
                    errors[0] += 1
                continue
            dt = (time.monotonic() - t0) * 1000.0
            with lat_lock:
                lat_ms.append(dt)
                rows_done[0] += b
    t_start = time.monotonic()
    ts = [threading.Thread(target=worker, args=(i,), daemon=True)
          for i in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(duration_s + 30.0)
    dur = time.monotonic() - t_start
    return _block("closed", dur, lat_ms, rows_done[0], errors[0], engine)


def open_loop(engine: ServingEngine, X: np.ndarray,
              qps: float = 200.0, duration_s: float = 3.0,
              batch_sizes: Sequence[int] = (1,),
              kind: str = "predict", seed: int = 0,
              timeout_ms: Optional[float] = None) -> Dict:
    """Poisson arrivals at ``qps`` for ``duration_s``; requests are
    submitted asynchronously regardless of completions, then all
    futures are collected. Shed/timeout responses count as errors —
    that's the load-shedding behavior this loop exists to measure."""
    rng = random.Random(seed)
    futures = []
    errors = 0
    rows_sent = 0
    t_start = time.monotonic()
    stop_at = t_start + duration_s
    next_at = t_start
    i = 0
    while True:
        now = time.monotonic()
        if now >= stop_at:
            break
        if now < next_at:
            time.sleep(min(next_at - now, 0.02))
            continue
        next_at += rng.expovariate(qps)
        b = batch_sizes[i % len(batch_sizes)]
        i += 1
        lo = rng.randrange(max(len(X) - b, 1))
        t0 = time.monotonic()
        try:
            fut = engine.submit(X[lo:lo + b], kind=kind,
                                timeout_ms=timeout_ms)
        except ServingError:
            errors += 1
            continue
        futures.append((t0, b, fut))
        rows_sent += b
    lat_ms: List[float] = []
    rows_done = 0
    for t0, b, fut in futures:
        try:
            fut.result(timeout=30.0)
        except ServingError:
            errors += 1
            continue
        lat_ms.append((time.monotonic() - t0) * 1000.0
                      if not fut.meta.get("latency_ms")
                      else fut.meta["latency_ms"])
        rows_done += b
    dur = time.monotonic() - t_start
    block = _block("open", dur, lat_ms, rows_done, errors, engine)
    block["offered_qps"] = qps
    return block


def serving_block(engine: ServingEngine, X: np.ndarray,
                  batch_sizes: Sequence[int] = (1, 8, 64),
                  threads: int = 2, duration_s: float = 2.0) -> Dict:
    """The compact closed-loop measurement ``bench.py`` embeds as the
    bench JSON's ``serving`` block."""
    block = closed_loop(engine, X, batch_sizes=batch_sizes,
                        threads=threads, duration_s=duration_s)
    block["batch_sizes"] = list(batch_sizes)
    block["buckets"] = list(engine.config.buckets)
    return block


# ----------------------------------------------------------------------
# sustained soak: open loop + reload storms + fault injection
def soak_loop(engine, X: np.ndarray, duration_s: float = 30.0,
              qps: float = 100.0, batch_sizes: Sequence[int] = (1,),
              models: Optional[Sequence[str]] = None,
              tenants: Optional[Sequence[str]] = None,
              kind: str = "predict", seed: int = 0,
              timeout_ms: Optional[float] = None,
              reload_every_s: float = 0.0,
              reload_sources: Optional[Dict[str, object]] = None,
              replica_storm_every_s: float = 0.0,
              kill_storm_every_s: float = 0.0,
              kill_storm_kinds: Sequence[str] = ("crash", "oom",
                                                 "hang"),
              fault_spec: str = "") -> Dict:
    """Sustained open-loop soak with chaos; see module docstring.

    ``engine`` is a ServingEngine; ``models`` and ``tenants`` name a
    fleet's entries and are not read by one engine. ``reload_sources``
    maps a name -> source; every ``reload_every_s`` one storm cycle
    hot-reloads each of them back-to-back. ``fault_spec`` installs a
    deterministic ``robustness/faults.py`` plan for the soak's duration
    (``fail_read`` faults land on the storm's model-file reads and are
    absorbed by the registry's retry/degraded-reload machinery —
    availability must not move). The fleet's storms
    (``replica_storm_every_s``, ``kill_storm_every_s`` and its
    ``kill_storm_kinds``) need the fleets, which the port does not have
    yet: they raise ``NotImplementedError``.
    """
    from ..robustness.faults import get_fault_plan, set_fault_plan
    if replica_storm_every_s > 0 or kill_storm_every_s > 0:
        raise NotImplementedError(
            "soak_loop's replica and kill storms need the serving fleets "
            "(ROADMAP.md Queue 1 item 10.2)")
    rng = random.Random(seed)
    plan = set_fault_plan(fault_spec) if fault_spec else None
    stop = threading.Event()
    chaos = {"reloads": 0, "reload_failures": 0, "replica_kills": 0,
             "cold_starts": 0, "fault_storms": 0}

    def chaos_loop() -> None:
        next_reload = time.monotonic() + reload_every_s
        while not stop.wait(0.05):
            now = time.monotonic()
            if reload_sources and now >= next_reload:
                next_reload = now + reload_every_s
                for source in reload_sources.values():
                    try:
                        engine.reload(source)
                        chaos["reloads"] += 1
                    except ServingError:
                        # a rejected reload (torn file, injected read
                        # fault past the retry budget) keeps the
                        # previous version serving — that is the
                        # degraded-but-available contract
                        chaos["reload_failures"] += 1

    chaos_thread = None
    if reload_every_s > 0:
        chaos_thread = threading.Thread(target=chaos_loop, daemon=True,
                                        name="lgbm-soak-chaos")
        chaos_thread.start()

    lat_ms: List[float] = []
    shed = 0
    non_shed_errors = 0
    rows_done = 0
    pending: List = []
    i = 0

    def harvest(block: bool) -> None:
        nonlocal shed, non_shed_errors, rows_done
        keep = []
        for t0, b, fut in pending:
            if not block and not fut.done():
                keep.append((t0, b, fut))
                continue
            try:
                fut.result(timeout=30.0)
            except (QueueFullError, QuotaExceededError):
                shed += 1
                continue
            except ServingError:
                non_shed_errors += 1
                continue
            lat_ms.append(fut.meta.get("latency_ms")
                          or (time.monotonic() - t0) * 1000.0)
            rows_done += b
        pending[:] = keep

    t_start = time.monotonic()
    stop_at = t_start + duration_s
    next_at = t_start
    while True:
        now = time.monotonic()
        if now >= stop_at:
            break
        if now < next_at:
            time.sleep(min(next_at - now, 0.02))
            continue
        next_at += rng.expovariate(qps)
        b = batch_sizes[i % len(batch_sizes)]
        lo = rng.randrange(max(len(X) - b, 1))
        i += 1
        t0 = time.monotonic()
        try:
            fut = engine.submit(X[lo:lo + b], kind=kind,
                                timeout_ms=timeout_ms)
        except (QueueFullError, QuotaExceededError):
            shed += 1
            continue
        except ServingError:
            non_shed_errors += 1
            continue
        pending.append((t0, b, fut))
        if len(pending) > 2048:   # bound memory on long soaks
            harvest(block=False)
    harvest(block=True)
    stop.set()
    if chaos_thread is not None:
        chaos_thread.join(10.0)
    dur = time.monotonic() - t_start

    requests = len(lat_ms) + shed + non_shed_errors
    block: Dict = {"mode": "soak", "duration_s": round(dur, 3),
                   "offered_qps": qps,
                   "requests": requests, "served": len(lat_ms),
                   "rows": rows_done,
                   "shed": shed,
                   "shed_rate": round(shed / requests, 4)
                   if requests else 0.0,
                   "non_shed_errors": non_shed_errors,
                   "availability": round(
                       1.0 - non_shed_errors / requests, 6)
                   if requests else None,
                   "throughput_rps": round(len(lat_ms) / dur, 2)
                   if dur else 0.0,
                   "rows_per_s": round(rows_done / dur, 2)
                   if dur else 0.0}
    block.update(_percentiles(lat_ms))
    block.update(chaos)
    block["faults_injected"] = 0 if plan is None else sum(
        ev.fired for ev in plan.events)
    if fault_spec:
        # leave no armed plan behind (the spec may not have fired)
        if get_fault_plan() is plan:
            set_fault_plan(None)
    block["batch_sizes"] = list(batch_sizes)
    block["buckets"] = list(engine.config.buckets)
    return block
