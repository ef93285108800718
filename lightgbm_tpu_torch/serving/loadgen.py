"""Closed- and open-loop load generation for the serving engine (port of
``lightgbm_tpu/serving/loadgen.py``; ``chip_smoke.py`` phases 19 and 20
drive it on the card). Both loops drive an in-process
:class:`ServingEngine` (or a fleet) and report the same block::

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
* **soak** — a sustained open loop against a
  :class:`~lightgbm_tpu_torch.serving.fleet.FleetEngine` (or a single
  engine) with chaos running alongside: periodic **reload storms**,
  replica kill/cold-start cycles, and a
  ``robustness/faults.py`` fault plan (``fail_read`` on model-file
  reads, ``sigterm`` for the flight-recorder drill). The block it
  returns carries the fleet trajectory numbers the bench trend gate
  chains (p99, throughput, shed rate) plus an **availability**
  verdict: the non-shed error rate over the whole soak (sheds are
  *correct* degradation; any other error is an availability loss).
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

    ``engine`` is a FleetEngine (models/tenants honored) or a plain
    ServingEngine. ``reload_sources`` maps model name -> source; every
    ``reload_every_s`` one storm cycle hot-reloads each of them
    back-to-back. ``replica_storm_every_s`` kills one healthy replica
    and cold-starts a replacement per cycle (fleet only, and only
    while >1 replica is healthy). ``kill_storm_every_s`` is the
    PROCESS-fault storm (serving/procfleet.py): every cycle one live
    replica takes the next ``kill_storm_kinds`` fault (crash = SIGKILL
    its worker, oom = exit 137, hang = go silent past the heartbeat
    timeout) through ``FleetEngine.inject_replica_fault`` — the
    supervisor must re-dispatch, heal and respawn; thread fleets
    approximate crash/oom with kill+cold-start. ``fault_spec``
    installs a deterministic ``robustness/faults.py`` plan for the
    soak's duration (``fail_read`` faults land on the storm's
    model-file reads and are absorbed by the registry's retry/
    degraded-reload machinery — availability must not move).
    """
    from ..robustness.faults import get_fault_plan, set_fault_plan
    is_fleet = bool(getattr(engine, "is_fleet", False))
    rng = random.Random(seed)
    model_cycle = list(models or ([None] if not is_fleet
                                  else [engine.default_model]))
    tenant_cycle = list(tenants or ["default"])
    plan = set_fault_plan(fault_spec) if fault_spec else None
    stop = threading.Event()
    chaos = {"reloads": 0, "reload_failures": 0, "replica_kills": 0,
             "cold_starts": 0, "fault_storms": 0}
    storm_i = [0]

    def chaos_loop() -> None:
        next_reload = time.monotonic() + reload_every_s
        next_storm = time.monotonic() + replica_storm_every_s
        next_kill = time.monotonic() + kill_storm_every_s
        while not stop.wait(0.05):
            now = time.monotonic()
            if reload_every_s > 0 and reload_sources \
                    and now >= next_reload:
                next_reload = now + reload_every_s
                for name, source in reload_sources.items():
                    try:
                        if is_fleet:
                            engine.reload(source, model=name)
                        else:
                            engine.reload(source)
                        chaos["reloads"] += 1
                    except ServingError:
                        # a rejected reload (torn file, injected read
                        # fault past the retry budget) keeps the
                        # previous version serving — that is the
                        # degraded-but-available contract
                        chaos["reload_failures"] += 1
            if is_fleet and replica_storm_every_s > 0 \
                    and now >= next_storm:
                next_storm = now + replica_storm_every_s
                live = [r for r in engine.replicas if r.state == "ok"]
                if len(live) > 1:
                    engine.kill_replica(live[0].rid)
                    chaos["replica_kills"] += 1
                    try:
                        engine.cold_start_replica()
                        chaos["cold_starts"] += 1
                    except Exception:  # noqa: BLE001 - keep soaking
                        pass
            if is_fleet and kill_storm_every_s > 0 \
                    and now >= next_kill:
                next_kill = now + kill_storm_every_s
                live = [r for r in engine.replicas if r.state == "ok"]
                if len(live) > 1:
                    kind = kill_storm_kinds[
                        storm_i[0] % len(kill_storm_kinds)]
                    storm_i[0] += 1
                    params = {}
                    if kind == "hang":
                        sup = getattr(engine, "_proc_supervisor",
                                      None)
                        to = sup.opts.heartbeat_timeout_ms \
                            if sup is not None else 1000.0
                        params["ms"] = int(to * 1.5)
                    if engine.inject_replica_fault(
                            live[-1].rid, kind, **params):
                        chaos["fault_storms"] += 1

    chaos_thread = None
    if reload_every_s > 0 or replica_storm_every_s > 0 \
            or kill_storm_every_s > 0:
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
                # 30s even in the non-blocking pass: a done-but-dead
                # future may re-dispatch inside result() (fleet)
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
        kwargs = {}
        if is_fleet:
            m = model_cycle[i % len(model_cycle)]
            if m is not None:
                kwargs["model"] = m
            kwargs["tenant"] = tenant_cycle[i % len(tenant_cycle)]
        i += 1
        t0 = time.monotonic()
        try:
            fut = engine.submit(X[lo:lo + b], kind=kind,
                                timeout_ms=timeout_ms, **kwargs)
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
    if is_fleet:
        st = engine.stats()
        for key in ("redispatches", "replica_deaths", "quota_shed",
                    "shadow_mirrored", "shadow_parity_ok",
                    "shadow_parity_mismatch", "shadow_skipped",
                    "promotions", "replica_restarts",
                    "replica_quarantines"):
            block[key] = int(st.get(key, 0))
        block["replicas"] = len(engine.replicas)
        block["models"] = engine.fleet.names()
        block["isolation"] = getattr(engine, "isolation", "thread")
    block["batch_sizes"] = list(batch_sizes)
    block["buckets"] = list(engine.config.buckets)
    return block
