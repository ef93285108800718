"""Crash flight recorder: the RingSink's last words, on disk (copy of
``lightgbm_tpu/observability/flightrec.py`` for the PyTorch port: the
same dump, so ``tools/run_report.py`` reads it).

Training keeps a bounded in-memory ring of telemetry records
(`RingSink`), but until now a crashed, preempted or guard-tripped run
simply discarded it. The flight recorder arms that ring and, on

  * **guard trips** — non-finite gradients / loss spikes
    (robustness/guards.py), *including* ones a rollback recovers from,
  * **preemption** — SIGTERM/SIGINT caught by the PreemptionGuard
    (robustness/preempt.py) and the engine loop's clean-shutdown path,
  * **uncaught exceptions** escaping the training loop (engine.py),

atomically dumps a single JSON file with the last-N iteration records,
counter totals, a memory snapshot, and the config / dataset-bin-layout
fingerprints — enough to reconstruct *what the run was doing* when it
died, without re-running it.

Dump path resolution (first match wins):

  1. ``LGBM_TPU_CRASH_DUMP`` env var;
  2. the ``crash_dump`` config parameter;
  3. ``<telemetry_out>.crash.json`` next to the configured JSONL trace
     (config param or ``LGBM_TPU_TELEMETRY``).

No path resolvable -> the recorder stays disarmed (`arm_recorder`
returns None): the flight recorder is an *observability* feature and
never invents output files nobody asked for.

Writes are atomic (temp file + ``os.replace``) so a dump racing a
second failure — or a signal handler racing the engine loop's own
final dump — can never leave a torn file. Dumping is best-effort and
exception-free: a failing recorder must never mask the original crash.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from typing import Any, Dict, List, Optional

from ..utils.log import log_info, log_warning
from .telemetry import get_telemetry, memory_snapshot

SCHEMA_VERSION = 1
_DEFAULT_LAST_N = 64


class FlightRecorder:
    """Armed recorder bound to one training run; see module doc."""

    def __init__(self, dump_path: str, config=None, gbdt=None,
                 last_n: Optional[int] = None):
        self.dump_path = dump_path
        self.last_n = int(last_n if last_n is not None else os.environ
                          .get("LGBM_TPU_FLIGHTREC_N", _DEFAULT_LAST_N))
        self.trips: List[Dict[str, Any]] = []
        self.dumps_written = 0
        self.config_fingerprint: Optional[str] = None
        self.bin_layout_fingerprint: Optional[str] = None
        self.config_meta: Dict[str, Any] = {}
        if config is not None:
            try:
                from ..robustness.checkpoint import config_fingerprint
                self.config_fingerprint = config_fingerprint(config)
            except Exception as e:
                log_warning(f"flightrec: config fingerprint failed: {e}")
            keys = ("objective", "tree_learner", "num_leaves",
                    "num_iterations", "learning_rate", "max_bin",
                    "bagging_fraction", "bagging_freq", "num_class",
                    "boosting", "linear_tree", "guard_policy", "seed")
            self.config_meta = {k: getattr(config, k) for k in keys
                                if hasattr(config, k)}
        if gbdt is not None:
            try:
                ds = getattr(gbdt, "train_data", None)
                if ds is not None:
                    self.bin_layout_fingerprint = \
                        ds.bin_layout_fingerprint()
            except Exception as e:
                log_warning(f"flightrec: bin-layout fingerprint "
                            f"failed: {e}")

    # -- events --------------------------------------------------------
    def note(self, kind: str, **info) -> None:
        """Annotate without dumping (bounded; oldest trimmed)."""
        self.trips.append({"kind": kind, "wall_time": time.time(),
                           **info})
        del self.trips[:-32]

    def dump(self, reason: str, exc: Optional[BaseException] = None,
             **extra) -> Optional[str]:
        """Write the black box. Returns the path, or None on failure;
        never raises."""
        try:
            payload = self._payload(reason, exc, extra)
            tmp = f"{self.dump_path}.{os.getpid()}.tmp"
            d = os.path.dirname(os.path.abspath(self.dump_path))
            os.makedirs(d, exist_ok=True)
            with open(tmp, "w") as fh:
                json.dump(payload, fh, indent=1, default=_jsonable)
                fh.write("\n")
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.dump_path)
            self.dumps_written += 1
            log_info(f"flight recorder: wrote {self.dump_path} "
                     f"(reason={reason})")
            return self.dump_path
        except Exception as e:  # never mask the original failure
            log_warning(f"flight recorder dump failed: {e}")
            try:
                os.unlink(tmp)
            except (OSError, UnboundLocalError):
                pass
            return None

    def _payload(self, reason: str, exc, extra) -> Dict[str, Any]:
        tel = get_telemetry()
        with tel._lock:
            counters = dict(tel.counters)
            gauges = {k: v for k, v in tel.gauges.items()}
            dists = {k: list(v) for k, v in tel.dists.items()}
        records = tel.records
        last_iter = tel.last_iter
        out: Dict[str, Any] = {
            "flight_recorder": SCHEMA_VERSION,
            "reason": reason,
            "wall_time": time.time(),
            "pid": os.getpid(),
            "iteration": None if last_iter is None
            else last_iter.get("iter"),
            "config_fingerprint": self.config_fingerprint,
            "bin_layout_fingerprint": self.bin_layout_fingerprint,
            "config": self.config_meta,
            "counters": counters,
            "gauges": gauges,
            "dists": dists,
            "memory": memory_snapshot(),
            "trips": list(self.trips),
            "records": records[-self.last_n:],
        }
        # trace correlation (observability/tracing.py): the span
        # stacks of everything in flight at trip time — open requests'
        # queue/batch spans and the current training iteration's phase
        # spans, each with its trace id — so the black box links
        # directly to the timeline that explains it
        try:
            from .tracing import get_tracer
            tracer = get_tracer()
            if tracer.enabled:
                out["trace_spans"] = tracer.active_spans()
                tracer.flush()   # the exported timeline survives too
        except Exception:  # never mask the original failure
            pass
        if exc is not None:
            out["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc)[:2000],
                "traceback": traceback.format_exception(
                    type(exc), exc, exc.__traceback__)[-20:],
            }
        try:
            from .metrics import get_metrics
            out["histograms"] = get_metrics().snapshots()
            # fleet observability: which worker shards the federation
            # held at trip time (and how stale), plus the last SLO
            # evaluation — a crash dump should answer "was the fleet
            # healthy and within objective when it died?"
            workers = get_metrics().federation_workers()
            if workers:
                out["federation_workers"] = workers
        except Exception:
            pass
        try:
            from .slo import last_evaluation
            ev = last_evaluation()
            if ev is not None:
                out["slo"] = ev
        except Exception:
            pass
        if extra:
            out.update(extra)
        return out


def _jsonable(o):
    try:
        return float(o)
    except (TypeError, ValueError):
        return str(o)


# ---------------------------------------------------------------------
# process-wide active recorder (one training run at a time; nested
# trainings — cv folds — reuse the outer arm)
_ACTIVE: List[Optional[FlightRecorder]] = [None]


def worker_dump_path(base: str, rid) -> str:
    """The per-worker dump path derived from the supervisor's path:
    ``<crash_dump>.worker<rid>.json``. A worker process writing to the
    parent's path verbatim would RACE the supervisor's own dump (both
    os.replace the same target); the suffix keeps every black box."""
    if base.endswith(".json"):
        base = base[:-len(".json")]
    return f"{base}.worker{rid}.json"


def resolve_dump_path(config=None) -> Optional[str]:
    env = os.environ.get("LGBM_TPU_CRASH_DUMP", "").strip()
    explicit = (getattr(config, "crash_dump", "") or "").strip()
    path = env or explicit
    if not path:
        tel_path = (getattr(config, "telemetry_out", "") or "").strip() \
            or os.environ.get("LGBM_TPU_TELEMETRY", "").strip()
        if tel_path:
            path = tel_path + ".crash.json"
    if not path:
        return None
    # a process-fleet worker (serving/worker.py exports its replica id)
    # resolves its OWN dump file next to the parent's — never the
    # parent's path itself
    rid = os.environ.get("LGBM_TPU_WORKER_RID", "").strip()
    if rid:
        path = worker_dump_path(path, rid)
    return path


def arm_recorder(config=None, gbdt=None,
                 dump_path: Optional[str] = None) \
        -> Optional[FlightRecorder]:
    """Arm the flight recorder for a training run. Ensures ring-only
    telemetry is collecting (the recorder is useless without records).
    Returns None (disarmed) when no dump path is configured or one is
    already armed (the outer run keeps ownership)."""
    if _ACTIVE[0] is not None:
        return _ACTIVE[0]
    path = dump_path or resolve_dump_path(config)
    if not path:
        return None
    get_telemetry().ensure_ring()
    rec = FlightRecorder(path, config=config, gbdt=gbdt)
    _ACTIVE[0] = rec
    return rec


def disarm_recorder(rec: Optional[FlightRecorder]) -> None:
    """Clear the active recorder IF ``rec`` owns it. A caller whose
    arm_recorder returned None (no path, or an outer run owns the
    slot) disarms nothing — the outer run keeps its black box."""
    if rec is not None and _ACTIVE[0] is rec:
        _ACTIVE[0] = None


def active_recorder() -> Optional[FlightRecorder]:
    return _ACTIVE[0]


def record_guard_trip(kind: str, iteration: int, **info) -> None:
    """Guard-trip hook (robustness/guards.py): annotate AND dump —
    a rollback may recover the run, but the faulting iteration's
    records are exactly what the ring is about to age out."""
    rec = _ACTIVE[0]
    if rec is None:
        return
    rec.note(kind, iteration=int(iteration), **info)
    rec.dump(f"guard:{kind}")


def notify_signal(signum: int) -> None:
    """Preemption hook (robustness/preempt.py): dump immediately from
    the signal handler — if the loop never reaches its clean-shutdown
    checkpoint (hung dispatch), this dump is all the evidence there
    is. The engine loop's own 'preemption' dump atomically replaces it
    with the complete post-checkpoint state."""
    rec = _ACTIVE[0]
    if rec is not None:
        rec.note("signal", signum=int(signum))
        rec.dump("sigterm" if signum != 2 else "sigint")


def dump_exception(exc: BaseException) -> Optional[str]:
    rec = _ACTIVE[0]
    if rec is None:
        return None
    return rec.dump("exception", exc=exc)
