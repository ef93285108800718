"""Fleet serving: replica pool + multi-model registry + routing (port
of ``lightgbm_tpu/serving/fleet.py``).

:class:`~lightgbm_tpu_torch.serving.engine.ServingEngine` is one model
behind one queue; this layer is the fleet topology on top of it:

* :class:`ModelFleet` — named models (per-tenant / A-B variants), each
  a :class:`~lightgbm_tpu_torch.serving.registry.ModelRegistry` on the
  fleet's device with the existing hot-reload/draining machinery. The
  stacked trees and the captured (bucket, kind) programs are per
  *version* and shared by every replica — one upload and one capture
  per model version for the whole pool.
* :class:`Replica` — one pool worker: a lazily-built
  :class:`ServingEngine` per named model (micro-batch queue + flusher
  each), a health state (``ok`` / ``draining`` / ``dead``), and a
  cold-start capture count. Because a version's programs live on the
  version, a replica's warmup *replays* the bucket programs the first
  warmup captured — a cold-started replica captures **zero** CUDA
  graphs (the JAX package's zero compiles). The price: each program has
  one lock, so two replicas that replay the same (version, bucket,
  kind) take turns.
* :class:`FleetEngine` — the fleet facade: per-tenant token-bucket
  quotas (``tenants.py``) and a shared bounded pending count admit the
  request; the :class:`~lightgbm_tpu_torch.serving.router.Router` resolves
  canary splits and shadow mirrors; least-loaded dispatch picks the
  healthiest replica; a dead replica's requests re-dispatch to a
  surviving one exactly once per failure (no duplicate responses —
  the dead engine *failed* the future, only the re-dispatch answers).

Request lifecycle::

    submit(rows, model=, tenant=)
      -> quota check (structured quota_exceeded shed, never a timeout)
      -> router: canary split / shadow mirror decision
      -> shared pending bound (queue_full shed)
      -> least-loaded healthy replica -> that replica's per-model
         ServingEngine queue (micro-batching, shape buckets, warmup —
         all the engine's machinery)
      -> FleetFuture (re-dispatches on replica death)
    shadow mirror -> least-loaded replica -> parity comparator thread
      (responses counted + compared, NEVER returned)

Observability: every response lands in the
``fleet_request_latency_ms{model, tenant}`` histogram (Prometheus
``GET /metrics``, docs/Observability.md), fleet gauges (pending,
healthy replicas, quota sheds) ride a scrape-time collector, and
every replica state transition sets ``lgbm_fleet_replica_state{rid}``.

Isolation: ``serving_isolation=process`` swaps each :class:`Replica`
for a :class:`~lightgbm_tpu_torch.serving.procfleet.ProcessReplica` —
the same dispatch/recovery seam, but the replica's engines live in
their own supervised worker OS process (its own CUDA context, stacks
and graphs), so a device OOM or runtime crash kills one replica, never
the pool.

Device: the fleet serves on ``device`` as ``ServingEngine`` does (None:
the card, or raise; ``"cpu"`` is the caller's explicit choice), and a
process fleet passes it to every worker.
"""

from __future__ import annotations

import queue
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..observability.metrics import get_metrics
from ..observability.telemetry import get_telemetry
from ..observability.tracing import get_tracer
from ..utils.log import log_info, log_warning
from .engine import ServingConfig, ServingEngine, ServingFuture
from .errors import (EngineStoppedError, InvalidRequestError,
                     ModelNotFoundError, QueueFullError,
                     QuotaExceededError, ReplicaUnavailableError,
                     RequestTimeoutError, ServingError)
from .procfleet import (STATE_CODES, ProcFleetOptions,
                        WorkerSupervisor)
from ..utils.device import resolve_device
from .registry import ModelRegistry, ModelVersion
from .router import Router
from .tenants import TenantQuotas

DEFAULT_MODEL = "default"


class ModelFleet:
    """Named models -> registries; the fleet's multi-model store. Its
    registries pin on ``device`` (None: the card, or raise)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._registries: Dict[str, ModelRegistry] = {}

    def registry(self, name: str) -> ModelRegistry:
        with self._lock:
            reg = self._registries.get(name)
            if reg is None:
                raise ModelNotFoundError(
                    f"model {name!r} is not served by this fleet",
                    model=name, known=sorted(self._registries))
            return reg

    def ensure(self, name: str) -> ModelRegistry:
        with self._lock:
            reg = self._registries.get(name)
            if reg is None:
                reg = self._registries[name] = ModelRegistry(self.device)
            return reg

    def has(self, name: str) -> bool:
        with self._lock:
            return name in self._registries

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._registries)

    def current(self, name: str) -> Optional[ModelVersion]:
        return self.registry(name).current()

    def load(self, name: str, source,
             pin_device: bool = True) -> ModelVersion:
        """Resolve ``source`` into a NEW (inactive) version of
        ``name``; the caller warms it before ``activate``."""
        return self.ensure(name).load(source, pin_device=pin_device)

    def activate(self, name: str, mv: ModelVersion) -> ModelVersion:
        return self.registry(name).activate(mv)

    def describe(self) -> Dict[str, Any]:
        out = {}
        for name in self.names():
            mv = self.registry(name).current()
            out[name] = None if mv is None else mv.describe()
        return out


class Replica:
    """One pool worker: per-model engines + health + cold-start cost
    (``cold_start_captures``: the CUDA graphs its warmup captured)."""

    STATES = ("ok", "draining", "dead")

    def __init__(self, rid: int, fleet: "ModelFleet",
                 config: ServingConfig):
        self.rid = rid
        self._fleet = fleet
        self._config = config
        self._lock = threading.Lock()
        self._engines: Dict[str, ServingEngine] = {}
        self.state = "ok"
        self.outstanding = 0        # fleet-side in-flight accounting
        # fleet futures currently riding this replica, so a kill can
        # EAGERLY re-dispatch them instead of waiting for each caller
        # to observe the death (weak: a dropped future needs no work)
        self.futures: "weakref.WeakSet" = weakref.WeakSet()
        self.started_at = time.time()
        self.cold_start_captures: Optional[int] = None
        self.cold_start_s: Optional[float] = None
        self.deaths = 0

    def engine_for(self, name: str) -> ServingEngine:
        """The replica's engine for a named model, built lazily around
        the fleet's shared registry (hot reloads of the name are
        visible to every replica at the next checkout)."""
        with self._lock:
            eng = self._engines.get(name)
            if eng is None:
                if self.state == "dead":
                    raise EngineStoppedError(
                        f"replica {self.rid} is dead", replica=self.rid)
                eng = ServingEngine(
                    config=self._config,
                    registry=self._fleet.registry(name))
                self._engines[name] = eng
            return eng

    def _captures(self) -> int:
        with self._lock:
            engines = list(self._engines.values())
        return sum(int(e.stats()["graph_captures"]) for e in engines)

    def warm(self, names: Optional[List[str]] = None) -> None:
        """Replay every (model, bucket, kind) program through this
        replica's engines. The programs live on each model version, so
        once any replica warmed a version this captures zero CUDA
        graphs — the zero-capture cold start. The captures actually
        paid are recorded."""
        before = self._captures()
        t0 = time.perf_counter()
        for name in names or self._fleet.names():
            mv = self._fleet.registry(name).current()
            if mv is None or not self._config.warmup:
                continue
            self.engine_for(name)._warmup(mv)
        self.cold_start_s = round(time.perf_counter() - t0, 4)
        self.cold_start_captures = self._captures() - before

    def load(self) -> int:
        """Dispatch load: fleet in-flight + everything queued in the
        replica's engines (the least-loaded dispatch key)."""
        with self._lock:
            engines = list(self._engines.values())
            out = self.outstanding
        return out + sum(e.queue_depth for e in engines)

    def stop(self, drain: bool = True) -> None:
        with self._lock:
            engines = list(self._engines.values())
        for eng in engines:
            eng.stop(drain=drain)

    def describe(self) -> Dict[str, Any]:
        with self._lock:
            models = sorted(self._engines)
        return {"replica": self.rid, "state": self.state,
                "load": self.load(), "models": models,
                "cold_start_captures": self.cold_start_captures,
                "cold_start_s": self.cold_start_s,
                "started_at": self.started_at}


class FleetFuture:
    """Future for one fleet request; re-dispatches on replica death."""

    __slots__ = ("_fleet", "_fut", "_replica", "_model", "_target",
                 "_kind", "_tenant", "_rows", "_t0", "_deadline",
                 "_redispatches", "_finished", "_meta", "_rlock",
                 "_span", "__weakref__")

    def __init__(self, fleet: "FleetEngine", fut: ServingFuture,
                 replica: Replica, model: str, target: str, kind: str,
                 tenant: str, rows: np.ndarray,
                 timeout_s: Optional[float], span=None):
        self._fleet = fleet
        self._fut = fut
        self._replica = replica
        self._model = model
        self._target = target
        self._kind = kind
        self._tenant = tenant
        self._rows = rows
        self._t0 = time.monotonic()
        self._deadline = None if timeout_s is None \
            else self._t0 + timeout_s
        self._redispatches = 0
        self._finished = False
        self._meta: Dict[str, Any] = {}
        # the request's root trace span (observability/tracing.py):
        # opened at submit, finished when the future completes
        self._span = span
        if span is not None:
            self._meta["trace_id"] = span.ctx.trace_id
        self._rlock = threading.Lock()
        replica.futures.add(self)

    def done(self) -> bool:
        return self._fut.done()

    @property
    def meta(self) -> Dict[str, Any]:
        out = self._fut.meta
        out.update(self._meta)
        out.update(model=self._model, target=self._target,
                   tenant=self._tenant, replica=self._replica.rid,
                   redispatches=self._redispatches)
        return out

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        while True:
            fut = self._fut
            try:
                out = fut.result(timeout=timeout)
            except EngineStoppedError as e:
                # replica died with this request aboard: the dead
                # engine FAILED the future (it never computed), so
                # re-dispatching to a survivor produces exactly one
                # response — no duplicates by construction
                with self._rlock:
                    if self._fut is not fut:
                        continue   # eagerly re-dispatched by the fleet
                    try:
                        self._replica, self._fut = \
                            self._fleet._redispatch(self, e)
                    except ServingError as e2:
                        self._finish(error=e2)
                        raise e2 from e
                    self._redispatches += 1
                continue
            except ServingError as e:
                self._finish(error=e)
                raise
            self._finish()
            return out

    def _try_redispatch(self) -> None:
        """Fleet-driven eager re-dispatch after a replica kill: move a
        failed (EngineStoppedError) request to a survivor NOW, before
        its deadline burns down waiting for the caller to collect.
        Non-blocking on the future's lock: a held lock means the
        caller's ``result()`` loop (or another death's eager pass) is
        already re-dispatching this future — skipping is correct, and
        waiting could deadlock when a re-dispatch inside the lock
        discovers ANOTHER dead replica and eagerly sweeps its futures."""
        if not self._rlock.acquire(blocking=False):
            return
        try:
            fut = self._fut
            if self._finished or not fut.done():
                return
            if not isinstance(fut._req.error, EngineStoppedError):
                return
            try:
                self._replica, self._fut = self._fleet._redispatch(
                    self, fut._req.error)
                self._redispatches += 1
            except ServingError:
                pass   # the caller's result() surfaces the failure
        finally:
            self._rlock.release()

    def _remaining_s(self) -> Optional[float]:
        if self._deadline is None:
            return None
        return self._deadline - time.monotonic()

    def _finish(self, error: Optional[ServingError] = None) -> None:
        if self._finished:
            return
        self._finished = True
        if error is not None:
            self._meta["error"] = error.code
        self._fleet._complete(self, error)


class FleetEngine:
    """Replica pool + multi-model routing facade; see module doc.
    ``device`` (as ``ServingEngine``'s) is where every replica serves."""

    is_fleet = True

    def __init__(self, models=None, config: Optional[ServingConfig] = None,
                 replicas: int = 2, router: Optional[Router] = None,
                 quotas: Optional[TenantQuotas] = None,
                 default_model: str = DEFAULT_MODEL,
                 max_pending: int = 0,
                 isolation: str = "thread",
                 proc_opts: Optional[ProcFleetOptions] = None,
                 device=None):
        if isolation not in ("thread", "process"):
            raise ValueError(
                f"isolation must be thread|process, got {isolation!r}")
        self.config = config or ServingConfig()
        self.fleet = ModelFleet(device)
        self.device = self.fleet.device
        self.router = router or Router()
        self.quotas = quotas or TenantQuotas()
        self.default_model = default_model
        self.isolation = isolation
        # process isolation (serving/procfleet.py): every replica's
        # engines live in a supervised worker process; this side is
        # the thin host that dispatches, heals and reaps
        self._proc_supervisor: Optional[WorkerSupervisor] = \
            WorkerSupervisor(self, proc_opts) \
            if isolation == "process" else None
        self._lock = threading.Lock()
        self._replicas: List[Replica] = []
        self._next_rid = 0
        self._rr = 0                 # tie-break rotation for dispatch
        self._pending = 0
        self.max_pending = int(max_pending) \
            or int(self.config.max_queue) * max(int(replicas), 1)
        self._stopping = False
        self._counts: Dict[str, float] = {}
        # the last FAILED model publish (None when the most recent
        # load of every model succeeded): the continuous-refit ramp
        # controller treats this as a hard abort — a candidate whose
        # publish was rejected must never sit in canary
        self._last_reload_error: Optional[Dict[str, Any]] = None
        self._lat_by_label: Dict[Tuple[str, str], int] = {}
        self._shadow_q: "queue.Queue" = queue.Queue(maxsize=512)
        self._shadow_thread: Optional[threading.Thread] = None
        self._metrics = get_metrics()
        ref = weakref.ref(self)

        def _collect() -> Dict[str, float]:
            fl = ref()
            if fl is None:
                return {}
            with fl._lock:
                out = {f"fleet_{k}": v for k, v in fl._counts.items()}
                out["fleet_pending"] = fl._pending
                out["fleet_replicas"] = len(fl._replicas)
                out["fleet_replicas_ok"] = sum(
                    1 for r in fl._replicas if r.state == "ok")
                out["fleet_replicas_quarantined"] = sum(
                    1 for r in fl._replicas
                    if r.state == "quarantined")
            return out

        self._metrics.register_collector(_collect, owner=self)

        if models is not None:
            if not isinstance(models, dict):
                models = {default_model: models}
            for name, source in models.items():
                self.load_model(name, source)
        n = max(int(replicas), 1)
        if self._proc_supervisor is not None:
            # spawn the pool concurrently: every worker pays a full
            # interpreter + torch import and a CUDA context;
            # serializing multiplies it
            reps = [self._proc_supervisor.new_replica()
                    for _ in range(n)]
            try:
                self._proc_supervisor.spawn_pool(reps)
            except BaseException:
                # no fleet object reaches the caller: reap the workers
                # that did come up
                self._proc_supervisor.shutdown(drain=False)
                raise
            with self._lock:
                self._replicas.extend(reps)
                self._next_rid = len(reps)
            for rep in reps:
                self._count("replica_starts")
                self._note_replica_state(rep)
        else:
            for _ in range(n):
                self.add_replica()

    @classmethod
    def from_config(cls, cfg, models=None, device=None) -> "FleetEngine":
        """Build from ``Config.serving_*``: replica count, model list
        (``name=path`` entries), canary/shadow rules, tenant quotas;
        ``device`` as the constructor's."""
        router = Router()
        default = DEFAULT_MODEL
        parsed: Dict[str, Any] = dict(models or {})
        for i, spec in enumerate(getattr(cfg, "serving_models", []) or []):
            name, sep, path = str(spec).partition("=")
            if not sep:
                name, path = f"model{i}", str(spec)
            parsed[name.strip()] = path.strip()
        if parsed and default not in parsed:
            default = sorted(parsed)[0]
        canary = getattr(cfg, "serving_canary_model", "") or ""
        weight = float(getattr(cfg, "serving_canary_weight", 0.0))
        if canary:
            router.set_canary(default, canary, weight)
        shadow = getattr(cfg, "serving_shadow_model", "") or ""
        if shadow:
            router.set_shadow(default, shadow)
        return cls(models=parsed or None,
                   config=ServingConfig.from_config(cfg),
                   replicas=int(getattr(cfg, "serving_replicas", 1)),
                   router=router,
                   quotas=TenantQuotas.from_config(cfg),
                   default_model=default,
                   max_pending=int(getattr(cfg, "serving_max_pending",
                                           0)),
                   isolation=str(getattr(cfg, "serving_isolation",
                                         "thread")),
                   proc_opts=ProcFleetOptions.from_config(cfg),
                   device=device)

    # -- model lifecycle ----------------------------------------------
    def load_model(self, name: str, source,
                   aot_booster=None) -> int:
        """Load + warm + atomically activate a version of ``name``
        (the multi-model analog of ``ServingEngine.load``). The warmup
        captures every (bucket, kind) program ONCE for the whole pool —
        replicas share the version's pinned stack and its programs.

        ``aot_booster`` (pipeline publishes) is the dataset-backed
        booster behind a text ``source``: process-mode publishes build
        an AOT predict artifact from it (serving/aot.py) on the fleet's
        device, and every worker pins the published stack."""
        pin = self.config.device != "never" \
            and self._proc_supervisor is None
        try:
            mv = self.fleet.load(name, source, pin_device=pin)
            if self._proc_supervisor is not None:
                # workers own the device arrays and the warmup; the
                # parent registry holds the metadata (names, versions,
                # health) and the replayable source for respawns.
                # Record the replay source only AFTER the parent
                # registry validated the publish: a rejected publish
                # must never poison the respawn replay state (or every
                # later worker death would replay the bad source and
                # quarantine the replica)
                aot_path = None
                if self.config.aot and self.config.device != "never":
                    from .aot import maybe_build_artifact
                    donor = aot_booster
                    if donor is None and not isinstance(source, str):
                        donor = source   # booster published directly
                    aot_path = maybe_build_artifact(
                        donor, source, self.config.buckets,
                        device=self.device)
                    if aot_path:
                        self._count("aot_publishes")
                self._proc_supervisor.set_model_source(
                    name, source, aot_path=aot_path)
                self._proc_supervisor.broadcast_model(name)
            else:
                rep = self._pick_replica(allow_none=True)
                if rep is not None and self.config.warmup:
                    rep.engine_for(name)._warmup(mv)
        except Exception as e:
            # a rejected publish (torn model file, integrity failure,
            # warmup crash) keeps every previous version serving and
            # flags the fleet degraded until a load succeeds —
            # surfaced in health() for the pipeline ramp controller
            self._last_reload_error = {
                "error": str(e),
                "code": getattr(e, "code", type(e).__name__),
                "model": name,
                "source": str(source)[:256],
                "at": time.time(),
            }
            self._count("reload_failures")
            log_warning(f"serving fleet: publish of model {name!r} "
                        f"failed (previous versions keep serving): {e}")
            raise
        self.fleet.activate(name, mv)
        self._last_reload_error = None
        self._count("reloads")
        return mv.version

    def reload(self, source, model: Optional[str] = None) -> int:
        """Hot reload a named model (the fleet signature mirrors
        ``ServingEngine.reload`` with an optional model name)."""
        return self.load_model(model or self.default_model, source)

    def promote_canary(self, model: Optional[str] = None
                       ) -> Optional[str]:
        promoted = self.router.promote(model or self.default_model)
        if promoted is not None:
            self._count("promotions")
        return promoted

    def charge_tenant_bytes(self, tenant: str, nbytes: int) -> None:
        """Charge ``nbytes`` of control-plane traffic (a pipeline
        refit window slice, a republished model text) against the
        tenant's admission bucket. Under ``serving_quota_unit=bytes``
        the cost is the byte count itself, so a tenant's refit volume
        draws from the SAME budget as its data-plane payloads; under
        ``requests`` the charge costs one token. Raises the structured
        :class:`QuotaExceededError` exactly like the data plane — the
        pipeline skips that tenant's cycle and retries after the
        bucket refills."""
        self.quotas.check(tenant,
                          cost=self.quotas.request_cost(int(nbytes)))
        self._count("tenant_byte_charges")

    # -- replica lifecycle --------------------------------------------
    def add_replica(self) -> Replica:
        """Cold-start one replica: build engines for every model and
        replay the bucket programs (zero captures when warm — the
        replica records what it actually paid). In process mode the
        replica is a spawned, supervised worker process, which captures
        its own."""
        if self._proc_supervisor is not None:
            rep = self._proc_supervisor.new_replica()
            self._proc_supervisor.spawn(rep)
            with self._lock:
                self._replicas.append(rep)
                self._next_rid = max(self._next_rid, rep.rid + 1)
            self._count("replica_starts")
            self._note_replica_state(rep)
            return rep
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
        rep = Replica(rid, self.fleet, self.config)
        rep.warm()
        with self._lock:
            self._replicas.append(rep)
        self._count("replica_starts")
        self._note_replica_state(rep)
        log_info(f"serving fleet: replica {rid} up "
                 f"(cold_start_captures={rep.cold_start_captures}, "
                 f"cold_start_s={rep.cold_start_s})")
        return rep

    cold_start_replica = add_replica

    def _replica(self, rid: int) -> Replica:
        with self._lock:
            for r in self._replicas:
                if r.rid == rid:
                    return r
        raise ServingError(f"no replica {rid}")

    def drain_replica(self, rid: int) -> None:
        """Graceful: stop dispatching to the replica, serve what it
        already queued, then stop its engines."""
        rep = self._replica(rid)
        rep.state = "draining"
        self._note_replica_state(rep)
        rep.stop(drain=True)
        rep.state = "dead"
        self._count("replica_drains")
        self._note_replica_state(rep, event="drained")

    def kill_replica(self, rid: int) -> None:
        """Hard death: queued requests fail with EngineStoppedError and
        re-dispatch to the surviving replicas via their FleetFutures.
        A process replica's worker is killed and NOT respawned (this
        is the operator's kill, not a crash the supervisor heals)."""
        rep = self._replica(rid)
        if getattr(rep, "is_process", False):
            rep._no_respawn = True
        if rep.state not in ("dead", "quarantined"):
            rep.state = "dead"
            rep.deaths += 1
            self._count("replica_deaths")
        rep.stop(drain=False)
        self._note_replica_state(rep, event="killed")
        # eager failover: everything the dead engines just failed with
        # EngineStoppedError moves to a survivor immediately, not when
        # its caller eventually calls result()
        for ff in list(rep.futures):
            ff._try_redispatch()

    def _mark_dead(self, rep: Replica) -> None:
        """Declare a replica dead and recover EVERYTHING it held:
        stop its engines non-drain so requests still QUEUED there fail
        with EngineStoppedError (not only the in-flight ones), then
        eagerly re-dispatch every fleet future it carried. Idempotent;
        discovery paths (submit-time failure, result-time failure,
        supervisor heartbeat) all funnel here."""
        if getattr(rep, "is_process", False) \
                and rep.state not in ("dead", "quarantined"):
            # run the full process-death path (classify, fail pending,
            # collect the worker dump, schedule the respawn); it calls
            # back into _on_replica_death for the fleet-side recovery
            if self._proc_supervisor is not None:
                self._proc_supervisor.declare_lost(rep)
                return
        if rep.state in ("dead", "quarantined"):
            # already declared: the first declaration swept the
            # futures. Sweeping again here would recurse (every
            # re-dispatch calls _mark_dead on the source replica) one
            # stack frame per queued future.
            return
        rep.state = "dead"
        rep.deaths += 1
        self._count("replica_deaths")
        rep.stop(drain=False)
        self._note_replica_state(rep)
        for ff in list(rep.futures):
            ff._try_redispatch()

    def _on_replica_death(self, rep, reason_code: str) -> None:
        """Supervisor callback (serving/procfleet.py): the worker
        process behind ``rep`` died; its pending requests were already
        failed — account the death and re-dispatch eagerly."""
        rep.deaths += 1
        self._count("replica_deaths")
        get_telemetry().count(f"fleet.worker_death.{reason_code}")
        self._note_replica_state(rep)
        for ff in list(rep.futures):
            ff._try_redispatch()

    def inject_replica_fault(self, rid: int, kind: str = "crash",
                             **params) -> bool:
        """Chaos lever: deliver a process-level fault to a replica's
        worker (``crash`` / ``hang`` / ``oom`` — the fault-grammar
        kinds, robustness/faults.py). Thread-mode fleets approximate
        ``crash``/``oom`` with :meth:`kill_replica`; ``hang`` has no
        thread analog and returns False."""
        if self._proc_supervisor is not None:
            return self._proc_supervisor.inject_fault(rid, kind,
                                                      **params)
        if kind in ("crash", "oom"):
            try:
                self.kill_replica(rid)
                return True
            except ServingError:
                return False
        return False

    def _note_replica_state(self, rep, event: Optional[str] = None
                            ) -> None:
        """The ``lgbm_fleet_replica_state{rid}`` gauge + a ``replica``
        telemetry record on every state transition (both isolation
        modes; docs/Observability.md)."""
        get_metrics().set_gauge(
            "lgbm_fleet_replica_state",
            STATE_CODES.get(rep.state, -1), labels={"rid": rep.rid})
        if event is not None:
            get_telemetry().record(
                "replica", rid=rep.rid, event=event, state=rep.state,
                isolation="process"
                if getattr(rep, "is_process", False) else "thread")

    def _pick_replica(self, exclude: Tuple[int, ...] = (),
                      allow_none: bool = False) -> Optional[Replica]:
        with self._lock:
            live = [r for r in self._replicas
                    if r.state == "ok" and r.rid not in exclude]
        if not live:
            if allow_none:
                return None
            raise ReplicaUnavailableError(
                "no healthy replica available",
                replicas=len(self._replicas))
        loads = [(r.load(), r) for r in live]
        lo = min(load for load, _ in loads)
        # ties rotate: an idle pool spreads traffic instead of pinning
        # everything on the lowest replica id
        cands = [r for load, r in loads if load == lo]
        with self._lock:
            self._rr += 1
            return cands[self._rr % len(cands)]

    # -- request entry -------------------------------------------------
    def submit(self, rows, kind: str = "predict",
               timeout_ms: Optional[float] = None,
               model: Optional[str] = None,
               tenant: str = "default",
               trace_ctx=None) -> FleetFuture:
        if self._stopping:
            raise EngineStoppedError("fleet is stopped")
        name = model or self.default_model
        tracer = get_tracer()
        # root span of the fleet request: everything downstream — the
        # canary/shadow targets, the replica engine's queue-wait/batch/
        # device spans — shares this trace id
        span = tracer.begin_span(
            "fleet.request", cat="fleet", ctx=trace_ctx,
            args={"model": name, "tenant": tenant, "kind": kind}) \
            if tracer.enabled else None
        try:
            # decode BEFORE admission: byte-costed quotas charge the
            # actual request payload, so the size must be known at the
            # admission decision (decode of a shed request is wasted
            # work, but a tenant paying per-byte must be charged for
            # what it actually sent)
            try:
                arr = np.asarray(rows, np.float64)
            except (TypeError, ValueError) as e:
                raise InvalidRequestError(
                    f"rows not numeric: {e}") from e
            try:
                # tenant admission runs attached to the root span so a
                # quota denial's marker lands on this request's trace
                with tracer.attach(None if span is None else span.ctx):
                    self.quotas.check(
                        tenant, cost=self.quotas.request_cost(
                            arr.nbytes))
            except QuotaExceededError:
                self._count("quota_shed")
                self._count("shed")
                raise
            decision = self.router.route(name)
            if span is not None and (decision.is_canary
                                     or decision.shadow):
                # the routing decision rides the root span's args so a
                # canary-tail investigation sees WHICH variant served
                tracer.instant("fleet.route", cat="fleet",
                               ctx=span.ctx,
                               args=decision.describe())
            if not self.fleet.has(decision.target):
                self._count("model_not_found")
                raise ModelNotFoundError(
                    f"model {decision.target!r} is not served by this "
                    "fleet", model=decision.target,
                    known=self.fleet.names())
            with self._lock:
                full = self._pending >= self.max_pending
                if not full:
                    self._pending += 1
            if full:
                self._count("shed")
                raise QueueFullError(
                    "fleet pending limit reached",
                    max_pending=self.max_pending)
            t = self.config.request_timeout_ms if timeout_ms is None \
                else timeout_ms
            timeout_s = None if t <= 0 else t / 1000.0
            try:
                rep, fut = self._dispatch(
                    decision.target, arr, kind, timeout_ms,
                    trace_ctx=None if span is None else span.ctx)
            except ServingError as e:
                with self._lock:
                    self._pending -= 1
                if isinstance(e, ReplicaUnavailableError):
                    # a no-healthy-replica rejection is an AVAILABILITY
                    # event, not a shed: without this the SLO source
                    # would read a fully-dead pool as 100% available
                    # (zero requests, zero errors)
                    self._count("unavailable")
                raise
        except ServingError as e:
            if span is not None:
                span.finish(error=e.code)
            raise
        self._count("requests")
        self._count("rows", arr.shape[0] if arr.ndim > 1 else 1)
        if decision.is_canary:
            self._count("canary_requests")
        ff = FleetFuture(self, fut, rep, name, decision.target, kind,
                         tenant, arr, timeout_s, span=span)
        ff._meta["is_canary"] = decision.is_canary
        if decision.shadow:
            self._mirror(decision.shadow, arr, kind, ff)
        return ff

    def predict(self, rows, kind: str = "predict",
                timeout_ms: Optional[float] = None,
                model: Optional[str] = None,
                tenant: str = "default") -> np.ndarray:
        fut = self.submit(rows, kind=kind, timeout_ms=timeout_ms,
                          model=model, tenant=tenant)
        t = self.config.request_timeout_ms if timeout_ms is None \
            else timeout_ms
        # same slack rule as ServingEngine.predict: the engine-side
        # structured timeout surfaces, not the caller wait
        wait = None if t <= 0 else t / 1000.0 + 5.0
        return fut.result(timeout=wait)

    def _dispatch(self, target: str, rows: np.ndarray, kind: str,
                  timeout_ms: Optional[float],
                  exclude: Tuple[int, ...] = (),
                  trace_ctx=None) -> Tuple[Replica, ServingFuture]:
        """Least-loaded dispatch with dead-replica failover at submit
        time (a replica that died between selection and submit is
        marked and the next one tried)."""
        tried = list(exclude)
        while True:
            rep = self._pick_replica(exclude=tuple(tried))
            try:
                fut = rep.engine_for(target).submit(
                    rows, kind, timeout_ms=timeout_ms,
                    trace_ctx=trace_ctx)
            except EngineStoppedError:
                self._mark_dead(rep)
                tried.append(rep.rid)
                continue
            with rep._lock:
                rep.outstanding += 1
            return rep, fut

    def _redispatch(self, ff: FleetFuture, err: EngineStoppedError
                    ) -> Tuple[Replica, ServingFuture]:
        """A FleetFuture's replica died mid-request: move the request
        to a survivor with the remaining deadline budget."""
        self._mark_dead(ff._replica)
        with ff._replica._lock:
            ff._replica.outstanding = max(ff._replica.outstanding - 1, 0)
        if self._stopping:
            raise err
        remaining = ff._remaining_s()
        if remaining is not None and remaining <= 0:
            raise RequestTimeoutError(
                "deadline passed before re-dispatch after replica "
                "death", replica=ff._replica.rid)
        self._count("redispatches")
        ctx = None
        if ff._span is not None:
            ctx = ff._span.ctx
            get_tracer().instant(
                "fleet.redispatch", cat="fleet", ctx=ctx,
                args={"from_replica": ff._replica.rid,
                      "target": ff._target})
        rep, fut = self._dispatch(
            ff._target, ff._rows, ff._kind,
            None if remaining is None else remaining * 1000.0,
            exclude=(ff._replica.rid,), trace_ctx=ctx)
        rep.futures.add(ff)
        return rep, fut

    def _complete(self, ff: FleetFuture,
                  error: Optional[ServingError]) -> None:
        with self._lock:
            self._pending = max(self._pending - 1, 0)
        with ff._replica._lock:
            ff._replica.outstanding = max(ff._replica.outstanding - 1, 0)
        if ff._span is not None:
            # end the root span at the moment the underlying request
            # actually completed, not when the caller collected it
            ff._span.finish(
                _end_t=getattr(ff._fut._req, "t_perf_done", None),
                replica=ff._replica.rid,
                redispatches=ff._redispatches,
                **({"error": error.code} if error is not None else {}))
        if error is None:
            lat = (time.monotonic() - ff._t0) * 1000.0
            self._metrics.observe(
                "fleet_request_latency_ms", lat,
                labels={"model": ff._model, "tenant": ff._tenant})
            key = (ff._model, ff._tenant)
            with self._lock:
                self._lat_by_label[key] = \
                    self._lat_by_label.get(key, 0) + 1
        else:
            self._count("errors")
            get_telemetry().count(f"fleet.error.{error.code}")

    # -- shadow mirroring ----------------------------------------------
    def _mirror(self, shadow: str, rows: np.ndarray, kind: str,
                primary: FleetFuture) -> None:
        """Duplicate the request to the shadow target; the response is
        compared for parity off-thread and never returned. A missing,
        empty or mid-drain shadow target is counted and skipped — the
        primary path is never affected."""
        mv = self.fleet.current(shadow) if self.fleet.has(shadow) \
            else None
        if mv is None or mv.draining:
            self._count("shadow_skipped")
            return
        rep = self._pick_replica(allow_none=True)
        if rep is None:
            self._count("shadow_skipped")
            return
        try:
            # the mirror rides the PRIMARY request's trace: its
            # queue/batch/device spans appear on the same timeline,
            # labeled by the shadow target
            fut = rep.engine_for(shadow).submit(
                rows, kind,
                trace_ctx=None if primary._span is None
                else primary._span.ctx)
        except ServingError:
            self._count("shadow_skipped")
            return
        with rep._lock:
            rep.outstanding += 1
        self._count("shadow_mirrored")
        try:
            self._shadow_q.put_nowait((primary, fut, rep, shadow))
        except queue.Full:
            self._count("shadow_dropped")
            with rep._lock:
                rep.outstanding = max(rep.outstanding - 1, 0)
            return
        self._ensure_shadow_thread()

    def _ensure_shadow_thread(self) -> None:
        with self._lock:
            if self._shadow_thread is not None \
                    and self._shadow_thread.is_alive():
                return
            self._shadow_thread = threading.Thread(
                target=self._shadow_loop, name="lgbm-fleet-shadow",
                daemon=True)
            self._shadow_thread.start()

    def _shadow_loop(self) -> None:
        while True:
            item = self._shadow_q.get()
            if item is None:
                return
            primary, fut, rep, shadow = item
            try:
                mirrored = fut.result(timeout=30.0)
                expect = primary._fut.result(timeout=30.0)
                if expect is not None \
                        and np.array_equal(np.asarray(mirrored),
                                           np.asarray(expect)):
                    self._count("shadow_parity_ok")
                else:
                    self._count("shadow_parity_mismatch")
                    log_warning(
                        f"serving fleet: shadow {shadow!r} diverged "
                        f"from primary {primary._target!r} "
                        f"({primary._kind}, {len(primary._rows)} rows)")
            except ServingError:
                self._count("shadow_errors")
            except Exception as e:  # never kill the comparator
                self._count("shadow_errors")
                log_warning(f"serving fleet: shadow compare failed: {e}")
            finally:
                with rep._lock:
                    rep.outstanding = max(rep.outstanding - 1, 0)

    # -- bookkeeping ---------------------------------------------------
    def _count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0.0) + value
        get_telemetry().count(f"fleet.{name}", value)

    def slo_counts(self) -> Dict[str, int]:
        """Cumulative counts the SLO engine samples (observability/
        slo.py): total attempts and the bad-event classes. ``shed``
        is intentional backpressure — excluded from the error SLI but
        reported so an error-rate spec can opt in."""
        with self._lock:
            c = dict(self._counts)
        return {"requests": int(c.get("requests", 0)),
                "errors": int(c.get("errors", 0)),
                "shed": int(c.get("shed", 0)),
                "unavailable": int(c.get("unavailable", 0))}

    @property
    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            counts = {k: int(v) for k, v in self._counts.items()}
            pending = self._pending
            reps = list(self._replicas)
            by_label = dict(self._lat_by_label)
        agg: Dict[str, float] = {}
        for rep in reps:
            with rep._lock:
                engines = list(rep._engines.values())
            for eng in engines:
                for k, v in eng.stats().items():
                    if isinstance(v, (int, float)) and not isinstance(
                            v, bool):
                        agg[k] = agg.get(k, 0) + v
        out: Dict[str, Any] = {
            "pending": pending,
            "max_pending": self.max_pending,
            "replicas": [r.describe() for r in reps],
            "models": self.fleet.describe(),
            "router": self.router.describe(),
            "quotas": self.quotas.describe(),
            "requests_by_model_tenant": {
                f"{m}/{t}": n for (m, t), n in sorted(by_label.items())},
            "engine_totals": {k: int(v) for k, v in sorted(agg.items())},
        }
        out.update(counts)
        for key in ("requests", "shed", "errors"):
            out.setdefault(key, 0)
        return out

    def health(self) -> Dict[str, Any]:
        with self._lock:
            reps = list(self._replicas)
            pending = self._pending
        ok = [r for r in reps if r.state == "ok"]
        models = self.fleet.describe()
        status = "ok"
        if not ok:
            status = "no_replicas"
        elif not models or all(v is None for v in models.values()):
            status = "no_model"
        elif len(ok) < len(reps) or self._last_reload_error is not None:
            # degraded-but-serving: a replica is down, or the last
            # model publish was rejected (previous versions keep
            # serving; the ramp controller aborts on this)
            status = "degraded"
        out = {
            "status": status,
            "fleet": True,
            "isolation": self.isolation,
            "pending": pending,
            "max_pending": self.max_pending,
            "default_model": self.default_model,
            "replicas": [r.describe() for r in reps],
            "replicas_quarantined": sum(
                1 for r in reps if r.state == "quarantined"),
            "models": models,
            "router": self.router.describe(),
            "quotas": self.quotas.describe(),
        }
        if self._last_reload_error is not None:
            out["last_reload_error"] = dict(self._last_reload_error)
        return out

    # ServingEngine-compat surface used by http.py / loadgen
    @property
    def version(self) -> Optional[int]:
        mv = self.fleet.current(self.default_model) \
            if self.fleet.has(self.default_model) else None
        return None if mv is None else mv.version

    def stop(self, drain: bool = True, timeout: float = 10.0) -> None:
        self._stopping = True
        if self._shadow_thread is not None:
            try:
                self._shadow_q.put_nowait(None)
            except queue.Full:
                pass
            self._shadow_thread.join(timeout)
        if self._proc_supervisor is not None:
            # drains every worker, closes the listener, stops the
            # monitor and reaps anything still alive — no orphans
            self._proc_supervisor.shutdown(drain=drain)
        for rep in self.replicas:
            if rep.state != "dead":
                rep.stop(drain=drain)
                rep.state = "dead"
        tel = get_telemetry()
        if tel.enabled:
            stats = self.stats()
            tel.record("fleet_stats", **{
                k: v for k, v in stats.items()
                if isinstance(v, (int, float, str))})
        get_tracer().flush()   # persist the request timeline

    def __enter__(self) -> "FleetEngine":
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
