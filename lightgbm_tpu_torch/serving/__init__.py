"""In-process serving on the card (port of ``lightgbm_tpu/serving/``).

* :class:`ModelRegistry` (``registry.py``) — versioned model storage
  with each version's trees stacked once on the device, atomic hot swap
  and old-version draining;
* :class:`ServingEngine` (``engine.py``) — micro-batching over a
  bounded request queue with a deadline flusher, shape-bucketed
  dispatch of one CUDA graph a (version, bucket, kind)
  (``programs.py``), warmup, per-request timeouts, queue-full shedding
  and a counted CPU fallback;
* ``aot.py`` — a published model text's stack as an npz artifact;
* ``http.py`` — a stdlib JSON frontend: predict / raw_score /
  pred_leaf / health / stats / metrics / slo / reload;
* ``loadgen.py`` — closed- and open-loop load generation plus the
  sustained soak mode;
* :class:`FleetEngine` / :class:`ModelFleet` / :class:`Replica`
  (``fleet.py``) — a replica pool over named models with least-loaded
  dispatch, re-dispatch on replica death, canary/shadow routing
  (:class:`Router`, ``router.py``) and per-tenant token-bucket
  admission (:class:`TenantQuotas`, ``tenants.py``);
* the process fleet (``procfleet.py``: :class:`WorkerSupervisor`,
  :class:`ProcessReplica`, :class:`ProcFleetOptions`) — each replica's
  engines in a spawned worker process (``worker.py``) over a
  length-prefixed JSON socket and a shared-memory row ring
  (``shm_ring.py``).
"""

from .engine import ServingConfig, ServingEngine
from .errors import (EngineStoppedError, InvalidRequestError,
                     ModelLoadError, ModelNotFoundError, QueueFullError,
                     QuotaExceededError, ReplicaUnavailableError,
                     RequestTimeoutError, ServingError)
from .fleet import FleetEngine, ModelFleet, Replica
from .procfleet import (ProcessReplica, ProcFleetOptions,
                        WorkerSupervisor)
from .registry import ModelRegistry, save_model_npz
from .router import RouteDecision, Router
from .tenants import TenantQuotas, TokenBucket

__all__ = ["ServingEngine", "ServingConfig", "ModelRegistry",
           "save_model_npz", "ServingError", "QueueFullError",
           "RequestTimeoutError", "EngineStoppedError",
           "ModelLoadError", "InvalidRequestError",
           "ModelNotFoundError", "QuotaExceededError",
           "ReplicaUnavailableError",
           "FleetEngine", "ModelFleet", "Replica",
           "ProcessReplica", "ProcFleetOptions", "WorkerSupervisor",
           "Router", "RouteDecision",
           "TenantQuotas", "TokenBucket"]
