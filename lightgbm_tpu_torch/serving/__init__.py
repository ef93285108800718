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
* :class:`Router` (``router.py``) and :class:`TenantQuotas`
  (``tenants.py``) — canary/shadow decisions and per-tenant
  token-bucket admission, for the fleets (``FleetEngine``,
  ``ModelFleet`` and the process fleet: ROADMAP.md Queue 1 item 10.2).
"""

from .engine import ServingConfig, ServingEngine
from .errors import (EngineStoppedError, InvalidRequestError,
                     ModelLoadError, ModelNotFoundError, QueueFullError,
                     QuotaExceededError, ReplicaUnavailableError,
                     RequestTimeoutError, ServingError)
from .registry import ModelRegistry, save_model_npz
from .router import RouteDecision, Router
from .tenants import TenantQuotas, TokenBucket

__all__ = ["ServingEngine", "ServingConfig", "ModelRegistry",
           "save_model_npz", "ServingError", "QueueFullError",
           "RequestTimeoutError", "EngineStoppedError",
           "ModelLoadError", "InvalidRequestError",
           "ModelNotFoundError", "QuotaExceededError",
           "ReplicaUnavailableError", "Router", "RouteDecision",
           "TenantQuotas", "TokenBucket"]
