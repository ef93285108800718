"""Structured serving errors (copy of ``lightgbm_tpu/serving/errors.py``
for the PyTorch port: the same codes, HTTP statuses and ``details``).

Every failure mode of the serving engine raises (or fulfills a future
with) one of these — a shed or timed-out request gets a typed error
with a machine-readable ``code``, never a hang. ``to_dict()`` is the
JSON wire shape the HTTP frontend returns, with ``http_status``
picking the response code (429 shed, 504 timeout, ...).
"""

from __future__ import annotations

from typing import Any, Dict


class ServingError(Exception):
    """Base serving error; ``code`` is stable and machine-readable."""

    code = "serving_error"
    http_status = 500

    def __init__(self, message: str = "", **details: Any):
        super().__init__(message or self.code)
        self.details = details

    def to_dict(self) -> Dict[str, Any]:
        out = {"error": self.code, "message": str(self)}
        if self.details:
            out.update(self.details)
        return out


class QueueFullError(ServingError):
    """Load shed: the bounded request queue is at ``max_queue``."""

    code = "queue_full"
    http_status = 429


class RequestTimeoutError(ServingError):
    """The request's deadline passed before a result was produced."""

    code = "timeout"
    http_status = 504


class EngineStoppedError(ServingError):
    """The engine was stopped while the request was pending."""

    code = "engine_stopped"
    http_status = 503


class ModelLoadError(ServingError):
    """A model source could not be loaded/parsed."""

    code = "model_load_error"
    http_status = 400


class ModelNotFoundError(ServingError):
    """The request named a model the fleet does not serve."""

    code = "model_not_found"
    http_status = 404


class QuotaExceededError(ServingError):
    """Per-tenant token-bucket quota exhausted: a structured shed (the
    fleet's admission-side load shedder), NEVER a timeout — the caller
    learns immediately and can back off (``retry_after_s`` detail)."""

    code = "quota_exceeded"
    http_status = 429


class ReplicaUnavailableError(ServingError):
    """No healthy replica can take the dispatch (all dead/draining)."""

    code = "replica_unavailable"
    http_status = 503


class InvalidRequestError(ServingError):
    """Malformed request payload (bad shape, non-numeric rows, ...)."""

    code = "invalid_request"
    http_status = 400
