"""Refit trainer: labeled windows -> checkpointed candidate models (port
of ``lightgbm_tpu/pipeline/trainer.py``).

Two modes, both warm-started from the current production model:

* ``refit`` — keep every tree's structure and refit the leaf values
  (and, for ``linear_tree`` models, the per-leaf coefficients) on the
  window via :meth:`Booster.refit` — ``pred_leaf`` over the window, then
  one replay on the device whose per-leaf sums are the ``hist_rows``
  kernel's refit route (``ops/hist_cuda.py:leaf_histogram``).
  Byte-stable: the same base model and the same window always produce
  the same candidate text.
* ``continue`` — continued training (``engine.train(init_model=...)``):
  grow ``continue_iters`` new trees on the window on top of the
  production model, on the learner ``create_tree_learner`` picks (at
  <= 255 bins the partitioned learner's fused segment step).

A third trainer, :class:`TenantRefitTrainer`, trains one candidate a
tenant through ``engine.train_many`` (the model-batched kernels).

Every candidate is checkpointed through ``robustness/checkpoint.py``
(atomic temp+fsync+rename, manifest digests, keep-last-K) before it is
ever published. ``device`` and ``ops`` are ``lt.train``'s: the card
unless the caller says otherwise, the kernels unless ``ops="plain"``.
"""

from __future__ import annotations

import os
import shutil
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np

from ..observability.telemetry import get_telemetry
from ..observability.tracing import get_tracer
from ..utils.log import log_info
from .logsource import LabeledWindow

MODES = ("refit", "continue")

# keys of a pipeline's params that are not training params
_NOT_TRAINING = ("task", "input_model", "output_model", "data", "config",
                 "num_iterations")


def training_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The training params of a pipeline's params: without the
    ``pipeline_*`` / ``serving_*`` keys and the CLI's file keys."""
    return {k: v for k, v in params.items()
            if not str(k).startswith(("pipeline_", "serving_"))
            and k not in _NOT_TRAINING}


class Candidate:
    """One refit candidate moving through the pipeline."""

    STATUSES = ("candidate", "published", "promoted", "rejected",
                "rolled_back")

    def __init__(self, cid: int, model_text: str, mode: str,
                 window_index: int, booster=None):
        self.cid = int(cid)
        self.model_text = model_text
        self.mode = mode
        self.window_index = int(window_index)
        self.booster = booster
        self.created_at = time.time()
        self.status = "candidate"
        self.reason = ""
        self.name: Optional[str] = None       # fleet registry name
        self.version: Optional[int] = None    # registry version id
        self.checkpoint_path: Optional[str] = None

    def mark(self, status: str, reason: str = "") -> None:
        self.status = status
        self.reason = reason

    def describe(self) -> Dict[str, Any]:
        return {"candidate": self.cid, "mode": self.mode,
                "window": self.window_index, "status": self.status,
                "reason": self.reason, "name": self.name,
                "version": self.version,
                "checkpoint": self.checkpoint_path}


class RefitTrainer:
    """Consumes labeled windows, emits checkpointed candidates."""

    def __init__(self, model_text: str,
                 params: Optional[Dict[str, Any]] = None,
                 mode: str = "refit", decay: float = 0.9,
                 continue_iters: int = 10,
                 checkpoint_dir: str = "", checkpoint_keep: int = 3,
                 device=None, ops: str = "kernel"):
        if mode not in MODES:
            raise ValueError(
                f"pipeline_mode must be one of {MODES}, got {mode!r}")
        self._model_text = model_text
        self.params = dict(params or {})
        self.mode = mode
        self.decay = float(decay)
        self.continue_iters = int(continue_iters)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_keep = int(checkpoint_keep)
        self.device = device
        self.ops = ops
        self._next_cid = 1

    @property
    def current_model_text(self) -> str:
        """The model the next candidate warm-starts from (advanced by
        :meth:`note_promoted`)."""
        return self._model_text

    def note_promoted(self, candidate: Candidate) -> None:
        self._model_text = candidate.model_text

    # ------------------------------------------------------------------
    def refit(self, window: LabeledWindow) -> Candidate:
        """One candidate from one window; see module docstring."""
        from ..basic import Booster
        tel = get_telemetry()
        cid = self._next_cid
        self._next_cid += 1
        with get_tracer().span("pipeline.refit", cat="pipeline",
                               args={"candidate": cid,
                                     "mode": self.mode,
                                     "window": window.index,
                                     "rows": window.rows}):
            with tel.span("pipeline.refit"):
                if self.mode == "refit":
                    base = Booster(model_str=self._model_text,
                                   device=self.device, ops=self.ops)
                    booster = base.refit(window.X, window.y,
                                         decay_rate=self.decay)
                else:
                    booster = self._continue(window)
        cand = Candidate(cid, booster.model_to_string(), self.mode,
                         window.index, booster=booster)
        tel.count("pipeline.candidates")
        checkpoint_candidate(cand, self.checkpoint_dir,
                             self.checkpoint_keep)
        log_info(f"pipeline: candidate {cid} ({self.mode}) from "
                 f"window {window.index} ({window.rows} rows)"
                 + (f", checkpointed at {cand.checkpoint_path}"
                    if cand.checkpoint_path else ""))
        return cand

    def _continue(self, window: LabeledWindow):
        from .. import engine
        from ..basic import Booster, Dataset
        init = Booster(model_str=self._model_text, device=self.device)
        return engine.train(
            training_params(self.params),
            Dataset(window.X, label=window.y),
            num_boost_round=self.continue_iters,
            init_model=init, verbose_eval=False, device=self.device,
            ops=self.ops)


def checkpoint_candidate(cand: Candidate, checkpoint_dir: str,
                         keep: int) -> None:
    """Atomic keep-last-K candidate checkpoint under
    ``<checkpoint_dir>/cand_<id>/`` (model text + training state +
    digest manifest); shared by the single-model and per-tenant
    trainers (no-op without a directory)."""
    if not checkpoint_dir:
        return
    path = os.path.join(checkpoint_dir, f"cand_{cand.cid:05d}")
    if getattr(cand.booster, "_gbdt", None) is not None:
        from ..robustness.checkpoint import CheckpointManager
        mgr = CheckpointManager(path, freq=0, keep=1)
        cand.checkpoint_path = mgr.save(cand.booster, [], 0)
    else:
        # a text-backed candidate (a multiboost tenant batch's) has no
        # live training state; the model text IS the whole artifact
        from ..robustness.checkpoint import atomic_write_text
        os.makedirs(path, exist_ok=True)
        atomic_write_text(os.path.join(path, "model.txt"),
                          cand.model_text)
        cand.checkpoint_path = path
    get_telemetry().count("pipeline.candidate_checkpoints")
    if not os.path.isdir(checkpoint_dir):
        return
    dirs: List[str] = sorted(d for d in os.listdir(checkpoint_dir)
                             if d.startswith("cand_"))
    for stale in dirs[:-max(int(keep), 1)]:
        shutil.rmtree(os.path.join(checkpoint_dir, stale),
                      ignore_errors=True)


class TenantRefitTrainer:
    """Per-tenant candidates from one window, batched as one
    ``train_many`` bucket.

    Every tenant owns a deterministic round-robin partition of the
    window's rows and a deterministic per-tenant ``bagging_seed``; the
    candidates for all admitted tenants train through
    :func:`lightgbm_tpu_torch.engine.train_many` — one
    :class:`~lightgbm_tpu_torch.multiboost.BoosterBatch` bucket (the
    per-tenant rows ride its row masks, the seeds its per-model
    parameter table), so T tenant models take one model-batched leaf
    step a split instead of T. Candidates are fresh models over the
    tenant's slice, sized by ``pipeline_continue_iters``.
    """

    def __init__(self, tenants, params: Optional[Dict[str, Any]] = None,
                 num_boost_round: int = 10, objective: str = "",
                 checkpoint_dir: str = "", checkpoint_keep: int = 3,
                 device=None, ops: str = "kernel"):
        self.tenants = [str(t) for t in tenants]
        if not self.tenants:
            raise ValueError("TenantRefitTrainer requires >= 1 tenant")
        self.params = dict(params or {})
        self.num_boost_round = int(num_boost_round)
        self.objective = objective
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_keep = int(checkpoint_keep)
        self.device = device
        self.ops = ops
        self.last_report: Optional[Dict[str, Any]] = None
        self._next_cid = 1

    @staticmethod
    def tenant_seed(tenant: str) -> int:
        """Deterministic per-tenant seed (stable across processes —
        not ``hash()``, which is salted per interpreter)."""
        return int(zlib.crc32(str(tenant).encode()) % 100003) + 1

    def partition(self, n_rows: int) -> Dict[str, np.ndarray]:
        """Round-robin row partition: tenant ``i`` of T owns rows
        ``i, i+T, i+2T, ...`` — every tenant sees the same traffic mix
        and the union covers the window exactly once."""
        T = len(self.tenants)
        return {t: np.arange(i, int(n_rows), T)
                for i, t in enumerate(self.tenants)}

    def tenant_params(self, tenant: str) -> Dict[str, Any]:
        """One tenant's training params. Its seed rides the batched
        ``bagging_seed`` (plain ``seed`` is a bucket key and would put
        every tenant in a bucket of its own)."""
        params = training_params(self.params)
        if self.objective and "objective" not in params:
            params["objective"] = self.objective
        params["bagging_seed"] = self.tenant_seed(tenant)
        return params

    def refit_all(self, window: LabeledWindow,
                  tenants=None) -> Dict[str, Candidate]:
        """One candidate per (admitted) tenant from one window; all of
        them trained by one ``train_many`` call."""
        from .. import engine
        from ..basic import Dataset
        tel = get_telemetry()
        tenants = [str(t) for t in (tenants or self.tenants)]
        parts = self.partition(window.rows)
        with get_tracer().span("pipeline.tenant_refit", cat="pipeline",
                               args={"tenants": len(tenants),
                                     "window": window.index,
                                     "rows": window.rows}):
            with tel.span("pipeline.refit"):
                boosters, report = engine.train_many(
                    [self.tenant_params(t) for t in tenants],
                    Dataset(window.X, label=window.y),
                    num_boost_round=self.num_boost_round,
                    row_indices=[parts[t] for t in tenants],
                    return_report=True, device=self.device, ops=self.ops)
        self.last_report = report
        out: Dict[str, Candidate] = {}
        for t, booster in zip(tenants, boosters):
            cand = Candidate(self._next_cid, booster.model_to_string(),
                             "multiboost", window.index,
                             booster=booster)
            self._next_cid += 1
            tel.count("pipeline.candidates")
            checkpoint_candidate(cand, self.checkpoint_dir,
                                 self.checkpoint_keep)
            out[t] = cand
        log_info(f"pipeline: {len(out)} tenant candidates from window "
                 f"{window.index} ({report['batched_models']} batched "
                 f"in {len(report['buckets'])} bucket(s), "
                 f"{len(report['loop_fallback'])} loop fallback)")
        return out


__all__ = ["Candidate", "RefitTrainer", "TenantRefitTrainer",
           "checkpoint_candidate", "training_params", "MODES"]
