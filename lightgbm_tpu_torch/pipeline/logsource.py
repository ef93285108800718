"""Labeled training windows for the continuous-refit pipeline (port of
``lightgbm_tpu/pipeline/logsource.py``: host numpy only, the same
``RandomState`` draws, so a replay window is bitwise the JAX package's).

Two sources, one contract — ``next_window(rows) -> LabeledWindow`` (or
``None`` when the stream has nothing yet):

* :class:`ReplayLogSource` — a deterministic synthetic stream: window
  ``i`` is a pure function of ``(seed, i)`` plus the armed drift
  state, so two processes with the same seed and the same fault plan
  draw byte-identical windows (the drill's byte-stable-parity check
  and every pipeline test rely on this). Rows follow the
  ``serving/loadgen.py`` benchmark shape (dense gaussian features, a
  linear ground-truth margin) and **drift** is injected through the
  ``robustness/faults.py`` grammar::

      drift@window=K[,shift=V][,feature=J][,flip=P][,once=1]

  From window ``K`` on, feature ``J``'s mean shifts by ``V`` (the
  covariate-drift leg — a refit genuinely improves quality) and/or
  labels flip with probability ``P`` (the poison leg — the refit
  candidate genuinely regresses on a clean holdout, which the ramp
  controller must catch and roll back). ``once=1`` limits the drift
  to the single window ``K`` (one poisoned batch); otherwise it
  persists until a later drift event replaces it.

* :class:`TailLogSource` — tails a serving-log JSONL file (one
  ``{"x": [...], "y": <label>}`` object per line, e.g. a frontend
  logging requests once their labels arrive) and assembles appended
  lines into windows. Bounded polling, never blocks forever.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..robustness.faults import get_fault_plan
from ..utils.log import log_info, log_warning


class LabeledWindow:
    """One labeled training window from the stream."""

    __slots__ = ("index", "X", "y", "drift")

    def __init__(self, index: int, X: np.ndarray, y: np.ndarray,
                 drift: Optional[Dict[str, Any]] = None):
        self.index = int(index)
        self.X = X
        self.y = y
        self.drift = drift      # active drift state (None = clean)

    @property
    def rows(self) -> int:
        return int(self.X.shape[0])

    def describe(self) -> Dict[str, Any]:
        return {"index": self.index, "rows": self.rows,
                "features": int(self.X.shape[1]),
                "drift": dict(self.drift) if self.drift else None}


class ReplayLogSource:
    """Deterministic replay stream; see module docstring."""

    def __init__(self, n_features: int = 8, seed: int = 0,
                 noise: float = 0.1, task: str = "binary",
                 coef: Optional[np.ndarray] = None):
        self.n_features = int(n_features)
        self.seed = int(seed)
        self.noise = float(noise)
        if task not in ("binary", "regression"):
            raise ValueError(f"ReplayLogSource task must be binary or "
                             f"regression, got {task!r}")
        self.task = task
        if coef is None:
            # the fault_smoke.py ground truth, extended to any width:
            # a few informative features, the rest noise
            coef = np.zeros(self.n_features)
            coef[: min(3, self.n_features)] = \
                [1.0, 0.5, -0.25][: min(3, self.n_features)]
        self.coef = np.asarray(coef, np.float64)
        self._index = 0
        self._drift: Optional[Dict[str, float]] = None

    def _rng(self, index: int) -> np.random.RandomState:
        # one independent, reproducible stream per window index
        return np.random.RandomState(
            (self.seed * 1000003 + index * 7919 + 1) % (2 ** 31 - 1))

    def _arm_drift(self, index: int) -> None:
        plan = get_fault_plan()
        if plan is None:
            return
        ev = plan.take("drift", window=index)
        if ev is None:
            return
        self._drift = {
            "window": index,
            "shift": float(ev.params.get("shift", 0.0)),
            "feature": int(ev.params.get("feature", 0)),
            "flip": float(ev.params.get("flip", 0.0)),
            "once": int(ev.params.get("once", 0)),
        }
        log_info(f"pipeline: drift armed from window {index} "
                 f"({self._drift})")

    def _draw(self, index: int, rows: int) -> LabeledWindow:
        rng = self._rng(index)
        X = rng.randn(rows, self.n_features)
        d = self._drift
        if d is not None and d.get("shift"):
            f = min(max(d["feature"], 0), self.n_features - 1)
            X[:, f] = X[:, f] + d["shift"]
        margin = X @ self.coef + self.noise * rng.randn(rows)
        if self.task == "binary":
            y = (margin > 0).astype(np.float64)
        else:
            y = margin
        if d is not None and d.get("flip"):
            mask = rng.rand(rows) < d["flip"]
            if self.task == "binary":
                y = np.where(mask, 1.0 - y, y)
            else:
                y = np.where(mask, -y, y)
        return LabeledWindow(index, X, y,
                             drift=dict(d) if d else None)

    @property
    def next_index(self) -> int:
        """The index the next ``next_window`` call will draw (arm
        drift events against this)."""
        return self._index

    def next_window(self, rows: int) -> LabeledWindow:
        """The next labeled window of ``rows`` rows; drift events armed
        for this window index fire before the draw. A later drift
        event REPLACES the active drift state; ``once=1`` drifts apply
        to exactly one window (a single poisoned batch) and disarm."""
        index = self._index
        self._index += 1
        self._arm_drift(index)
        out = self._draw(index, rows)
        if self._drift is not None and self._drift.get("once"):
            self._drift = None
        return out

    def peek_window(self, index: int, rows: int,
                    drifted: bool = False) -> LabeledWindow:
        """Re-draw window ``index`` out of band (drill verification):
        same bytes as the in-band draw with the same drift state."""
        saved = self._drift
        if not drifted:
            self._drift = None
        try:
            return self._draw(index, rows)
        finally:
            self._drift = saved


class TailLogSource:
    """Tails a serving-log JSONL file into labeled windows."""

    def __init__(self, path: str, n_features: int,
                 poll_s: float = 0.05, wait_s: float = 5.0):
        self.path = path
        self.n_features = int(n_features)
        self.poll_s = float(poll_s)
        self.wait_s = float(wait_s)
        self._offset = 0
        self._index = 0
        self._pending: List[Any] = []

    def _pull(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path) as fh:
            fh.seek(self._offset)
            chunk = fh.read()
            self._offset = fh.tell()
        for line in chunk.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                x = np.asarray(rec["x"], np.float64)
                y = float(rec["y"])
            except (json.JSONDecodeError, KeyError, TypeError,
                    ValueError) as e:
                log_warning(f"pipeline: skipping bad log line: {e}")
                continue
            if x.shape != (self.n_features,):
                log_warning(
                    f"pipeline: skipping log row with {x.shape} "
                    f"features (expected {self.n_features})")
                continue
            self._pending.append((x, y))

    def next_window(self, rows: int) -> Optional[LabeledWindow]:
        """Poll until ``rows`` labeled rows accumulated or ``wait_s``
        elapsed; returns what arrived (None when nothing did)."""
        deadline = time.monotonic() + self.wait_s
        while True:
            self._pull()
            if len(self._pending) >= rows \
                    or time.monotonic() >= deadline:
                break
            time.sleep(self.poll_s)
        if not self._pending:
            return None
        take, self._pending = self._pending[:rows], self._pending[rows:]
        X = np.stack([x for x, _ in take])
        y = np.asarray([y for _, y in take], np.float64)
        index = self._index
        self._index += 1
        return LabeledWindow(index, X, y)


__all__ = ["LabeledWindow", "ReplayLogSource", "TailLogSource"]
