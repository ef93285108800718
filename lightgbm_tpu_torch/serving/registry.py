"""Versioned model registry with device pinning and hot reload (port of
``lightgbm_tpu/serving/registry.py``).

Each loaded model becomes a :class:`ModelVersion`: the prediction
source (a trained ``GBDT`` or a text-parsed ``LoadedBooster``), its
trees stacked once on the engine's device (``predictor.stack_trees``,
pinned instead of restacked per request) and, once the engine has
warmed it, one replayable program a (bucket, kind)
(``serving/programs.py``).

The port walks raw float64 features, so every source pins and serves on
the device, model text and npz included (the JAX package serves those
through its host loop: they carry no bin mappers).

Hot reload is an atomic pointer swap: :meth:`ModelRegistry.activate`
replaces the current version under a lock; requests already dispatched
keep the version they acquired (``checkout``), and the old version's
device tensors are dropped only when its in-flight count drains to zero.

Sources accepted by :meth:`ModelRegistry.load`:

* an in-memory ``basic.Booster`` / ``models.GBDT`` / ``LoadedBooster``;
* a model-text string (contains a newline);
* a path to a model text file;
* a path to an ``.npz`` written by :func:`save_model_npz` (by either
  package: the format is the JAX package's).
"""

from __future__ import annotations

import os
import threading
import time
import zipfile
from typing import Any, List, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.log import log_info, log_warning
from .errors import ModelLoadError, ServingError

_NPZ_FORMAT = "lightgbm_tpu.serving.model.v1"


def save_model_npz(src, path: str) -> None:
    """Serialize a booster into an ``.npz`` the registry can load.

    The payload is the reference model-text format (the repo's lingua
    franca for model interchange) wrapped in an npz member, plus a
    format tag — a single-file binary artifact for deploy pipelines
    that already move npz datasets around.
    """
    from ..io.model_text import save_model_to_string
    if hasattr(src, "_src"):                      # basic.Booster
        text = src.model_to_string()
    else:
        text = save_model_to_string(src)
    np.savez(path, format=np.asarray(_NPZ_FORMAT),
             model_text=np.asarray(text))


def _load_npz(path: str):
    import io as _io
    from ..io.model_text import load_model_from_string
    from ..robustness.retry import read_bytes, retry_call
    raw = retry_call(read_bytes, path, attempts=3, base_delay_s=0.05,
                     desc=f"serving npz read {path}")
    try:
        with np.load(_io.BytesIO(raw), allow_pickle=False) as z:
            if "model_text" not in z.files:
                raise ModelLoadError(
                    f"{path!r} is not a serving model npz "
                    "(no model_text member)", path=path)
            fmt = str(z["format"]) if "format" in z.files else ""
            if fmt and fmt != _NPZ_FORMAT:
                log_warning(f"serving npz {path!r} has format {fmt!r}; "
                            f"expected {_NPZ_FORMAT!r} — trying anyway")
            text = str(z["model_text"])
    except (zipfile.BadZipFile, ValueError, OSError) as e:
        # a torn/partially-copied npz fails the zip CRC/structure checks
        raise ModelLoadError(
            f"{path!r} is torn or not a valid npz: {e}",
            path=path) from e
    _check_model_text_integrity(text, path)
    return load_model_from_string(text)


def _check_model_text_integrity(text: str, source: str) -> None:
    """Reject partially-written / torn model text BEFORE parsing: a
    complete save always carries the ``end of trees`` marker (and the
    parameter footer's terminator when a footer was started). Loading
    a torn file would otherwise silently drop trailing trees."""
    if "end of trees" not in text:
        raise ModelLoadError(
            f"model source {source!r} is truncated (missing 'end of "
            "trees' marker); refusing to serve a torn model",
            path=source)
    if "\nparameters:" in text and "end of parameters" not in text:
        raise ModelLoadError(
            f"model source {source!r} is truncated inside the "
            "parameters footer; refusing to serve a torn model",
            path=source)


def _check_sidecar_manifest(path: str) -> None:
    """When a ``<path>.manifest.json`` sidecar exists (the checkpoint
    manifest format — deploy pipelines can publish one next to the
    model artifact), verify the recorded size + sha256 digest before
    loading; a mismatch means the artifact is torn or stale."""
    import hashlib
    import json
    sidecar = path + ".manifest.json"
    if not os.path.exists(sidecar):
        return
    from ..robustness.retry import read_bytes, read_text, retry_call
    try:
        manifest = json.loads(retry_call(
            read_text, sidecar, attempts=3, base_delay_s=0.05,
            desc=f"serving sidecar {sidecar}"))
        info = (manifest.get("files") or {}).get(
            os.path.basename(path)) or manifest
        data = retry_call(read_bytes, path, attempts=3,
                          base_delay_s=0.05,
                          desc=f"serving model read {path}")
    except (OSError, ValueError, json.JSONDecodeError) as e:
        raise ModelLoadError(
            f"cannot verify {path!r} against its manifest sidecar: "
            f"{e}", path=path) from e
    if "bytes" in info and len(data) != int(info["bytes"]):
        raise ModelLoadError(
            f"model file {path!r} is torn: {len(data)} bytes on disk "
            f"vs {info['bytes']} recorded in the manifest", path=path)
    if "sha256" in info \
            and hashlib.sha256(data).hexdigest() != info["sha256"]:
        raise ModelLoadError(
            f"model file {path!r} digest mismatch vs its manifest "
            "(torn or stale artifact)", path=path)


def num_features(src) -> int:
    """The raw feature count a request row must have."""
    data = getattr(src, "train_data", None)
    if data is not None:
        return int(data.num_total_features)
    return int(getattr(src, "max_feature_idx", 0)) + 1


class ModelVersion:
    """One immutable loaded model + its device residency + drain state."""

    def __init__(self, version: int, src, source_desc: str,
                 booster=None):
        self.version = version
        self.src = src
        self.booster = booster          # keep a basic.Booster alive
        self.source_desc = source_desc
        self.created_at = time.time()
        self.k = int(src.num_tree_per_iteration)
        self.num_trees = len(src.models)
        self.num_features = num_features(src)
        self.device = None
        self.stacked = None             # predictor.stack_trees, pinned
        self.aot = None                 # serving.aot.AotPredict or None
        # (bucket, kind) -> serving.programs.BucketProgram
        self.programs = {}
        self.program_lock = threading.Lock()
        self._lock = threading.Lock()
        self._inflight = 0
        self._draining = False

    # -- device residency ----------------------------------------------
    def pin_device(self, device) -> None:
        """Stack the trees and upload once (a failure, e.g. out of
        device memory, raises: the engine's load fails and the previous
        version keeps serving)."""
        if self.stacked is None:
            from ..predictor import stack_trees
            self.stacked = stack_trees(self.src.models, device)
            self.device = torch.device(device)

    def attach_aot(self, art) -> None:
        """Attach an AOT predict artifact (serving/aot.py): its stacked
        arrays, rebuilt from the bundle on the artifact's device, become
        this version's pinned stack. Shape agreement with the parsed
        model text is a publish invariant — a mismatch means the
        publisher shipped the wrong bundle, so fail loudly."""
        if int(art.num_trees) != int(self.num_trees) \
                or int(art.k) != int(self.k):
            raise ModelLoadError(
                f"AOT artifact does not match model: artifact has "
                f"{art.num_trees} trees / k={art.k}, model text has "
                f"{self.num_trees} trees / k={self.k}")
        self.aot = art
        self.stacked, self.device = art.stacked, art.device

    @property
    def device_ready(self) -> bool:
        return self.stacked is not None

    # -- draining ------------------------------------------------------
    def acquire(self) -> "ModelVersion":
        with self._lock:
            self._inflight += 1
        return self

    def release(self) -> None:
        free = False
        with self._lock:
            self._inflight -= 1
            if self._draining and self._inflight <= 0:
                free = True
        if free:
            self._free()

    def start_draining(self) -> None:
        free = False
        with self._lock:
            self._draining = True
            free = self._inflight <= 0
        if free:
            self._free()

    def _free(self) -> None:
        # drop the pinned device tensors and the captured programs; the
        # python trees stay (cheap)
        self.stacked = None
        self.aot = None
        self.programs = {}

    @property
    def inflight(self) -> int:
        return self._inflight

    @property
    def draining(self) -> bool:
        return self._draining

    def describe(self) -> dict:
        return {"version": self.version, "source": self.source_desc,
                "num_trees": self.num_trees, "k": self.k,
                "device_ready": self.device_ready,
                "aot": self.aot is not None,
                "draining": self._draining, "inflight": self._inflight,
                "created_at": self.created_at}


class _Checkout:
    """Context manager pairing acquire/release around one dispatch."""

    __slots__ = ("mv",)

    def __init__(self, mv: ModelVersion):
        self.mv = mv

    def __enter__(self) -> ModelVersion:
        return self.mv

    def __exit__(self, *exc):
        self.mv.release()
        return False


class ModelRegistry:
    """Thread-safe versioned model store with atomic activation; its
    versions pin on ``device`` (None: the card, or raise)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._current: Optional[ModelVersion] = None
        self._history: List[ModelVersion] = []
        self._next_version = 1

    # -- loading -------------------------------------------------------
    def load(self, source: Any, pin_device: bool = True) -> ModelVersion:
        """Resolve a source into a new (inactive) ModelVersion."""
        src, desc, booster = self._resolve(source)
        if not src.models:
            raise ModelLoadError("model has no trees", source=desc)
        with self._lock:
            v = self._next_version
            self._next_version += 1
        mv = ModelVersion(v, src, desc, booster=booster)
        if pin_device:
            mv.pin_device(self.device)
        return mv

    def _resolve(self, source):
        from ..io.model_text import load_model_from_string
        booster = None
        if hasattr(source, "_src"):                 # basic.Booster
            booster = source
            return source._src(), "booster", booster
        if hasattr(source, "models") \
                and hasattr(source, "num_tree_per_iteration"):
            return source, type(source).__name__, None
        if isinstance(source, str):
            if "\n" in source:                      # model text
                try:
                    _check_model_text_integrity(source, "model_str")
                    return (load_model_from_string(source),
                            "model_str", None)
                except ServingError:
                    raise
                except Exception as e:
                    raise ModelLoadError(
                        f"cannot parse model string: {e}") from e
            if not os.path.exists(source):
                raise ModelLoadError(f"model file not found: {source!r}",
                                     path=source)
            _check_sidecar_manifest(source)
            if source.endswith(".npz") or zipfile.is_zipfile(source):
                return _load_npz(source), source, None
            try:
                from ..robustness.retry import read_text, retry_call
                text = retry_call(read_text, source, attempts=3,
                                  base_delay_s=0.05,
                                  desc=f"serving model read {source}")
                _check_model_text_integrity(text, source)
                return load_model_from_string(text), source, None
            except ServingError:
                raise
            except Exception as e:
                raise ModelLoadError(
                    f"cannot load model file {source!r}: {e}",
                    path=source) from e
        raise ModelLoadError(
            f"unsupported model source type {type(source).__name__}")

    # -- activation / checkout -----------------------------------------
    def activate(self, mv: ModelVersion) -> ModelVersion:
        """Atomically make ``mv`` current; the previous version drains
        (device tensors dropped once its in-flight count hits zero)."""
        with self._lock:
            old = self._current
            self._current = mv
            self._history.append(mv)
        if old is not None:
            old.start_draining()
            log_info(f"serving: model v{old.version} -> v{mv.version} "
                     f"({mv.source_desc}, {mv.num_trees} trees, "
                     f"device={'yes' if mv.device_ready else 'no'})")
        return mv

    def current(self) -> Optional[ModelVersion]:
        with self._lock:
            return self._current

    def checkout(self) -> _Checkout:
        """Acquire the current version for one dispatch (refcounted so
        a concurrent hot reload cannot free it mid-flight)."""
        with self._lock:
            mv = self._current
            if mv is None:
                raise ServingError("no model loaded")
            mv.acquire()
        return _Checkout(mv)

    def versions(self) -> List[dict]:
        with self._lock:
            return [mv.describe() for mv in self._history]
