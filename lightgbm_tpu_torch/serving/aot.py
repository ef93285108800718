"""Published predict artifacts: a model text's pinned stack, built once
by the publisher (port of ``lightgbm_tpu/serving/aot.py``).

The JAX package's artifact carries the bin mappers and serialised XLA
executables of its leaf-index scan over *binned* rows, so a process that
parsed only the model text can run the device route with zero compiles.
The port walks raw float64 features and needs no bin mappers: its
bundle holds the stacked node arrays (``predictor.stack_trees``) and the
float64 leaf values, bound to the published text by its sha256. A
serving engine that loads the text with the artifact takes the stack
from the bundle instead of restacking the parsed trees, then captures
its per-bucket programs over it (``serving/programs.py``); the CUDA
graph capture is the port's counterpart of the AOT compile, and it
happens in the serving process (a graph cannot be serialised).

:meth:`AotPredict.predict_raw` is the walk's leaf indices plus an
in-order float64 add of the leaf values: bit-identical to the host
prediction of the same model text, the pipeline's promotion parity
standard.

Scope cuts, with the JAX package's words: linear-leaf forests, and
donors whose trees were not grown on a dataset (text-loaded models,
refit candidates of a text model), raise :class:`AotUnavailable`.
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.log import log_info, log_warning
from .errors import ModelLoadError

AOT_FORMAT = "lightgbm_tpu_torch.serving.aot.v1"

# stack_trees' tensors saved in the bundle (``is_cat`` / ``words`` too
# when a node is categorical)
_STACK_FIELDS = ("feat", "thr", "dleft", "miss", "left", "right", "leaf",
                 "single")


class AotUnavailable(Exception):
    """The model/dataset shape cannot be served via an AOT artifact;
    callers serve without one (never a publish failure)."""


def text_sha(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def publish_text(source) -> str:
    """Normalize a ``load_model`` source into the model text a serving
    process will parse — the string the artifact's sha256 binds to."""
    if isinstance(source, str):
        if "\n" in source:
            return source
        with open(source, "r") as f:
            return f.read()
    if hasattr(source, "model_to_string"):
        return source.model_to_string()
    raise AotUnavailable(
        f"cannot derive model text from source type "
        f"{type(source).__name__}")


def _resolve_donor(donor):
    """The dataset-backed GBDT behind a donor handle (basic.Booster via
    ``_src()``, or a GBDT/LoadedBooster directly)."""
    if hasattr(donor, "_src"):
        return donor._src()
    if hasattr(donor, "models") and hasattr(donor,
                                            "num_tree_per_iteration"):
        return donor
    raise AotUnavailable(
        f"donor type {type(donor).__name__} is not a booster")


def artifact_dir(config=None) -> str:
    """``<build dir>/aot``: beside the kernel library, under
    ``compile_cache_dir`` when the config names one."""
    from ..ops import _native
    if config is not None:
        _native.maybe_enable_compile_cache(config)
    path = os.path.join(_native.build_dir(), "aot")
    os.makedirs(path, exist_ok=True)
    return path


def build_artifact(donor, model_text: str,
                   buckets: Sequence[int] = (),
                   out_dir: Optional[str] = None,
                   config=None, device=None) -> str:
    """Build the predict artifact for ``model_text``.

    ``donor`` supplies the finalized trees, grown on its dataset;
    ``model_text`` is what the serving process will actually parse, so
    when the two are distinct objects the donor's own serialization must
    hash identically — a mismatch would ship an artifact for a different
    model than the text being promoted.

    The bundle is read back through :func:`load_artifact` onto
    ``device`` (None: the card, or raise) and walked once a bucket there
    (:meth:`AotPredict.warm`; the JAX package compiles each bucket's
    program at this point). Returns the artifact
    path (``<out_dir>/<sha16>.npz``). Raises :class:`AotUnavailable`
    for unsupported shapes and :class:`ModelLoadError` for donor/text
    disagreement.
    """
    from ..predictor import stack_trees

    src = _resolve_donor(donor)
    if getattr(src, "train_data", None) is None:
        raise AotUnavailable("donor has no dataset (text-loaded?)")
    if not src.models:
        raise AotUnavailable("donor has no trees")
    if any(m.num_leaves > 1 and not getattr(m, "has_bins", False)
           for m in src.models):
        # refit candidates deep-copy text-parsed trees, never grown on
        # the window dataset's bins
        raise AotUnavailable(
            "donor trees carry no binned representation (text-loaded "
            "or refit structures); host route")
    if any(getattr(m, "is_linear", False) for m in src.models):
        raise AotUnavailable("linear-leaf forests serve host-route")
    sha = text_sha(model_text)
    if donor is not model_text and hasattr(donor, "model_to_string"):
        if text_sha(donor.model_to_string()) != sha:
            raise ModelLoadError(
                "AOT donor booster does not serialize to the model "
                "text being published; refusing to ship a mismatched "
                "artifact")

    k = int(src.num_tree_per_iteration)
    st = stack_trees(src.models, "cpu")
    t = st["feat"].shape[0]
    out_dir = out_dir or artifact_dir(config)
    path = os.path.join(out_dir, f"{sha[:16]}.npz")
    payload = {
        "format": np.asarray(AOT_FORMAT),
        "model_sha": np.asarray(sha),
        "k": np.asarray(k),
        "num_trees": np.asarray(t),
        "average_output": np.asarray(
            bool(getattr(src, "average_output", False))),
        "num_total_features": np.asarray(
            int(src.train_data.num_total_features)),
        "depth": np.asarray(int(st["depth"])),
        "buckets": np.asarray([int(b) for b in buckets], np.int64),
    }
    fields = _STACK_FIELDS + (("is_cat", "words")
                              if st["words"] is not None else ())
    for f in fields:
        payload["st_" + f] = st[f].numpy()
    tmp = path + f".tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, **payload)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass

    # round-trip through the serving process's own load path: a torn or
    # buggy bundle rejects the publish here instead of poisoning it
    art = load_artifact(path, expected_sha=sha, device=device)
    n = art.warm(buckets)
    log_info(f"serving aot: artifact {os.path.basename(path)} "
             f"({t} trees, k={k}) walked {n} bucket(s) on {art.device}")
    return path


def maybe_build_artifact(donor, source, buckets: Sequence[int],
                         config=None, device=None) -> Optional[str]:
    """Publish-facing convenience: build the artifact, or return None
    (serve without one) when the shape is unsupported or the build
    fails — artifact loss must never fail a model publish."""
    if donor is None:
        return None
    try:
        text = publish_text(source)
        return build_artifact(donor, text, buckets=buckets,
                              config=config, device=device)
    except AotUnavailable as e:
        log_info(f"serving aot: artifact unavailable ({e}); serving "
                 "without one")
        return None
    except ModelLoadError:
        raise
    except Exception as e:
        log_warning(f"serving aot: artifact build failed ({e}); "
                    "serving without one")
        return None


def load_artifact(path: str, expected_sha: Optional[str] = None,
                  device=None) -> "AotPredict":
    """Load an artifact bundle onto ``device`` (None: the card, or
    raise) as an :class:`AotPredict`.

    ``expected_sha`` binds the artifact to the model text being loaded
    alongside it (sha256); a mismatch is a publish-pipeline bug and
    raises. Torn/unreadable bundles raise :class:`ModelLoadError`.
    """
    dev = resolve_device(device)
    try:
        with np.load(path, allow_pickle=False) as z:
            fmt = str(z["format"])
            if fmt != AOT_FORMAT:
                raise ModelLoadError(
                    f"AOT artifact {path!r} has format {fmt!r}; "
                    f"expected {AOT_FORMAT!r}", path=path)
            sha = str(z["model_sha"])
            if expected_sha is not None and sha != expected_sha:
                raise ModelLoadError(
                    f"AOT artifact {path!r} was built for a different "
                    f"model text (sha {sha[:12]} != "
                    f"{expected_sha[:12]})", path=path)
            stacked = {f[3:]: torch.as_tensor(np.asarray(z[f]),
                                              device=dev)
                       for f in z.files if f.startswith("st_")}
            stacked.setdefault("words", None)
            stacked.update(depth=int(z["depth"]), linear={})
            return AotPredict(
                stacked, k=int(z["k"]),
                average_output=bool(z["average_output"]),
                num_total_features=int(z["num_total_features"]),
                model_sha=sha,
                buckets=tuple(int(b) for b in z["buckets"]),
                path=path)
    except ModelLoadError:
        raise
    except (zipfile.BadZipFile, KeyError, ValueError, OSError) as e:
        raise ModelLoadError(
            f"AOT artifact {path!r} is torn or unreadable: {e}",
            path=path) from e


class AotPredict:
    """A stack rebuilt from an artifact bundle on one device: the raw
    float64 walk's leaf indices and the in-order float64 add of the
    leaf values, bit-identical to the host route."""

    def __init__(self, stacked, k, average_output, num_total_features,
                 model_sha, buckets, path):
        self.stacked = stacked
        self.device = stacked["feat"].device
        self.k = self.num_tree_per_iteration = int(k)
        self.average_output = bool(average_output)
        self.num_total_features = int(num_total_features)
        self.model_sha = model_sha
        self.buckets = tuple(buckets)
        self.path = path
        self.num_trees = int(stacked["feat"].shape[0])

    def nbytes(self) -> int:
        return int(sum(v.numel() * v.element_size()
                       for v in self.stacked.values()
                       if isinstance(v, torch.Tensor)))

    def warm(self, buckets: Sequence[int] = ()) -> int:
        """Walk zero rows once a bucket on the artifact's device; returns
        the number of buckets walked."""
        want = sorted({int(b) for b in (tuple(buckets) or self.buckets)
                       if int(b) > 0})
        for b in want:
            self.leaf_idx(np.zeros((b, self.num_total_features)))
        return len(want)

    def _rows(self, data) -> torch.Tensor:
        """The rows on the device, padded to their power-of-two bucket
        (``predictor.bucket_rows``) as the JAX artifact pads them."""
        from ..predictor import bucket_rows
        data = np.asarray(data, np.float64)
        b = bucket_rows(len(data))
        if b > len(data):
            data = np.concatenate(
                [data, np.zeros((b - len(data), data.shape[1]))])
        return torch.as_tensor(data, device=self.device)

    def leaf_idx(self, data: np.ndarray) -> np.ndarray:
        """[N, T] leaf index per row per tree via the device walk —
        exactly ``Tree.predict_leaf_index`` per tree."""
        from ..predictor import predict_leaf_index
        n = len(data)
        if n == 0:
            return np.zeros((0, self.num_trees), np.int64)
        idx = predict_leaf_index(self.stacked, self._rows(data))
        return idx.T[:n].cpu().numpy()

    def predict_raw(self, data: np.ndarray) -> np.ndarray:
        """Raw scores, bit-identical to the host float64 loop: the
        device walk's leaves, then one float64 add a tree in tree order
        (pairwise/vectorized summation is NOT bit-identical to
        sequential +=)."""
        from ..predictor import serve_rows
        n = len(data)
        raw = serve_rows(self, self.stacked, self._rows(data),
                         "raw_score")
        return raw[:n].cpu().numpy()

    def describe(self) -> dict:
        return {"path": self.path, "model_sha": self.model_sha[:16],
                "num_trees": self.num_trees, "k": self.k,
                "buckets": list(self.buckets),
                "nbytes": self.nbytes()}
