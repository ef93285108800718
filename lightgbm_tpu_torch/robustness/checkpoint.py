"""Atomic versioned training checkpoints with bitwise resume (port of
``lightgbm_tpu/robustness/checkpoint.py``, its single-process layout).

A checkpoint captures everything a boosting run needs to continue *as
if it had never stopped*:

* the model so far (the model text, the JAX writer's format), and each
  tree's bin-space fields that the text does not carry (its inner
  features, bin thresholds, category bitsets and leaf parents), so a
  restored tree walks the bins as the grown one did (DART's re-scored
  drops, rollbacks);
* the score cache (train + every valid set, float32 copied from the
  card without arithmetic) — optional via ``checkpoint_score_cache``;
* every host stream the port advances: the GBDT's ``_feature_rng``,
  the learner's ``_extra_rng`` and ``_bynode_rng``
  (``learner/node_rand.py``), DART's ``_drop_rng`` (the reference LCG:
  its uint32 state) with ``_tree_weight`` and ``_sum_weight``, and
  ``rank_xendcg``'s ``_rng``; the partitioned learner's row order
  (it persists across trees, and a histogram's float64 sums follow it)
  and CEGB's used features and charged rows. Device bagging is a pure
  function of ``(bagging_seed, iteration)`` (``models/gbdt.py:bag_mask``
  collapses an iteration to its ``bagging_freq`` boundary), so the mask
  is not saved: a resume between two draws recomputes the last draw;
* the eval history, replayed into early-stopping / record-evaluation
  callbacks on resume so their closure state matches the uninterrupted
  run;
* fingerprints of the training config and the dataset bin layout, so a
  checkpoint is never resumed against a different experiment.

Write protocol (crash-safe on POSIX): everything lands in a hidden
temp directory first — each file is flushed + fsync'd, the manifest
(with per-file sizes and sha256 digests) is written **last** — then
one ``rename`` publishes the checkpoint and the parent directory is
fsync'd. A reader either sees a complete checkpoint or none; a torn
payload that somehow survives is caught by the manifest digest check
and the loader falls back to the previous retained checkpoint
(``keep-last-K`` retention, ``checkpoint_keep``).

Layout (the JAX package's: the same file names, ``CKPT_FORMAT`` and
manifest keys, so either package's ``validate`` accepts the other's
directory)::

    <checkpoint_dir>/
      ckpt_00000020/
        model.txt        # model text at iteration 20
        state.npz        # score cache + host streams + tree bins
        manifest.json    # written last; sizes+digests of the above

Config: ``checkpoint_dir`` (enables the subsystem), ``checkpoint_freq``
(iterations between periodic checkpoints; preemption always writes a
final one), ``checkpoint_keep``, ``checkpoint_score_cache``,
``resume=auto|off``. A run over more than one rank is refused: its
coordinated two-phase checkpoint is ROADMAP.md Queue 1 item 11.2.
"""

from __future__ import annotations

import hashlib
import io as _io
import json
import os
import shutil
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..utils.log import LightGBMError, log_info, log_warning
from .faults import get_fault_plan
from .retry import read_bytes, read_text, retry_call

CKPT_FORMAT = "lightgbm_tpu.checkpoint.v1"
CKPT_PREFIX = "ckpt_"
_TMP_PREFIX = ".tmp_ckpt_"

MULTI_RANK_REFUSAL = (
    "checkpoint_dir over more than one rank needs the coordinated "
    "two-phase checkpoint (ROADMAP.md Queue 1 item 11.2)")

# params that must NOT invalidate a resume (the JAX package's set)
_FINGERPRINT_EXCLUDE = frozenset({
    "task", "config", "data", "valid", "input_model", "output_model",
    "output_result", "snapshot_freq", "verbosity", "telemetry_out",
    "compile_cache_dir", "convert_model", "convert_model_language",
    "checkpoint_dir", "checkpoint_freq", "checkpoint_keep",
    "checkpoint_score_cache", "resume", "faults", "guard_policy",
    "guard_loss_spike", "guard_max_rollbacks", "num_iterations",
    "num_iteration_predict", "predict_raw_score", "predict_leaf_index",
    "predict_contrib", "predict_disable_shape_check", "pred_early_stop",
    "pred_early_stop_freq", "pred_early_stop_margin",
    "serving_host", "serving_port", "serving_buckets",
    "serving_max_queue", "serving_flush_ms", "serving_timeout_ms",
    "serving_shed_policy", "serving_device", "serving_warmup",
    "serving_replicas", "serving_models", "serving_max_pending",
    "serving_quota_qps", "serving_quota_burst",
    "serving_quota_tenants", "serving_canary_model",
    "serving_canary_weight", "serving_shadow_model",
    "pipeline_mode", "pipeline_source", "pipeline_log_path",
    "pipeline_window_rows", "pipeline_holdout_rows",
    "pipeline_cycles", "pipeline_interval_s", "pipeline_dir",
    "pipeline_canary_stages", "pipeline_stage_requests",
    "pipeline_latency_slo_pct", "pipeline_quality_drop",
    "pipeline_continue_iters", "pipeline_replay_seed",
    "pipeline_replay_noise", "pipeline_serve_http",
    "num_threads",
    "machines", "machine_list_filename", "local_listen_port",
    "time_out",
    "elastic_watchdog", "elastic_heartbeat_ms",
    "elastic_heartbeat_timeout_ms", "elastic_stall_timeout_ms",
    "elastic_abort_grace_ms", "elastic_port", "elastic_resume",
    "elastic_shutdown", "elastic_barrier_s",
})


# ----------------------------------------------------------------------
# atomic file primitives
def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms without directory fds
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write-temp + fsync + rename: ``path`` either keeps its previous
    content or atomically becomes ``data`` — never a torn mix."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".{os.path.basename(path)}.{os.getpid()}.tmp")
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        _fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_text(path: str, text: str) -> None:
    atomic_write_bytes(path, text.encode("utf-8"))


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def config_fingerprint(config) -> str:
    """Digest of every training-relevant parameter (IO/robustness/
    serving knobs excluded): equal fingerprints mean a checkpoint can
    legally continue under this config."""
    params = {k: v for k, v in config.to_params().items()
              if k not in _FINGERPRINT_EXCLUDE}
    payload = json.dumps(params, sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()


def _multi_rank() -> bool:
    from ..parallel.distributed import current_world
    return current_world() is not None


# ----------------------------------------------------------------------
# the host streams and learner state a resume must continue
def _random_states(gbdt) -> Dict[str, np.random.RandomState]:
    """Every ``RandomState`` the port advances during training, by the
    name its state is saved under."""
    out = {"_feature_rng": gbdt._feature_rng}
    nr = getattr(gbdt.learner, "node_rand", None)
    if nr is not None:
        out["_extra_rng"] = nr._extra_rng
        out["_bynode_rng"] = nr._bynode_rng
    rng = getattr(gbdt.objective, "_rng", None)
    if isinstance(rng, np.random.RandomState):
        out["_objective_rng"] = rng
    return out


def _tree_arrays(models) -> Dict[str, np.ndarray]:
    """The bin-space fields of every tree that the model text does not
    carry, concatenated, with each tree's node and leaf counts."""
    nodes = [len(t.threshold_bin) for t in models]
    leaves = [len(t.leaf_parent) for t in models]
    cat = [np.asarray(t.cat_bitsets, np.uint32).reshape(-1) for t in models]

    def cat_i32(parts, dtype):
        return np.concatenate([np.asarray(p, dtype).reshape(-1)
                               for p in parts]) if parts \
            else np.zeros(0, dtype)
    return {
        "tree_nodes": np.asarray(nodes, np.int64),
        "tree_leaves": np.asarray(leaves, np.int64),
        "tree_cat_words": np.asarray([len(c) for c in cat], np.int64),
        "tree_feature_inner": cat_i32(
            [t.split_feature_inner for t in models], np.int32),
        "tree_threshold_bin": cat_i32(
            [t.threshold_bin for t in models], np.int32),
        "tree_leaf_parent": cat_i32(
            [t.leaf_parent for t in models], np.int32),
        "tree_cat_bitsets": cat_i32(cat, np.uint32),
    }


def _rebind_trees(models, z, dataset) -> None:
    """Give trees parsed from the model text their bin-space fields back
    (the saved arrays, then what the dataset's mappers derive from them,
    as ``Tree.__init__`` does for a grown tree)."""
    from ..models.tree import _MISSING_TYPE_CODE
    nodes = z["tree_nodes"]
    if len(nodes) != len(models):
        raise LightGBMError(
            f"checkpoint: {len(nodes)} trees of bin fields for "
            f"{len(models)} trees of model text")
    off = np.concatenate([[0], np.cumsum(nodes)])
    loff = np.concatenate([[0], np.cumsum(z["tree_leaves"])])
    coff = np.concatenate([[0], np.cumsum(z["tree_cat_words"])])
    grp, goff, _ = dataset.bundle_maps()
    for i, t in enumerate(models):
        a, b = int(off[i]), int(off[i + 1])
        sfi = np.asarray(z["tree_feature_inner"][a:b], np.int32)
        t.split_feature_inner = sfi
        t.threshold_bin = np.asarray(z["tree_threshold_bin"][a:b],
                                     np.int32)
        t.leaf_parent = np.asarray(
            z["tree_leaf_parent"][int(loff[i]):int(loff[i + 1])], np.int32)
        t.cat_bitsets = np.asarray(
            z["tree_cat_bitsets"][int(coff[i]):int(coff[i + 1])],
            np.uint32).reshape(max(b - a, 1), -1)
        if t.num_leaves <= 1:
            continue
        mappers = [dataset.feature_mapper(int(f)) for f in sfi]
        t.missing_code = np.asarray(
            [_MISSING_TYPE_CODE[m.missing_type] for m in mappers], np.int32)
        t.num_bin = np.asarray([m.num_bin for m in mappers], np.int32)
        t.default_bin = np.asarray([m.default_bin for m in mappers],
                                   np.int32)
        t.col = np.asarray(grp, np.int32)[sfi]
        t.offset = np.asarray(goff, np.int32)[sfi]


class ResumeInfo(NamedTuple):
    iteration: int
    begin_iteration: int
    eval_history: List
    path: str


class CheckpointManager:
    """Writes, validates, retains and restores training checkpoints."""

    def __init__(self, directory: str, freq: int = 0, keep: int = 3,
                 save_scores: bool = True):
        self.directory = directory
        self.freq = int(freq)
        self.keep = max(int(keep), 1)
        self.save_scores = bool(save_scores)
        self._writes = 0
        self._last_saved: Optional[int] = None

    @classmethod
    def from_config(cls, cfg) -> "CheckpointManager":
        return cls(cfg.checkpoint_dir,
                   freq=int(getattr(cfg, "checkpoint_freq", 0)),
                   keep=int(getattr(cfg, "checkpoint_keep", 3)),
                   save_scores=bool(getattr(cfg,
                                            "checkpoint_score_cache",
                                            True)))

    # -- listing -------------------------------------------------------
    def checkpoints(self) -> List[Tuple[int, str]]:
        """[(iteration, path)] sorted ascending by iteration."""
        if not os.path.isdir(self.directory):
            return []
        out = []
        for name in os.listdir(self.directory):
            if not name.startswith(CKPT_PREFIX):
                continue
            try:
                it = int(name[len(CKPT_PREFIX):])
            except ValueError:
                continue
            out.append((it, os.path.join(self.directory, name)))
        return sorted(out)

    def has_checkpoint(self) -> bool:
        return bool(self.checkpoints())

    # -- writing -------------------------------------------------------
    def maybe_save(self, booster, eval_history: List,
                   begin_iteration: int) -> Optional[str]:
        """Periodic save at the ``checkpoint_freq`` cadence; call at
        iteration boundaries (after eval)."""
        it = booster._gbdt.iter
        if self.freq <= 0 or it <= 0 or it % self.freq != 0:
            return None
        return self.save(booster, eval_history, begin_iteration)

    def save(self, booster, eval_history: List,
             begin_iteration: int) -> Optional[str]:
        """Write one checkpoint for the booster's current state.
        Idempotent per iteration (a preemption right after a periodic
        save does not write twice)."""
        gbdt = booster._gbdt
        it = int(gbdt.iter)
        if self._last_saved == it:
            return None
        from ..observability.telemetry import get_telemetry
        tel = get_telemetry()
        with tel.span("checkpoint.write"):
            path = self._write(booster, it, eval_history,
                               begin_iteration)
        self._last_saved = it
        self._retain()
        return path

    def _write(self, booster, it: int, eval_history: List,
               begin_iteration: int) -> str:
        if _multi_rank():
            raise NotImplementedError(MULTI_RANK_REFUSAL)
        gbdt = booster._gbdt
        os.makedirs(self.directory, exist_ok=True)
        self._cleanup_tmp()
        from ..io.model_text import save_model_to_string
        model_text = save_model_to_string(gbdt)
        state_bytes = self._state_npz_bytes(gbdt)

        name = f"{CKPT_PREFIX}{it:08d}"
        final = os.path.join(self.directory, name)
        tmp = os.path.join(self.directory,
                           f"{_TMP_PREFIX}{it:08d}_{os.getpid()}")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            files: Dict[str, Dict[str, Any]] = {}
            payloads = {"model.txt": model_text.encode("utf-8"),
                        "state.npz": state_bytes}
            for fname, data in payloads.items():
                with open(os.path.join(tmp, fname), "wb") as fh:
                    fh.write(data)
                    fh.flush()
                    os.fsync(fh.fileno())
                files[fname] = {"bytes": len(data),
                                "sha256": _digest(data)}

            self._writes += 1
            plan = get_fault_plan()
            if plan is not None and plan.take(
                    "torn_checkpoint", nth=self._writes) is not None:
                # simulate a torn write that still got published: the
                # manifest keeps the pre-truncation digests, so the
                # validator MUST reject this checkpoint later
                victim = os.path.join(tmp, "state.npz")
                with open(victim, "r+b") as fh:
                    fh.truncate(max(len(state_bytes) // 2, 1))

            manifest = {
                "format": CKPT_FORMAT,
                "iteration": it,
                "begin_iteration": int(begin_iteration),
                "num_models": len(gbdt.models),
                "num_tree_per_iteration": gbdt.num_tree_per_iteration,
                "num_valid_sets": len(gbdt.valid_scores),
                "shrinkage_rate": float(gbdt.shrinkage_rate),
                "score_cache": self.save_scores,
                "config_fingerprint": config_fingerprint(gbdt.config),
                "data_fingerprint":
                    gbdt.train_data.bin_layout_fingerprint(),
                "eval_history": eval_history,
                "files": files,
            }
            mbytes = json.dumps(manifest, default=float).encode("utf-8")
            with open(os.path.join(tmp, "manifest.json"), "wb") as fh:
                fh.write(mbytes)
                fh.flush()
                os.fsync(fh.fileno())

            if os.path.isdir(final):  # pre-rollback leftover: replace
                shutil.rmtree(final)
            os.rename(tmp, final)
            _fsync_dir(self.directory)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        from ..observability.telemetry import get_telemetry
        tel = get_telemetry()
        tel.count("checkpoint.writes")
        tel.count("checkpoint.bytes",
                  sum(f["bytes"] for f in files.values()) + len(mbytes))
        log_info(f"checkpoint: wrote iteration {it} -> {final}")
        return final

    def _state_npz_bytes(self, gbdt) -> bytes:
        arrays: Dict[str, np.ndarray] = {}
        if self.save_scores:
            # float32 copied from the device, no arithmetic
            arrays["train_score"] = gbdt.train_score.cpu().numpy()
            for i, vs in enumerate(gbdt.valid_scores):
                arrays[f"valid_score_{i}"] = vs.cpu().numpy()
        for attr, rng in _random_states(gbdt).items():
            name, keys, pos, has_gauss, cached = rng.get_state()
            arrays[f"rng{attr}_keys"] = np.asarray(keys, np.uint32)
            arrays[f"rng{attr}_meta"] = np.asarray([pos, has_gauss],
                                                   np.int64)
            arrays[f"rng{attr}_cached"] = np.asarray([cached], np.float64)
        drop = getattr(gbdt, "_drop_rng", None)
        if drop is not None:
            arrays["dart_drop_rng"] = np.asarray([drop.x], np.uint32)
            arrays["dart_tree_weight"] = np.asarray(gbdt._tree_weight,
                                                    np.float64)
            arrays["dart_sum_weight"] = np.asarray([gbdt._sum_weight],
                                                   np.float64)
        for key, val in gbdt.learner.checkpoint_arrays().items():
            arrays[f"learner_{key}"] = val
        arrays.update(_tree_arrays(gbdt.models))
        buf = _io.BytesIO()
        np.savez(buf, **arrays)
        return buf.getvalue()

    def _cleanup_tmp(self) -> None:
        """Drop temp dirs left by crashed writers (best effort)."""
        try:
            for name in os.listdir(self.directory):
                if name.startswith(_TMP_PREFIX):
                    shutil.rmtree(os.path.join(self.directory, name),
                                  ignore_errors=True)
        except OSError:
            pass

    def _retain(self) -> None:
        ckpts = self.checkpoints()
        for it, path in ckpts[:-self.keep]:
            shutil.rmtree(path, ignore_errors=True)

    # -- validation / restore ------------------------------------------
    def validate(self, path: str) -> Optional[Dict[str, Any]]:
        """Parse + verify one checkpoint dir; returns the manifest when
        every payload matches its recorded size and sha256."""
        try:
            mtext = retry_call(read_text,
                               os.path.join(path, "manifest.json"),
                               attempts=3, base_delay_s=0.05,
                               desc=f"checkpoint manifest {path}")
            manifest = json.loads(mtext)
            if manifest.get("format") != CKPT_FORMAT:
                log_warning(f"checkpoint: {path} has unknown format "
                            f"{manifest.get('format')!r}")
                return None
            if manifest.get("world"):
                # a coordinated (multi-rank) checkpoint: item 11.2
                log_warning(f"checkpoint: {path} is a coordinated "
                            "multi-rank checkpoint (ROADMAP.md Queue 1 "
                            "item 11.2)")
                return None
            for fname, info in manifest.get("files", {}).items():
                data = retry_call(read_bytes,
                                  os.path.join(path, fname),
                                  attempts=3, base_delay_s=0.05,
                                  desc=f"checkpoint file {fname}")
                if len(data) != int(info["bytes"]) \
                        or _digest(data) != info["sha256"]:
                    log_warning(
                        f"checkpoint: {path}/{fname} is torn "
                        f"({len(data)} bytes vs recorded "
                        f"{info['bytes']}; digest mismatch)")
                    return None
            return manifest
        except (OSError, ValueError, KeyError, json.JSONDecodeError) \
                as e:
            log_warning(f"checkpoint: cannot validate {path}: {e}")
            return None

    def latest_valid(self) -> Optional[Tuple[str, Dict[str, Any]]]:
        """Newest checkpoint that passes validation; invalid ones fall
        back to the previous retained checkpoint (counted + warned)."""
        from ..observability.telemetry import get_telemetry
        for it, path in reversed(self.checkpoints()):
            manifest = self.validate(path)
            if manifest is not None:
                return path, manifest
            get_telemetry().count("checkpoint.fallbacks")
            log_warning(f"checkpoint: {path} failed validation; "
                        "falling back to the previous checkpoint")
        return None

    def restore_latest(self, booster) -> Optional[ResumeInfo]:
        """Restore the newest valid, fingerprint-matching checkpoint
        into the booster. Returns None (with a warning) when nothing
        valid/compatible exists — callers then start fresh."""
        if _multi_rank():
            raise NotImplementedError(MULTI_RANK_REFUSAL)
        found = self.latest_valid()
        if found is None:
            return None
        path, manifest = found
        gbdt = booster._gbdt
        cfg_fp = config_fingerprint(gbdt.config)
        if manifest.get("config_fingerprint") != cfg_fp:
            log_warning(
                "checkpoint: config fingerprint mismatch (training "
                "parameters changed since the checkpoint was written); "
                f"ignoring {path}")
            return None
        data_fp = gbdt.train_data.bin_layout_fingerprint()
        if manifest.get("data_fingerprint") != data_fp:
            log_warning(
                "checkpoint: dataset bin-layout fingerprint mismatch "
                f"(different data/binning); ignoring {path}")
            return None
        if int(manifest.get("num_valid_sets", 0)) \
                != len(gbdt.valid_scores):
            log_warning(
                "checkpoint: validation-set count changed since the "
                f"checkpoint was written; ignoring {path}")
            return None
        self._apply(booster, path, manifest)
        from ..observability.telemetry import get_telemetry
        get_telemetry().count("checkpoint.restores")
        log_info(f"checkpoint: restored iteration "
                 f"{manifest['iteration']} from {path}")
        return ResumeInfo(int(manifest["iteration"]),
                          int(manifest.get("begin_iteration", 0)),
                          manifest.get("eval_history") or [], path)

    def _apply(self, booster, path: str,
               manifest: Dict[str, Any]) -> None:
        import torch
        gbdt = booster._gbdt
        from ..io.model_text import load_model_from_string
        loaded = load_model_from_string(
            read_text(os.path.join(path, "model.txt")))
        if loaded.num_tree_per_iteration \
                != gbdt.num_tree_per_iteration:
            raise LightGBMError(
                "checkpoint model has "
                f"{loaded.num_tree_per_iteration} trees/iteration; "
                f"booster expects {gbdt.num_tree_per_iteration}")
        models = list(loaded.models)
        with np.load(_io.BytesIO(
                read_bytes(os.path.join(path, "state.npz"))),
                allow_pickle=False) as z:
            names = set(z.files)
            _rebind_trees(models, z, gbdt.train_data)
            gbdt.models = models
            gbdt.iter = int(manifest["iteration"])
            gbdt.shrinkage_rate = float(
                manifest.get("shrinkage_rate", gbdt.shrinkage_rate))
            dev = gbdt.device
            if "train_score" in names:
                gbdt.train_score = torch.from_numpy(
                    z["train_score"].copy()).to(dev)
                for i in range(len(gbdt.valid_scores)):
                    gbdt.valid_scores[i] = torch.from_numpy(
                        z[f"valid_score_{i}"].copy()).to(dev)
            else:
                self._recompute_scores(booster)
            # the draw of the iteration's bagging_freq boundary is
            # recomputed from (seed, iteration) at the next iteration
            gbdt.bag_weight = None
            for attr, rng in _random_states(gbdt).items():
                if f"rng{attr}_keys" not in names:
                    continue
                meta = z[f"rng{attr}_meta"]
                rng.set_state((
                    "MT19937", np.asarray(z[f"rng{attr}_keys"], np.uint32),
                    int(meta[0]), int(meta[1]),
                    float(z[f"rng{attr}_cached"][0])))
            if "dart_drop_rng" in names:
                gbdt._drop_rng.x = int(z["dart_drop_rng"][0])
                gbdt._tree_weight = [float(v)
                                     for v in z["dart_tree_weight"]]
                gbdt._sum_weight = float(z["dart_sum_weight"][0])
            gbdt.learner.restore_arrays(
                {n[len("learner_"):]: z[n] for n in names
                 if n.startswith("learner_")})

    def _recompute_scores(self, booster) -> None:
        """Score-cache-less restore: rebuild the score buffers by
        predicting every checkpointed tree over the raw feature matrices
        (the port's predictor: float64 sums rounded to float32, as a
        continued training's seed) — NOT guaranteed bitwise to the
        device-accumulated cache; prefer ``checkpoint_score_cache=true``
        (the default) when exact resume matters."""
        import torch
        from ..predictor import predict_raw
        log_warning(
            "checkpoint: score cache absent; recomputing scores from "
            "the raw data (resume is approximate, not bitwise)")
        gbdt = booster._gbdt
        k = gbdt.num_tree_per_iteration

        def rebuilt(score0, ds):
            X = ds.raw_matrix(booster.config)
            add = predict_raw(gbdt.models, X, gbdt.device, k)
            return score0 + torch.as_tensor(add).to(
                gbdt.device, torch.float32).reshape(score0.shape[0], -1)

        n, nv = gbdt.num_data, [vs.shape[0] for vs in gbdt.valid_scores]
        zero = torch.zeros((n, k), dtype=torch.float32, device=gbdt.device)
        init = gbdt.train_data.metadata.init_score
        if init is not None:
            from ..models.gbdt import init_score_matrix
            zero = torch.as_tensor(init_score_matrix(init, n, k),
                                   dtype=torch.float32, device=gbdt.device)
        gbdt.train_score = rebuilt(zero, booster.train_set)
        for i, vd in enumerate(booster.valid_sets):
            v0 = torch.zeros((nv[i], k), dtype=torch.float32,
                             device=gbdt.device)
            vinit = gbdt.valid_sets[i].metadata.init_score
            if vinit is not None:
                from ..models.gbdt import init_score_matrix
                v0 = torch.as_tensor(init_score_matrix(vinit, nv[i], k),
                                     dtype=torch.float32,
                                     device=gbdt.device)
            gbdt.valid_scores[i] = rebuilt(v0, vd)
