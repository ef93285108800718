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
``resume=auto|off``.

**Coordinated (multi-rank) checkpoints** (JAX ``checkpoint.py:43-70``).
A run over ranks (the manager's ``world``, set by the engine when the
learner spans a group) commits in two phases over the shared directory::

    <checkpoint_dir>/
      ckpt_00000020/
        model.txt          # rank 0 (the trees are the same on every rank)
        shard_00000.npz    # rank r's state: its score rows with their
        shard_00001.npz    #   global row ranges, row order, streams, bins
        done_00000.json    # rank r's fsync receipt (size + sha256)
        done_00001.json
        manifest.json      # rank 0, after every done marker: + world
        COMMIT.json        # rank 0, after the directory's rename

Phase 1: every rank fsyncs its shard, then its ``done`` marker (the
markers are the barrier: no socket and no collective in the checkpoint
path). Phase 2: rank 0 waits for every marker whose digest matches its
shard (bounded by ``elastic_barrier_s``; a timeout abandons the
version, never commits it from fewer ranks), writes the manifest with a
``world`` section (size, machine list, each rank's bin-layout
fingerprint), renames the temporary directory into place, and only then
writes ``COMMIT.json``. A coordinated version without its marker is torn:
validation skips it and rank 0 prunes it, so a resume takes the newest
version with a full quorum. The score rows are raw float32 with their
global ranges, so a resume on any world size (``elastic_resume``, the
N -> M reshard) reassembles the same bytes; a world of another size
cannot take a rank's row order (the partitioned learner's), so a
reshard starts each rank from its rows' natural order and is bitwise by
construction only for the learners whose histograms do not follow it
(the ``leaf_id`` layout: the data learner past 255 bins and the feature
learner). A world-size mismatch without ``elastic_resume`` is a
structured error naming both sides.
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
# a coordinated checkpoint's phase-2 marker: its presence is the full
# quorum (rank 0 writes it after every shard's receipt and the rename)
COMMIT_MARKER = "COMMIT.json"

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


def _rank_rows(gbdt) -> Tuple[int, int]:
    """(the run's rows, the global row of this process's first score
    row): a ``pre_partition`` rank holds its own rows, at the learner's
    global offset; any other process holds every row."""
    lrn = gbdt.learner
    if getattr(lrn, "local_data", False):
        return int(lrn.global_num_data), int(lrn.global_row_lo)
    return int(gbdt.num_data), 0


def _written_rows(num_rows: int, base: int, local: int, world
                  ) -> Tuple[int, int]:
    """Global [lo, hi) of the score rows rank ``world.rank`` writes: its
    own rows (``pre_partition``), else its equal block of every row
    (``parallel/ingest.py:shard_bounds``), so the shards cover the run's
    rows once."""
    if local != num_rows:
        return base, base + local
    from ..parallel.ingest import shard_bounds
    return shard_bounds(num_rows, world.rank, world.size)


def _pack_blocked(arrays: Dict[str, np.ndarray], key: str, full_rows: int,
                  lo: int, block: np.ndarray) -> None:
    """``block`` (the rows [lo, lo + len) of a [full_rows, ...] array)
    under ``key`` with the array's shape and its row range (JAX
    ``_pack_blocked``)."""
    arrays[f"{key}_shape"] = np.asarray((full_rows,) + block.shape[1:],
                                        np.int64)
    arrays[f"{key}_ranges"] = np.asarray([[lo, lo + block.shape[0]]],
                                         np.int64)
    arrays[f"{key}_block_0"] = block


def _reassemble_blocked(shards: List[Any], key: str) -> Optional[np.ndarray]:
    """The whole array ``key`` from every shard's row ranges: raw
    float32, no arithmetic, so the same bytes whatever world wrote it
    (JAX ``_reassemble_blocked``). None when no shard carries it; raises
    when the shards leave rows uncovered."""
    shape = None
    for z in shards:
        if f"{key}_shape" in z.files:
            shape = tuple(int(v) for v in z[f"{key}_shape"])
            break
    if shape is None:
        return None
    full = np.zeros(shape, np.float32)
    filled = np.zeros(shape[0], bool)
    for z in shards:
        if f"{key}_ranges" not in z.files:
            continue
        for j, (a, b) in enumerate(np.asarray(z[f"{key}_ranges"],
                                              np.int64)):
            full[int(a):int(b)] = z[f"{key}_block_{j}"]
            filled[int(a):int(b)] = True
    if not filled.all():
        raise LightGBMError(
            f"coordinated checkpoint: {key} row coverage incomplete "
            f"({int((~filled).sum())} of {shape[0]} rows missing across "
            f"{len(shards)} shards)")
    return full


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
                 save_scores: bool = True, world=None,
                 barrier_s: float = 120.0):
        self.directory = directory
        self.freq = int(freq)
        self.keep = max(int(keep), 1)
        self.save_scores = bool(save_scores)
        # the run's WorldInfo over ranks (the coordinated protocol), or
        # None for one process
        self.world = world
        self.barrier_s = float(barrier_s)
        self._writes = 0
        self._last_saved: Optional[int] = None

    @classmethod
    def from_config(cls, cfg, world=None) -> "CheckpointManager":
        return cls(cfg.checkpoint_dir,
                   freq=int(getattr(cfg, "checkpoint_freq", 0)),
                   keep=int(getattr(cfg, "checkpoint_keep", 3)),
                   save_scores=bool(getattr(cfg,
                                            "checkpoint_score_cache",
                                            True)),
                   world=world,
                   barrier_s=float(getattr(cfg, "elastic_barrier_s", 120.0)))

    def _leader(self) -> bool:
        """Retention, pruning and temporary-directory cleanup are rank
        0's alone (one process: itself)."""
        return self.world is None or self.world.rank == 0

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
        if self._leader():
            self._retain()
        return path

    def _write(self, booster, it: int, eval_history: List,
               begin_iteration: int) -> Optional[str]:
        if self.world is not None:
            return self._write_coordinated(booster, it, eval_history,
                                           begin_iteration, self.world)
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

            manifest = self._manifest(gbdt, it, begin_iteration,
                                      eval_history, files)
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

    # -- coordinated (multi-rank) writing ------------------------------
    def _write_coordinated(self, booster, it: int, eval_history: List,
                           begin_iteration: int, world) -> Optional[str]:
        """The two-phase commit over the shared directory (the module
        docstring; JAX ``_write_coordinated``): every rank's shard and
        receipt, then rank 0's manifest, rename and commit marker.
        Returns the committed path, or None where this version was
        abandoned (a quorum or commit timeout: training goes on)."""
        import time
        gbdt = booster._gbdt
        os.makedirs(self.directory, exist_ok=True)
        final = os.path.join(self.directory, f"{CKPT_PREFIX}{it:08d}")
        # one temporary directory a version, the same name on every rank
        tmp = os.path.join(self.directory, f"{_TMP_PREFIX}{it:08d}")
        os.makedirs(tmp, exist_ok=True)
        from ..observability.telemetry import get_telemetry
        tel = get_telemetry()

        def put(fname: str, data: bytes) -> Dict[str, Any]:
            with open(os.path.join(tmp, fname), "wb") as fh:
                fh.write(data)
                fh.flush()
                os.fsync(fh.fileno())
            return {"bytes": len(data), "sha256": _digest(data)}

        # phase 1 (every rank): the shard, then its receipt. A stale
        # receipt of a crashed attempt is harmless: rank 0 takes only a
        # receipt whose digest matches the shard on disk
        shard_name = f"shard_{world.rank:05d}.npz"
        info = put(shard_name, self._shard_npz_bytes(gbdt, world))
        fp = gbdt.train_data.bin_layout_fingerprint()
        put(f"done_{world.rank:05d}.json", json.dumps({
            "rank": world.rank, "file": shard_name, **info,
            "data_fingerprint": fp}).encode("utf-8"))
        _fsync_dir(tmp)
        if world.rank != 0:
            # wait for rank 0's phase 2; a timeout abandons this version
            # (never committed, so the validator skips it)
            deadline = time.monotonic() + self.barrier_s
            commit = os.path.join(final, COMMIT_MARKER)
            while time.monotonic() < deadline:
                if os.path.exists(commit):
                    return final
                time.sleep(0.02)
            tel.count("elastic.barrier_timeouts")
            log_warning(
                f"checkpoint: rank {world.rank} timed out after "
                f"{self.barrier_s:.0f}s waiting for the iteration-{it} "
                "commit marker; continuing without this checkpoint")
            return None

        # phase 2 (rank 0): the model text, the quorum, the manifest
        files: Dict[str, Dict[str, Any]] = {shard_name: info}
        from ..io.model_text import save_model_to_string
        files["model.txt"] = put(
            "model.txt", save_model_to_string(gbdt).encode("utf-8"))
        fingerprints = {"0": fp}
        deadline = time.monotonic() + self.barrier_s
        while len(fingerprints) < world.size:
            for r in range(1, world.size):
                if str(r) in fingerprints:
                    continue
                mpath = os.path.join(tmp, f"done_{r:05d}.json")
                if not os.path.exists(mpath):
                    continue
                try:
                    marker = json.loads(read_text(mpath))
                    data = read_bytes(os.path.join(tmp, marker["file"]))
                except (OSError, ValueError, KeyError):
                    continue  # mid-write: poll again
                if _digest(data) != marker.get("sha256"):
                    continue  # a stale receipt against a fresh shard
                files[marker["file"]] = {"bytes": marker["bytes"],
                                         "sha256": marker["sha256"]}
                fingerprints[str(r)] = marker.get("data_fingerprint", "")
            if len(fingerprints) < world.size:
                if time.monotonic() > deadline:
                    tel.count("elastic.barrier_timeouts")
                    log_warning(
                        f"checkpoint: quorum timeout at iteration {it}: "
                        f"{len(fingerprints)}/{world.size} ranks fsync'd "
                        f"within {self.barrier_s:.0f}s; abandoning this "
                        "checkpoint (not committed)")
                    return None
                time.sleep(0.02)
        manifest = dict(self._manifest(gbdt, it, begin_iteration,
                                       eval_history, files),
                        world={"size": world.size,
                               "machines": self._machine_strings(
                                   gbdt.config),
                               "data_fingerprints": fingerprints})
        put("manifest.json", json.dumps(manifest,
                                        default=float).encode("utf-8"))
        if os.path.isdir(final):  # a pre-rollback or torn leftover
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(self.directory)
        # the commit marker last: a rename without it is torn
        atomic_write_text(os.path.join(final, COMMIT_MARKER),
                          json.dumps({"iteration": it,
                                      "world_size": world.size}))
        tel.count("checkpoint.writes")
        tel.count("checkpoint.coordinated_writes")
        tel.count("checkpoint.bytes",
                  sum(f["bytes"] for f in files.values()))
        log_info(f"checkpoint: committed coordinated iteration {it} "
                 f"({world.size} ranks) -> {final}")
        return final

    def _manifest(self, gbdt, it: int, begin_iteration: int,
                  eval_history: List, files: Dict[str, Any]
                  ) -> Dict[str, Any]:
        return {
            "format": CKPT_FORMAT,
            "iteration": it,
            "begin_iteration": int(begin_iteration),
            "num_models": len(gbdt.models),
            "num_tree_per_iteration": gbdt.num_tree_per_iteration,
            "num_valid_sets": len(gbdt.valid_scores),
            "shrinkage_rate": float(gbdt.shrinkage_rate),
            "score_cache": self.save_scores,
            "config_fingerprint": config_fingerprint(gbdt.config),
            "data_fingerprint": gbdt.train_data.bin_layout_fingerprint(),
            "eval_history": eval_history,
            "files": files,
        }

    @staticmethod
    def _machine_strings(config) -> List[str]:
        from ..parallel.distributed import parse_machines
        try:
            return [f"{h}:{p}" for h, p in parse_machines(config)]
        except (OSError, ValueError):
            return []

    def _shard_npz_bytes(self, gbdt, world) -> bytes:
        """Rank ``world.rank``'s shard (JAX ``_shard_npz_bytes``): its
        score rows with their global ranges (raw float32), and every
        other array of the single process's ``state.npz`` (the streams,
        the learner's arrays, the trees' bin fields)."""
        arrays = self._state_arrays(gbdt, scores=False)
        if self.save_scores:
            num_rows, base = _rank_rows(gbdt)
            lo, hi = _written_rows(num_rows, base, gbdt.num_data, world)
            _pack_blocked(arrays, "train_score", num_rows, lo,
                          gbdt.train_score[lo - base:hi - base].cpu().numpy())
            from ..parallel.ingest import shard_bounds
            for i, vs in enumerate(gbdt.valid_scores):
                vlo, vhi = shard_bounds(vs.shape[0], world.rank, world.size)
                _pack_blocked(arrays, f"valid_score_{i}", vs.shape[0], vlo,
                              vs[vlo:vhi].cpu().numpy())
        buf = _io.BytesIO()
        np.savez(buf, **arrays)
        return buf.getvalue()

    def _state_npz_bytes(self, gbdt) -> bytes:
        buf = _io.BytesIO()
        np.savez(buf, **self._state_arrays(gbdt, scores=self.save_scores))
        return buf.getvalue()

    def _state_arrays(self, gbdt, scores: bool) -> Dict[str, np.ndarray]:
        arrays: Dict[str, np.ndarray] = {}
        if scores:
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
        return arrays

    def cleanup_stale(self) -> None:
        """Rank 0, at the start of a run over ranks: drop the temporary
        directories of versions that a crashed run never committed,
        before this run's first write (no rank can write one before
        rank 0 has joined the run's first collective)."""
        if self.world is not None and self._leader() \
                and os.path.isdir(self.directory):
            self._cleanup_tmp()

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
            if manifest.get("world") and not os.path.exists(
                    os.path.join(path, COMMIT_MARKER)):
                # a coordinated checkpoint without its phase-2 marker
                # never reached its quorum: torn by definition
                log_warning(f"checkpoint: {path} lacks the commit "
                            "marker (torn coordinated write)")
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
            self._maybe_prune_torn(path)
        return None

    def _maybe_prune_torn(self, path: str) -> None:
        """Remove a torn coordinated checkpoint (a world manifest and no
        commit marker) so that it never shadows an older full-quorum
        version again; rank 0's alone. A torn single-process checkpoint
        stays for a post-mortem."""
        if not self._leader():
            return
        try:
            manifest = json.loads(read_text(
                os.path.join(path, "manifest.json")))
        except (OSError, ValueError):
            return
        if not manifest.get("world") or os.path.exists(
                os.path.join(path, COMMIT_MARKER)):
            return
        shutil.rmtree(path, ignore_errors=True)
        from ..observability.telemetry import get_telemetry
        get_telemetry().count("checkpoint.pruned_torn")
        log_warning(f"checkpoint: pruned torn coordinated checkpoint {path}")

    def restore_latest(self, booster) -> Optional[ResumeInfo]:
        """Restore the newest valid, fingerprint-matching checkpoint
        into the booster. Returns None (with a warning) when nothing
        valid/compatible exists — callers then start fresh."""
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
        reshard = self._check_world_compat(manifest, gbdt.config, path)
        self._apply(booster, path, manifest, reshard)
        from ..observability.telemetry import get_telemetry
        get_telemetry().count("checkpoint.restores")
        log_info(f"checkpoint: restored iteration "
                 f"{manifest['iteration']} from {path}")
        return ResumeInfo(int(manifest["iteration"]),
                          int(manifest.get("begin_iteration", 0)),
                          manifest.get("eval_history") or [], path)

    def _check_world_compat(self, manifest: Dict[str, Any], config,
                            path: str) -> bool:
        """The checkpoint's world against this run's (JAX
        ``_check_world_compat``): a mismatch is a structured error naming
        both sides, unless ``elastic_resume`` asks for the N -> M
        reshard. Returns whether this restore reshards."""
        world_m = manifest.get("world") or {}
        cur = self.world
        if not world_m and cur is None:
            return False  # one process wrote it, one process reads it
        ck_size = int(world_m.get("size", 1))
        ck_machines = [str(m) for m in world_m.get("machines", [])]
        cur_size = cur.size if cur is not None else 1
        cur_machines = self._machine_strings(config) \
            if cur is not None else []
        if ck_size == cur_size and ck_machines == cur_machines:
            return False
        if bool(getattr(config, "elastic_resume", False)):
            log_info(
                f"checkpoint: elastic resume {ck_size} -> {cur_size} "
                f"ranks (checkpoint machines={ck_machines or ['-']}, "
                f"current={cur_machines or ['-']}); re-sharding {path}")
            return ck_size != cur_size
        raise LightGBMError(
            "checkpoint: world mismatch — checkpoint was written by "
            f"{ck_size} rank(s) on machines "
            f"[{', '.join(ck_machines) or '-'}] but this run has "
            f"{cur_size} rank(s) on machines "
            f"[{', '.join(cur_machines) or '-'}]. Set "
            "elastic_resume=true to re-shard onto the new world, or "
            "restart on the original machine list. "
            f"(checkpoint: {path})")

    def _apply(self, booster, path: str, manifest: Dict[str, Any],
               reshard: bool = False) -> None:
        if manifest.get("world"):
            self._apply_world_state(booster, path, manifest, reshard)
            return
        with np.load(_io.BytesIO(
                read_bytes(os.path.join(path, "state.npz"))),
                allow_pickle=False) as z:
            arrays = {n: z[n] for n in z.files}
        scores = None
        if "train_score" in arrays:
            scores = [arrays["train_score"]] + [
                arrays[f"valid_score_{i}"]
                for i in range(len(booster._gbdt.valid_scores))]
        self._apply_state(booster, path, manifest, arrays, scores, reshard)

    def _apply_world_state(self, booster, path: str,
                           manifest: Dict[str, Any], reshard: bool) -> None:
        """The coordinated restore (JAX ``_apply_world_state``): the
        whole score arrays reassembled from every writer rank's row
        ranges (raw values, no arithmetic), this rank's rows of them;
        the rest from this rank's own shard, or on a reshard from rank
        0's (the streams advance alike on every rank)."""
        names = sorted(f for f in manifest.get("files", {})
                       if f.startswith("shard_") and f.endswith(".npz"))
        shards = [np.load(_io.BytesIO(read_bytes(os.path.join(path, f))),
                          allow_pickle=False) for f in names]
        try:
            world = self.world
            own = shards[0] if reshard or world is None \
                else shards[world.rank]
            arrays = {n: own[n] for n in own.files
                      if not n.startswith(("train_score", "valid_score_"))}
            train = _reassemble_blocked(shards, "train_score")
            scores = None
            if train is not None:
                scores = [train] + [
                    _reassemble_blocked(shards, f"valid_score_{i}")
                    for i in range(len(booster._gbdt.valid_scores))]
        finally:
            for z in shards:
                z.close()
        self._apply_state(booster, path, manifest, arrays, scores, reshard)

    def _apply_state(self, booster, path: str, manifest: Dict[str, Any],
                     z: Dict[str, np.ndarray], scores, reshard: bool
                     ) -> None:
        """Put a checkpoint's state into the booster: the trees (the
        model text with their bin fields), the iteration, the scores
        (``scores``: the whole train array and each valid set's, of
        which this process takes its rows; None: recomputed), the
        streams and the learner's arrays. A reshard drops the learner's
        row order: it belongs to the writer rank's block."""
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
        names = set(z)
        _rebind_trees(models, z, gbdt.train_data)
        gbdt.models = models
        gbdt.iter = int(manifest["iteration"])
        gbdt.shrinkage_rate = float(
            manifest.get("shrinkage_rate", gbdt.shrinkage_rate))
        dev = gbdt.device
        if scores is not None:
            num_rows, base = _rank_rows(gbdt)
            if scores[0].shape[0] != num_rows:
                raise LightGBMError(
                    f"checkpoint: {scores[0].shape[0]} score rows for a "
                    f"run of {num_rows} rows ({path})")
            gbdt.train_score = torch.from_numpy(np.ascontiguousarray(
                scores[0][base:base + gbdt.num_data])).to(dev)
            for i in range(len(gbdt.valid_scores)):
                gbdt.valid_scores[i] = torch.from_numpy(
                    scores[i + 1].copy()).to(dev)
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
            gbdt._tree_weight = [float(v) for v in z["dart_tree_weight"]]
            gbdt._sum_weight = float(z["dart_sum_weight"][0])
        gbdt.learner.restore_arrays(
            {n[len("learner_"):]: z[n] for n in names
             if n.startswith("learner_")
             and not (reshard and n == "learner_row_order")})

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
