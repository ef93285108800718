"""Configuration / flag system.

Copy of ``lightgbm_tpu/config.py`` for the PyTorch port: same dataclass,
aliases and ``check_param_conflict``. The difference: ``device_type``
defaults to ``cuda``. Which parameters the
port's training path accepts is checked where they are used
(``parallel/learners.py:create_tree_learner`` and the learners).

Originally a TPU-native re-design of the reference parameter system
(``include/LightGBM/config.h:32-1081``, ``src/io/config.cpp``,
``src/io/config_auto.cpp``): a typed dataclass holding every training-time
parameter with LightGBM-compatible names, defaults and the full alias table,
plus ``Config.from_params`` (the analog of ``Config::Set``) and
``check_param_conflict`` (analog of ``Config::CheckParamConflict``).

Unlike the reference there is no code generation step: the dataclass *is* the
source of truth, and aliases live in ``_PARAM_ALIASES`` below.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .utils.log import log_warning

kDefaultNumLeaves = 31

# Alias -> canonical name. Mirrors the generated alias table in
# src/io/config_auto.cpp (ParameterAlias::KeyAliasTransform).
_PARAM_ALIASES: Dict[str, str] = {
    "config_file": "config",
    "task_type": "task",
    "objective_type": "objective", "app": "objective", "application": "objective",
    "boosting_type": "boosting", "boost": "boosting",
    "train": "data", "train_data": "data", "train_data_file": "data",
    "data_filename": "data",
    "test": "valid", "valid_data": "valid", "valid_data_file": "valid",
    "test_data": "valid", "test_data_file": "valid", "valid_filenames": "valid",
    "num_iteration": "num_iterations", "n_iter": "num_iterations",
    "num_tree": "num_iterations", "num_trees": "num_iterations",
    "num_round": "num_iterations", "num_rounds": "num_iterations",
    "num_boost_round": "num_iterations", "n_estimators": "num_iterations",
    "shrinkage_rate": "learning_rate", "eta": "learning_rate",
    "num_leaf": "num_leaves", "max_leaves": "num_leaves", "max_leaf": "num_leaves",
    "tree": "tree_learner", "tree_type": "tree_learner",
    "tree_learner_type": "tree_learner",
    "num_thread": "num_threads", "nthread": "num_threads",
    "nthreads": "num_threads", "n_jobs": "num_threads",
    "device": "device_type",
    "random_seed": "seed", "random_state": "seed",
    "hist_pool_size": "histogram_pool_size",
    "min_data_per_leaf": "min_data_in_leaf", "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf",
    "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "sub_row": "bagging_fraction", "subsample": "bagging_fraction",
    "bagging": "bagging_fraction",
    "pos_sub_row": "pos_bagging_fraction", "pos_subsample": "pos_bagging_fraction",
    "pos_bagging": "pos_bagging_fraction",
    "neg_sub_row": "neg_bagging_fraction", "neg_subsample": "neg_bagging_fraction",
    "neg_bagging": "neg_bagging_fraction",
    "subsample_freq": "bagging_freq",
    "bagging_fraction_seed": "bagging_seed",
    "sub_feature": "feature_fraction", "colsample_bytree": "feature_fraction",
    "sub_feature_bynode": "feature_fraction_bynode",
    "colsample_bynode": "feature_fraction_bynode",
    "early_stopping_rounds": "early_stopping_round",
    "early_stopping": "early_stopping_round",
    "n_iter_no_change": "early_stopping_round",
    "max_tree_output": "max_delta_step", "max_leaf_output": "max_delta_step",
    "reg_alpha": "lambda_l1",
    "reg_lambda": "lambda_l2", "lambda": "lambda_l2",
    "min_split_gain": "min_gain_to_split",
    "rate_drop": "drop_rate",
    "topk": "top_k",
    "linear_trees": "linear_tree",
    "linear_leaf": "linear_tree",
    "linear_l2": "linear_lambda",
    "linear_max_leaf_features": "linear_max_features",
    "mc": "monotone_constraints", "monotone_constraint": "monotone_constraints",
    "feature_contrib": "feature_contri", "fc": "feature_contri",
    "fp": "feature_contri", "feature_penalty": "feature_contri",
    "fs": "forcedsplits_filename",
    "forced_splits_filename": "forcedsplits_filename",
    "forced_splits_file": "forcedsplits_filename",
    "forced_splits": "forcedsplits_filename",
    "verbose": "verbosity",
    "model_input": "input_model", "model_in": "input_model",
    "model_output": "output_model", "model_out": "output_model",
    "save_period": "snapshot_freq",
    "subsample_for_bin": "bin_construct_sample_cnt",
    "data_seed": "data_random_seed",
    "is_sparse": "is_enable_sparse", "enable_sparse": "is_enable_sparse",
    "sparse": "is_enable_sparse",
    "is_enable_bundle": "enable_bundle", "bundle": "enable_bundle",
    "is_pre_partition": "pre_partition",
    "two_round_loading": "two_round", "use_two_round_loading": "two_round",
    "has_header": "header",
    "label": "label_column",
    "weight": "weight_column",
    "group": "group_column", "group_id": "group_column",
    "query_column": "group_column", "query": "group_column",
    "query_id": "group_column",
    "ignore_feature": "ignore_column", "blacklist": "ignore_column",
    "cat_feature": "categorical_feature",
    "categorical_column": "categorical_feature", "cat_column": "categorical_feature",
    "is_save_binary": "save_binary", "is_save_binary_file": "save_binary",
    "is_predict_raw_score": "predict_raw_score",
    "predict_rawscore": "predict_raw_score", "raw_score": "predict_raw_score",
    "is_predict_leaf_index": "predict_leaf_index",
    "leaf_index": "predict_leaf_index",
    "is_predict_contrib": "predict_contrib", "contrib": "predict_contrib",
    "predict_result": "output_result", "prediction_result": "output_result",
    "predict_name": "output_result", "prediction_name": "output_result",
    "pred_name": "output_result", "name_pred": "output_result",
    "convert_model_file": "convert_model",
    "num_classes": "num_class",
    "unbalance": "is_unbalance", "unbalanced_sets": "is_unbalance",
    "metrics": "metric", "metric_types": "metric",
    "output_freq": "metric_freq",
    "training_metric": "is_provide_training_metric",
    "is_training_metric": "is_provide_training_metric",
    "train_metric": "is_provide_training_metric",
    "ndcg_eval_at": "eval_at", "ndcg_at": "eval_at", "eval_at_points": "eval_at",
    "num_machine": "num_machines",
    "local_port": "local_listen_port", "port": "local_listen_port",
    "machine_list_file": "machine_list_filename",
    "machine_list": "machine_list_filename", "mlist": "machine_list_filename",
    "workers": "machines", "nodes": "machines",
    "telemetry": "telemetry_out", "telemetry_file": "telemetry_out",
    "telemetry_output": "telemetry_out",
    "trace": "trace_out", "trace_file": "trace_out",
    "trace_output": "trace_out", "chrome_trace": "trace_out",
    "profiler_dir": "profile_dir", "jax_profile_dir": "profile_dir",
    "prometheus_port": "metrics_port",
    "metrics_http_port": "metrics_port",
    "crash_dump_path": "crash_dump",
    "flight_recorder_path": "crash_dump",
    "compile_cache": "compile_cache_dir",
    "compilation_cache_dir": "compile_cache_dir",
    "serve_host": "serving_host",
    "serve_port": "serving_port",
    "serving_bucket_sizes": "serving_buckets",
    "serving_num_replicas": "serving_replicas",
    "num_replicas": "serving_replicas",
    "serving_model_list": "serving_models",
    "serving_canary": "serving_canary_model",
    "serving_shadow": "serving_shadow_model",
    "serving_quota_rate": "serving_quota_qps",
    "quota_unit": "serving_quota_unit",
    "serving_quota_cost_unit": "serving_quota_unit",
    "aot": "serving_aot", "serving_aot_artifacts": "serving_aot",
    "shm": "serving_shm", "serving_shm_transport": "serving_shm",
    "shm_slots": "serving_shm_slots",
    "shm_slot_bytes": "serving_shm_slot_bytes",
    "shm_min_bytes": "serving_shm_min_bytes",
    "isolation": "serving_isolation",
    "replica_isolation": "serving_isolation",
    "serving_replica_restart_max": "replica_restart_max",
    "replica_restarts_max": "replica_restart_max",
    "checkpoint_path": "checkpoint_dir", "ckpt_dir": "checkpoint_dir",
    "pipeline_stages": "pipeline_canary_stages",
    "pipeline_window": "pipeline_window_rows",
    "pipeline_workdir": "pipeline_dir",
    "pipeline_interval": "pipeline_interval_s",
    "checkpoint_period": "checkpoint_freq",
    "keep_checkpoints": "checkpoint_keep",
    "nonfinite_policy": "guard_policy", "guard": "guard_policy",
    "loss_spike_factor": "guard_loss_spike",
    "fault_spec": "faults",
    "slos": "slo_specs", "slo_spec": "slo_specs",
    "max_slo_burn": "pipeline_max_slo_burn",
    "federation": "serving_federation",
    "use_multiboost": "multiboost", "multi_boost": "multiboost",
    "multiboost_batch": "multiboost_max_batch",
    "max_models_per_batch": "multiboost_max_batch",
    "tenants": "pipeline_tenants",
    "pipeline_tenant_models": "pipeline_tenants",
    "elastic_hb_ms": "elastic_heartbeat_ms",
    "elastic_hb_timeout_ms": "elastic_heartbeat_timeout_ms",
    "stall_timeout_ms": "elastic_stall_timeout_ms",
    "elastic_ckpt_barrier_s": "elastic_barrier_s",
    "reshard_resume": "elastic_resume",
}

_OBJECTIVE_ALIASES: Dict[str, str] = {
    # objective-name aliases handled in Config::Set of the reference
    "regression_l2": "regression", "l2": "regression", "mean_squared_error":
    "regression", "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "l1": "regression_l1", "mean_absolute_error": "regression_l1",
    "mae": "regression_l1",
    "mean_absolute_percentage_error": "mape",
    "lambda_rank": "lambdarank", "rank_xendcg": "rank_xendcg",
    "xendcg": "rank_xendcg", "xe_ndcg": "rank_xendcg",
    "xe_ndcg_mart": "rank_xendcg", "xendcg_mart": "rank_xendcg",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "xentropy": "cross_entropy", "xentlambda": "cross_entropy_lambda",
    "mean_ap": "map",
}

_METRIC_ALIASES: Dict[str, str] = {
    "l1": "l1", "mean_absolute_error": "l1", "mae": "l1", "regression_l1": "l1",
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2", "regression": "l2",
    "l2_root": "rmse", "root_mean_squared_error": "rmse", "rmse": "rmse",
    "quantile": "quantile", "huber": "huber", "fair": "fair",
    "poisson": "poisson", "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "gamma_deviance": "gamma_deviance", "tweedie": "tweedie",
    "ndcg": "ndcg", "lambdarank": "ndcg", "rank_xendcg": "ndcg",
    "xendcg": "ndcg", "xe_ndcg": "ndcg", "xe_ndcg_mart": "ndcg",
    "xendcg_mart": "ndcg",
    "map": "map", "mean_average_precision": "map",
    "auc": "auc", "auc_mu": "auc_mu",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multiclassova": "multi_logloss",
    "multiclass_ova": "multi_logloss", "ova": "multi_logloss",
    "ovr": "multi_logloss",
    "multi_error": "multi_error",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
    "kldiv": "kullback_leibler", "kullback_leibler": "kullback_leibler",
    "none": "custom", "null": "custom", "custom": "custom", "na": "custom",
}


def _parse_list(value: Any, typ) -> list:
    if value is None:
        return []
    if isinstance(value, str):
        if not value:
            return []
        return [typ(v) for v in value.replace(";", ",").split(",")]
    if isinstance(value, (list, tuple)):
        return [typ(v) for v in value]
    return [typ(value)]


_UNIMPLEMENTED_PARAMS = {
}


@dataclass
class Config:
    """All parameters, LightGBM-compatible names (config.h:32-1081)."""

    # ---- core (config.h:96-232)
    config: str = ""
    task: str = "train"
    objective: str = "regression"
    boosting: str = "gbdt"
    data: str = ""
    valid: List[str] = field(default_factory=list)
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = kDefaultNumLeaves
    tree_learner: str = "serial"
    num_threads: int = 0
    device_type: str = "cuda"
    seed: int = 0

    # ---- learning control (config.h:236-517)
    force_col_wise: bool = False
    force_row_wise: bool = False
    # fused split-step megakernel gate (ops/split_step_pallas.py):
    # auto = on where the Mosaic lowering probe passes (compiled
    # backends, numerical fast path), on/off force it. The
    # LGBM_TPU_FUSED_SPLIT_KERNEL env var overrides per process.
    fused_split_kernel: str = "auto"
    histogram_pool_size: float = -1.0
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    bagging_fraction: float = 1.0
    pos_bagging_fraction: float = 1.0
    neg_bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    feature_fraction: float = 1.0
    feature_fraction_bynode: float = 1.0
    feature_fraction_seed: int = 2
    extra_trees: bool = False
    extra_seed: int = 6
    early_stopping_round: int = 0
    first_metric_only: bool = False
    max_delta_step: float = 0.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4
    top_rate: float = 0.2
    other_rate: float = 0.1
    min_data_per_group: int = 100
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    top_k: int = 20
    monotone_constraints: List[int] = field(default_factory=list)
    feature_contri: List[float] = field(default_factory=list)
    forcedsplits_filename: str = ""
    refit_decay_rate: float = 0.9
    # piecewise-linear leaf models (docs/LinearTrees.md): fit a small
    # ridge regression over each leaf's path features from the leaf's
    # gradient/hessian sufficient statistics ("Gradient Boosting With
    # Piece-Wise Linear Regression Trees", arxiv 1802.05640)
    linear_tree: bool = False
    linear_lambda: float = 0.0         # ridge strength on the leaf coeffs
    linear_max_features: int = 8       # per-leaf feature cap (pads the IR)
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    cegb_penalty_feature_lazy: List[float] = field(default_factory=list)
    cegb_penalty_feature_coupled: List[float] = field(default_factory=list)

    # ---- IO (config.h:521-671)
    verbosity: int = 1
    input_model: str = ""
    output_model: str = "LightGBM_model.txt"
    snapshot_freq: int = -1
    max_bin: int = 255
    max_bin_by_feature: List[int] = field(default_factory=list)
    min_data_in_bin: int = 3
    bin_construct_sample_cnt: int = 200000
    data_random_seed: int = 1
    is_enable_sparse: bool = True
    enable_bundle: bool = True
    use_missing: bool = True
    zero_as_missing: bool = False
    feature_pre_filter: bool = True
    pre_partition: bool = False
    two_round: bool = False
    header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    categorical_feature: str = ""
    forcedbins_filename: str = ""
    save_binary: bool = False
    # structured training telemetry (docs/Observability.md): path of a
    # JSONL trace; empty = disabled unless LGBM_TPU_TELEMETRY is set
    telemetry_out: str = ""
    # live metrics plane (docs/Observability.md): >0 serves Prometheus
    # text on GET http://<metrics_host>:<metrics_port>/metrics for the
    # training CLI; 0 = off unless LGBM_TPU_METRICS_PORT is set. The
    # serving frontend always mounts /metrics on its own port.
    metrics_port: int = 0
    metrics_host: str = "127.0.0.1"
    # crash flight recorder dump path override; empty = derive
    # <telemetry_out>.crash.json (or LGBM_TPU_CRASH_DUMP env)
    crash_dump: str = ""
    # end-to-end trace correlation (docs/Observability.md "Tracing"):
    # path of the Chrome-trace-event JSON export (Perfetto-loadable
    # request/iteration span timeline); empty = disabled unless
    # LGBM_TPU_TRACE is set
    trace_out: str = ""
    # one-shot jax.profiler capture window aligned to span boundaries
    # (LGBM_TPU_PROFILE_DIR env analog; skip/length via
    # LGBM_TPU_PROFILE_SKIP / LGBM_TPU_PROFILE_SPANS); empty = off
    profile_dir: str = ""
    # persistent XLA compilation cache directory (docs/Performance.md):
    # compiled executables are serialized there and reloaded by later
    # processes, so repeat runs skip the cold-compile bill. Empty =
    # disabled unless LGBM_TPU_COMPILE_CACHE is set.
    compile_cache_dir: str = ""

    # ---- robustness (lightgbm_tpu/robustness/, docs/Robustness.md):
    # atomic versioned checkpoints + resume, non-finite guards, and the
    # deterministic fault-injection harness
    checkpoint_dir: str = ""           # empty = checkpointing off
    checkpoint_freq: int = 0           # iterations between checkpoints
    checkpoint_keep: int = 3           # keep-last-K retention
    checkpoint_score_cache: bool = True  # save device score buffers
    resume: str = "auto"               # auto | off
    guard_policy: str = "off"          # off | raise | skip_iter | rollback
    guard_loss_spike: float = 0.0      # >1 = eval-loss spike factor
    guard_max_rollbacks: int = 3       # bound on guard-driven restores
    faults: str = ""                   # fault spec (LGBM_TPU_FAULTS analog)
    # ---- elastic distributed training (robustness/elastic.py,
    # docs/Robustness.md "Elastic distributed training"): collective
    # watchdog over a rank heartbeat side-channel, coordinated
    # (two-phase) multi-rank checkpoints, and resume across mesh sizes
    elastic_watchdog: bool = True      # watchdog on for multi-process runs
    elastic_heartbeat_ms: float = 500.0   # rank heartbeat send period
    # rank declared peer_lost / coordinator_lost after this silence
    elastic_heartbeat_timeout_ms: float = 10000.0
    # no local iteration boundary for this long => collective_stall
    elastic_stall_timeout_ms: float = 120000.0
    # grace between classified abort and forced exit of a wedged rank
    elastic_abort_grace_ms: float = 5000.0
    # side-channel TCP port; 0 = coordinator port + 521, or an
    # ephemeral port published through the group's store
    elastic_port: int = 0
    # allow resume=auto onto a machine list that mismatches the
    # checkpoint manifest (elastic N->M reshard); off = structured error
    elastic_resume: bool = False
    # leave the process group (destroy_process_group) at the end of
    # a train over the ranks
    elastic_shutdown: bool = True
    # bound on the two-phase checkpoint commit barrier (all-ranks fsync)
    elastic_barrier_s: float = 120.0

    # ---- predict task (config.h:675-741)
    num_iteration_predict: int = -1
    predict_raw_score: bool = False
    predict_leaf_index: bool = False
    predict_contrib: bool = False
    predict_disable_shape_check: bool = False
    pred_early_stop: bool = False
    pred_early_stop_freq: int = 10
    pred_early_stop_margin: float = 10.0
    output_result: str = "LightGBM_predict_result.txt"

    # ---- convert task (config.h:745-757)
    convert_model_language: str = ""
    convert_model: str = "gbdt_prediction.cpp"

    # ---- serve task (lightgbm_tpu/serving/, docs/Serving.md) — the
    # HTTP frontend address plus the ServingEngine knobs: power-of-two
    # row buckets precompiled at warmup, the bounded request queue, the
    # micro-batch coalescing window, per-request deadline, shed policy
    # (reject_new | drop_oldest) and the device route (auto | always |
    # never)
    serving_host: str = "127.0.0.1"
    serving_port: int = 8080
    serving_buckets: List[int] = field(default_factory=list)
    serving_max_queue: int = 1024
    serving_flush_ms: float = 2.0
    serving_timeout_ms: float = 1000.0
    serving_shed_policy: str = "reject_new"
    serving_device: str = "auto"
    serving_warmup: bool = True
    # ---- fleet serving (serving/fleet.py, docs/Serving.md "Fleet"):
    # replica pool size, named-model list ("name=path" entries; the
    # default model is input_model when set), the shared pending bound
    # (0 = replicas * serving_max_queue), per-tenant token-bucket
    # quotas (qps rate + burst; serving_quota_tenants entries are
    # "tenant=rate" or "tenant=rate:burst"), and the canary/shadow
    # routing rules applied to the default model
    serving_replicas: int = 1
    serving_models: List[str] = field(default_factory=list)
    serving_max_pending: int = 0
    serving_quota_qps: float = 0.0
    serving_quota_burst: float = 0.0
    serving_quota_tenants: List[str] = field(default_factory=list)
    serving_canary_model: str = ""
    serving_canary_weight: float = 0.0
    serving_shadow_model: str = ""
    # what one quota token buys: "requests" (one call, one token) or
    # "bytes" (a call costs its decoded f64 payload bytes — rates
    # above become bytes/second, bounding data volume not call count)
    serving_quota_unit: str = "requests"
    # ---- AOT predict artifacts (serving/aot.py, docs/Serving.md
    # "AOT artifacts"): when on, a model publish builds a serialized
    # predict artifact (stacked tree arrays + bin mappers + the
    # AOT-compiled shape-bucket executables persisted in the compile
    # cache) that process workers replay at load/respawn, so the
    # device route serves with ZERO retraces and no training dataset
    # in the worker
    serving_aot: bool = True
    # ---- process isolation (serving/procfleet.py, docs/Serving.md
    # "Process isolation"): serving_isolation=process runs every
    # replica's ServingEngine in its own spawned OS process (own JAX
    # runtime, own flight recorder) behind a length-prefixed local
    # socket, so a device OOM / runtime abort / segfault kills ONE
    # replica, never the pool. A dead worker's requests re-dispatch
    # eagerly to survivors and the worker respawns with the bounded
    # deterministic backoff from robustness/retry.py, capped by
    # replica_restart_max; a flapping replica is quarantined (the
    # fleet degrades, it never dies).
    serving_isolation: str = "thread"  # thread | process
    replica_restart_max: int = 3       # respawns before quarantine
    # shared-memory row transport (serving/shm_ring.py): each process
    # worker gets a seqlock'd shared-memory ring; batches whose f64
    # payload is >= serving_shm_min_bytes travel as raw row blocks
    # instead of JSON arrays (the socket frame stays the control
    # channel and the small-batch / ring-full fallback path)
    serving_shm: bool = True
    serving_shm_slots: int = 4
    serving_shm_slot_bytes: int = 1048576   # 1 MiB per slot
    serving_shm_min_bytes: int = 16384      # below this, JSON framing
    replica_heartbeat_ms: float = 200.0
    replica_heartbeat_timeout_ms: float = 3000.0
    replica_spawn_timeout_s: float = 120.0
    # ---- observability federation + SLOs (observability/{metrics,
    # slo}.py, docs/Observability.md "Federation"): process-mode
    # workers piggyback metrics deltas on their heartbeat pongs so ONE
    # parent /metrics scrape renders the whole fleet under a `worker`
    # label; the SLO engine evaluates declarative objectives
    # ("name:kind:objective[:threshold_ms]"; kinds availability |
    # latency | error_rate) as multi-window burn rates over the
    # merged state and publishes lgbm_slo_burn{slo,window} gauges
    serving_federation: bool = True
    slo_specs: List[str] = field(default_factory=list)
    slo_windows: List[str] = field(default_factory=list)
    slo_eval_interval_s: float = 5.0
    # >0 arms the ramp's SLO gate: a canary stage observing a worst
    # burn above this rolls back (pipeline/ramp.py max_slo_burn)
    pipeline_max_slo_burn: float = 0.0
    # per-metric cap on distinct label sets in the metrics registry;
    # overflow series are dropped and counted in
    # lgbm_metrics_dropped_series (0 = unbounded)
    metrics_max_series: int = 256

    # ---- pipeline task (lightgbm_tpu/pipeline/, docs/Pipeline.md) —
    # the continuous refit-and-promote loop: a log source (replay
    # stream or tailed serving-log JSONL) feeds labeled windows to a
    # refit trainer; each candidate is checkpointed, published into
    # the fleet registry, ramped through the canary stages and
    # auto-promoted (or rolled back on latency/quality/parity/
    # flight-recorder regression)
    pipeline_mode: str = "refit"       # refit | continue
    pipeline_source: str = "replay"    # replay | tail
    pipeline_log_path: str = ""        # tail source JSONL path
    pipeline_window_rows: int = 512    # rows per refit window
    pipeline_holdout_rows: int = 256   # rows per quality holdout
    pipeline_cycles: int = 0           # 0 = loop until preempted
    pipeline_interval_s: float = 0.0   # idle wait between cycles
    pipeline_dir: str = ""             # candidate checkpoint workdir
    pipeline_canary_stages: List[float] = field(default_factory=list)
    pipeline_stage_requests: int = 64  # watched requests per stage
    pipeline_latency_slo_pct: float = 100.0  # canary p99 headroom %
    pipeline_quality_drop: float = 0.02  # max holdout quality drop
    pipeline_continue_iters: int = 10  # trees per continue-mode cycle
    pipeline_replay_seed: int = 0      # replay stream seed
    pipeline_replay_noise: float = 0.1  # replay label noise
    pipeline_serve_http: bool = False  # serve HTTP during the loop
    # per-tenant refit loops: each named tenant owns a logical model
    # in the fleet registry; every cycle refits ALL tenants' candidates
    # as one multiboost batch and ramps/promotes them independently
    pipeline_tenants: List[str] = field(default_factory=list)

    # ---- multiboost (lightgbm_tpu/multiboost/): many-model training
    # as ONE compiled program. "auto" batches whenever the models are
    # eligible (and, for cv, the learning rate is an exact power of
    # two so the batched path is bit-identical to the loop path);
    # "on" forces batching for every eligible bucket; "off" restores
    # the per-model Python loop everywhere.
    multiboost: str = "auto"           # auto | on | off
    multiboost_max_batch: int = 64     # max models per compiled batch

    # ---- objective (config.h:761-832)
    objective_seed: int = 5
    num_class: int = 1
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0
    sigmoid: float = 1.0
    boost_from_average: bool = True
    reg_sqrt: bool = False
    alpha: float = 0.9
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    tweedie_variance_power: float = 1.5
    lambdarank_truncation_level: int = 20
    lambdarank_norm: bool = True
    label_gain: List[float] = field(default_factory=list)

    # ---- metric (config.h:836-862)
    metric: List[str] = field(default_factory=list)
    metric_freq: int = 1
    is_provide_training_metric: bool = False
    eval_at: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 5])
    multi_error_top_k: int = 1
    auc_mu_weights: List[float] = field(default_factory=list)

    # ---- network (config.h:866-887); on TPU these select the mesh, not sockets
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_filename: str = ""
    machines: str = ""

    # ---- device (config.h:891-918). gpu_* kept as accepted-but-ignored
    # compatibility aliases; the TPU path replaces the OpenCL learner.
    gpu_platform_id: int = -1
    gpu_device_id: int = -1
    gpu_use_dp: bool = False
    # TPU-specific knobs (new in this framework)
    hist_dtype: str = "float32"        # histogram accumulation dtype
    n_devices: int = 0                 # 0 = all visible devices
    mesh_axes: str = "data"            # mesh layout for parallel learners

    # internal, filled by check_param_conflict
    is_parallel: bool = False
    # derived like the reference (config.cpp:275-295): data/voting
    # learners find bins cooperatively (seed + sample sync)
    is_parallel_find_bin: bool = False

    def __post_init__(self):
        self.objective = _OBJECTIVE_ALIASES.get(self.objective, self.objective)

    # --- analog of Config::Set (src/io/config.cpp:177-245)
    # params that are accepted but NOT implemented yet: setting a
    # non-default value warns loudly instead of silently ignoring.
    # Structurally-meaningless-on-TPU params (num_threads,
    # force_col_wise/row_wise, is_enable_sparse, pre_partition,
    # gpu_*) are accepted silently for config compatibility
    # — XLA owns threading/layout/memory. histogram_pool_size IS
    # honored: when the per-leaf histogram cache would exceed it, the
    # grow loops run pool-bounded (learner/serial.py:use_hist_cache);
    # two_round IS honored: file ingestion streams in two memory-
    # bounded passes (data/dataset.py:from_file_two_round).

    @classmethod
    def from_params(cls, params: Optional[Dict[str, Any]]) -> "Config":
        params = dict(params or {})
        known = {f.name: f for f in dataclasses.fields(cls)}
        kwargs: Dict[str, Any] = {}
        for raw_key, value in params.items():
            key = _PARAM_ALIASES.get(raw_key, raw_key)
            if key not in known:
                log_warning(f"Unknown parameter: {raw_key}")
                continue
            if key in kwargs:
                log_warning(f"{raw_key} is set with multiple values, "
                            f"current value kept")
                continue
            f = known[key]
            kwargs[key] = _coerce(value, f)
        if "seed" in kwargs:
            # the master seed derives every sub-seed not explicitly set
            # (Config::Set, src/io/config.cpp:187-196) using the exact
            # reference LCG (Random::RandInt16, utils/random.h) so
            # config dumps match the reference for the same seed;
            # explicit sub-seed params override the derived values
            x = int(kwargs["seed"]) & 0xFFFFFFFF
            for sub in ("data_random_seed", "bagging_seed", "drop_seed",
                        "feature_fraction_seed", "objective_seed",
                        "extra_seed"):
                x = (214013 * x + 2531011) & 0xFFFFFFFF
                if sub not in kwargs:
                    # NextShort(0, 32767) = RandInt16() % 32767, so a
                    # raw 15-bit draw of exactly 32767 wraps to 0
                    kwargs[sub] = ((x >> 16) & 0x7FFF) % 32767
        cfg = cls(**kwargs)
        cfg._warn_unimplemented(kwargs)
        cfg.check_param_conflict()
        return cfg

    def _warn_unimplemented(self, explicit: Dict[str, Any]) -> None:
        defaults = {
            f.name: (f.default if f.default is not dataclasses.MISSING
                     else f.default_factory()
                     if f.default_factory is not dataclasses.MISSING
                     else None)
            for f in dataclasses.fields(self)}
        for key in explicit:
            if key in _UNIMPLEMENTED_PARAMS \
                    and getattr(self, key) != defaults.get(key):
                log_warning(
                    f"Parameter {key} ({_UNIMPLEMENTED_PARAMS[key]}) is "
                    "accepted but NOT implemented in lightgbm_tpu_torch; it "
                    "has no effect")

    # --- analog of Config::CheckParamConflict (src/io/config.cpp:261-327)
    def check_param_conflict(self) -> None:
        from .utils.log import set_verbosity
        set_verbosity(self.verbosity)
        if self.max_bin <= 1:
            raise ValueError("max_bin should be greater than 1")
        if self.num_leaves <= 1:
            raise ValueError("num_leaves should be greater than 1")
        for name in ("bagging_fraction", "feature_fraction",
                     "feature_fraction_bynode", "pos_bagging_fraction",
                     "neg_bagging_fraction"):
            v = getattr(self, name)
            if not (0.0 < v <= 1.0):
                raise ValueError(f"{name} should be in (0.0, 1.0]")
        if self.learning_rate <= 0.0:
            raise ValueError("learning_rate should be greater than 0")
        if self.fused_split_kernel not in ("auto", "on", "off"):
            raise ValueError(
                "fused_split_kernel should be auto, on or off")
        if self.is_single_machine():
            self.is_parallel = False
            if self.tree_learner not in ("serial", "partitioned") \
                    and self.num_machines <= 1 and self.n_devices == 1:
                # single machine, single device -> serial learner
                self.tree_learner = "serial"
        else:
            self.is_parallel = True
        # is_parallel_find_bin derivation (config.cpp:283-295): data and
        # voting learners share one bin-finding sample; the data learner
        # also disables the histogram LRU pool to avoid paying its
        # refetch communication on every shard
        if self.tree_learner in ("data", "voting"):
            self.is_parallel_find_bin = True
            if self.histogram_pool_size >= 0 \
                    and self.tree_learner == "data":
                log_warning(
                    "Histogram LRU queue was enabled "
                    f"(histogram_pool_size={self.histogram_pool_size}).\n"
                    "Will disable this to reduce communication costs")
                self.histogram_pool_size = -1
        else:
            self.is_parallel_find_bin = False
        if self.tree_learner == "feature" and self.bagging_fraction < 1.0:
            log_warning("Found bagging_fraction with feature parallel; "
                        "bagging applies to the full data on every shard")
        if self.boosting == "rf":
            if not (self.bagging_freq > 0 and 0.0 < self.bagging_fraction < 1.0):
                raise ValueError(
                    "Random forest needs bagging_freq > 0 and "
                    "bagging_fraction in (0, 1)")
        if self.boosting == "goss" and self.top_rate + self.other_rate > 1.0:
            raise ValueError("top_rate + other_rate must be <= 1.0 for goss")
        if self.max_depth > 0:
            full = 1 << self.max_depth
            if self.num_leaves == kDefaultNumLeaves or self.num_leaves > full:
                self.num_leaves = min(self.num_leaves, full)
        if self.linear_tree:
            if self.linear_lambda < 0.0:
                raise ValueError("linear_lambda must be >= 0")
            if self.linear_max_features < 1:
                raise ValueError("linear_max_features must be >= 1")
            if self.boosting in ("dart", "rf"):
                # DART re-scores dropped trees and RF keeps a running
                # average through code paths that predate the linear
                # leaf IR; the combination is unvalidated
                log_warning(f"linear_tree is not supported with "
                            f"boosting={self.boosting}; using constant "
                            "leaves")
                self.linear_tree = False
            elif self.tree_learner not in ("serial", "partitioned") \
                    or self.is_parallel:
                log_warning("linear_tree is only supported by the "
                            "single-device serial/partitioned tree "
                            "learners; using constant leaves")
                self.linear_tree = False
        if self.guard_policy not in ("off", "raise", "skip_iter",
                                     "rollback"):
            raise ValueError(
                f"guard_policy={self.guard_policy!r} is not one of "
                "off|raise|skip_iter|rollback")
        if self.resume not in ("auto", "off"):
            raise ValueError(f"resume={self.resume!r} is not auto|off")
        if self.elastic_heartbeat_ms <= 0 \
                or self.elastic_heartbeat_timeout_ms <= 0 \
                or self.elastic_stall_timeout_ms <= 0 \
                or self.elastic_abort_grace_ms <= 0 \
                or self.elastic_barrier_s <= 0:
            raise ValueError("elastic_heartbeat_ms, "
                             "elastic_heartbeat_timeout_ms, "
                             "elastic_stall_timeout_ms, "
                             "elastic_abort_grace_ms and "
                             "elastic_barrier_s must be > 0")
        if not (0 <= self.elastic_port <= 65535):
            raise ValueError(
                f"elastic_port={self.elastic_port} is not a port")
        if self.elastic_heartbeat_timeout_ms \
                <= self.elastic_heartbeat_ms:
            raise ValueError(
                "elastic_heartbeat_timeout_ms must exceed "
                "elastic_heartbeat_ms")
        if not (0 <= self.metrics_port <= 65535):
            raise ValueError(
                f"metrics_port={self.metrics_port} is not a port")
        if self.serving_replicas < 1:
            raise ValueError("serving_replicas must be >= 1")
        if not (0.0 <= self.serving_canary_weight <= 1.0):
            raise ValueError(
                "serving_canary_weight must be in [0, 1]")
        if self.serving_quota_qps < 0 or self.serving_quota_burst < 0:
            raise ValueError("serving_quota_* must be >= 0")
        if self.serving_quota_unit not in ("requests", "bytes"):
            raise ValueError(
                f"serving_quota_unit={self.serving_quota_unit!r} is "
                "not requests|bytes")
        if self.serving_shm_slots < 1:
            raise ValueError("serving_shm_slots must be >= 1")
        if self.serving_shm_slot_bytes < 4096:
            raise ValueError(
                "serving_shm_slot_bytes must be >= 4096")
        if self.serving_shm_min_bytes < 0:
            raise ValueError("serving_shm_min_bytes must be >= 0")
        if self.serving_isolation not in ("thread", "process"):
            raise ValueError(
                f"serving_isolation={self.serving_isolation!r} is not "
                "thread|process")
        if self.replica_restart_max < 0:
            raise ValueError("replica_restart_max must be >= 0")
        if self.replica_heartbeat_ms <= 0 \
                or self.replica_heartbeat_timeout_ms <= 0 \
                or self.replica_spawn_timeout_s <= 0:
            raise ValueError("replica_heartbeat_ms, "
                             "replica_heartbeat_timeout_ms and "
                             "replica_spawn_timeout_s must be > 0")
        if self.serving_canary_weight > 0 \
                and not self.serving_canary_model:
            log_warning("serving_canary_weight is set without "
                        "serving_canary_model; no canary traffic "
                        "will be split")
        if self.checkpoint_freq > 0 and not self.checkpoint_dir:
            log_warning("checkpoint_freq is set without checkpoint_dir; "
                        "no checkpoints will be written")
        if self.pipeline_mode not in ("refit", "continue"):
            raise ValueError(
                f"pipeline_mode={self.pipeline_mode} must be refit or "
                "continue")
        if self.pipeline_source not in ("replay", "tail"):
            raise ValueError(
                f"pipeline_source={self.pipeline_source} must be "
                "replay or tail")
        for w in self.pipeline_canary_stages:
            if not (0.0 < w <= 1.0):
                raise ValueError("pipeline_canary_stages weights must "
                                 f"be in (0, 1], got {w}")
        if self.pipeline_quality_drop < 0 \
                or self.pipeline_latency_slo_pct < 0:
            raise ValueError("pipeline_quality_drop and "
                             "pipeline_latency_slo_pct must be >= 0")
        if self.pipeline_window_rows <= 0 \
                or self.pipeline_holdout_rows <= 0:
            raise ValueError("pipeline_window_rows and "
                             "pipeline_holdout_rows must be > 0")
        if self.slo_eval_interval_s <= 0:
            raise ValueError("slo_eval_interval_s must be > 0")
        if self.pipeline_max_slo_burn < 0:
            raise ValueError("pipeline_max_slo_burn must be >= 0")
        if self.metrics_max_series < 0:
            raise ValueError("metrics_max_series must be >= 0")
        if self.slo_specs or self.slo_windows:
            # fail at configure time, not inside the background
            # evaluator thread
            from .observability.slo import (parse_slo_specs,
                                            parse_window)
            parse_slo_specs(self.slo_specs)
            for w in self.slo_windows:
                parse_window(w)
        if self.objective in ("multiclass", "multiclassova") and self.num_class < 2:
            raise ValueError("num_class must be >= 2 for multiclass objectives")
        if self.objective not in ("multiclass", "multiclassova", "custom",
                                  "none", "null", "na") \
                and self.num_class != 1:
            raise ValueError("num_class must be 1 for non-multiclass objectives")

    def is_single_machine(self) -> bool:
        return self.num_machines <= 1 and not self.machines \
            and not self.machine_list_filename

    def num_tree_per_iteration(self) -> int:
        return self.num_class if self.objective in (
            "multiclass", "multiclassova") else 1

    def resolved_metrics(self) -> List[str]:
        """Metric list with aliases resolved; empty -> metric of objective."""
        if not self.metric:
            default = {
                "regression": "l2", "regression_l1": "l1", "huber": "huber",
                "fair": "fair", "poisson": "poisson", "quantile": "quantile",
                "mape": "mape", "gamma": "gamma", "tweedie": "tweedie",
                "binary": "binary_logloss",
                "multiclass": "multi_logloss", "multiclassova": "multi_logloss",
                "lambdarank": "ndcg", "rank_xendcg": "ndcg",
                "cross_entropy": "cross_entropy",
                "cross_entropy_lambda": "cross_entropy_lambda",
                "custom": "custom", "none": "custom",
            }.get(self.objective)
            return [default] if default else []
        out: List[str] = []
        for m in self.metric:
            canon = _METRIC_ALIASES.get(m, m)
            if canon not in out:
                out.append(canon)
        return [m for m in out if m != "custom"] \
            if any(m != "custom" for m in out) else out

    def to_params(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _coerce(value: Any, f: dataclasses.Field) -> Any:
    """Typed parse of one parameter value (GetInt/GetDouble/GetBool/GetString)."""
    typ = f.type
    is_list = str(typ).startswith("List") or "List" in str(typ)
    if is_list:
        elem = int if "int" in str(typ) else (
            float if "float" in str(typ) else str)
        return _parse_list(value, elem)
    if typ in ("bool", bool):
        if isinstance(value, str):
            return value.lower() in ("true", "1", "+", "yes", "y", "on")
        return bool(value)
    if typ in ("int", int):
        return int(float(value))
    if typ in ("float", float):
        return float(value)
    if isinstance(value, (list, tuple)):
        return ",".join(str(v) for v in value)
    return str(value)
