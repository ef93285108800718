"""Command-line entry: ``python -m lightgbm_tpu_torch config=train.conf``
(port of ``lightgbm_tpu/cli.py``: the same tasks, conf files and
precedence). Every task runs on the card unless ``device_type=cpu``
(``utils/device.py:config_device``); a missing card is an error.

Reference analog: ``Application``
(``src/application/application.cpp:24-224``, ``src/main.cpp``). Accepts
the reference CLI conventions: ``key=value`` arguments, a ``config=``
file of ``key = value`` lines with ``#`` comments (CLI args override
file entries), and the tasks

  * ``task=train`` (default) — load ``data`` (+ ``valid`` list), train,
    save ``output_model``; ``snapshot_freq=N`` writes
    ``<output_model>.snapshot_iter_<i>`` every N iterations
    (gbdt.cpp:258-262); ``input_model`` continues training from an
    existing model file.
  * ``task=predict`` — load ``input_model``, predict ``data``, write
    one line per row to ``output_result`` (predictor.cpp:46-109);
    honors ``predict_raw_score`` / ``predict_leaf_index`` /
    ``predict_contrib`` and ``num_iteration_predict``.
  * ``task=refit`` — load ``input_model``, refit leaf values on
    ``data`` with ``refit_decay_rate``, save ``output_model``.
  * ``task=serve`` — load ``input_model`` and serve it over the JSON
    HTTP endpoint (``serving_host``/``serving_port``) with
    micro-batching and one CUDA graph a (bucket, kind) on the card
    (``serving/``).
  * ``task=pipeline`` — the continuous refit-and-promote loop: serve
    ``input_model`` from a fleet pool while tailing a log source,
    refitting candidates, canary-ramping and auto-promoting them
    (``pipeline_*`` params; ``pipeline/``).
  * ``task=convert_model`` — write ``input_model`` as standalone C++
    source (``io/codegen.py``).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np

from .utils.device import config_device
from .utils.log import log_fatal, log_info, log_warning


def parse_config_file(path: str) -> Dict[str, str]:
    params: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, _, val = line.partition("=")
            params[key.strip()] = val.strip()
    return params


def parse_cli_params(argv: List[str]) -> Dict[str, str]:
    """CLI ``key=value`` args + optional config file; CLI wins
    (application.cpp LoadParameters precedence)."""
    cli: Dict[str, str] = {}
    for arg in argv:
        arg = arg.strip()
        if not arg or "=" not in arg:
            if arg:
                log_warning(f"Unknown CLI argument: {arg}")
            continue
        key, _, val = arg.partition("=")
        cli[key.strip()] = val.strip()
    conf = cli.pop("config", None) or cli.pop("config_file", None)
    params = parse_config_file(conf) if conf else {}
    params.update(cli)
    return params


def _load_predict_data(path: str, config) -> np.ndarray:
    """Feature matrix of a prediction input file: same parsing as
    training (label/weight/group columns dropped when present)."""
    from .data.file_loader import load_file
    X, _, _, _, _, _ = load_file(path, config)
    return X


def _pred_fmt(pred: np.ndarray) -> str:
    return "%d" if pred.dtype.kind in "iu" else "%.18g"


def _predict_file_streaming(booster, path: str, cfg, out: str,
                            **kwargs) -> None:
    """two_round predict: stream the input file in bounded chunks and
    append predictions per chunk (the reference predictor never holds
    the parsed file either, predictor.cpp:46-109). Writes go to a temp
    file replaced atomically at the end — a mid-stream failure must not
    destroy a previous result or leave a partial file behind."""
    import os
    from .data.file_loader import TwoRoundLoader
    loader = TwoRoundLoader(path, cfg)
    wrote = 0
    fmt = None
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as fh:
            for X, _, _, _ in loader.iter_chunks():
                pred = np.asarray(booster.predict(X, **kwargs))
                if fmt is None:
                    fmt = _pred_fmt(pred)
                np.savetxt(fh, pred, delimiter="\t", fmt=fmt)
                wrote += X.shape[0]
        os.replace(tmp, out)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    log_info(f"Finished prediction ({wrote} rows, streamed); "
             f"results saved to {out}")


def run_train(params: Dict[str, str]) -> None:
    from . import engine
    from .basic import Dataset
    from .config import Config
    cfg = Config.from_params(params)
    # start telemetry before ingestion so dataset counters are captured
    # (telemetry_out=<path.jsonl> CLI/config param or LGBM_TPU_TELEMETRY)
    from .observability.telemetry import get_telemetry
    get_telemetry().ensure_started(cfg)
    # live metrics plane: metrics_port=<p> / LGBM_TPU_METRICS_PORT
    # serves GET /metrics (Prometheus text) for the whole run
    from .observability.metrics import maybe_configure, \
        maybe_start_exporter
    maybe_configure(cfg)
    maybe_start_exporter(cfg)
    if cfg.machines or cfg.machine_list_filename:
        from .parallel.distributed import init_distributed
        init_distributed(cfg)
    if not cfg.data:
        log_fatal("task=train requires data=<training file>")
    train_set = Dataset(cfg.data, params=dict(params))
    valid_sets = []
    valid_names = []
    for v in cfg.valid:
        valid_sets.append(Dataset(v, params=dict(params),
                                  reference=train_set))
        valid_names.append(v.split("/")[-1])

    callbacks = []
    output_model = cfg.output_model or "LightGBM_model.txt"
    if cfg.snapshot_freq > 0:
        freq = int(cfg.snapshot_freq)
        # snapshots route through the robustness subsystem's atomic
        # writer (temp + fsync + rename): a crash mid-snapshot can no
        # longer leave a torn `<output_model>.snapshot_iter_<i>` file
        # behind. Filenames are unchanged (gbdt.cpp:258-262 compat).
        from .robustness.checkpoint import atomic_write_text

        def snapshot(env):
            it = env.iteration + 1
            if it % freq == 0:
                out = f"{output_model}.snapshot_iter_{it}"
                atomic_write_text(out, env.model.model_to_string())
                log_info(f"Saved snapshot to {out}")
        snapshot.order = 30
        # snapshots are side effects of LIVE iterations; never re-fire
        # them for replayed (pre-checkpoint) iterations on resume
        snapshot.replay_on_resume = False
        callbacks.append(snapshot)

    booster = engine.train(
        dict(params), train_set,
        num_boost_round=int(cfg.num_iterations),
        valid_sets=valid_sets or None,
        valid_names=valid_names or None,
        init_model=cfg.input_model or None,
        callbacks=callbacks or None, device=config_device(cfg))
    # leave the process group on every clean exit shape (idempotent —
    # engine.train already left it on the plain path; the preempt
    # escalation path is covered by init_distributed's
    # preempt.register_escalation_cleanup)
    from .parallel.distributed import shutdown_distributed
    if getattr(booster, "preempted", False):
        # preemption-safe shutdown: the final checkpoint is already on
        # disk (engine.train wrote it before returning); do NOT publish
        # a partial output model
        if bool(cfg.elastic_shutdown):
            shutdown_distributed()
        get_telemetry().flush()
        log_info(
            f"Training preempted at iteration {booster._gbdt.iter}; "
            f"checkpoint saved under {cfg.checkpoint_dir} — rerun the "
            "same command (resume=auto) to continue")
        return
    if bool(cfg.elastic_shutdown):
        shutdown_distributed()
    from .robustness.checkpoint import atomic_write_text
    atomic_write_text(output_model, booster.model_to_string())
    get_telemetry().flush()
    log_info(f"Finished training; model saved to {output_model}")


def run_predict(params: Dict[str, str]) -> None:
    from .basic import Booster
    from .config import Config
    cfg = Config.from_params(params)
    if not cfg.input_model:
        log_fatal("task=predict requires input_model=<model file>")
    if not cfg.data:
        log_fatal("task=predict requires data=<input file>")
    booster = Booster(model_file=cfg.input_model,
                      device=config_device(cfg))
    ni = int(cfg.num_iteration_predict)
    kwargs = dict(num_iteration=ni if ni > 0 else -1)
    if cfg.pred_early_stop:
        kwargs.update(
            pred_early_stop=True,
            pred_early_stop_freq=int(cfg.pred_early_stop_freq),
            pred_early_stop_margin=float(cfg.pred_early_stop_margin))
    if cfg.predict_leaf_index:
        kwargs["pred_leaf"] = True
    elif cfg.predict_contrib:
        kwargs["pred_contrib"] = True
    else:
        kwargs["raw_score"] = bool(cfg.predict_raw_score)
    out = cfg.output_result or "LightGBM_predict_result.txt"
    if cfg.two_round:
        # memory-bounded streaming predict, like training ingestion
        _predict_file_streaming(booster, cfg.data, cfg, out, **kwargs)
        return
    X = _load_predict_data(cfg.data, cfg)
    pred = np.asarray(booster.predict(X, **kwargs))
    np.savetxt(out, pred, delimiter="\t", fmt=_pred_fmt(pred))
    log_info(f"Finished prediction; results saved to {out}")


def run_refit(params: Dict[str, str]) -> None:
    from .basic import Booster
    from .config import Config
    from .data.file_loader import load_file
    cfg = Config.from_params(params)
    if not cfg.input_model or not cfg.data:
        log_fatal("task=refit requires input_model= and data=")
    booster = Booster(model_file=cfg.input_model,
                      device=config_device(cfg))
    # the refitted booster trains under the task's full config, not
    # library defaults (the reference CLI refits under config_)
    booster.params = {k: v for k, v in params.items()
                      if k not in ("task", "input_model", "output_model",
                                   "data", "config")}
    X, label, _, _, _, _ = load_file(cfg.data, cfg)
    if label is None:
        log_fatal("task=refit requires labels in the data file")
    new_booster = booster.refit(X, label,
                                decay_rate=float(cfg.refit_decay_rate))
    out = cfg.output_model or "LightGBM_model.txt"
    new_booster.save_model(out)
    log_info(f"Finished refit; model saved to {out}")


def run_serve(params: Dict[str, str]) -> None:
    """``task=serve``: load ``input_model`` and serve it over the JSON
    HTTP frontend (serving/http.py) with micro-batching and one CUDA
    graph a (bucket, kind) on the card.

    ``serving_replicas > 1`` or a ``serving_models`` list switches to
    the fleet topology (serving/fleet.py): a replica pool with
    least-loaded dispatch, named models, canary/shadow routing
    (``serving_canary_*`` / ``serving_shadow_model``) and per-tenant
    quotas (``serving_quota_*``) behind the same frontend."""
    from .basic import Booster
    from .config import Config
    from .observability.telemetry import get_telemetry
    from .serving import FleetEngine, ServingConfig, ServingEngine
    from .ops._native import maybe_enable_compile_cache
    from .serving.http import serve_forever
    cfg = Config.from_params(params)
    dev = config_device(cfg)
    get_telemetry().ensure_started(cfg)
    # the frontend serves /metrics on its own port; metrics_port
    # additionally exports on a dedicated port when configured
    from .observability.metrics import maybe_configure, \
        maybe_start_exporter
    maybe_configure(cfg)
    maybe_start_exporter(cfg)
    # compile_cache_dir: where the kernel library is built (the
    # serving route itself is PyTorch, captured as CUDA graphs)
    maybe_enable_compile_cache(cfg)
    fleet_mode = int(cfg.serving_replicas) > 1 or cfg.serving_models
    if not cfg.input_model and not cfg.serving_models:
        log_fatal("task=serve requires input_model=<model file> "
                  "(or serving_models=name=path,...)")
    if fleet_mode:
        models = {}
        if cfg.input_model:
            models["default"] = Booster(model_file=cfg.input_model,
                                        device=dev)
        engine = FleetEngine.from_config(cfg, models=models, device=dev)
    else:
        booster = Booster(model_file=cfg.input_model, device=dev)
        engine = ServingEngine(booster,
                               config=ServingConfig.from_config(cfg),
                               device=dev)
    # SLO burn-rate engine (observability/slo.py): evaluates the
    # configured objectives over the merged (local + federated)
    # metrics for the lifetime of the serve loop; GET /slo and the
    # lgbm_slo_burn gauges expose the evaluations
    from .observability.slo import engine_from_config
    slo = engine_from_config(
        cfg, counts_fn=getattr(engine, "slo_counts", None)).start()
    try:
        serve_forever(engine, cfg.serving_host, int(cfg.serving_port))
    finally:
        slo.stop()


def run_pipeline(params: Dict[str, str]) -> None:
    """``task=pipeline``: the continuous refit-and-promote loop
    (``pipeline/``). Loads ``input_model``
    as the production model, serves it from a fleet replica pool, and
    then — forever (or for ``pipeline_cycles`` cycles) — tails the
    log source for labeled windows, refits a checkpointed candidate,
    publishes it into the fleet registry, ramps it through the
    ``pipeline_canary_stages`` traffic splits with latency/quality/
    parity/flight-recorder watchdogs, and promotes it (or rolls back
    on regression). Preemption-safe: SIGTERM finishes the in-flight
    cycle, drains the fleet, and exits cleanly."""
    from .pipeline import run_pipeline as _run
    _run(params)


def run_convert_model(params: Dict[str, str]) -> None:
    """``task=convert_model``: model text -> standalone C++ if-else
    source (GBDT::ModelToIfElse, gbdt_model_text.cpp:117-299)."""
    from .config import Config
    from .io.codegen import convert_model_file
    cfg = Config.from_params(params)
    if not cfg.input_model:
        log_fatal("task=convert_model requires input_model=<model file>")
    lang = cfg.convert_model_language or "cpp"
    if lang not in ("cpp", "c++"):
        log_fatal(f"convert_model_language={lang} is not supported "
                  "(only cpp)")
    out = cfg.convert_model or "gbdt_prediction.cpp"
    convert_model_file(cfg.input_model, out)
    log_info(f"Finished converting model; source saved to {out}")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    params = parse_cli_params(argv)
    task = params.get("task", "train")
    if task == "train":
        run_train(params)
    elif task in ("predict", "prediction", "test"):
        run_predict(params)
    elif task == "refit":
        run_refit(params)
    elif task == "serve":
        run_serve(params)
    elif task == "pipeline":
        run_pipeline(params)
    elif task == "convert_model":
        run_convert_model(params)
    else:
        log_fatal(f"Unknown task: {task}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
