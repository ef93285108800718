"""The ``task=pipeline`` driver: the long-lived self-updating loop
(port of ``lightgbm_tpu/pipeline/driver.py``).

One cycle (every stage a span on the PR 11 trace timeline and the
current stage a ``lgbm_pipeline_stage{stage}`` gauge on /metrics)::

    ingest   tail the log source for a labeled window (+ a clean
             holdout window from the same stream)
    refit    RefitTrainer: window -> checkpointed candidate
    publish  Publisher: candidate -> fleet registry (atomic reload;
             a rejected publish marks the candidate rejected)
    ramp     RampController: staged canary + watched metrics;
             auto-rollback on regression, else atomic promote
    idle     wait out the cycle interval

The loop is preemption-safe (``robustness/preempt.py``): the first
SIGTERM/SIGINT finishes the in-flight cycle — the candidate is
checkpointed, a mid-ramp candidate is rolled back rather than left in
canary — then the fleet drains and the process exits cleanly; a
second signal escalates. The fleet serves traffic (optionally over
the JSON HTTP frontend) for the entire lifetime of the loop,
including through every publish/ramp/promote: availability is the
loop's core invariant.

The fleet, the trainers and the ramp's parity probe run on ``device``
(the card unless the caller passes ``device="cpu"``, or the params say
``device_type=cpu``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..observability.telemetry import get_telemetry
from ..observability.tracing import get_tracer
from ..ops._native import maybe_enable_compile_cache
from ..utils.device import config_device, resolve_device
from ..utils.log import log_fatal, log_info, log_warning
from .logsource import ReplayLogSource, TailLogSource
from .publisher import Publisher
from .ramp import RampController, RampThresholds, set_stage
from .trainer import RefitTrainer, TenantRefitTrainer


class PipelineDriver:
    """Owns the loop's components; built from ``pipeline_*`` params."""

    def __init__(self, params: Dict[str, Any], fleet=None,
                 source=None, device=None):
        from ..basic import Booster
        from ..config import Config
        from ..serving import FleetEngine
        self.params = dict(params)
        cfg = self.config = Config.from_params(params)
        if device is None:
            device = fleet.device if fleet is not None \
                else config_device(cfg)
        self.device = resolve_device(device)
        tel = get_telemetry()
        tel.ensure_started(cfg)
        get_tracer().ensure_started(cfg)
        from ..observability.metrics import maybe_start_exporter
        maybe_start_exporter(cfg)
        maybe_enable_compile_cache(cfg)
        if cfg.faults:
            from ..robustness.faults import set_fault_plan
            set_fault_plan(cfg.faults)

        if not cfg.input_model:
            log_fatal("task=pipeline requires input_model=<model file> "
                      "(the production model the loop refits)")
        with open(cfg.input_model) as fh:
            model_text = fh.read()
        booster = Booster(model_str=model_text, device=self.device)
        self.n_features = booster.num_feature()
        obj = ""
        for line in model_text.splitlines():
            if line.startswith("objective="):
                obj = line[len("objective="):]
                break

        # per-tenant logical models all start from the production
        # model; each tenant's refit/promote lifecycle then advances
        # its own registry entry independently
        self.tenants = [str(t) for t in (cfg.pipeline_tenants or [])]
        models = {"default": booster}
        for t in self.tenants:
            models.setdefault(t, booster)
        self.fleet = fleet if fleet is not None else \
            FleetEngine.from_config(cfg, models=models,
                                    device=self.device)
        self.model = self.fleet.default_model
        self.publisher = Publisher(self.fleet, model=self.model)
        self.tenant_publishers: Dict[str, Publisher] = {}
        self.tenant_trainer = None
        if self.tenants:
            for t in self.tenants:
                if not self.fleet.fleet.has(t):
                    self.fleet.load_model(t, model_text)
            self.tenant_publishers = {
                t: Publisher(self.fleet, model=t) for t in self.tenants}
            self.tenant_trainer = TenantRefitTrainer(
                self.tenants, params=self.params,
                num_boost_round=int(cfg.pipeline_continue_iters),
                objective=obj.split(" ")[0] if obj else "",
                checkpoint_dir=cfg.pipeline_dir,
                checkpoint_keep=int(cfg.checkpoint_keep),
                device=self.device)
        self.trainer = RefitTrainer(
            model_text, params=self.params,
            mode=cfg.pipeline_mode,
            decay=float(cfg.refit_decay_rate),
            continue_iters=int(cfg.pipeline_continue_iters),
            checkpoint_dir=cfg.pipeline_dir,
            checkpoint_keep=int(cfg.checkpoint_keep),
            device=self.device)
        # SLO engine (observability/slo.py): burn rates over the
        # fleet's merged counters/histograms — including every
        # federated worker shard in process isolation — evaluated in
        # the background for the lifetime of the loop and gating ramp
        # stages when pipeline_max_slo_burn arms the gate
        from ..observability.slo import engine_from_config
        self.slo = engine_from_config(
            cfg, counts_fn=self.fleet.slo_counts).start()
        max_burn = float(getattr(cfg, "pipeline_max_slo_burn", 0.0)
                         or 0.0)
        self.ramp = RampController(
            self.publisher,
            stages=list(cfg.pipeline_canary_stages)
            or [0.05, 0.25, 0.5],
            stage_requests=int(cfg.pipeline_stage_requests),
            thresholds=RampThresholds(
                latency_regression_pct=float(
                    cfg.pipeline_latency_slo_pct),
                quality_drop=float(cfg.pipeline_quality_drop),
                max_slo_burn=max_burn),
            slo_fn=self.slo.max_burn)
        if source is not None:
            self.source = source
        elif cfg.pipeline_source == "tail":
            if not cfg.pipeline_log_path:
                log_fatal("pipeline_source=tail requires "
                          "pipeline_log_path=<jsonl file>")
            self.source = TailLogSource(cfg.pipeline_log_path,
                                        self.n_features)
        else:
            self.source = ReplayLogSource(
                n_features=self.n_features,
                seed=int(cfg.pipeline_replay_seed),
                noise=float(cfg.pipeline_replay_noise),
                task="binary" if obj.startswith(
                    ("binary", "xentropy", "cross_entropy"))
                else "regression")
        self.window_rows = int(cfg.pipeline_window_rows)
        self.holdout_rows = int(cfg.pipeline_holdout_rows)
        self.interval_s = float(cfg.pipeline_interval_s)
        self.history: List[Dict[str, Any]] = []
        self._http_server = None
        self._http_thread: Optional[threading.Thread] = None
        if cfg.pipeline_serve_http:
            self._start_http(cfg)

    def _start_http(self, cfg) -> None:
        from ..serving.http import make_http_server
        self._http_server = make_http_server(
            self.fleet, cfg.serving_host, int(cfg.serving_port))
        self._http_thread = threading.Thread(
            target=self._http_server.serve_forever,
            name="lgbm-pipeline-http", daemon=True)
        self._http_thread.start()
        addr = self._http_server.server_address
        log_info(f"pipeline: serving on http://{addr[0]}:{addr[1]} "
                 "for the lifetime of the loop")

    # ------------------------------------------------------------------
    def run(self, max_cycles: Optional[int] = None,
            stop_fleet: bool = True) -> Dict[str, Any]:
        """The loop: run ``max_cycles`` cycles (None/0 = until
        preempted). Returns a summary of every cycle.
        ``stop_fleet=False`` leaves the fleet serving afterward (the
        drill asserts availability on the live pool; call ``stop()``
        when done)."""
        from ..robustness.preempt import PreemptionGuard
        tel = get_telemetry()
        cycles = 0
        promoted = 0
        rolled_back = 0
        t0 = time.monotonic()
        with PreemptionGuard() as guard:
            while not guard.requested:
                if max_cycles and cycles >= max_cycles:
                    break
                rec = self._cycle(cycles, guard)
                self.history.append(rec)
                cycles += 1
                if rec.get("promoted"):
                    promoted += 1
                elif rec.get("status") in ("rolled_back", "rejected"):
                    rolled_back += 1
                if guard.requested or (max_cycles
                                       and cycles >= max_cycles):
                    break
                set_stage("idle")
                if self.interval_s > 0:
                    deadline = time.monotonic() + self.interval_s
                    while time.monotonic() < deadline \
                            and not guard.requested:
                        time.sleep(min(
                            0.05, max(deadline - time.monotonic(), 0)))
            preempted = guard.requested
        set_stage("stopped")
        self.slo.evaluate()     # final sample before the report
        slo_report = self.slo.report()
        summary = {
            "cycles": cycles, "promoted": promoted,
            "rolled_back": rolled_back, "preempted": preempted,
            "duration_s": round(time.monotonic() - t0, 3),
            "model": self.model,
            "primary": self.publisher.primary_name(),
            "history": list(self.history),
            "slo": slo_report,
        }
        if self.tenants:
            summary["tenants"] = {
                t: {"promoted": sum(
                    1 for r in self.history
                    if (r.get("tenants") or {}).get(t, {}).get(
                        "promoted")),
                    "primary": self.tenant_publishers[t].primary_name()}
                for t in self.tenants}
        tel.record("pipeline_summary", **{
            k: v for k, v in summary.items()
            if isinstance(v, (int, float, str, bool))})
        tel.record("slo_report",
                   max_burn=(slo_report.get("last") or {}).get(
                       "max_burn") if slo_report else None,
                   specs=len(self.slo.specs))
        if stop_fleet or preempted:
            self.stop()
        return summary

    # ------------------------------------------------------------------
    def _cycle(self, index: int, guard=None) -> Dict[str, Any]:
        if self.tenants:
            return self._cycle_tenants(index, guard)
        tel = get_telemetry()
        tracer = get_tracer()
        rec: Dict[str, Any] = {"cycle": index}
        with tracer.span("pipeline.cycle", cat="pipeline",
                         args={"cycle": index}):
            set_stage("ingest")
            with tel.span("pipeline.ingest"):
                window = self.source.next_window(self.window_rows)
                holdout_w = None
                if window is not None:
                    holdout_w = self.source.next_window(
                        self.holdout_rows)
            if window is None or holdout_w is None:
                rec["status"] = "no_data"
                tel.count("pipeline.empty_windows")
                return rec
            rec["window"] = window.describe()

            set_stage("refit")
            try:
                cand = self.trainer.refit(window)
            except Exception as e:
                # a failed refit (bad labels, guard trip) skips the
                # cycle; the production model keeps serving untouched
                log_warning(f"pipeline: refit failed for window "
                            f"{window.index}: {e}")
                tel.count("pipeline.refit_failures")
                rec["status"] = "refit_failed"
                rec["error"] = str(e)[:256]
                return rec
            rec["candidate"] = cand.cid

            set_stage("publish")
            name = self.publisher.publish(cand)
            if name is None:
                rec["status"] = cand.status          # rejected
                rec["reason"] = cand.reason
                return rec

            # a preemption that landed during refit/publish: do not
            # START a ramp we cannot finish — the candidate stays
            # published-but-unrouted and the next run ramps fresh
            if guard is not None and guard.requested:
                rec["status"] = "preempted_before_ramp"
                return rec

            promoted = self.ramp.ramp(cand,
                                      (holdout_w.X, holdout_w.y))
            if promoted:
                self.trainer.note_promoted(cand)
            rec["promoted"] = bool(promoted)
            rec["status"] = cand.status
            rec["reason"] = cand.reason
            rec["model_text_sha"] = _sha16(cand.model_text)
            rec["stages"] = [
                {"stage": m.stage, "weight": m.weight,
                 "decision": v.decision, "reasons": v.reasons,
                 "slo_burn": m.slo_burn}
                for m, v in self.ramp.verdicts]
            tel.record("pipeline_cycle", cycle=index,
                       candidate=cand.cid, status=cand.status,
                       promoted=bool(promoted),
                       window=window.index, rows=window.rows)
        return rec

    # ------------------------------------------------------------------
    def _cycle_tenants(self, index: int, guard=None) -> Dict[str, Any]:
        """One refit-and-promote cycle PER TENANT over one shared
        window: admit each tenant's row slice against its byte quota,
        train every admitted tenant's candidate as ONE multiboost
        batch, then publish + quality-gate + promote/rollback each
        tenant's candidate against its own registry entry. Emits a
        per-tenant stage timeline (``rec["timeline"]``) rendered by
        tools/run_report.py."""
        from ..serving.errors import QuotaExceededError
        tel = get_telemetry()
        tracer = get_tracer()
        rec: Dict[str, Any] = {"cycle": index, "tenants": {}}
        timeline: List[Dict[str, Any]] = []
        t_cycle0 = time.monotonic()

        def mark(tenant: str, stage: str, t0: float) -> None:
            timeline.append({
                "tenant": tenant, "stage": stage,
                "start_s": round(t0 - t_cycle0, 6),
                "dur_s": round(time.monotonic() - t0, 6)})

        with tracer.span("pipeline.cycle", cat="pipeline",
                         args={"cycle": index,
                               "tenants": len(self.tenants)}):
            set_stage("ingest")
            with tel.span("pipeline.ingest"):
                window = self.source.next_window(self.window_rows)
                holdout_w = None
                if window is not None:
                    holdout_w = self.source.next_window(
                        self.holdout_rows)
            if window is None or holdout_w is None:
                rec["status"] = "no_data"
                tel.count("pipeline.empty_windows")
                return rec
            rec["window"] = window.describe()
            parts = self.tenant_trainer.partition(window.rows)
            hold_parts = self.tenant_trainer.partition(holdout_w.rows)

            # admission: each tenant's refit is charged its window
            # slice's decoded f64 bytes BEFORE any training happens —
            # a throttled tenant skips this cycle, the others proceed
            admitted: List[str] = []
            for t in self.tenants:
                nbytes = int(parts[t].size) * (self.n_features + 1) * 8
                t0 = time.monotonic()
                trec: Dict[str, Any] = {
                    "window_rows": int(parts[t].size)}
                try:
                    self.fleet.charge_tenant_bytes(t, nbytes)
                    admitted.append(t)
                    trec["status"] = "admitted"
                    trec["charged_bytes"] = nbytes
                except QuotaExceededError as e:
                    trec["status"] = "quota_exceeded"
                    trec["reason"] = str(e)[:128]
                    trec["charged_bytes"] = 0
                    tel.count("pipeline.tenant_quota_denials")
                    log_warning(f"pipeline: tenant {t!r} throttled "
                                f"for cycle {index}: {e}")
                rec["tenants"][t] = trec
                mark(t, "admit", t0)
            if not admitted:
                rec["status"] = "all_tenants_throttled"
                rec["timeline"] = timeline
                return rec

            set_stage("refit")
            t0 = time.monotonic()
            try:
                cands = self.tenant_trainer.refit_all(window, admitted)
            except Exception as e:
                log_warning(f"pipeline: tenant refit failed for "
                            f"window {window.index}: {e}")
                tel.count("pipeline.refit_failures")
                rec["status"] = "refit_failed"
                rec["error"] = str(e)[:256]
                rec["timeline"] = timeline
                return rec
            # ONE batched refit covers every admitted tenant: the
            # shared span lands on each tenant's timeline row
            for t in admitted:
                mark(t, "refit", t0)
            report = self.tenant_trainer.last_report or {}
            rec["refit_report"] = {
                k: report.get(k) for k in
                ("models", "buckets", "loop_fallback",
                 "batched_models", "batched_seconds")}

            promoted_n = 0
            for t in admitted:
                cand = cands[t]
                pub = self.tenant_publishers[t]
                trec = rec["tenants"][t]
                trec["candidate"] = cand.cid
                set_stage("publish")
                t0 = time.monotonic()
                name = pub.publish(cand)
                mark(t, "publish", t0)
                if name is None:
                    trec["status"] = cand.status     # rejected
                    trec["reason"] = cand.reason
                    continue
                if guard is not None and guard.requested:
                    trec["status"] = "preempted_before_ramp"
                    continue
                set_stage("ramp")
                t0 = time.monotonic()
                hidx = hold_parts[t]
                ok = self._tenant_gate(pub, cand, holdout_w.X[hidx],
                                       holdout_w.y[hidx])
                mark(t, "ramp", t0)
                trec["status"] = cand.status
                trec["reason"] = cand.reason
                trec["promoted"] = ok
                trec["model_text_sha"] = _sha16(cand.model_text)
                if ok:
                    promoted_n += 1
                tel.record("pipeline_tenant_cycle", cycle=index,
                           tenant=t, candidate=cand.cid,
                           status=cand.status, promoted=ok,
                           window=window.index,
                           rows=int(parts[t].size))
            rec["status"] = "tenants"
            rec["promoted"] = promoted_n > 0
            rec["promoted_tenants"] = promoted_n
            rec["timeline"] = timeline
        return rec

    def _tenant_gate(self, pub: Publisher, cand, Xh, yh) -> bool:
        """Single-stage quality gate for one tenant's candidate: score
        candidate vs current primary on the tenant's OWN holdout slice
        (``ramp.default_quality``), promote unless the drop exceeds
        ``pipeline_quality_drop``, roll back otherwise. The full
        staged-canary RampController stays the single-model path's
        gate; T tenants x S stages x stage_requests live requests per
        cycle would swamp the loop."""
        from .ramp import default_quality
        # the promote below flips the CANARY rule to primary, so the
        # candidate must hold the canary slot while it is gated
        pub.start_canary(cand, 1.0)
        if len(yh) == 0:
            pub.promote(cand)
            return True
        try:
            cq = default_quality(
                self.fleet.predict(Xh, model=cand.name), yh)
            pq = default_quality(
                self.fleet.predict(Xh, model=pub.primary_name()), yh)
        except Exception as e:
            pub.rollback(cand, f"quality_probe_failed: {e}")
            return False
        drop = pq - cq
        if drop > float(self.config.pipeline_quality_drop):
            pub.rollback(cand, f"quality_drop:{drop:.6g} (> "
                         f"{float(self.config.pipeline_quality_drop):g})")
            return False
        pub.promote(cand)
        return True

    # ------------------------------------------------------------------
    def stop(self) -> None:
        self.slo.stop()
        if self._http_server is not None:
            try:
                self._http_server.shutdown()
                self._http_server.server_close()
            except Exception:
                pass
            self._http_server = None
        self.fleet.stop()
        get_telemetry().flush()
        get_tracer().flush()


def _sha16(text: str) -> str:
    import hashlib
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def run_pipeline(params: Dict[str, Any]) -> Dict[str, Any]:
    """CLI entry (``task=pipeline``; the card unless ``device_type=cpu``)."""
    driver = PipelineDriver(params)
    cfg = driver.config
    summary = driver.run(max_cycles=int(cfg.pipeline_cycles) or None)
    if summary["preempted"]:
        log_info("pipeline: preempted — in-flight cycle finished, "
                 "fleet drained; rerun the same command to continue "
                 f"from the promoted model ({summary['primary']!r})")
    log_info(f"pipeline: {summary['cycles']} cycles, "
             f"{summary['promoted']} promoted, "
             f"{summary['rolled_back']} rolled back; primary is "
             f"{summary['primary']!r}")
    return summary


__all__ = ["PipelineDriver", "run_pipeline"]
