"""The port's observability plane (``lightgbm_tpu_torch/observability/``)
against the JAX package's on the CPU.

Held against a JAX run of the same params: the JSONL record kinds and
the keys of the ``iter`` / ``eval`` / ``train_end`` / ``phase_probe``
records (docs/Observability.md; the port's ``iter`` counts add
``launch.<kernel>``, the kernel launches, all 0 here: the plain versions
launch nothing), the span names of the Chrome trace, the flight
recorder's dump keys, and ``metrics_text()`` after the same
observations (equal text). ``tools/run_report.py`` (stdlib only) renders
the port's JSONL, trace and crash dump. The probe's phases, the
profiler window's torch trace and ``record_telemetry`` are the port's
own. Every test resets the telemetry, tracer, metrics and fault plan of
both packages.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.observability import metrics as jmetrics
from lightgbm_tpu.observability.telemetry import get_telemetry as jtel
from lightgbm_tpu.observability.tracing import get_tracer as jtracer
from lightgbm_tpu.robustness import faults as jfaults
from lightgbm_tpu_torch.observability import metrics
from lightgbm_tpu_torch.observability.telemetry import get_telemetry
from lightgbm_tpu_torch.observability.tracing import get_tracer
from lightgbm_tpu_torch.ops import _native
from lightgbm_tpu_torch.robustness import faults

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 3
BASE = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
        "min_data_in_leaf": 10}
LAUNCH_KEYS = {f"launch.{k}" for k in
               list(_native.LAUNCHES) + list(_native.ROUTE_LAUNCHES)}


def _reset():
    for mod in (faults, jfaults):
        mod.set_fault_plan(None)
    for tel in (get_telemetry(), jtel()):
        tel.reset()
    for tr in (get_tracer(), jtracer()):
        tr.reset()
    for reg in (metrics.get_metrics(), jmetrics.get_metrics()):
        reg.reset()


@pytest.fixture(autouse=True)
def _clean_planes():
    _reset()
    yield
    _reset()


def _data(n=1000, f=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.4 * rng.randn(n) > 0).astype(float)
    return X, y


def _run_both(tmp_path, extra=None, rounds=ROUNDS):
    """The same params through both packages with a valid set, each
    writing its JSONL and trace under ``tmp_path``; returns the records
    and the trace events of each."""
    X, y = _data()
    Xv, yv = _data(300, seed=1)
    out = {}
    for name, pkg, kw in (("jax", lgb, {}), ("port", lt, {"device": "cpu"})):
        _reset()
        p = dict(BASE, telemetry_out=str(tmp_path / f"{name}.jsonl"),
                 trace_out=str(tmp_path / f"{name}.trace.json"),
                 **(extra or {}))
        ds = pkg.Dataset(X, label=y)
        pkg.train(p, ds, rounds, valid_sets=[ds.create_valid(Xv, label=yv)],
                  verbose_eval=False, **kw)
        (jtel() if name == "jax" else get_telemetry()).flush()
        with open(tmp_path / f"{name}.jsonl") as fh:
            recs = [json.loads(line) for line in fh]
        with open(tmp_path / f"{name}.trace.json") as fh:
            events = json.load(fh)["traceEvents"]
        out[name] = (recs, events)
    return out


def test_record_kinds_and_keys_match_jax(tmp_path):
    out = _run_both(tmp_path)
    (jr, _), (pr, _) = out["jax"], out["port"]
    # the JAX package's jit compiles are its own record kind; the port's
    # one build is train_end's ``compile``
    assert {r["kind"] for r in jr} - {"compile"} == {r["kind"] for r in pr}
    for kind in ("iter", "eval", "train_end", "phase_probe"):
        jk = [r for r in jr if r["kind"] == kind]
        pk = [r for r in pr if r["kind"] == kind]
        assert len(jk) == len(pk) > 0, kind
        assert [set(r) for r in jk] == [set(r) for r in pk], kind
    for a, b in zip([r for r in jr if r["kind"] == "iter"],
                    [r for r in pr if r["kind"] == "iter"]):
        assert a["iter"] == b["iter"] and set(a["phases"]) == set(
            b["phases"])
        assert set(b["counts"]) == set(a["counts"]) | LAUNCH_KEYS
        assert all(b["counts"][k] == 0.0 for k in LAUNCH_KEYS)
        assert b["counts"]["host.syncs"] >= 1
    for a, b in zip([r for r in jr if r["kind"] == "eval"],
                    [r for r in pr if r["kind"] == "eval"]):
        assert [x[:2] + x[3:] for x in a["results"]] \
            == [x[:2] + x[3:] for x in b["results"]]
    (je,), (pe,) = ([r for r in rs if r["kind"] == "train_end"]
                    for rs in (jr, pr))
    assert set(je["compile"]) == set(pe["compile"])
    assert set(je["phase_totals"]) == set(pe["phase_totals"])
    (jp,), (pp,) = ([r for r in rs if r["kind"] == "phase_probe"]
                    for rs in (jr, pr))
    assert set(jp["phases"]) == set(pp["phases"]) == {
        "grad", "update", "hist", "partition", "split"}
    assert all(v >= 0.0 for v in pp["phases"].values())
    assert pp["learner"] == "PartitionedTreeLearner"
    (rs,) = [r for r in pr if r["kind"] == "run_start"]
    assert {"torch_version", "backend", "device_count",
            "config"} <= set(rs)


def test_trace_span_names_match_jax(tmp_path):
    out = _run_both(tmp_path)

    def spans(events):
        return {e["name"] for e in events if e.get("ph") == "X"}
    assert spans(out["port"][1]) == spans(out["jax"][1]) == {
        "boosting", "grad", "grow", "tree", "update", "eval"}
    for e in out["port"][1]:
        if e.get("ph") == "X":
            assert {"trace_id", "span_id"} <= set(e["args"])


def test_checkpoint_span_and_counters_match_jax(tmp_path):
    out = _run_both(tmp_path, {"checkpoint_dir": str(tmp_path / "ck"),
                               "checkpoint_freq": 1})
    (jr, je), (pr, pe) = out["jax"], out["port"]
    assert "checkpoint.write" in {e["name"] for e in pe if e.get("ph") == "X"}
    jc = [r for r in jr if r["kind"] == "train_end"][0]["counters"]
    pc = [r for r in pr if r["kind"] == "train_end"][0]["counters"]
    for k in ("checkpoint.writes", "train.rows", "data.rows_binned"):
        assert pc[k] == jc[k], k


def _run_report(path, *flags):
    return subprocess.run([sys.executable, "tools/run_report.py", str(path),
                           *flags], cwd=REPO, capture_output=True, text=True,
                          timeout=60)


def test_run_report_renders_the_port_files(tmp_path):
    X, y = _data()
    p = dict(BASE, telemetry_out=str(tmp_path / "t.jsonl"),
             trace_out=str(tmp_path / "trace.json"),
             guard_policy="raise", faults="nan_grad@iteration=2")
    with pytest.raises(lt.robustness.NonFiniteGradientError):
        lt.train(p, lt.Dataset(X, label=y), 4, device="cpu")
    get_telemetry().flush()
    crash = tmp_path / "t.jsonl.crash.json"
    for path in (tmp_path / "t.jsonl", tmp_path / "trace.json", crash):
        r = _run_report(path, "--json")
        assert r.returncode == 0, r.stderr
        json.loads(r.stdout)
        r = _run_report(path)
        assert r.returncode == 0 and r.stdout, r.stderr
    d = json.loads(_run_report(crash, "--json").stdout)
    assert d["reason"] == "exception" and d["iteration"] == 1
    assert d["exception"]["type"] == "NonFiniteGradientError"
    digest = json.loads(_run_report(tmp_path / "t.jsonl", "--json").stdout)
    assert "host.dispatches" in digest["iter_counts"]
    assert "launch.fused_split_step_segment" in digest["iter_counts"]


def test_record_telemetry():
    X, y = _data()
    res = {}
    lt.train(BASE, lt.Dataset(X, label=y), ROUNDS, device="cpu",
             callbacks=[lt.callback.record_telemetry(res)])
    assert [r["iteration"] for r in res["iterations"]] == list(range(ROUNDS))
    for r in res["iterations"]:
        assert set(r["phases"]) == {"grad", "grow", "tree", "update"}
        assert LAUNCH_KEYS <= set(r["counts"])
    assert set(res["summary"]) == {"counters", "compile", "phase_totals"}
    assert res["summary"]["counters"]["train.rows"] == len(y)
    with pytest.raises(TypeError):
        lt.callback.record_telemetry([])


def _observe(reg):
    reg.include_memory = False
    for i, v in enumerate([0.001, 0.02, 0.0003, 1.5, 0.02, 7e-6, 33.0]):
        reg.observe("train_phase_seconds", v,
                    labels={"phase": ("grad", "grow", "update")[i % 3]})
        reg.observe("serving_request_seconds", v * 2,
                    labels={"bucket": str(i % 2)})
        reg.exemplar_max("serving_request_seconds", v * 2,
                         labels={"trace_id": f"{i:016x}"})
    reg.set_gauge("fleet_replicas", 3, labels={"model": "m"})
    reg.register_collector(lambda: {"queue_depth": 4, "shed": 1})
    reg.merge_snapshot("w1", {"hists": [
        {"n": "train_phase_seconds", "l": {"phase": "grad"},
         "c": [1] + [0] * 10, "t": 1, "s": 0.5}],
        "gauges": [{"n": "rss", "v": 10.0}], "counters": {"x": 2.0}})


def test_metrics_text_matches_jax():
    for reg in (metrics.get_metrics(), jmetrics.get_metrics()):
        _observe(reg)
    # every line but the federated shard's age (wall clock since merge)
    def lines(text):
        return [ln for ln in text.splitlines()
                if not ln.startswith("lgbm_worker_snapshot_age_seconds{")]
    text = metrics.metrics_text()
    assert lines(text) == lines(jmetrics.metrics_text())
    assert len(lines(text)) == len(text.splitlines()) - 1
    assert "lgbm_train_phase_seconds_bucket" in text
    assert metrics.hist_layout("train_phase_seconds") \
        == jmetrics.hist_layout("train_phase_seconds")


def test_end_iteration_feeds_the_phase_histogram():
    X, y = _data()
    get_telemetry().ensure_ring()
    lt.train(BASE, lt.Dataset(X, label=y), ROUNDS, device="cpu",
             callbacks=[lt.callback.record_telemetry({})])
    snaps = {s["labels"]["phase"]: s for s in metrics.get_metrics()
             .snapshots("train_phase_seconds")}
    assert set(snaps) == {"grad", "grow", "tree", "update"}
    assert all(s["count"] == ROUNDS for s in snaps.values())


@pytest.mark.parametrize("trip", ["exception", "guard"])
def test_flight_recorder_dumps(tmp_path, trip):
    from lightgbm_tpu.observability import slo as jslo
    from lightgbm_tpu_torch.observability import slo as pslo
    X, y = _data()
    out = {}
    for name, pkg, kw, slo in (
            ("jax", lgb, {"verbose_eval": False}, jslo),
            ("port", lt, {"device": "cpu"}, pslo)):
        _reset()
        # an SLO engine has evaluated: the dump carries its section
        slo.SLOEngine(slo.parse_slo_specs(["a:availability:0.99"]),
                      counts_fn=lambda: {"requests": 3}).evaluate(now=1.0)
        path = tmp_path / f"{name}.crash.json"
        p = dict(BASE, crash_dump=str(path),
                 faults="nan_grad@iteration=1",
                 guard_policy="raise" if trip == "exception"
                 else "skip_iter")
        if trip == "exception":
            with pytest.raises(Exception, match="non-finite"):
                pkg.train(p, pkg.Dataset(X, label=y), ROUNDS, **kw)
        else:
            pkg.train(p, pkg.Dataset(X, label=y), ROUNDS, **kw)
        with open(path) as fh:
            out[name] = json.load(fh)
    j, p = out["jax"], out["port"]
    assert set(p) == set(j) and "slo" in p
    for d in (j, p):
        d["slo"].pop("at")
    assert p["slo"] == j["slo"]
    assert p["reason"] == j["reason"] == (
        "exception" if trip == "exception" else "guard:nonfinite")
    assert [t["kind"] for t in p["trips"]] == [t["kind"] for t in j["trips"]]
    assert p["config_fingerprint"] and p["bin_layout_fingerprint"]
    assert p["memory"] == {}      # no device memory on the CPU


def test_profile_window_writes_a_torch_trace(tmp_path, monkeypatch):
    from lightgbm_tpu_torch.observability import tracing
    monkeypatch.setattr(tracing, "_PROFILE", tracing.ProfileWindow())
    monkeypatch.setenv("LGBM_TPU_PROFILE_SPANS", "2")
    X, y = _data()
    lt.train(dict(BASE, profile_dir=str(tmp_path / "prof")),
             lt.Dataset(X, label=y), 5, device="cpu")
    w = tracing.profile_window()
    assert w.state == "done" and os.path.exists(w.trace_path)
    with open(w.trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


@pytest.mark.parametrize("case", ["partitioned", "serial", "bundled"])
def test_probe_phases_on_the_cpu(case):
    from lightgbm_tpu_torch.observability.probe import run_phase_probe
    X, y = _data(n=2000)
    p = dict(BASE)
    if case == "serial":
        X = np.round(X * 300) / 300     # > 600 distinct values a feature
        p["max_bin"] = 600
    if case == "bundled":
        X = np.zeros((2000, 6))
        X[np.arange(2000), np.arange(2000) % 6] = 1.0 + np.arange(2000) % 3
        y = (np.arange(2000) % 6 < 3).astype(float)
    bst = lt.train(p, lt.Dataset(X, label=y), 2, device="cpu")
    ph = run_phase_probe(bst._gbdt)
    if case == "bundled":
        assert bst._gbdt.learner.bundled and ph is None
        return
    assert set(ph) == {"grad", "update", "hist", "partition", "split"}
    assert all(v >= 0.0 for v in ph.values())
    assert type(bst._gbdt.learner).__name__ == (
        "SerialTreeLearner" if case == "serial" else "PartitionedTreeLearner")
    # the probe leaves the trained model and the learner's rows alone
    before = bst.model_to_string()
    ph = run_phase_probe(bst._gbdt)
    assert bst.model_to_string() == before


def test_multiboost_telemetry(tmp_path):
    X, y = _data()
    p = dict(BASE, telemetry_out=str(tmp_path / "mb.jsonl"))
    boosters, report = lt.engine.train_many(
        [dict(p, learning_rate=lr) for lr in (0.1, 0.2)],
        lt.Dataset(X, label=y), 2, return_report=True, device="cpu")
    get_telemetry().flush()
    c = get_telemetry().counters
    assert c["multiboost.batches"] == 1 and c["multiboost.models"] == 2
    with open(tmp_path / "mb.jsonl") as fh:
        recs = [json.loads(line) for line in fh]
    (mb,) = [r for r in recs if r["kind"] == "multiboost_report"]
    assert mb["models"] == 2 and mb["batched_models"] == 2
    assert report["batched_models"] == 2
