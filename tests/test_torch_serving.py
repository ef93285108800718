"""The port's in-process serving plane on the CPU, against the JAX
package's (``lightgbm_tpu/serving/``).

Models are trained by the JAX package from numpy seeds (the fixtures of
``tests/test_serving.py`` plus a random forest), carried into the port
by model text (``lt.Booster(model_str=, device="cpu")``) and served by
both engines: the JAX engine on its float64 host loop
(``device="never"``), the port's on the CPU (its programs run eagerly
there). Responses, error codes and statuses, the HTTP frontend's JSON
and the npz interchange are compared; the port's hot reload runs under
concurrent submits. The CUDA graphs are held against the eager walk on
the card in ``tests/test_torch_serving_cuda.py``.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.serving import ServingConfig as JConfig
from lightgbm_tpu.serving import ServingEngine as JEngine
from lightgbm_tpu.serving import save_model_npz as jsave_npz
from lightgbm_tpu.serving.http import make_http_server as jhttp
from lightgbm_tpu_torch.serving import (ModelRegistry, QueueFullError,
                                        ServingConfig, ServingEngine,
                                        ServingError, save_model_npz)
from lightgbm_tpu_torch.serving import loadgen
from lightgbm_tpu_torch.serving.http import make_http_server

KINDS = (("predict", {}), ("raw_score", {"raw_score": True}),
         ("pred_leaf", {"pred_leaf": True}))
WAIT = 30.0


def _toy(n=600, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.5 * X[:, 1] - 0.3 * X[:, 2] > 0).astype(np.float64)
    return X, y


def _carry(jbst):
    return lt.Booster(model_str=jbst.model_to_string(), device="cpu")


@pytest.fixture(scope="module")
def models():
    """name -> (JAX booster, port booster, X)."""
    out = {}
    X, y = _toy()
    out["binary"] = (lgb.train({"objective": "binary", "num_leaves": 7,
                                "verbosity": -1}, lgb.Dataset(X, label=y),
                               num_boost_round=10), X)
    rng = np.random.RandomState(3)
    Xm = rng.randn(450, 5)
    ym = (Xm[:, 0] > 0.4).astype(int) + (Xm[:, 1] > 0).astype(int)
    out["multiclass"] = (lgb.train(
        {"objective": "multiclass", "num_class": 3, "num_leaves": 5,
         "verbosity": -1}, lgb.Dataset(Xm, label=ym.astype(np.float64)),
        num_boost_round=5), Xm)
    rng = np.random.RandomState(5)
    Xr = rng.randn(400, 5)
    yr = Xr[:, 0] * 2.0 - Xr[:, 1] + 0.1 * rng.randn(400)
    out["regression"] = (lgb.train(
        {"objective": "regression", "num_leaves": 7, "verbosity": -1},
        lgb.Dataset(Xr, label=yr), num_boost_round=6), Xr)
    out["rf"] = (lgb.train(
        {"objective": "binary", "boosting": "rf", "bagging_freq": 1,
         "bagging_fraction": 0.8, "num_leaves": 7, "verbosity": -1},
        lgb.Dataset(X, label=y), num_boost_round=5), X)
    out["linear"] = (lgb.train(
        {"objective": "regression", "linear_tree": True, "num_leaves": 5,
         "verbosity": -1}, lgb.Dataset(Xr, label=yr), num_boost_round=4),
        Xr)
    Xc = X.copy()
    Xc[:, 3] = np.random.RandomState(9).randint(0, 12, len(X))
    Xc[::11, 3] = np.nan
    yc = ((Xc[:, 3] % 3 == 0) ^ (Xc[:, 0] > 0)).astype(np.float64)
    out["categorical"] = (lgb.train(
        {"objective": "binary", "num_leaves": 7, "verbosity": -1},
        lgb.Dataset(Xc, label=yc, categorical_feature=[3]),
        num_boost_round=6), Xc)
    return {k: (j, _carry(j), x) for k, (j, x) in out.items()}


def _pair(jsrc, psrc, **cfg):
    """A JAX engine on its host loop and a port engine on the CPU with
    the same settings."""
    jeng = JEngine(jsrc, config=JConfig(device="never", **cfg))
    peng = ServingEngine(psrc, config=ServingConfig(**cfg), device="cpu")
    return jeng, peng


# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["binary", "multiclass", "regression",
                                  "rf", "linear", "categorical"])
def test_responses_equal_the_jax_engine(models, name):
    """predict, raw_score and pred_leaf byte-equal to the JAX engine's
    host route at 1, 7, 16 and 23 rows (23 > the largest bucket:
    chunked 16 + 7), and to the port's Booster.predict."""
    jbst, pbst, X = models[name]
    # the JAX engine serves the same model text (a trained JAX booster
    # converts in float32 through its objective, a text model in
    # float64 as the port does)
    jeng, peng = _pair(jbst.model_to_string(), pbst, buckets=(4, 16),
                       flush_interval_ms=1.0)
    try:
        assert peng.registry.current().device_ready
        for n in (1, 7, 16, 23):
            for kind, kw in KINDS:
                a = peng.predict(X[:n], kind=kind)
                b = jeng.predict(X[:n], kind=kind)
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes(), (name, n, kind)
                assert a.tobytes() == pbst.predict(X[:n], **kw).tobytes()
                c = peng.predict_now(X[:n], kind=kind)
                assert c.tobytes() == b.tobytes()
    finally:
        jeng.stop()
        peng.stop()


def test_text_and_npz_sources_and_interchange(models, tmp_path):
    """Model text, a text file and an npz written by either package
    load in either engine; the port pins every source on its device."""
    jbst, _, X = models["binary"]
    txt = tmp_path / "m.txt"
    jbst.save_model(str(txt))
    jnpz, pnpz = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jsave_npz(jbst, jnpz)
    save_model_npz(lt.Booster(model_file=str(txt), device="cpu"), pnpz)
    ref = lgb.Booster(model_file=str(txt)).predict(X[:9])
    for source in (str(txt), jnpz, pnpz, txt.read_text()):
        jeng, peng = _pair(source, source, buckets=(4, 16),
                           flush_interval_ms=1.0)
        try:
            assert peng.registry.current().device_ready
            assert peng.predict(X[:9]).tobytes() == ref.tobytes()
            assert jeng.predict(X[:9]).tobytes() == ref.tobytes()
        finally:
            jeng.stop()
            peng.stop()


def test_predict_takes_the_pinned_stack(models):
    """``predictor.predict(..., stacked=)`` over a version's pinned stack
    (iterations a view of it) equals the restacking predict."""
    from lightgbm_tpu_torch import predictor
    _, pbst, X = models["multiclass"]
    mv = ModelRegistry(device="cpu").load(pbst)
    for kw in ({}, {"raw_score": True}, {"pred_leaf": True},
               {"num_iteration": 2, "start_iteration": 1},
               {"pred_early_stop": True, "pred_early_stop_freq": 1,
                "pred_early_stop_margin": 0.5}):
        a = predictor.predict(mv.src, X, "cpu", stacked=mv.stacked, **kw)
        b = predictor.predict(mv.src, X, "cpu", **kw)
        assert torch.equal(a, b), kw


def test_registry_version_sequence(models, tmp_path):
    _, pbst, _ = models["binary"]
    reg = ModelRegistry(device="cpu")
    v1 = reg.load(pbst)
    reg.activate(v1)
    assert reg.current().version == 1 and v1.device_ready
    txt = tmp_path / "m.txt"
    pbst.save_model(str(txt))
    v2 = reg.load(str(txt))
    reg.activate(v2)
    assert reg.current().version == 2
    assert v1.draining and not v1.device_ready and not v1.programs


# ----------------------------------------------------------------------
# errors: the same code, HTTP status and details as JAX's
def _raised(fn):
    try:
        fn()
    except ServingError as e:       # the port's
        return e
    except Exception as e:          # noqa: BLE001 - the JAX package's
        if hasattr(e, "code"):
            return e
        raise
    raise AssertionError("no serving error raised")


def _same_error(a, b, code, status):
    assert a.code == b.code == code
    assert a.http_status == b.http_status == status
    assert a.to_dict() == b.to_dict()


def test_request_errors_match(models):
    jbst, pbst, X = models["binary"]
    jeng, peng = _pair(jbst, pbst, buckets=(4,), warmup=False)
    try:
        for rows, kind in ((X[:2, :3], "predict"), ([["a", "b"]], "predict"),
                           (X[:1], "nope"), (np.zeros((0, 6)), "predict")):
            _same_error(_raised(lambda: peng.submit(rows, kind=kind)),
                        _raised(lambda: jeng.submit(rows, kind=kind)),
                        "invalid_request", 400)
    finally:
        jeng.stop()
        peng.stop()


@pytest.mark.parametrize("policy", ["reject_new", "drop_oldest"])
def test_queue_full_matches(models, policy):
    jbst, pbst, X = models["binary"]
    jeng, peng = _pair(jbst, pbst, buckets=(4,), warmup=False, max_queue=2,
                       shed_policy=policy)
    for e in (jeng, peng):
        e._auto_start = False
    try:
        errs, queued = [], []
        for eng in (peng, jeng):
            first = eng.submit(X[:1], timeout_ms=0)
            queued.append(eng.submit(X[1:2], timeout_ms=0))
            if policy == "reject_new":
                errs.append(_raised(lambda: eng.submit(X[2:3])))
            else:
                eng.submit(X[2:3], timeout_ms=0)      # evicts the first
                assert first.done()
                errs.append(_raised(lambda: first.result(timeout=0)))
            assert eng.stats()["shed"] == 1
        _same_error(*errs, "queue_full", 429)
        peng.start()
        assert queued[0].result(timeout=WAIT).tobytes() \
            == pbst.predict(X[1:2]).tobytes()
    finally:
        jeng.stop()
        peng.stop()


def test_flood_past_max_queue_structured(models):
    """10 threads flood a queue of 2 with the flusher off: exactly 2
    queued, 8 structured QueueFullErrors, the queued ones served."""
    _, pbst, X = models["binary"]
    eng = ServingEngine(pbst, config=ServingConfig(
        buckets=(4,), warmup=False, max_queue=2, request_timeout_ms=10000),
        auto_start=False, device="cpu")
    results, lock = [], threading.Lock()

    def submit_one(i):
        try:
            f = eng.submit(X[i:i + 1])
            out = ("ok", f)
        except ServingError as e:
            out = ("shed", e)
        with lock:
            results.append(out)

    threads = [threading.Thread(target=submit_one, args=(i,))
               for i in range(10)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
        ok = [r for s, r in results if s == "ok"]
        shed = [r for s, r in results if s == "shed"]
        assert len(ok) == 2 and len(shed) == 8
        assert all(isinstance(e, QueueFullError) for e in shed)
        eng.start()
        assert all(len(f.result(timeout=WAIT)) == 1 for f in ok)
    finally:
        eng.stop()


def test_timeout_and_stopped_match(models):
    jbst, pbst, X = models["binary"]
    jeng, peng = _pair(jbst, pbst, buckets=(4,), warmup=False,
                       request_timeout_ms=50)
    for e in (jeng, peng):
        e._auto_start = False
    try:
        futs = [e.submit(X[:1]) for e in (peng, jeng)]
        # the caller's own wait runs out first (the flusher is off)
        _same_error(_raised(lambda: futs[0].result(timeout=0.01)),
                    _raised(lambda: futs[1].result(timeout=0.01)),
                    "timeout", 504)
        time.sleep(0.1)                     # every deadline passes
        for e in (peng, jeng):
            e.start()
        _same_error(_raised(lambda: futs[0].result(timeout=WAIT)),
                    _raised(lambda: futs[1].result(timeout=WAIT)),
                    "timeout", 504)
        assert peng.stats()["timeouts"] == jeng.stats()["timeouts"] == 1
    finally:
        jeng.stop()
        peng.stop()
    _same_error(_raised(lambda: peng.submit(X[:1])),
                _raised(lambda: jeng.submit(X[:1])), "engine_stopped", 503)


def _torn_and_mismatched(jbst, tmp_path):
    text = jbst.model_to_string()
    torn = tmp_path / "torn.txt"
    torn.write_text(text[:len(text) // 2])
    stale = tmp_path / "stale.txt"
    stale.write_text(text)
    (tmp_path / "stale.txt.manifest.json").write_text(json.dumps(
        {"files": {"stale.txt": {"bytes": len(text.encode()),
                                 "sha256": "0" * 64}}}))
    short = tmp_path / "short.txt"
    short.write_text(text)
    (tmp_path / "short.txt.manifest.json").write_text(json.dumps(
        {"bytes": len(text.encode()) + 7}))
    return [str(torn), str(stale), str(short), text[:len(text) // 2]]


def test_reload_errors_match_and_keep_serving(models, tmp_path):
    """A torn file, a digest mismatch and a size mismatch against the
    manifest sidecar, and torn model text: the same ModelLoadError in
    both engines; the port's health is degraded and the old version
    keeps serving."""
    jbst, pbst, X = models["binary"]
    jeng, peng = _pair(jbst, pbst, buckets=(4,), flush_interval_ms=1.0)
    try:
        for bad in _torn_and_mismatched(jbst, tmp_path):
            _same_error(_raised(lambda: peng.reload(bad)),
                        _raised(lambda: jeng.reload(bad)),
                        "model_load_error", 400)
            h, jh = peng.health(), jeng.health()
            assert h["status"] == jh["status"] == "degraded"
            assert h["version"] == jh["version"] == 1
            assert set(h) == set(jh)
            assert h["last_reload_error"]["code"] == "model_load_error"
            assert peng.predict(X[:3]).tobytes() \
                == pbst.predict(X[:3]).tobytes()
        assert peng.stats().get("reloads", 0) == 0
        assert peng.reload(pbst) == 2   # a failed load takes no version
        assert peng.health()["status"] == "ok"
    finally:
        jeng.stop()
        peng.stop()


def test_fail_read_fault_lands_on_registry_reads(models, tmp_path):
    from lightgbm_tpu_torch.robustness.faults import set_fault_plan
    jbst, pbst, X = models["binary"]
    path = tmp_path / "m.txt"
    jbst.save_model(str(path))
    eng = ServingEngine(config=ServingConfig(buckets=(4,)), device="cpu")
    try:
        plan = set_fault_plan("fail_read@times=2")
        assert eng.load(str(path)) == 1       # the third read succeeds
        assert sum(ev.fired for ev in plan.events) == 2
        set_fault_plan("fail_read@times=5")
        with pytest.raises(ServingError, match="cannot load model file"):
            eng.load(str(path))
        assert eng.health()["status"] == "degraded"
    finally:
        set_fault_plan(None)
        eng.stop()


# ----------------------------------------------------------------------
def test_hot_reload_concurrent_no_failures(models):
    """Four threads hammer the queue while the model hot-reloads: no
    failed request, every response equal to the direct predict of the
    version that served it, the old version drained."""
    _, pbst1, X = models["binary"]
    jbst2 = lgb.train({"objective": "binary", "num_leaves": 5,
                       "verbosity": -1},
                      lgb.Dataset(X, label=(X[:, 0] > 0).astype(float)),
                      num_boost_round=4)
    pbst2 = _carry(jbst2)
    sizes = [1, 3, 8, 13]
    slices = [X[j % 50:j % 50 + sizes[j % 4]] for j in range(40)]
    refs = {v: {k: [b.predict(s, **kw) for s in slices] for k, kw in KINDS}
            for v, b in ((1, pbst1), (2, pbst2))}
    eng = ServingEngine(pbst1, config=ServingConfig(
        buckets=(4, 16), flush_interval_ms=1.0, request_timeout_ms=30000),
        device="cpu")
    failures, done = [], threading.Event()

    def hammer(tid):
        rng = np.random.RandomState(tid)
        while not done.is_set():
            i = rng.randint(len(slices))
            kind = KINDS[rng.randint(3)][0]
            try:
                fut = eng.submit(slices[i], kind=kind, timeout_ms=30000)
                out = fut.result(timeout=WAIT)
                ref = refs[fut.meta["version"]][kind][i]
                assert out.tobytes() == ref.tobytes()
            except Exception as e:  # noqa: BLE001
                failures.append((tid, kind, repr(e)))
                return

    threads = [threading.Thread(target=hammer, args=(t,), daemon=True)
               for t in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.3)
        assert eng.reload(pbst2) == 2
        time.sleep(0.3)
        done.set()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
        assert not failures, failures[:3]
        hist = eng.registry.versions()
        assert hist[0]["draining"] and hist[0]["inflight"] == 0
        assert not eng.registry._history[0].device_ready
        assert eng.stats()["reloads"] == 1
    finally:
        done.set()
        eng.stop()


def test_loadgen_blocks(models):
    """The closed, open and soak loops against one engine give the JAX
    blocks' keys; the soak's reloads fail nothing; the fleet storms are
    refused with their ROADMAP item."""
    jbst, pbst, X = models["binary"]
    jeng, peng = _pair(jbst, pbst, buckets=(1, 8, 64),
                       flush_interval_ms=1.0)
    from lightgbm_tpu.serving import loadgen as jloadgen
    try:
        p = loadgen.serving_block(peng, X, batch_sizes=(1, 8), threads=2,
                                  duration_s=0.3)
        j = jloadgen.serving_block(jeng, X, batch_sizes=(1, 8), threads=2,
                                   duration_s=0.3)
        assert set(p) == set(j) and p["errors"] == 0 and p["requests"] > 0
        p = loadgen.open_loop(peng, X, qps=100, duration_s=0.3)
        j = jloadgen.open_loop(jeng, X, qps=100, duration_s=0.3)
        assert set(p) == set(j) and p["errors"] == 0
        p = loadgen.soak_loop(peng, X, duration_s=0.8, qps=100,
                              reload_every_s=0.2,
                              reload_sources={"m": pbst})
        assert p["non_shed_errors"] == 0 and p["reloads"] >= 1
        assert p["availability"] == 1.0
        j = jloadgen.soak_loop(jeng, X, duration_s=0.2, qps=50)
        assert set(p) == set(j)
        for kw in ({"replica_storm_every_s": 0.1},
                   {"kill_storm_every_s": 0.1}):
            with pytest.raises(NotImplementedError, match="item 10.2"):
                loadgen.soak_loop(peng, X, duration_s=0.1, **kw)
    finally:
        jeng.stop()
        peng.stop()


def test_serving_config_from_config():
    params = {"serving_buckets": [3, 16], "serving_max_queue": 7,
              "serving_shed_policy": "drop_oldest", "serving_flush_ms": 3.0,
              "serving_device": "always", "serving_aot": False}
    from lightgbm_tpu.config import Config as JCfg
    p = ServingConfig.from_config(lt.Config.from_params(params))
    j = JConfig.from_config(JCfg.from_params(params))
    for key in ("buckets", "max_batch_rows", "max_queue",
                "flush_interval_ms", "request_timeout_ms", "shed_policy",
                "device", "warmup", "fallback_to_host", "aot"):
        assert getattr(p, key) == getattr(j, key), key
    assert p.buckets == (4, 16)
    with pytest.raises(ValueError, match="unknown shed_policy"):
        ServingConfig(shed_policy="lifo")


def test_fallback_is_counted(models, monkeypatch):
    """A device-route failure falls back to the CPU walk when the
    config allows it (counted in fallbacks), and fails the request when
    it does not."""
    from lightgbm_tpu_torch.serving import programs
    _, pbst, X = models["binary"]
    for allow in (True, False):
        eng = ServingEngine(pbst, config=ServingConfig(
            buckets=(4,), warmup=False, flush_interval_ms=1.0,
            fallback_to_host=allow), device="cpu")

        def boom(self, rows):
            raise RuntimeError("injected device failure")
        monkeypatch.setattr(programs.BucketProgram, "run", boom)
        try:
            if allow:
                assert eng.predict(X[:5]).tobytes() \
                    == pbst.predict(X[:5]).tobytes()
                assert eng.stats()["fallbacks"] == 1
            else:
                with pytest.raises(ServingError, match="injected"):
                    eng.predict(X[:5])
                assert eng.stats()["fallbacks"] == 0
        finally:
            monkeypatch.undo()
            eng.stop()


# ----------------------------------------------------------------------
def _serve(engine):
    server = make_http_server(engine, "127.0.0.1", 0) \
        if isinstance(engine, ServingEngine) \
        else jhttp(engine, "127.0.0.1", 0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, t


def _call(port, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            body = r.read()
            status = r.status
    except urllib.error.HTTPError as e:
        body, status = e.read(), e.code
    try:
        return status, json.loads(body)
    except json.JSONDecodeError:
        return status, body.decode()


def test_http_endpoints_match_jax(models, tmp_path):
    from lightgbm_tpu.observability.metrics import MetricsRegistry as JReg
    from lightgbm_tpu.observability.slo import SLOEngine as JSLO
    from lightgbm_tpu.observability.slo import parse_slo_specs as jspecs
    from lightgbm_tpu_torch.observability.metrics import MetricsRegistry
    from lightgbm_tpu_torch.observability.slo import (SLOEngine,
                                                      parse_slo_specs)
    jbst, pbst, X = models["multiclass"]
    txt = tmp_path / "m.txt"
    jbst.save_model(str(txt))
    jeng, peng = _pair(str(txt), str(txt), buckets=(4,),
                       flush_interval_ms=1.0)
    servers = []
    try:
        ports = []
        for eng in (peng, jeng):
            servers.append(_serve(eng))
            ports.append(servers[-1][0].server_address[1])
        calls = [("/predict", {"rows": X[:3].tolist()}),
                 ("/raw_score", {"row": X[0].tolist()}),
                 ("/pred_leaf", {"rows": X[:2].tolist()}),
                 ("/predict", {"rows": X[:2, :3].tolist()}),
                 ("/predict", {"nope": 1}),
                 ("/nope", {"rows": [[0.0]]}),
                 ("/route", {"model": "a", "canary": "b", "weight": 0.5}),
                 ("/reload", {"model_str": "tree\nnot a model"}),
                 ("/reload", {"model_file": str(txt)})]
        for path, body in calls:
            (ps, pb), (js, jb) = (_call(p, path, body) for p in ports)
            assert ps == js, (path, ps, js)
            if path in ("/predict", "/raw_score", "/pred_leaf") \
                    and ps == 200:
                assert pb["predictions"] == jb["predictions"], path
                # trace_id rides along when the package's process-wide
                # tracer is on (an earlier test may have turned it on)
                assert set(pb) - {"trace_id"} == set(jb) - {"trace_id"}
                assert pb["version"] == jb["version"]
                assert pb["kind"] == jb["kind"]
            else:
                assert pb == jb, (path, pb, jb)
        (ps, ph), (js, jh) = (_call(p, "/health") for p in ports)
        assert ps == js == 200 and set(ph) == set(jh)
        for key in ("status", "version", "started", "queue_depth",
                    "buckets"):
            assert ph[key] == jh[key], key
        for p in ports:
            status, text = _call(p, "/metrics")
            assert status == 200 and "serving_request_latency_ms" in text
        # /slo after an SLO engine over each engine's counters evaluated
        specs = ["availability:availability:0.999", "errors:error_rate:0.99"]
        slos = [SLOEngine(parse_slo_specs(specs), ["1m"], peng.stats,
                          registry=MetricsRegistry()),
                JSLO(jspecs(specs), ["1m"], jeng.stats, registry=JReg())]
        for s in slos:
            s.sample(now=100.0)
            s.evaluate(now=130.0)
        (ps, pslo), (js, jslo) = (_call(p, "/slo") for p in ports)
        assert ps == js == 200 and pslo["enabled"] and jslo["enabled"]
        for d in (pslo, jslo):
            d["last"].pop("at")
        assert pslo == jslo
    finally:
        for server, t in servers:
            server.shutdown()
            server.server_close()
            t.join(WAIT)
        jeng.stop()
        peng.stop()
