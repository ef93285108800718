"""The port's thread fleet on the CPU, against the JAX package's
(``lightgbm_tpu/serving/fleet.py``).

Models are trained by the JAX package on ``tests/test_fleet.py``'s
``_toy`` data and given to both packages as the same model texts. The
JAX fleet serves them on its float64 host route (``device="never"``),
the port's on the CPU (its programs run eagerly there). One request
sequence goes through both: mixed sizes and every kind, a hot reload, a
canary at 0.25 and at 1.0, ``promote_canary``; the responses are held
byte for byte and the canary assignment request by request. Shadow
mirroring, quota sheds, admission, drain and the HTTP frontend are held
against the JAX fleet's counters, error payloads and JSON; replica death
and the soak's storms against the port's own ``Booster.predict``. The
process fleet is in ``tests/test_torch_procfleet.py``, the card's
fleets in ``tests/test_torch_serving_cuda.py``.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.serving import FleetEngine as JFleet
from lightgbm_tpu.serving import ServingConfig as JConfig
from lightgbm_tpu.serving import TenantQuotas as JQuotas
from lightgbm_tpu.serving.http import make_http_server as jhttp
from lightgbm_tpu_torch.serving import (FleetEngine, ModelNotFoundError,
                                        QueueFullError, QuotaExceededError,
                                        ReplicaUnavailableError,
                                        ServingConfig, TenantQuotas)
from lightgbm_tpu_torch.serving.http import make_http_server

KINDS = (("predict", {}), ("raw_score", {"raw_score": True}),
         ("pred_leaf", {"pred_leaf": True}))
WAIT = 30.0


@pytest.fixture(scope="module", autouse=True)
def _lock_order_guarded():
    # every lock the fleets under test create is instrumented; a
    # lock-order inversion fails the module outright
    if os.environ.get("LGBM_SYNC_GUARDS", "1") == "0":
        yield
        return
    from tools.graftsync.runtime import lock_order_guard
    with lock_order_guard():
        yield


def _toy(n=500, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.5 * X[:, 1] - 0.3 * X[:, 2] > 0).astype(np.float64)
    return X, y


@pytest.fixture(scope="module")
def texts():
    """name -> model text (trained by the JAX package), and X."""
    X, y = _toy()
    alpha = lgb.train({"objective": "binary", "num_leaves": 7,
                       "verbosity": -1}, lgb.Dataset(X, label=y),
                      num_boost_round=8)
    beta = lgb.train({"objective": "binary", "num_leaves": 5,
                      "verbosity": -1},
                     lgb.Dataset(X, label=(X[:, 1] > 0).astype(float)),
                     num_boost_round=5)
    X2, y2 = _toy(seed=9)
    gamma = lgb.train({"objective": "binary", "num_leaves": 9,
                       "verbosity": -1}, lgb.Dataset(X2, label=y2),
                      num_boost_round=6)
    return {"alpha": alpha.model_to_string(),
            "beta": beta.model_to_string(),
            "gamma": gamma.model_to_string()}, X


def _ref(text):
    return lt.Booster(model_str=text, device="cpu")


def _pair(models, replicas=2, default="alpha", quotas=None, jkw=None,
          pkw=None, **cfg):
    """A JAX fleet on its host route and a port fleet on the CPU with
    the same settings (``quotas`` builds each its own TenantQuotas)."""
    cfg.setdefault("buckets", (4, 16))
    cfg.setdefault("flush_interval_ms", 1.0)
    jf = JFleet(models=models, config=JConfig(device="never", **cfg),
                replicas=replicas, default_model=default,
                quotas=None if quotas is None else quotas(JQuotas),
                **(jkw or {}))
    pf = FleetEngine(models=models, config=ServingConfig(**cfg),
                     replicas=replicas, default_model=default,
                     quotas=None if quotas is None else quotas(TenantQuotas),
                     device="cpu", **(pkw or {}))
    return jf, pf


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    return a.tobytes() == b.tobytes()


def _wait_counter(fl, name, value, timeout=10.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if fl.stats().get(name, 0) >= value:
            return True
        time.sleep(0.02)
    return False


# ----------------------------------------------------------------------
def test_request_sequence_equals_the_jax_fleet(texts):
    """Mixed sizes and kinds, a reload, a canary at 0.25 and 1.0 and a
    promotion: every response byte-equal to the JAX fleet's and to the
    port's Booster.predict of its target, the same target request by
    request; the port's cold-started replica captures nothing."""
    t, X = texts
    refs = {k: _ref(v) for k, v in t.items()}
    jf, pf = _pair({"alpha": t["alpha"], "beta": t["beta"]})
    try:
        for n in (1, 3, 7, 16, 23):
            for model in ("alpha", "beta"):
                for kind, kw in KINDS:
                    a = pf.predict(X[:n], model=model, kind=kind)
                    b = jf.predict(X[:n], model=model, kind=kind)
                    assert _same(a, b), (n, model, kind)
                    assert _same(a, refs[model].predict(X[:n], **kw))
        served = [r for r in pf.replicas
                  if any(e.stats()["requests"] > 0
                         for e in r._engines.values())]
        assert len(served) == 2, "least-loaded dispatch used one replica"

        assert pf.reload(t["gamma"], model="alpha") \
            == jf.reload(t["gamma"], model="alpha") == 2
        a = pf.predict(X[:7], model="alpha")
        assert _same(a, jf.predict(X[:7], model="alpha"))
        assert _same(a, refs["gamma"].predict(X[:7]))

        for weight, hits in ((0.25, 10), (1.0, 40)):
            jf.router.set_canary("alpha", "beta", weight)
            pf.router.set_canary("alpha", "beta", weight)
            targets = []
            for i in range(40):
                pfut = pf.submit(X[i:i + 3], model="alpha")
                jfut = jf.submit(X[i:i + 3], model="alpha")
                a, b = pfut.result(WAIT), jfut.result(WAIT)
                assert pfut.meta["target"] == jfut.meta["target"]
                assert _same(a, b)
                target = pfut.meta["target"]
                gen = "gamma" if target == "alpha" else "beta"
                assert _same(a, refs[gen].predict(X[i:i + 3]))
                targets.append(target)
            assert targets.count("beta") == hits, (weight, targets)
        assert pf.promote_canary("alpha") == jf.promote_canary("alpha") \
            == "beta"
        for n in (1, 5, 16):
            pfut = pf.submit(X[:n], model="alpha")
            jfut = jf.submit(X[:n], model="alpha")
            assert pfut.meta["target"] == jfut.meta["target"] == "beta"
            assert _same(pfut.result(WAIT), jfut.result(WAIT))
        assert pf.router.describe() == jf.router.describe()

        rep = pf.cold_start_replica()
        jf.cold_start_replica()
        assert rep.cold_start_captures == 0
        assert rep.describe()["cold_start_captures"] == 0
        assert _same(pf.predict(X[:9], model="beta"),
                     jf.predict(X[:9], model="beta"))
        ps, js = pf.stats(), jf.stats()
        for key in ("requests", "rows", "canary_requests", "promotions",
                    "reloads", "errors", "replica_starts"):
            assert ps.get(key, 0) == js.get(key, 0), key
        assert ps["errors"] == 0
        assert pf.slo_counts() == jf.slo_counts()
        h = pf.health()
        assert h["status"] == jf.health()["status"] == "ok"
        assert h["fleet"] and len(h["replicas"]) == 3
    finally:
        jf.stop()
        pf.stop()


def test_fleet_device_takes_the_card_or_raises(texts):
    t, _ = texts
    if torch.cuda.is_available():
        fl = FleetEngine(models={"alpha": t["alpha"]}, replicas=1,
                         default_model="alpha")
        try:
            assert fl.device.type == "cuda"
        finally:
            fl.stop()
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            FleetEngine(models={"alpha": t["alpha"]}, replicas=1,
                        default_model="alpha")


# ----------------------------------------------------------------------
def test_shadow_matches_the_jax_fleet(texts):
    """Shadows to a different model (mismatch), to the same text under
    a second name (parity), to a missing, an empty and a mid-drain
    target (skipped): the primary's response always, the shadow's
    never, and the same counters as the JAX fleet's."""
    t, X = texts
    models = {"alpha": t["alpha"], "beta": t["beta"],
              "alpha2": t["alpha"]}
    jf, pf = _pair(models)
    ref = _ref(t["alpha"])
    try:
        steps = (("beta", "shadow_parity_mismatch", 1),
                 ("alpha2", "shadow_parity_ok", 1))
        for shadow, counter, value in steps:
            for fl in (jf, pf):
                fl.router.set_shadow("alpha", shadow)
            a = pf.predict(X[:3], model="alpha")
            assert _same(a, jf.predict(X[:3], model="alpha"))
            assert _same(a, ref.predict(X[:3]))
            assert _wait_counter(pf, counter, value)
            assert _wait_counter(jf, counter, value)
        for fl in (jf, pf):
            fl.router.set_shadow("alpha", "nope")
            fl.predict(X[:2], model="alpha")
            fl.fleet.ensure("empty")
            fl.router.set_shadow("alpha", "empty")
            fl.predict(X[:2], model="alpha")
            fl.fleet.current("beta").start_draining()
            fl.router.set_shadow("alpha", "beta")
            fl.predict(X[:2], model="alpha")
        ps, js = pf.stats(), jf.stats()
        for key in ("shadow_mirrored", "shadow_parity_ok",
                    "shadow_parity_mismatch", "shadow_skipped", "errors",
                    "requests"):
            assert ps.get(key, 0) == js.get(key, 0), key
        assert ps["shadow_skipped"] == 3 and ps["shadow_mirrored"] == 2
    finally:
        jf.stop()
        pf.stop()


def test_quota_shed_matches_the_jax_fleet(texts):
    t, X = texts
    clock = [0.0]
    jf, pf = _pair({"alpha": t["alpha"]}, replicas=1,
                   quotas=lambda cls: cls(tenants={"t1": (1.0, 2.0)},
                                          clock=lambda: clock[0]),
                   buckets=(4,), warmup=False)
    try:
        errs = []
        for fl in (pf, jf):
            t0 = time.monotonic()
            fl.predict(X[:1], tenant="t1")
            fl.predict(X[:1], tenant="t1")
            with pytest.raises(Exception) as ei:
                fl.predict(X[:1], tenant="t1")
            assert time.monotonic() - t0 < 5.0   # a shed, not a timeout
            errs.append(ei.value)
            for _ in range(3):
                fl.predict(X[:1])                # unnamed: unlimited
        assert isinstance(errs[0], QuotaExceededError)
        assert errs[0].to_dict() == errs[1].to_dict()
        assert errs[0].http_status == errs[1].http_status == 429
        assert errs[0].to_dict()["error"] == "quota_exceeded"
        clock[0] += 1.0                          # the bucket refills
        assert _same(pf.predict(X[:1], tenant="t1"),
                     jf.predict(X[:1], tenant="t1"))
        assert pf.stats()["quota_shed"] == jf.stats()["quota_shed"] == 1
        assert pf.slo_counts() == jf.slo_counts()
        clock[0] += 1.0
        pf.charge_tenant_bytes("t1", 10)         # requests unit: 1 token
        with pytest.raises(QuotaExceededError):
            pf.charge_tenant_bytes("t1", 10)
    finally:
        jf.stop()
        pf.stop()


# ----------------------------------------------------------------------
def test_replica_death_redispatches_without_duplicates(texts):
    """A slow flusher keeps requests queued while their replica is
    killed: each re-dispatches once to the survivor, no request is lost
    and none is answered twice."""
    t, X = texts
    ref = _ref(t["alpha"])
    fl = FleetEngine(models={"alpha": t["alpha"]},
                     config=ServingConfig(buckets=(4,), warmup=False,
                                          flush_interval_ms=400.0,
                                          request_timeout_ms=30000),
                     replicas=2, default_model="alpha", device="cpu")
    try:
        futs = [fl.submit(X[i:i + 1]) for i in range(8)]
        victim = futs[0]._replica.rid
        fl.kill_replica(victim)
        for i, f in enumerate(futs):
            assert _same(f.result(timeout=WAIT), ref.predict(X[i:i + 1]))
        st = fl.stats()
        assert st["redispatches"] >= 1 and st["replica_deaths"] == 1
        assert st["errors"] == 0 and st["requests"] == 8
        assert st["engine_totals"]["requests"] == 8 + st["redispatches"]
        moved = [f for f in futs if f.meta["redispatches"] > 0]
        assert moved and all(f.meta["replica"] != victim for f in moved)
        f = fl.submit(X[:1])
        assert f._replica.rid != victim
        f.result(timeout=WAIT)
        # the thread-mode fault lever: crash is a kill, hang has none
        live = [r.rid for r in fl.replicas if r.state == "ok"]
        assert fl.inject_replica_fault(live[0], "hang", ms=10) is False
    finally:
        fl.stop()


def test_admission_and_exhaustion_match_the_jax_fleet(texts):
    t, X = texts
    jf, pf = _pair({"alpha": t["alpha"]}, replicas=1, buckets=(4,),
                   warmup=False, flush_interval_ms=300.0,
                   jkw={"max_pending": 2}, pkw={"max_pending": 2})
    try:
        seen, types = [], []
        for fl in (pf, jf):
            f1, f2 = fl.submit(X[:1]), fl.submit(X[:1])
            codes = []
            with pytest.raises(Exception) as ei:
                fl.submit(X[:1])
            codes.append((ei.value.to_dict(), ei.value.http_status))
            if fl is pf:
                assert isinstance(ei.value, QueueFullError)
            f1.result(timeout=WAIT)
            f2.result(timeout=WAIT)
            with pytest.raises(Exception) as ei:
                fl.submit(X[:1], model="ghost")
            codes.append((ei.value.to_dict(), ei.value.http_status))
            if fl is pf:
                assert isinstance(ei.value, ModelNotFoundError)
            fl.kill_replica(fl.replicas[0].rid)
            with pytest.raises(Exception) as ei:
                fl.submit(X[:1])
            codes.append((ei.value.to_dict(), ei.value.http_status))
            seen.append(codes)
            types.append(type(ei.value).__name__)
        assert seen[0] == seen[1] and types[0] == types[1]
        assert [c[1] for c in seen[0]] == [429, 404, 503]
        assert pf.slo_counts() == jf.slo_counts()
        assert pf.health()["status"] == jf.health()["status"] \
            == "no_replicas"
        with pytest.raises(ReplicaUnavailableError):
            pf.submit(X[:1])
    finally:
        jf.stop()
        pf.stop()


def test_drain_replica_serves_queued_then_retires(texts):
    t, X = texts
    ref = _ref(t["alpha"])
    fl = FleetEngine(models={"alpha": t["alpha"]},
                     config=ServingConfig(buckets=(4,), warmup=False,
                                          flush_interval_ms=100.0,
                                          request_timeout_ms=30000),
                     replicas=2, default_model="alpha", device="cpu")
    try:
        futs = [fl.submit(X[i:i + 1]) for i in range(4)]
        victim = futs[0]._replica.rid
        fl.drain_replica(victim)
        for i, f in enumerate(futs):
            assert _same(f.result(timeout=WAIT), ref.predict(X[i:i + 1]))
        st = fl.stats()
        assert st["errors"] == 0 and st.get("redispatches", 0) == 0
        assert st["replica_drains"] == 1
        assert fl.health()["status"] == "degraded"
    finally:
        fl.stop()


# ----------------------------------------------------------------------
def test_from_config_matches_the_jax_fleet(texts, tmp_path):
    from lightgbm_tpu.config import Config as JCfg
    from lightgbm_tpu_torch.config import Config
    t, X = texts
    pa, pb = tmp_path / "a.txt", tmp_path / "b.txt"
    pa.write_text(t["alpha"])
    pb.write_text(t["beta"])
    params = {"serving_replicas": 2,
              "serving_models": f"prod={pa},cand={pb}",
              "serving_canary_model": "cand", "serving_canary_weight": 0.5,
              "serving_shadow_model": "cand",
              "serving_quota_qps": 0, "serving_quota_tenants": "a=10:20",
              "serving_buckets": "4,16", "serving_device": "never",
              "verbosity": -1}
    cfg, jcfg = Config.from_params(params), JCfg.from_params(params)
    assert cfg.serving_models == jcfg.serving_models
    pf = FleetEngine.from_config(cfg, device="cpu")
    jf = JFleet.from_config(jcfg)
    try:
        assert pf.fleet.names() == jf.fleet.names() == ["cand", "prod"]
        assert pf.default_model == jf.default_model == "cand"
        assert len(pf.replicas) == len(jf.replicas) == 2
        assert pf.quotas.describe() == jf.quotas.describe()
        assert pf.router.describe() == jf.router.describe()
        assert pf.max_pending == jf.max_pending
        assert pf.config.buckets == jf.config.buckets == (4, 16)
        assert _same(pf.predict(X[:3], model="prod"),
                     jf.predict(X[:3], model="prod"))
        assert _same(pf.predict(X[:3], model="prod"),
                     _ref(t["alpha"]).predict(X[:3]))
    finally:
        jf.stop()
        pf.stop()


@pytest.mark.parametrize("params", [{"serving_replicas": 0},
                                    {"serving_canary_weight": 1.5},
                                    {"serving_quota_qps": -1},
                                    {"serving_isolation": "container"}])
def test_config_fleet_param_validation(params):
    from lightgbm_tpu.config import Config as JCfg
    from lightgbm_tpu_torch.config import Config
    with pytest.raises(ValueError):
        JCfg.from_params(params)
    with pytest.raises(ValueError):
        Config.from_params(params)


# ----------------------------------------------------------------------
def _serve(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread


def _post(port, path, payload, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=WAIT) as r:
        return r.status, r.read().decode()


def test_http_fleet_endpoints_match_jax(texts, tmp_path):
    """The fleet body keys, ``X-Tenant``, a named ``/reload`` and
    ``/route`` (canary, shadow, promote, a bad body): the same statuses
    and JSON as the JAX frontend over the JAX fleet."""
    t, X = texts
    clock = [0.0]
    jf, pf = _pair({"alpha": t["alpha"], "beta": t["beta"]},
                   quotas=lambda cls: cls(tenants={"slow": (0.001, 1.0)},
                                          clock=lambda: clock[0]))
    txt = tmp_path / "m.txt"
    txt.write_text(t["alpha"])
    servers = [make_http_server(pf, "127.0.0.1", 0),
               jhttp(jf, "127.0.0.1", 0)]
    threads = [_serve(s) for s in servers]
    ports = [s.server_address[1] for s in servers]
    calls = [
        ("/predict", {"rows": X[:2].tolist(), "model": "beta",
                      "tenant": "acme"}, None),
        ("/raw_score", {"rows": X[:3].tolist()}, None),
        ("/pred_leaf", {"rows": X[:2].tolist(), "model": "beta"}, None),
        ("/predict", {"rows": X[:1].tolist()}, {"X-Tenant": "slow"}),
        ("/predict", {"rows": X[:1].tolist()}, {"X-Tenant": "slow"}),
        ("/predict", {"rows": X[:1].tolist(), "model": "ghost"}, None),
        ("/reload", {"model_file": str(txt), "model": "beta"}, None),
        ("/predict", {"rows": X[:4].tolist(), "model": "beta"}, None),
        ("/route", {"model": "alpha", "canary": "beta", "weight": 1.0},
         None),
        ("/route", {"model": "alpha", "shadow": "beta"}, None),
        ("/route", {"model": "alpha"}, None),
        ("/route", {"model": "alpha", "canary": "beta", "weight": 2.0},
         None),
        ("/route", {"model": "alpha", "promote": True}, None),
        ("/predict", {"rows": X[:2].tolist(), "model": "alpha"}, None),
    ]
    try:
        for path, payload, headers in calls:
            (ps, pb), (js, jb) = (_post(p, path, payload, headers)
                                  for p in ports)
            assert ps == js, (path, payload, pb, jb)
            if ps == 200 and "predictions" in pb:
                # the port serves on its device (here the CPU), the
                # JAX fleet on its host loop: the same bytes
                assert pb["route"] == "device" and jb["route"] == "host"
            for body in (pb, jb):
                for key in ("latency_ms", "queue_ms", "compute_ms",
                            "trace_id", "replica", "message", "route"):
                    body.pop(key, None)
            assert pb == jb, (path, {k: (pb.get(k), jb.get(k))
                                     for k in set(pb) | set(jb)
                                     if pb.get(k) != jb.get(k)})
        status, body = _post(ports[0], "/predict",
                             {"rows": X[:2].tolist(), "model": "beta",
                              "tenant": "acme"})
        assert status == 200 and body["replica"] in (0, 1)
        health = [json.loads(_get(p, "/health")[1]) for p in ports]
        assert health[0]["fleet"] and health[0]["status"] \
            == health[1]["status"] == "ok"
        assert set(health[0]["models"]) == set(health[1]["models"]) \
            == {"alpha", "beta"}
        assert len(health[0]["replicas"]) == 2
        text = _get(ports[0], "/metrics")[1]
        assert "lgbm_fleet_request_latency_ms_bucket" in text
        assert 'model="beta"' in text and 'tenant="acme"' in text
        assert "lgbm_fleet_replicas_ok" in text
        assert "lgbm_fleet_replica_state" in text
    finally:
        for s, th in zip(servers, threads):
            s.shutdown()
            s.server_close()
            th.join(WAIT)
        jf.stop()
        pf.stop()


def test_route_is_404_on_one_engine(texts):
    from lightgbm_tpu_torch.serving import ServingEngine
    t, X = texts
    eng = ServingEngine(t["alpha"], config=ServingConfig(buckets=(4,)),
                        device="cpu")
    server = make_http_server(eng, "127.0.0.1", 0)
    thread = _serve(server)
    try:
        port = server.server_address[1]
        status, _ = _post(port, "/route", {"model": "alpha",
                                           "promote": True})
        assert status == 404
        # one engine ignores the fleet's body keys
        status, body = _post(port, "/predict", {"rows": X[:2].tolist(),
                                                "model": "x",
                                                "tenant": "y"})
        assert status == 200
        assert np.asarray(body["predictions"]).tobytes() \
            == _ref(t["alpha"]).predict(X[:2]).tobytes()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(WAIT)
        eng.stop()


# ----------------------------------------------------------------------
@pytest.mark.parametrize("storm", ["replica", "kill"])
def test_soak_loop_storms_availability(texts, tmp_path, storm):
    """The soak's replica storm (kill + cold start) and kill storm (the
    thread-mode fault lever) with reloads and injected read faults
    alongside: availability 1.0."""
    from lightgbm_tpu_torch.robustness.faults import get_fault_plan
    from lightgbm_tpu_torch.serving.loadgen import soak_loop
    t, X = texts
    pa = tmp_path / "alpha.txt"
    pa.write_text(t["alpha"])
    fl = FleetEngine(models={"alpha": t["alpha"], "beta": t["beta"]},
                     config=ServingConfig(buckets=(4,), warmup=False,
                                          flush_interval_ms=1.0),
                     replicas=3, default_model="alpha", device="cpu")
    kw = {"replica_storm_every_s": 0.4} if storm == "replica" \
        else {"kill_storm_every_s": 0.3}
    try:
        block = soak_loop(
            fl, X, duration_s=1.5, qps=100, batch_sizes=(1, 3),
            models=["alpha", "beta"], tenants=["default", "t2"],
            timeout_ms=20000, reload_every_s=0.4,
            reload_sources={"alpha": str(pa)},
            fault_spec=f"fail_read@times=2,match={pa.name}", **kw)
        assert block["mode"] == "soak" and block["requests"] > 20
        assert block["non_shed_errors"] == 0
        assert block["availability"] == 1.0
        assert block["reloads"] >= 1 and block["faults_injected"] >= 1
        if storm == "replica":
            assert block["replica_kills"] >= 1
            assert block["cold_starts"] >= 1
        else:
            assert block["fault_storms"] >= 1
        assert block["isolation"] == "thread"
        assert block["models"] == ["alpha", "beta"]
        assert get_fault_plan() is None
        for key in ("p50_ms", "p99_ms", "throughput_rps", "shed_rate",
                    "redispatches", "replicas"):
            assert key in block
    finally:
        fl.stop()
