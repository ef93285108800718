"""The port's SLO engine, router and tenant quotas against the JAX
package's (``lightgbm_tpu/observability/slo.py``,
``serving/router.py``, ``serving/tenants.py``): the same evaluations
after the same sample sequence over the same counters and latency
histogram, the same spec errors, the same routing decisions and the
same admissions under one injected clock. The config's ``slo_specs`` /
``slo_windows`` validate as JAX's do.
"""

import json
import re

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.observability import metrics as jmetrics
from lightgbm_tpu.observability import slo as jslo
from lightgbm_tpu.serving import router as jrouter
from lightgbm_tpu.serving import tenants as jtenants
from lightgbm_tpu_torch.observability import metrics as pmetrics
from lightgbm_tpu_torch.observability import slo as pslo
from lightgbm_tpu_torch.serving import errors as perrors
from lightgbm_tpu_torch.serving import router as prouter
from lightgbm_tpu_torch.serving import tenants as ptenants

SPECS = ["availability:availability:0.999", "lat:latency:0.99:5",
         "errors:error_rate:0.995"]


def _script(seed):
    """Cumulative counters and latency observations, one step a sample."""
    rng = np.random.RandomState(seed)
    counts = {"requests": 0, "errors": 0, "shed": 0, "unavailable": 0}
    steps = []
    for _ in range(12):
        counts = {k: v + int(rng.randint(0, 50 if k == "requests" else 3))
                  for k, v in counts.items()}
        steps.append((dict(counts), rng.exponential(3.0, size=20)))
    return steps


@pytest.mark.parametrize("shed", [False, True])
def test_evaluations_equal_jax(shed):
    out = []
    for mod, reg_mod in ((pslo, pmetrics), (jslo, jmetrics)):
        reg = reg_mod.MetricsRegistry()
        cur = {}
        eng = mod.SLOEngine(mod.parse_slo_specs(SPECS), ["30s", "2m", "1h"],
                            counts_fn=lambda: cur, interval_s=5.0,
                            registry=reg, include_shed_errors=shed)
        evals = []
        for i, (counts, lats) in enumerate(_script(7)):
            cur.clear()
            cur.update(counts)
            for v in lats:
                reg.observe("serving_request_latency_ms", float(v),
                            labels={"kind": "predict", "bucket": 1})
            t = 1000.0 + 15.0 * i
            if i % 3 == 2:
                ev = eng.evaluate(now=t)
                ev.pop("at")
                evals.append(ev)
            else:
                eng.sample(now=t)
        out.append((evals, eng.max_burn(), eng.max_burn("2m"),
                    reg.labeled_gauges("slo_burn"),
                    {k: v for k, v in eng.report().items() if k != "last"}))
    assert out[0] == out[1]
    assert out[0][1] > 0.0


@pytest.mark.parametrize("text", [
    "a:b", "x:latency:0.9", "x:nope:0.9", "x:availability:1.5",
    "x:availability:0", "x:error_rate:abc", "a:b:c:d:e"])
def test_spec_errors_equal_jax(text):
    errs = []
    for mod in (pslo, jslo):
        with pytest.raises(ValueError) as ei:
            mod.parse_slo_spec(text)
        errs.append(str(ei.value))
    assert errs[0] == errs[1]


def test_config_validates_as_jax():
    """slo_specs / slo_windows: no refusal any more; bad values raise
    the JAX config's ValueError."""
    good = {"slo_specs": ["a:availability:0.99", "b:latency:0.9:20"],
            "slo_windows": ["30s", "5m"]}
    cfg = lt.Config.from_params(good)
    assert cfg.slo_specs == good["slo_specs"]
    eng = pslo.engine_from_config(cfg)
    jeng = jslo.engine_from_config(lgb.Config.from_params(good))
    assert [s.describe() for s in eng.specs] \
        == [s.describe() for s in jeng.specs]
    assert eng.windows == jeng.windows == ["30s", "5m"]
    assert eng.interval_s == jeng.interval_s
    for bad in ({"slo_specs": ["a:availability:0.99", "a:latency:0.9:1"]},
                {"slo_specs": ["a:avail:0.99"]}, {"slo_windows": ["5x"]}):
        errs = []
        for cls in (lt.Config, lgb.Config):
            with pytest.raises(ValueError) as ei:
                cls.from_params(bad)
            errs.append(str(ei.value))
        assert errs[0] == errs[1]


def test_defaults_and_env(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_SLOS", "x:error_rate:0.9,y:latency:0.5:9")
    assert [s.describe() for s in pslo.specs_from_config(None)] \
        == [s.describe() for s in jslo.specs_from_config(None)]
    monkeypatch.delenv("LGBM_TPU_SLOS")
    assert [s.name for s in pslo.specs_from_config(None)] \
        == ["availability", "latency_p99", "errors"]
    assert pslo.windows_from_config(None) == jslo.windows_from_config(None)
    assert pslo.parse_window("90s") == 90.0


def test_background_loop_and_accessors():
    """start() evaluates on its cadence and becomes the module's last
    engine (what GET /slo and the flight recorder read); stop() joins
    its thread."""
    eng = pslo.SLOEngine(pslo.parse_slo_specs(SPECS[:1]), ["1m"],
                         counts_fn=lambda: {"requests": 10},
                         interval_s=0.05,
                         registry=pmetrics.MetricsRegistry())
    eng.start()
    try:
        assert pslo.get_slo_engine() is eng
        for _ in range(200):
            if eng.last_evaluation() is not None:
                break
            eng._stop.wait(0.01)
        assert pslo.last_evaluation()["slos"][0]["name"] == "availability"
    finally:
        eng.stop()
    assert eng._thread is None


def test_flight_recorder_carries_the_last_evaluation(tmp_path):
    from lightgbm_tpu_torch.observability.flightrec import FlightRecorder
    eng = pslo.SLOEngine(pslo.parse_slo_specs(SPECS[:1]), ["1m"],
                         counts_fn=lambda: {"requests": 4, "errors": 1},
                         registry=pmetrics.MetricsRegistry())
    eng.evaluate(now=50.0)
    path = FlightRecorder(str(tmp_path / "crash.json")).dump("test")
    with open(path) as fh:
        dump = json.load(fh)
    assert dump["slo"] == json.loads(json.dumps(eng.last_evaluation()))


# ----------------------------------------------------------------------
@pytest.mark.parametrize("weight", [0.0, 0.1, 0.25, 1 / 3, 0.5, 0.9, 1.0])
def test_router_decisions_equal_jax(weight):
    rng = np.random.RandomState(int(weight * 1000))
    seq = [("m", "c") if rng.rand() < 0.8 else ("n", None)
           for _ in range(300)]
    out = []
    for mod in (prouter, jrouter):
        r = mod.Router()
        r.set_canary("m", "m_canary", weight)
        r.set_shadow("n", "n_shadow")
        got = [r.route(model).describe() for model, _ in seq]
        promoted = r.promote("m")
        got.append((promoted, r.route("m").describe(), r.describe()))
        out.append(got)
    assert out[0] == out[1]
    errs = []
    for mod in (prouter, jrouter):
        with pytest.raises(ValueError) as ei:
            mod.Router().set_canary("m", "c", 1.5)
        errs.append(str(ei.value))
    assert errs[0] == errs[1]


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("unit", ["requests", "bytes"])
def test_quota_admissions_equal_jax(unit):
    spec = "a=5,b=2:4;c=bad,=3,d"
    assert ptenants.parse_tenant_specs(spec) \
        == jtenants.parse_tenant_specs(spec)
    rng = np.random.RandomState(11)
    steps = [(["a", "b", "z"][rng.randint(3)], float(rng.exponential(0.1)),
              int(rng.randint(1, 900))) for _ in range(400)]
    out = []
    for mod in (ptenants, jtenants):
        clock = _Clock()
        q = mod.TenantQuotas(default_rate=3.0, default_burst=0.0,
                             tenants=mod.parse_tenant_specs(spec),
                             clock=clock, cost_unit=unit)
        got = []
        for tenant, dt, nbytes in steps:
            clock.t += dt
            try:
                q.check(tenant, q.request_cost(nbytes))
                got.append("ok")
            except Exception as e:  # noqa: BLE001 - either package's
                assert e.code == "quota_exceeded" and e.http_status == 429
                got.append(e.to_dict())
        got.append(q.describe())
        out.append(got)
    assert out[0] == out[1]
    assert "ok" in out[0] and any(isinstance(g, dict) for g in out[0])
    bucket = ptenants.TokenBucket(2.0, clock=_Clock())
    jbucket = jtenants.TokenBucket(2.0, clock=_Clock())
    assert [bucket.try_acquire(1.5) for _ in range(4)] \
        == [jbucket.try_acquire(1.5) for _ in range(4)]
    assert issubclass(ptenants.QuotaExceededError,
                      perrors.ServingError)
    with pytest.raises(ValueError, match=re.escape("unknown quota cost")):
        ptenants.TenantQuotas(cost_unit="calls")
