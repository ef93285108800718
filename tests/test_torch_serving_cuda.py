"""The serving engine's CUDA graphs on the card (``serving/programs.py``):
every bucket's replay equals the eager walk (``Booster.predict`` of the
same rows) to the bit, warmup captures every (bucket, kind) program so
steady traffic captures none, and a program that fails to capture fails
the load while the previous version keeps serving. The fleets on the
card: a thread fleet bitwise ``Booster.predict`` whose cold-started
replica captures no graph (the version's graphs are shared), and a
process fleet whose 2 workers each report ``cuda`` and capture their own
12 graphs a model. Marked ``cuda``: without a CUDA device every test
here skips. On a card: ``python -m pytest tests/test_torch_serving_cuda.py
--noconftest``. ``chip_smoke.py`` phases 19 and 20 serve the full-width
models."""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.serving import (FleetEngine, ProcFleetOptions,
                                        ServingConfig, ServingEngine,
                                        ServingError)
from lightgbm_tpu_torch.serving import programs

pytestmark = pytest.mark.cuda

KINDS = (("predict", {}), ("raw_score", {"raw_score": True}),
         ("pred_leaf", {"pred_leaf": True}))
BUCKETS = (1, 8, 64, 512)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module",
                params=["binary", "multiclass", "linear", "categorical"])
def model(dev, request):
    rng = np.random.RandomState(0)
    X = rng.randn(2000, 8)
    X[::7, 2] = np.nan
    extra = {}
    if request.param == "binary":
        params = {"objective": "binary", "num_leaves": 31}
        y = (X[:, 0] + X[:, 1] > 0).astype(np.float64)
    elif request.param == "multiclass":
        params = {"objective": "multiclass", "num_class": 4,
                  "num_leaves": 15}
        y = (np.abs(X[:, 0] * 2).astype(int) % 4).astype(np.float64)
    elif request.param == "linear":
        params = {"objective": "regression", "linear_tree": True,
                  "num_leaves": 15}
        y = 2.0 * X[:, 0] - X[:, 1] + 0.1 * rng.randn(len(X))
    else:
        params = {"objective": "binary", "num_leaves": 15}
        X[:, 3] = rng.randint(0, 40, len(X))
        y = ((X[:, 3] % 3 == 0) ^ (X[:, 0] > 0)).astype(np.float64)
        extra = {"categorical_feature": [3]}
    cpu = lt.train(dict(params, verbosity=-1),
                   lt.Dataset(X, label=y, **extra), 12, device="cpu")
    return lt.Booster(model_str=cpu.model_to_string(), device=dev), X


def test_replay_equals_the_eager_walk_at_every_bucket(model, dev):
    bst, X = model
    eng = ServingEngine(bst, config=ServingConfig(
        buckets=BUCKETS, device="always", fallback_to_host=False), device=dev)
    try:
        mv = eng.registry.current()
        assert len(mv.programs) == len(BUCKETS) * len(KINDS)
        for (b, kind), prog in mv.programs.items():
            assert prog.graph is not None
            ref = dict(KINDS)[kind]
            for n in sorted({1, b // 2 + 1, b}):
                out = prog.run(X[:n])
                assert out.tobytes() == bst.predict(X[:n], **ref).tobytes()
                eager = prog._body()[:n].cpu().numpy()
                assert out.tobytes() == eager.tobytes()
        for kind, kw in KINDS:        # 700 rows: chunked 512 + 188
            assert eng.predict(X[:700], kind=kind).tobytes() \
                == bst.predict(X[:700], **kw).tobytes()
        assert eng.stats()["fallbacks"] == 0
    finally:
        eng.stop()


def test_zero_captures_after_warmup(model, dev):
    bst, X = model
    eng = ServingEngine(bst, config=ServingConfig(
        buckets=BUCKETS, device="always", fallback_to_host=False,
        flush_interval_ms=0.5), device=dev)
    try:
        captured = eng.stats()["graph_captures"]
        assert captured == len(BUCKETS) * len(KINDS)
        for _ in range(2):
            for n in (1, 7, 64, 300, 700):
                for kind, _kw in KINDS:
                    assert len(eng.predict(X[:n], kind=kind)) == n
        st = eng.stats()
        assert st["graph_captures"] == captured
        assert st["graph_replays"] >= 30 and st["fallbacks"] == 0
        assert st["bucket_misses"] <= len(BUCKETS)
    finally:
        eng.stop()


def test_capture_failure_fails_the_load(model, dev, monkeypatch):
    bst, X = model
    eng = ServingEngine(bst, config=ServingConfig(
        buckets=(1, 8), fallback_to_host=False), device=dev)
    try:
        def boom(self):
            raise RuntimeError("injected capture failure")
        monkeypatch.setattr(programs.BucketProgram, "_capture", boom)
        with pytest.raises(RuntimeError, match="injected capture"):
            eng.reload(bst.model_to_string())
        monkeypatch.undo()
        h = eng.health()
        assert h["status"] == "degraded" and h["version"] == 1
        assert eng.stats().get("reloads", 0) == 0
        assert eng.predict(X[:3]).tobytes() == bst.predict(X[:3]).tobytes()
        with pytest.raises(ServingError):
            eng.submit(X[:1, :2])
    finally:
        eng.stop()


def test_thread_fleet_bitwise_and_cold_replica_captures_none(model, dev):
    bst, X = model
    fl = FleetEngine(models={"m": bst.model_to_string()},
                     config=ServingConfig(buckets=BUCKETS, device="always",
                                          fallback_to_host=False,
                                          flush_interval_ms=0.5),
                     replicas=2, default_model="m", device=dev)
    try:
        captured = sum(r._captures() for r in fl.replicas)
        assert captured == len(BUCKETS) * len(KINDS)
        for n in (1, 7, 64, 300, 700):
            for kind, kw in KINDS:
                assert fl.predict(X[:n], kind=kind).tobytes() \
                    == bst.predict(X[:n], **kw).tobytes()
        rep = fl.cold_start_replica()
        assert rep.cold_start_captures == 0
        for _ in range(4):   # least-loaded dispatch reaches the new one
            assert fl.predict(X[:9]).tobytes() \
                == bst.predict(X[:9]).tobytes()
        assert sum(r._captures() for r in fl.replicas) == captured
        st = fl.stats()
        assert st["errors"] == 0
        assert st["engine_totals"].get("fallbacks", 0) == 0
    finally:
        fl.stop()


def test_process_workers_report_cuda_and_capture_their_graphs(dev):
    rng = np.random.RandomState(1)
    X = rng.randn(2000, 8)
    y = (X[:, 0] - X[:, 2] > 0).astype(np.float64)
    text = lt.train({"objective": "binary", "num_leaves": 31,
                     "verbosity": -1}, lt.Dataset(X, label=y), 12,
                    device="cpu").model_to_string()
    ref = lt.Booster(model_str=text, device=dev)
    per_model = len(BUCKETS) * len(KINDS)
    fl = FleetEngine(models={"m": text, "n": text},
                     config=ServingConfig(buckets=BUCKETS, device="always",
                                          fallback_to_host=False),
                     replicas=2, default_model="m", isolation="process",
                     proc_opts=ProcFleetOptions(spawn_timeout_s=120.0,
                                                shm_min_bytes=16384),
                     device=dev)
    try:
        for r in fl.replicas:
            assert r.state == "ok" and r.device == "cuda"
            assert r.captures == {"m": per_model, "n": per_model}
            assert r.cold_start_captures == 2 * per_model
        for n in (1, 64, 512):          # JSON, JSON, the ring
            for model in ("m", "n"):
                for kind, kw in KINDS:
                    assert fl.predict(X[:n], kind=kind,
                                      model=model).tobytes() \
                        == ref.predict(X[:n], **kw).tobytes()
        shm = [r.shm_stats() for r in fl.replicas]
        assert sum(s["writes"] for s in shm) > 0
        assert all(s["fallbacks"] == 0 for s in shm)
        assert fl.stats()["errors"] == 0
    finally:
        fl.stop(drain=False)
