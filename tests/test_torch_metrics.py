"""Every metric name of the JAX factory against its port, on the CPU.

The same seeded labels, weights, query groups and float32 scores go
through the JAX package's batched eval (``batched_eval``: one fetch,
float64 numpy on the host) and the port's metrics (float64 torch on the
scores' device), weighted and unweighted, with tied scores. There is no
objective, so both see the raw scores as the predictions, and the test
holds the metric arithmetic alone (the conversions are held in
``test_torch_objectives.py``). Pointwise means agree within 1e-10
relative (the sums associate differently); the tie-grouped metrics (auc,
auc_mu, ndcg, map) within 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.dataset import Metadata as JMetadata
from lightgbm_tpu.metric import create_metric as jax_metric
from lightgbm_tpu.metric.metrics import batched_eval
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data.dataset import Metadata
from lightgbm_tpu_torch.metric import create_metric

torch.set_num_threads(2)
N = 2500
REGRESSION = ["l2", "mean_squared_error", "mse", "rmse", "l2_root", "l1",
              "mean_absolute_error", "mae", "quantile", "huber", "fair",
              "mape"]
POSITIVE = ["poisson", "gamma", "gamma_deviance", "tweedie"]
PROBABILITY = ["binary_logloss", "binary_error", "cross_entropy",
               "xentropy", "kullback_leibler", "kldiv"]
INTENSITY = ["cross_entropy_lambda", "xentlambda"]
MULTICLASS = ["multi_logloss", "multi_error", "auc_mu"]
RANKING = ["ndcg", "map"]
ALL = REGRESSION + POSITIVE + PROBABILITY + INTENSITY + MULTICLASS \
    + RANKING + ["auc"]
TIE_GROUPED = {"auc", "auc_mu", "ndcg", "map"}


def _case(name, weighted):
    """(labels, weights, query sizes or None, float32 scores, params)."""
    rng = np.random.RandomState(ALL.index(name))
    lat = rng.randn(N)
    params = {"verbosity": -1, "alpha": 0.7, "tweedie_variance_power": 1.3,
              "fair_c": 0.8, "eval_at": [1, 3, 5, 10]}
    group = None
    if name in REGRESSION:
        y, s = lat * 2, lat + 0.5 * rng.randn(N)
    elif name in POSITIVE:
        y = np.exp(0.5 * lat) * rng.gamma(2.0, 0.5, N)
        s = np.exp(0.5 * lat + 0.2 * rng.randn(N))
    elif name in PROBABILITY:
        p = 1.0 / (1.0 + np.exp(-lat))
        y = (p > rng.rand(N)).astype(np.float64) \
            if name.startswith("binary") else p
        s = 1.0 / (1.0 + np.exp(-(lat + rng.randn(N))))
        s[::7] = 0.5                      # on the error threshold
    elif name in INTENSITY:
        y = 1.0 / (1.0 + np.exp(-lat))
        s = np.log1p(np.exp(lat + 0.5 * rng.randn(N)))
    elif name in MULTICLASS:
        params.update(objective="multiclass", num_class=3,
                      multi_error_top_k=2 if name ==
                      "multi_error" else 1)
        y = rng.randint(0, 3, N).astype(np.float64)
        raw = np.round(rng.randn(N, 3) * 2) / 2      # ties
        raw[np.arange(N), y.astype(int)] += 0.5
        e = np.exp(raw)
        s = raw if name == "auc_mu" else e / e.sum(axis=1, keepdims=True)
        s[::11] = s[::11, :1]             # every class tied
    elif name in RANKING:
        group = np.diff(np.r_[0, np.sort(rng.choice(N - 1, 199, False)
                                          + 1), N])
        y = rng.randint(0, 5, N).astype(np.float64)
        y[:group[0]] = 0                  # a query without gain
        s = np.round(lat + 0.3 * y, 1)    # ties within queries
    else:                                 # auc
        y = (lat + rng.randn(N) > 0).astype(np.float64)
        s = np.round(lat, 1)
    w = rng.rand(N) * 2 + 0.1 if weighted else None
    return y, w, group, np.asarray(s, np.float32), params


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ALL)
def test_metric_matches_jax(name, weighted):
    y, w, group, s, params = _case(name, weighted)
    jm, tm = JMetadata(N), Metadata(N)
    for md in (jm, tm):
        md.set_label(y)
        md.set_weights(w)
        md.set_query(group)
    ref_metric = jax_metric(name, JConfig.from_params(params))
    port_metric = create_metric(name, Config.from_params(params))
    ref_metric.init(jm, N)
    port_metric.init(tm, N, "cpu")
    assert port_metric.names == ref_metric.names
    assert port_metric.factor_to_bigger_better \
        == ref_metric.factor_to_bigger_better
    ref = [r[2] for r in batched_eval([([ref_metric], jnp.asarray(s),
                                        "v")], None)[0]]
    st = torch.from_numpy(s)
    got = port_metric.eval(st, st)
    assert all(v.dtype == torch.float64 and v.dim() == 0 for v in got)
    got = [float(v) for v in got]
    rtol = 1e-12 if name in TIE_GROUPED else 1e-10
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)


@pytest.mark.parametrize("name", ["custom", "none", "null", "na", ""])
def test_no_metric_names(name):
    assert create_metric(name, Config.from_params({})) is None
