"""Every objective of the JAX factory against its port, on the CPU.

The same seeded labels, weights, query groups and float32 scores go
through the JAX objective and the port's. Gradients and hessians of the
objectives built from subtractions, compares and products of the inputs
(regression, regression_l1, quantile, huber, fair, mape) are equal to
the bit. The others go through ``exp`` / ``log1p``, whose float32 values
differ by an ulp between XLA and PyTorch on the CPU; their gradients are
held within 64 float32 ulp of the larger of the value and the gradient's
largest magnitude: cancellations (``exp(f) - y``, lambdarank's pair
sums, rank_xendcg's sums over ``1 - rho``) turn one ulp of an operand
into many of a small difference (the largest seen is ~37 for
rank_xendcg). ``boost_from_score``, ``class_need_train`` and the factory
(``None`` for custom objectives) agree exactly; ``convert_output``
within 4 ulp.

The L1-family leaf refit (``ops/percentile.py``) is held against the
JAX package's ``renew_leaf_outputs`` on ties, weights, empty leaves and
one-row leaves: unweighted percentiles to the bit, weighted ones to
1e-12 relative (their cumulative weights are differences of one
cumulative sum over all sorted rows, not numpy's per-leaf ``cumsum``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.dataset import Metadata as JMetadata
from lightgbm_tpu.objective import create_objective as jax_objective
from lightgbm_tpu.ops import percentile as jperc
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data.dataset import Metadata
from lightgbm_tpu_torch.objective import create_objective
from lightgbm_tpu_torch.ops import percentile as tperc

torch.set_num_threads(2)
N = 3000
EPS32 = 2.0 ** -23
OBJECTIVES = ["regression", "regression_l1", "quantile", "huber", "fair",
              "poisson", "mape", "gamma", "tweedie", "binary", "multiclass",
              "multiclassova", "lambdarank", "rank_xendcg", "cross_entropy",
              "cross_entropy_lambda"]
EXACT = {"regression", "regression_l1", "quantile", "huber", "fair",
         "mape"}


def _labels(objective, rng):
    lat = rng.randn(N)
    if objective.startswith("multiclass"):
        return rng.randint(0, 3, N).astype(np.float64)
    if objective in ("poisson", "gamma", "tweedie"):
        return np.exp(0.5 * lat) * rng.gamma(2.0, 0.5, N)
    if objective.startswith("cross_entropy"):
        return 1.0 / (1.0 + np.exp(-lat))
    if objective in ("lambdarank", "rank_xendcg"):
        return rng.randint(0, 5, N).astype(np.float64)
    if objective == "binary":
        return (lat > 0).astype(np.float64)
    return lat + 0.3 * rng.randn(N)


def _pair(objective, weighted, **extra):
    """The JAX objective and the port's, initialised on the same data."""
    rng = np.random.RandomState(OBJECTIVES.index(objective))
    y = _labels(objective, rng)
    w = rng.rand(N) + 0.5 if weighted else None
    params = dict({"objective": objective, "verbosity": -1,
                   "num_class": 3 if objective.startswith("multiclass")
                   else 1}, **extra)
    jm, tm = JMetadata(N), Metadata(N)
    for m in (jm, tm):
        m.set_label(y)
        m.set_weights(w)
        if objective in ("lambdarank", "rank_xendcg"):
            m.set_query(np.diff(np.r_[0, np.sort(
                np.random.RandomState(7).choice(N - 1, 149, False) + 1),
                N]))
    jo = jax_objective(JConfig.from_params(params))
    to = create_objective(Config.from_params(params))
    jo.init(jm, N)
    to.init(tm, N, "cpu")
    return jo, to


def _scores(k, seed=5):
    shape = (N, k) if k > 1 else (N,)
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _assert_close32(port, ref, ulps):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    bound = ulps * EPS32 * (np.abs(ref) + np.abs(ref).max())
    assert (np.abs(port - ref) <= bound).all(), \
        float(np.max(np.abs(port - ref) / bound))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_gradients_match_jax(objective, weighted):
    jo, to = _pair(objective, weighted)
    k = jo.num_model_per_iteration
    assert to.num_model_per_iteration == k
    for it in range(2):     # rank_xendcg draws new uniforms each call
        sc = _scores(k, seed=5 + it)
        jg, jh = jo.gradients(jnp.asarray(sc))
        tg, th = to.gradients(torch.from_numpy(sc))
        assert tg.dtype == th.dtype == torch.float32
        if objective in EXACT:
            np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
            np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        else:
            _assert_close32(tg.numpy(), jg, 64)
            _assert_close32(th.numpy(), jh, 64)


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_init_scores_and_conversion_match_jax(objective):
    jo, to = _pair(objective, weighted=objective.endswith("l1"))
    k = jo.num_model_per_iteration
    for c in range(k):
        assert to.boost_from_score(c) == jo.boost_from_score(c)
        if hasattr(jo, "class_need_train"):
            assert to.class_need_train(c) == jo.class_need_train(c)
    assert to.name() == jo.name()
    assert to.is_renew_tree_output == jo.is_renew_tree_output
    sc = _scores(k)
    _assert_close32(to.convert_output(torch.from_numpy(sc)).numpy(),
                    jo.convert_output(jnp.asarray(sc)), 4)


def test_multiclass_needs_no_tree_for_an_empty_class():
    y = np.r_[np.zeros(10), np.full(10, 2.0)]
    md = Metadata(20)
    md.set_label(y)
    to = create_objective(Config.from_params(
        {"objective": "multiclass", "num_class": 3, "verbosity": -1}))
    to.init(md, 20, "cpu")
    assert [to.class_need_train(c) for c in range(3)] == [True, False,
                                                          True]


@pytest.mark.parametrize("name", ["custom", "none", "null", "na"])
def test_custom_objective_is_none(name):
    assert create_objective(Config.from_params({"objective": name})) \
        is None
    assert jax_objective(JConfig.from_params({"objective": name})) is None


# ----------------------------------------------------------------------
def _refit_case(case):
    """Residuals (float64 of float32), leaf ids and weights for one of
    the refit shapes."""
    rng = np.random.RandomState(11)
    n, leaves = 4000, 31
    residual = rng.randn(n).astype(np.float32)
    leaf = rng.randint(0, leaves, n)
    weights = None
    if case == "ties":
        residual = np.round(residual * 4) / 4
    elif case == "empty_and_single":
        leaf[leaf == 3] = 4             # leaf 3 empty
        leaf[leaf == 7] = 8
        leaf[np.nonzero(leaf == 8)[0][0]] = 7   # leaf 7: one row
        leaf[leaf == leaves - 1] = 0    # the last leaf empty
    elif case == "weighted":
        weights = (rng.rand(n) * 3 + 0.1).astype(np.float32)
    elif case == "weighted_ties":
        residual = np.round(residual * 2) / 2
        weights = rng.randint(1, 4, n).astype(np.float32)
    elif case == "weighted_empty_and_single":
        leaf[leaf == 5] = 6
        leaf[np.nonzero(leaf == 6)[0][:2]] = (5, 9)
        leaf[leaf == 12] = 13
        weights = (rng.rand(n) * 2 + 0.05).astype(np.float32)
    return residual.astype(np.float64), leaf, leaves, weights


@pytest.mark.parametrize("alpha", [0.5, 0.1, 0.93])
@pytest.mark.parametrize("case", ["ties", "empty_and_single", "weighted",
                                  "weighted_ties",
                                  "weighted_empty_and_single"])
def test_refit_matches_jax_percentiles(case, alpha):
    residual, leaf, leaves, weights = _refit_case(case)
    ref = jperc.renew_leaf_outputs(residual, leaf, leaves, weights, alpha)
    port = tperc.renew_leaf_outputs(
        torch.from_numpy(residual), torch.from_numpy(leaf), leaves,
        None if weights is None else torch.from_numpy(weights),
        alpha).numpy()
    if weights is None:
        np.testing.assert_array_equal(port, ref)
    else:
        np.testing.assert_allclose(port, ref, rtol=1e-12, atol=0)
    assert port[np.bincount(leaf, minlength=leaves) == 0].tolist() == \
        [0.0] * int((np.bincount(leaf, minlength=leaves) == 0).sum())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("objective", ["regression_l1", "quantile", "mape"])
def test_objective_refit_matches_jax(objective, weighted):
    """``renew_tree_output`` from the float32 train score and leaf ids,
    the residual formed in float32 as the JAX package forms it."""
    jo, to = _pair(objective, weighted, alpha=0.7)
    score = _scores(1, seed=9)
    leaf = np.random.RandomState(3).randint(0, 20, N)
    ref = jo.renew_tree_output(score.astype(np.float64), leaf, 20, None)
    port = to.renew_tree_output(torch.from_numpy(score),
                                torch.from_numpy(leaf), 20).numpy()
    if objective == "mape" or weighted:
        np.testing.assert_allclose(port, ref, rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(port, ref)
