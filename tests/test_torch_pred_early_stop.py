"""Prediction early stopping (``pred_early_stop``) in the port against
the JAX predictor (``lightgbm_tpu/predictor.py:140
_predict_raw_early_stop``), on the CPU.

A binary and a 5-class model trained by the port (20 iterations) predict
through ``Booster.predict(..., pred_early_stop=True,
pred_early_stop_freq=, pred_early_stop_margin=)`` and through the JAX
predictor on the same trees (the model text), at margins that stop no
row, about half the rows and every row at the first check. Both sum
each row's trees in float64 in tree order, so raw scores agree to the
bit; converted scores within 2 float32 ulp (each package's own
sigmoid / softmax). Regression warns and predicts normally, as does a
random forest (``average_output``)."""

import numpy as np
import pytest
import torch

from lightgbm_tpu.io import model_text as jtext
from lightgbm_tpu.predictor import predict as jpredict
import lightgbm_tpu_torch as lt

torch.set_num_threads(2)
FREQ = 3


def _model(objective):
    rng = np.random.RandomState(0)
    X = rng.randn(3000, 6)
    z = X[:, 0] - 0.7 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3] \
        + 0.5 * rng.randn(3000)
    if objective == "binary":
        y = (z > 0).astype(np.float32)
        p = {"objective": "binary"}
    elif objective == "multiclass":
        y = np.digitize(z, np.quantile(z, [0.2, 0.4, 0.6, 0.8])).astype(
            np.float32)
        p = {"objective": "multiclass", "num_class": 5}
    else:
        y = z.astype(np.float32)
        p = {"objective": objective}
    p.update(num_leaves=15, learning_rate=0.3, verbosity=-1)
    if objective == "rf":
        p.update(objective="binary", boosting="rf", bagging_fraction=0.6,
                 bagging_freq=1)
        y = (z > 0).astype(np.float32)
    bst = lt.train(p, lt.Dataset(X, label=y), 20, device="cpu")
    return X, bst, jtext.load_model_from_string(bst.model_to_string())


def _first_margins(bst, X):
    """Each row's margin after the first ``FREQ * k`` trees."""
    k = bst.num_model_per_iteration()
    raw = bst.predict(X, raw_score=True, num_iteration=FREQ).reshape(
        len(X), k)
    if k == 1:
        return 2.0 * np.abs(raw[:, 0])
    top = np.sort(raw, axis=1)
    return top[:, -1] - top[:, -2]


@pytest.fixture(scope="module", params=["binary", "multiclass"])
def model(request):
    return _model(request.param)


@pytest.mark.parametrize("stop", [0.0, 0.5, 1.0])
def test_early_stopped_scores_match_jax(model, stop):
    X, bst, jb = model
    m = _first_margins(bst, X)
    margin = {0.0: 1e30, 0.5: float(np.median(m)), 1.0: 0.0}[stop]
    stopped = float(np.mean(m >= margin))
    assert abs(stopped - stop) <= 0.05   # margins take few values
    kw = dict(pred_early_stop=True, pred_early_stop_freq=FREQ,
              pred_early_stop_margin=margin)
    raw = bst.predict(X, raw_score=True, **kw)
    jraw = jpredict(jb, X, raw_score=True, **kw)
    np.testing.assert_array_equal(raw, jraw)
    conv = bst.predict(X, **kw)
    np.testing.assert_array_max_ulp(conv.astype(np.float32),
                                    np.asarray(jpredict(jb, X, **kw),
                                               np.float32), maxulp=2)
    full = bst.predict(X, raw_score=True)
    if stop == 0.0:
        np.testing.assert_array_equal(raw, full)
    else:
        assert not np.array_equal(raw, full)


def test_early_stop_params_come_from_the_booster(model):
    X, bst, jb = model
    margin = float(np.median(_first_margins(bst, X)))
    kw = dict(pred_early_stop=True, pred_early_stop_freq=FREQ,
              pred_early_stop_margin=margin)
    b2 = lt.Booster(model_str=bst.model_to_string(), device="cpu",
                    params=kw)
    np.testing.assert_array_equal(b2.predict(X, raw_score=True),
                                  jpredict(jb, X, raw_score=True, **kw))


@pytest.mark.parametrize("objective", ["regression", "rf"])
def test_other_models_predict_normally(objective):
    X, bst, jb = _model(objective)
    kw = dict(pred_early_stop=True, pred_early_stop_freq=1,
              pred_early_stop_margin=0.0)
    raw = bst.predict(X, raw_score=True, **kw)
    np.testing.assert_array_equal(raw, bst.predict(X, raw_score=True))
    np.testing.assert_array_equal(raw, jpredict(jb, X, raw_score=True,
                                                **kw))
