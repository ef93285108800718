"""The port's scikit-learn estimators against the JAX package's, on the
CPU: ``LGBMRegressor``, ``LGBMClassifier`` (string labels, binary and
3-class, ``class_weight``) and ``LGBMRanker`` fit with an ``eval_set``
and early stopping (the ranker stops early); ``predict`` /
``predict_proba`` within 1e-5 of JAX's (rtol and atol, the trees' leaf
values' tolerance in the training tests), the same ``classes_``,
``best_iteration_`` and
``evals_result_`` keys, ``feature_importances_`` equal; scikit-learn's
``clone`` / ``get_params`` / ``set_params`` and a grid search; and a
subprocess with scikit-learn blocked fitting the classifier to the same
probabilities, to the bit, as this process does.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from sklearn.base import clone
from sklearn.model_selection import GridSearchCV
from sklearn.utils.class_weight import compute_sample_weight

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import sklearn as psk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(n_estimators=30, num_leaves=15, learning_rate=0.1)


def _data(kind, seed=0, n=2500):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    z = X[:, 0] - 0.7 * X[:, 1] + 0.5 * X[:, 2] * (X[:, 3] > 0) \
        + 0.5 * rng.randn(n)
    if kind == "regression":
        return X, z
    if kind == "binary":
        return X, np.where(z > 0.3, "yes", "no")
    if kind == "multiclass":
        return X, np.array(["low", "mid", "high"])[np.digitize(z, [-0.5,
                                                                  0.5])]
    return X, np.digitize(z, [-1, 0, 1]).astype(np.float64)


def _groups(n, seed):
    g = np.random.RandomState(seed).randint(5, 20, n // 5)
    g = g[np.cumsum(g) <= n]
    g[-1] += n - g.sum()
    return g


def _fit_both(kind, **fit):
    X, y = _data(kind)
    Xv, yv = _data(kind, seed=1, n=700)
    est = {"regression": "LGBMRegressor", "binary": "LGBMClassifier",
           "multiclass": "LGBMClassifier", "rank": "LGBMRanker"}[kind]
    fit = dict(eval_set=[(Xv, yv)], early_stopping_rounds=2, **fit)
    if kind == "rank":
        fit.update(group=_groups(len(y), 2), eval_group=[_groups(700, 3)])
    out = []
    for pkg, extra in ((lt, {"device": "cpu"}), (lgb, {})):
        m = getattr(pkg, est)(**KW, **extra)
        out.append(m.fit(X, y, **fit))
    return X, Xv, out


@pytest.mark.parametrize("kind", ["regression", "binary", "multiclass",
                                  "rank"])
def test_estimator_matches_jax(kind):
    X, Xv, (port, jax) = _fit_both(kind)
    assert port.best_iteration_ == jax.best_iteration_
    if kind == "rank":
        assert port.best_iteration_ < KW["n_estimators"]
    assert port.n_features_ == jax.n_features_ == 6
    assert port.evals_result_.keys() == jax.evals_result_.keys()
    for name in port.evals_result_:
        for metric, hist in port.evals_result_[name].items():
            np.testing.assert_allclose(hist, jax.evals_result_[name][metric],
                                       rtol=1e-5, atol=1e-5)
    assert np.array_equal(port.feature_importances_,
                          jax.feature_importances_)
    if kind in ("binary", "multiclass"):
        assert list(port.classes_) == list(jax.classes_)
        assert port.n_classes_ == jax.n_classes_
        np.testing.assert_allclose(port.predict_proba(Xv),
                                   jax.predict_proba(Xv), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(port.predict(Xv, raw_score=True),
                               jax.predict(Xv, raw_score=True), rtol=1e-5,
                               atol=1e-5)
    if kind in ("binary", "multiclass"):
        same = np.mean(port.predict(Xv) == jax.predict(Xv))
        assert same > 0.999 and set(port.predict(Xv)) <= set(port.classes_)
    else:
        np.testing.assert_allclose(port.predict(Xv), jax.predict(Xv),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("class_weight", ["balanced", "dict"])
def test_class_weight_matches_jax_and_sklearn(class_weight):
    """Weights keyed by the caller's labels. The JAX estimator computes
    them on the encoded labels (0, 1), so its dict is keyed by those
    (ROADMAP.md Queue 3): the same weights either way."""
    X, y = _data("binary")
    cw, jcw = class_weight, class_weight
    if class_weight == "dict":
        cw, jcw = {"yes": 3.0, "no": 0.5}, {1: 3.0, 0: 0.5}
    w = psk.compute_sample_weight(cw, y)
    np.testing.assert_allclose(w, compute_sample_weight(cw, y), rtol=1e-15,
                               atol=0)
    port = lt.LGBMClassifier(**KW, class_weight=cw, device="cpu").fit(X, y)
    jax = lgb.LGBMClassifier(**KW, class_weight=jcw).fit(X, y)
    np.testing.assert_allclose(port.predict_proba(X), jax.predict_proba(X),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="not in class_weight"):
        psk.compute_sample_weight({"maybe": 2.0}, y)


def test_estimator_equals_train():
    """``LGBMClassifier`` is ``lt.train`` on the same parameters: its
    probabilities are the booster's, to the bit."""
    X, y = _data("binary")
    est = lt.LGBMClassifier(**KW, device="cpu").fit(X, y)
    enc = (y == "yes").astype(np.float64)
    bst = lt.train({"objective": "binary", "num_leaves": 15,
                    "learning_rate": 0.1, "verbosity": -1},
                   lt.Dataset(X, label=enc), 30, device="cpu")
    p = bst.predict(X)
    assert np.array_equal(est.predict_proba(X), np.vstack([1 - p, p]).T)


def test_clone_get_params_set_params():
    est = lt.LGBMRegressor(n_estimators=5, num_leaves=7, device="cpu",
                           min_data_per_group=50)
    params = est.get_params()
    assert params["device"] == "cpu" and params["ops"] == "kernel"
    assert params["min_data_per_group"] == 50 and params["num_leaves"] == 7
    copy = clone(est)
    assert copy.get_params() == params and copy is not est
    copy.set_params(num_leaves=11, max_bin=63)
    assert copy.num_leaves == 11 and copy.get_params()["max_bin"] == 63
    assert est.num_leaves == 7
    # device and ops go to train, never into the parameters
    assert "device" not in copy._process_params()
    assert "ops" not in copy._process_params()
    assert copy._process_params()["max_bin"] == 63


def test_grid_search_runs():
    X, y = _data("binary", n=600)
    grid = GridSearchCV(lt.LGBMClassifier(n_estimators=3, device="cpu"),
                        {"num_leaves": [3, 7]}, cv=2)
    grid.fit(X, y)
    assert grid.best_params_["num_leaves"] in (3, 7)
    assert grid.predict(X[:10]).dtype.kind == "U"


def test_unseen_eval_label_is_refused():
    X, y = _data("binary", n=400)
    with pytest.raises(ValueError, match="unseen"):
        lt.LGBMClassifier(n_estimators=2, device="cpu").fit(
            X, y, eval_set=[(X[:10], np.array(["maybe"] * 10))])


def test_ranker_needs_groups():
    X, y = _data("rank", n=400)
    with pytest.raises(ValueError, match="group"):
        lt.LGBMRanker(device="cpu").fit(X, y)


_NO_SKLEARN = r"""
import builtins, json, sys
import numpy as np
real_import = builtins.__import__
def guarded(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and (name == "sklearn" or name.startswith("sklearn.")):
        raise ImportError("scikit-learn is blocked here")
    return real_import(name, globals, locals, fromlist, level)
builtins.__import__ = guarded
sys.modules["sklearn"] = None
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import sklearn as psk
assert not psk.SKLEARN_INSTALLED
X = np.asarray(json.loads(sys.argv[1]))
y = np.asarray(json.loads(sys.argv[2]))
est = lt.LGBMClassifier(n_estimators=6, num_leaves=7,
                        class_weight="balanced", device="cpu")
params = est.get_params()
est.set_params(learning_rate=0.2)
est.fit(X, y)
print(json.dumps({"proba": est.predict_proba(X).tolist(),
                  "pred": est.predict(X).tolist(),
                  "classes": est.classes_.tolist(),
                  "params": sorted(params),
                  "mods": sorted(m for m in sys.modules
                                 if m.split(".")[0] == "sklearn"
                                 and sys.modules[m] is not None)}))
"""


def test_classifier_fits_without_sklearn():
    """With scikit-learn blocked the estimator still gets and sets its
    parameters, encodes string labels and weighs classes, to the same
    probabilities as with scikit-learn present."""
    X, y = _data("multiclass", n=500)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _NO_SKLEARN, json.dumps(X.tolist()),
         json.dumps(y.tolist())], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    here = lt.LGBMClassifier(n_estimators=6, num_leaves=7,
                             class_weight="balanced", device="cpu")
    assert res["params"] == sorted(here.get_params())
    here.set_params(learning_rate=0.2).fit(X, y)
    assert res["mods"] == []
    assert res["classes"] == here.classes_.tolist()
    assert np.array_equal(np.asarray(res["proba"]), here.predict_proba(X))
    assert res["pred"] == here.predict(X).tolist()
