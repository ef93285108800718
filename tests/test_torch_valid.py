"""Training with valid sets and early stopping, the port against the JAX
package on the CPU (2000 x 8, 15 leaves, learning rate 0.4, up to 40
iterations).

Regression, regression_l1, multiclass (3 classes), lambdarank and
cross_entropy train through ``lt.train`` and ``lgb.train`` (its serial
learner, the model oracle on the CPU) with a valid set binned with the
training set's mappers (``create_valid``), ``early_stopping_rounds=3``
and ``evals_result``.

Tree structure is exact up to the first tie: a node where the two
packages choose splits whose gains agree within 1e-5 relative (float32
against float64 histogram sums; ROADMAP.md Queue 3). The test asserts
that the first difference is such a tie and compares the trees before
it; the trees after it grow from other scores. On this data the ties
are a NaN feature's default direction (regression tree 12, multiclass
tree 17, cross_entropy tree 9); the JAX package's own serial and
partitioned learners break the same kind of tie apart (regression tree
8, multiclass 17, cross_entropy 9). Leaf values agree at rtol 1e-5 /
atol 1e-5, as in ``tests/test_torch_train.py``, except lambdarank's at
atol 5e-5: its leaf sums cancel (each query's lambdas sum to zero), and
the port is 2.9e-5 from the JAX serial learner by tree 8 where the JAX
partitioned learner is 2.9e-4 from it. The eval histories agree at
rtol 1e-5 / atol 1e-5 for the iterations before the first tie, and
both packages stop at the same ``best_iteration`` when they stopped
before it; otherwise each stops where its own history says.

The JAX-trained trees carried into the port (``convert.py``) write the
JAX writer's text up to ``best_iteration``, objective line included;
the port's own text keeps ``best_iteration`` (the model holds that many
iterations) and predicts as the trained booster does at
``best_iteration``, which is also what ``predict`` gives with no
``num_iteration``. Custom objectives (``fobj``) and metrics (``feval``),
evaluation of the training set, query groups read from a ``.query``
file, the booster's own early-stopping loop and every metric name of
the JAX factory evaluated on a valid set are held against JAX too.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.io import model_text as jtext
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import bin_mappers_from_state, trees_from_state
from lightgbm_tpu_torch.data import Dataset
from lightgbm_tpu_torch.io import model_text as ptext
from lightgbm_tpu_torch.models.gbdt import GBDT

torch.set_num_threads(2)
N, F, NV = 2000, 8, 600
ROUNDS = 40
OBJECTIVES = ["regression", "regression_l1", "multiclass", "lambdarank",
              "cross_entropy"]
BASE = {"num_leaves": 15, "learning_rate": 0.4, "verbosity": -1}


def _data(objective, seed):
    rng = np.random.RandomState(seed)
    n = N if seed == 0 else NV
    X = rng.randn(n, F)
    X[rng.rand(n) < 0.1, 2] = np.nan
    lat = X[:, 0] - 0.7 * X[:, 1] + 0.5 * np.nan_to_num(X[:, 2]) * X[:, 3]
    noisy = lat + 0.8 * rng.randn(n)
    kw = {}
    if objective == "multiclass":
        y = np.digitize(noisy, [-0.5, 0.5]).astype(np.float64)
    elif objective == "lambdarank":
        sizes = np.full(n // 20, 20)
        kw["group"] = sizes
        y = np.clip(np.round(noisy + 2), 0, 4)
    elif objective == "cross_entropy":
        y = 1.0 / (1.0 + np.exp(-noisy))
    else:
        y = noisy + rng.standard_cauchy(n) * 0.1 \
            if objective == "regression_l1" else noisy
    return X, y, kw


def _params(objective):
    p = dict(BASE, objective=objective)
    if objective == "multiclass":
        p["num_class"] = 3
    if objective == "lambdarank":
        p["eval_at"] = [1, 3, 5]
    return p


def _train_both(objective):
    X, y, kw = _data(objective, 0)
    Xv, yv, kwv = _data(objective, 1)
    params = _params(objective)
    port_er, jax_er = {}, {}
    tr = lt.Dataset(X, label=y, **kw)
    port = lt.train(params, tr, ROUNDS,
                    valid_sets=[tr.create_valid(Xv, label=yv, **kwv)],
                    valid_names=["valid"], early_stopping_rounds=3,
                    evals_result=port_er, verbose_eval=False, device="cpu")
    jtr = lgb.Dataset(X, label=y, **kw)
    jb = lgb.train(dict(params, fused_split_kernel="off"), jtr, ROUNDS,
                   valid_sets=[jtr.create_valid(Xv, label=yv, **kwv)],
                   valid_names=["valid"], early_stopping_rounds=3,
                   evals_result=jax_er, verbose_eval=False)
    return dict(X=X, Xv=Xv, params=params, port=port, jax=jb,
                port_er=port_er, jax_er=jax_er)


@pytest.fixture(scope="module", params=OBJECTIVES)
def run(request):
    return _train_both(request.param)


def _structure(t):
    return (t.num_leaves, t.split_feature_inner.tolist(),
            t.threshold_bin.tolist(), (t.decision_type & 2).tolist(),
            t.left_child.tolist(), t.right_child.tolist())


LEAF_ATOL = {"lambdarank": 5e-5}


def _first_difference(a, b):
    """The first node at which two trees' splits differ, or None."""
    for s in range(min(a.num_leaves, b.num_leaves) - 1):
        if _structure_at(a, s) != _structure_at(b, s):
            return s
    return None


def _structure_at(t, s):
    return (int(t.split_feature_inner[s]), int(t.threshold_bin[s]),
            int(t.decision_type[s] & 2), int(t.left_child[s]),
            int(t.right_child[s]))


def _first_tie(port_models, jax_models):
    """The index of the first tree whose structure differs from JAX's,
    None when none does. The difference must be a tie: the first
    differing node's two splits have the same gain within 1e-5."""
    for i, (a, b) in enumerate(zip(port_models, jax_models)):
        if _structure(a) == _structure(b):
            continue
        s = _first_difference(a, b)
        assert s is not None, f"tree {i}: same splits, other leaf count"
        ga, gb = float(a.split_gain[s]), float(b.split_gain[s])
        assert abs(ga - gb) <= 1e-5 * abs(gb), (i, s, ga, gb)
        return i
    return None


def test_trees_match_jax(run):
    pm, jm = run["port"].models, run["jax"]._gbdt.models
    tie = _first_tie(pm, jm)
    if tie is None:
        assert len(pm) == len(jm)
    atol = LEAF_ATOL.get(run["params"]["objective"], 1e-5)
    for a, b in list(zip(pm, jm))[:tie]:
        assert _structure(a) == _structure(b)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=atol)


def _stop(history, rounds):
    """(iterations trained, best iteration) by the early-stopping rule
    on a recorded history."""
    best = {name: (None, 0) for name in history}
    for i in range(len(next(iter(history.values())))):
        for name, hist in history.items():
            val, it = best[name]
            if val is None or (hist[i] > val if name.startswith("ndcg")
                               else hist[i] < val):
                best[name] = (hist[i], i)
            elif i - it >= rounds:
                return i + 1, it + 1
    return None


def test_eval_history_and_best_iteration_match_jax(run):
    port, jb = run["port"], run["jax"]
    k = port.num_model_per_iteration()
    tie = _first_tie(port.models, jb._gbdt.models)
    upto = None if tie is None else tie // k
    assert list(run["port_er"]) == list(run["jax_er"]) == ["valid"]
    assert list(run["port_er"]["valid"]) == list(run["jax_er"]["valid"])
    for name, hist in run["jax_er"]["valid"].items():
        np.testing.assert_allclose(run["port_er"]["valid"][name][:upto],
                                   hist[:upto], rtol=1e-5, atol=1e-5)
    # the port's early stopping on its own history: the first metric
    # (in order) whose best is 3 iterations old stops training there
    assert port.current_iteration() < ROUNDS
    assert (port.current_iteration(), port.best_iteration) \
        == _stop(run["port_er"]["valid"], 3)
    if upto is None or port.current_iteration() <= upto:
        assert port.best_iteration == jb.best_iteration
        for name, val in jb.best_score["valid"].items():
            np.testing.assert_allclose(port.best_score["valid"][name], val,
                                       rtol=1e-5, atol=1e-5)


def _jax_tree_state(t):
    return dict(num_leaves=t.num_leaves, split_feature=t.split_feature,
                threshold=t.threshold, decision_type=t.decision_type,
                left_child=t.left_child, right_child=t.right_child,
                leaf_value=t.leaf_value, missing_code=t._missing_code,
                threshold_bin=t.threshold_bin,
                split_feature_inner=t.split_feature_inner,
                split_gain=t.split_gain, internal_value=t.internal_value,
                internal_weight=t.internal_weight,
                internal_count=t.internal_count,
                leaf_weight=t.leaf_weight, leaf_count=t.leaf_count,
                leaf_parent=t.leaf_parent, leaf_depth=t.leaf_depth,
                shrinkage=t.shrinkage, cat_threshold=t.cat_threshold)


def test_carried_model_writes_the_jax_writers_text(run):
    """The JAX-trained trees in a port GBDT: the port's writer gives the
    JAX writer's text up to best_iteration (objective line and all) but
    for the footer's ``device_type``."""
    jb = run["jax"]
    jg = jb._gbdt
    jg.finalize_trees()
    params = dict(run["params"], fused_split_kernel="off")
    cfg = Config.from_params(params)
    X, y, kw = _data(params["objective"], 0)
    mappers = bin_mappers_from_state(
        [m.to_dict() for m in jb.train_set._inner.bin_mappers])
    ds = Dataset.from_numpy(X, cfg, label=y, bin_mappers=mappers, **kw)
    gbdt = GBDT(cfg, ds, torch.device("cpu"))
    gbdt.init_from_models(trees_from_state(
        [_jax_tree_state(t) for t in jg.models]))
    best = jb.best_iteration
    port = ptext.save_model_to_string(gbdt, 0, best).split("\n")
    ref = jtext.save_model_to_string(jg, 0, best).split("\n")
    assert len(port) == len(ref)
    diff = [(a, b) for a, b in zip(port, ref) if a != b]
    assert diff == [("[device_type: cuda]", "[device_type: tpu]")], diff[:3]


def test_best_iteration_survives_the_model_text(run):
    port, Xv = run["port"], run["Xv"]
    best = port.best_iteration
    text = port.model_to_string()
    loaded = lt.Booster(model_str=text, device="cpu")
    assert loaded.current_iteration() == best < port.current_iteration()
    at_best = port.predict(Xv, num_iteration=best)
    np.testing.assert_array_equal(port.predict(Xv), at_best)
    np.testing.assert_array_equal(loaded.predict(Xv), at_best)
    np.testing.assert_array_equal(
        lgb.Booster(model_str=text).predict(Xv, raw_score=True),
        port.predict(Xv, raw_score=True))


def test_custom_objective_and_metric_match_jax():
    """``fobj`` (L2 gradients) trains the JAX package's trees; ``feval``
    and the training set's own metric land in the history."""
    X, y, _ = _data("regression", 0)
    Xv, yv, _ = _data("regression", 1)

    def fobj(score, data):
        label = np.asarray(data.get_label(), np.float64)
        return score - label, np.ones_like(score)

    def feval(score, data):
        return "max_err", float(np.abs(score - data.get_label()).max()), \
            False
    params = dict(BASE, metric="l1")
    out = {}
    for pkg in ("port", "jax"):
        er = {}
        kw = {"device": "cpu"} if pkg == "port" else {}
        mod = lt if pkg == "port" else lgb
        tr = mod.Dataset(X, label=y)
        bst = mod.train(params, tr, 6, valid_sets=[tr, tr.create_valid(
            Xv, label=yv)], valid_names=["train", "valid"], fobj=fobj,
            feval=feval, evals_result=er, verbose_eval=False, **kw)
        out[pkg] = (bst, er)
    (port, port_er), (jb, jax_er) = out["port"], out["jax"]
    assert port._gbdt.objective is None
    assert [_structure(t) for t in port.models] \
        == [_structure(t) for t in jb._gbdt.models]
    assert list(port_er) == list(jax_er) == ["train", "valid"]
    for ds in jax_er:
        assert list(port_er[ds]) == list(jax_er[ds]) == ["l1", "max_err"]
        for name in jax_er[ds]:
            np.testing.assert_allclose(port_er[ds][name], jax_er[ds][name],
                                       rtol=1e-5, atol=1e-5)


def test_valid_set_bins_through_the_training_mappers():
    X, y, _ = _data("regression", 0)
    Xv, yv, _ = _data("regression", 1)
    Xv[:5] = X.max(axis=0) + 1.0          # past every training bin
    tr = lt.Dataset(X, label=y)
    bst = lt.Booster({"objective": "regression", "verbosity": -1}, tr,
                     device="cpu")
    va = tr.create_valid(Xv, label=yv)
    bst.add_valid(va, "valid")
    jtr = lgb.Dataset(X, label=y, params={"verbosity": -1})
    jb = lgb.Booster({"objective": "regression", "verbosity": -1}, jtr)
    jva = jtr.create_valid(Xv, label=yv)
    jb.add_valid(jva, "valid")
    np.testing.assert_array_equal(va._binned.binned, jva._inner.binned)
    assert va._binned.bin_mappers == tr._binned.bin_mappers


def test_query_file_fills_the_groups(tmp_path):
    """A ``.query`` file beside a CSV gives the same lambdarank trees as
    the same groups passed as arrays."""
    X, y, kw = _data("lambdarank", 0)
    path = str(tmp_path / "rank.csv")
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.17g")
    np.savetxt(path + ".query", kw["group"], fmt="%d")
    params = _params("lambdarank")
    from_file = lt.train(params, lt.Dataset(path), 3, device="cpu")
    from_arrays = lt.train(params, lt.Dataset(X, label=y, **kw), 3,
                           device="cpu")
    assert [_structure(t) for t in from_file.models] \
        == [_structure(t) for t in from_arrays.models]
    for a, b in zip(from_file.models, from_arrays.models):
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)


def test_booster_training_loop_stops_early_as_jax():
    """``GBDT.train`` with ``early_stopping_round`` in the parameters
    (the reference CLI's loop): ``output_metric`` records the training
    and valid metrics every iteration, stops once the valid metric has
    not improved for 3 iterations, and cuts the model and the cached
    scores back to the best iteration, as the JAX package does."""
    X, y, _ = _data("regression_l1", 0)
    Xv, yv, _ = _data("regression_l1", 1)
    params = dict(_params("regression_l1"), early_stopping_round=3,
                  is_provide_training_metric=True, metric="l1,l2")
    port = lt.Booster(params, lt.Dataset(X, label=y), device="cpu")
    port.add_valid(port.train_set.create_valid(Xv, label=yv), "valid")
    jtr = lgb.Dataset(X, label=y)
    jb = lgb.Booster(dict(params, fused_split_kernel="off"), jtr)
    jb.add_valid(jtr.create_valid(Xv, label=yv), "valid")
    port._gbdt.train(ROUNDS)
    jb._gbdt.train(ROUNDS)
    pg, jg = port._gbdt, jb._gbdt
    jg.finalize_trees()
    assert pg.iter == jg.iter < ROUNDS - 3
    assert [_structure(t) for t in pg.models] \
        == [_structure(t) for t in jg.models]
    assert list(pg.evals_result) == list(jg.evals_result) \
        == ["training", "valid"]
    for ds, metrics in jg.evals_result.items():
        for name, hist in metrics.items():
            np.testing.assert_allclose(pg.evals_result[ds][name], hist,
                                       rtol=1e-5, atol=1e-5)
    for ps, js in [(pg.train_score, jg.train_score)] \
            + list(zip(pg.valid_scores, jg.valid_scores)):
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("objective,metrics", [
    ("regression", "l2,mse,rmse,l1,mae,quantile,huber,fair,mape"),
    ("poisson", "poisson,gamma,gamma_deviance,tweedie"),
    ("binary", "binary_logloss,binary_error,auc,cross_entropy,"
               "kullback_leibler"),
    ("cross_entropy_lambda", "cross_entropy_lambda,xentlambda"),
    ("multiclass", "multi_logloss,multi_error,auc_mu"),
    ("lambdarank", "ndcg,map"),
])
def test_every_metric_evaluates_on_a_valid_set(objective, metrics):
    """Every metric name of the JAX factory on a valid set, through the
    objective's conversion, 2 iterations: the same names and values as
    JAX's history."""
    base = {"binary": "multiclass", "poisson": "regression",
            "cross_entropy_lambda": "cross_entropy"}.get(objective,
                                                         objective)
    X, y, kw = _data(base, 0)
    Xv, yv, kwv = _data(base, 1)
    if objective == "binary":
        y, yv = (y > 0).astype(np.float64), (yv > 0).astype(np.float64)
    elif objective == "poisson":
        y, yv = np.exp(0.5 * y), np.exp(0.5 * yv)
    params = dict(_params(objective), metric=metrics)
    hist = {}
    for pkg, mod, pkg_params, extra in (
            ("port", lt, params, {"device": "cpu"}),
            ("jax", lgb, dict(params, fused_split_kernel="off"), {})):
        er = {}
        tr = mod.Dataset(X, label=y, **kw)
        mod.train(pkg_params, tr, 2,
                  valid_sets=[tr.create_valid(Xv, label=yv, **kwv)],
                  evals_result=er, verbose_eval=False, **extra)
        hist[pkg] = er["valid_0"]
    assert list(hist["port"]) == list(hist["jax"])
    for name, vals in hist["jax"].items():
        np.testing.assert_allclose(hist["port"][name], vals, rtol=1e-5,
                                   atol=1e-5)
