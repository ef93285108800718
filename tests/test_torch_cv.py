"""``lt.cv`` against ``lgb.cv`` on the CPU, and the port's fold
splitters against scikit-learn's.

Folds: the port's copies of ``StratifiedKFold`` and ``GroupKFold``
give scikit-learn 1.9.0's folds exactly, for several seeds and fold
counts, with tied group sizes. Training: the same folds, then each
fold's trees exact and leaf values within 2e-4 x the learning rate
up to the first
threshold tie, which must be one (the first differing node's two gains
within 1e-5 relative: the port sums histograms in float64, the JAX
serial learner in float32; ROADMAP.md Queue 3); the cv means and
standard deviations within 1e-5 over the iterations before any fold's
tie, the same keys, and the same best iteration when no tie comes
before the stop. Leaf values are held at 2e-4 x the learning rate
(the leaf value is the rate times the leaf's G / H), not 1e-5: the JAX
serial learner takes a small leaf's sums as float32 parent minus
sibling (the 600-bin entry of Queue 3); on the binary folds here, at
rate 0.1, its tree-0 leaves of 20 rows are 1.2e-5 from the port's. The JAX side runs with ``multiboost="off"`` (its
per-fold loop), once with ``"auto"`` at learning rate 0.1, where it
falls back to that loop too.
"""

import re

import numpy as np
import pytest
from sklearn.model_selection import GroupKFold, KFold, StratifiedKFold

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import engine as pe

from torch_efb_data import node, same_tree

N = 3000


def _data(objective, seed=0, n=N):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[rng.rand(n) < 0.05, 4] = np.nan
    z = X[:, 0] - 0.7 * X[:, 1] + 0.5 * X[:, 2] * (X[:, 3] > 0) \
        + 0.4 * rng.randn(n)
    group = None
    if objective == "binary":
        y = (z > 0).astype(np.float64)
    elif objective == "multiclass":
        y = np.digitize(z, [-0.6, 0.6]).astype(np.float64)
    elif objective == "lambdarank":
        y = np.digitize(z, [-1, 0, 1]).astype(np.float64)
        group = rng.randint(5, 25, n // 10)
        group = group[np.cumsum(group) <= n]
        group[-1] += n - group.sum()
    else:
        y = z
    return X, y, group


@pytest.mark.parametrize("nfold", [2, 3, 5])
@pytest.mark.parametrize("seed", [0, 1, 42])
@pytest.mark.parametrize("classes", [2, 3])
def test_stratified_folds_equal_sklearn(nfold, seed, classes):
    rng = np.random.RandomState(seed + 100)
    y = rng.randint(0, classes, 997).astype(np.float64)
    y[:5] = classes - 1           # the first label is not the smallest
    want = StratifiedKFold(nfold, shuffle=True, random_state=seed).split(
        np.empty(len(y)), y)
    got = pe._StratifiedKFold(nfold, shuffle=True, random_state=seed).split(
        np.empty(len(y)), y)
    for (a, b), (c, d) in zip(got, want, strict=True):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    plain = zip(pe._StratifiedKFold(nfold).split(None, y),
                StratifiedKFold(nfold).split(np.empty(len(y)), y),
                strict=True)
    assert all(np.array_equal(a, c) and np.array_equal(b, d)
               for (a, b), (c, d) in plain)


@pytest.mark.parametrize("nfold", [2, 3, 5, 7])
def test_group_folds_equal_sklearn(nfold):
    """Whole groups, many of equal size: the tie order is scikit-learn's
    (a stable argsort reversed)."""
    rng = np.random.RandomState(nfold)
    sizes = rng.choice([3, 5, 5, 8, 8, 8, 13], 60)
    groups = np.repeat(np.arange(60), sizes)
    want = GroupKFold(nfold).split(np.empty(len(groups)), groups=groups)
    got = pe._GroupKFold(nfold).split(None, groups=groups)
    for (a, b), (c, d) in zip(got, want, strict=True):
        assert np.array_equal(a, c) and np.array_equal(b, d)


def _params(objective, **extra):
    p = {"objective": objective, "num_leaves": 15, "learning_rate": 0.1,
         "verbosity": -1, "multiboost": "off"}
    if objective == "multiclass":
        p["num_class"] = 3
    p.update(extra)
    return p


def _first_tie(port_models, jax_models, lr):
    """The first tree index whose structure differs (None if none); it
    must be a threshold tie on one feature."""
    for i, (a, b) in enumerate(zip(port_models, jax_models)):
        if same_tree(a, b):
            np.testing.assert_allclose(a.leaf_value, b.leaf_value,
                                       rtol=1e-5, atol=2e-4 * lr)
            continue
        s = next(s for s in range(min(a.num_leaves, b.num_leaves) - 1)
                 if node(a, s) != node(b, s))
        ga, gb = float(a.split_gain[s]), float(b.split_gain[s])
        assert int(a.split_feature_inner[s]) \
            == int(b.split_feature_inner[s]), (i, s)
        assert abs(ga - gb) <= 1e-5 * abs(gb), (i, s, ga, gb)
        return i
    return None


def _run_both(objective, rounds=10, data=None, **kw):
    X, y, group = data or _data(objective)
    params = kw.pop("params", _params(objective))
    jparams = dict(params, **kw.pop("jax_params", {}))
    pk = dict(kw)
    rp = lt.cv(params, lt.Dataset(X, label=y, group=group), rounds,
               return_cvbooster=True, device="cpu", **pk)
    rj = lgb.cv(jparams, lgb.Dataset(X, label=y, group=group), rounds,
                return_cvbooster=True, **kw)
    return rp, rj


def _compare(rp, rj):
    """Keys, folds, trees up to a tie, and the cv lists before it;
    returns the first tie's iteration (None without one)."""
    bp, bj = rp.pop("cvbooster"), rj.pop("cvbooster")
    assert set(rp) == set(rj)
    rp["cvbooster"], rj["cvbooster"] = bp, bj
    assert len(bp.boosters) == len(bj.boosters)
    k = bp.boosters[0].num_model_per_iteration()
    ties = []
    for a, b in zip(bp.boosters, bj.boosters):
        assert np.array_equal(a.train_set.used_indices,
                              b.train_set.used_indices)
        assert a.num_trees() == len(b._gbdt.models)
        tie = _first_tie(a.models, b._gbdt.models,
                         float(a.params.get("learning_rate", 0.1)))
        if tie is not None:
            ties.append(tie // k)
    stop = min(ties) if ties else None
    for key in set(rp) - {"cvbooster"}:
        assert len(rp[key]) == len(rj[key]) or stop is not None
        np.testing.assert_allclose(rp[key][:stop], rj[key][:stop],
                                   rtol=1e-5, atol=1e-5)
    assert bp.best_iteration == bj.best_iteration or (
        stop is not None and stop < bp.best_iteration)
    return stop


def test_cv_regression_matches_jax():
    rp, rj = _run_both("regression", metrics=["l2", "l1"])
    assert set(rp) == {"l2-mean", "l2-stdv", "l1-mean", "l1-stdv",
                       "cvbooster"}
    _compare(rp, rj)


def test_cv_binary_stratified_early_stopping_matches_jax():
    X, y, _ = _data("binary")
    rp, rj = _run_both("binary", rounds=30, metrics="auc",
                       early_stopping_rounds=3,
                       params=_params("binary", learning_rate=0.5))
    bp, bj = rp["cvbooster"], rj["cvbooster"]
    # stratified: each fold's valid rows hold the label's share
    for b in bp.boosters:
        rows = np.setdiff1d(np.arange(N), b.train_set.used_indices)
        assert abs(y[rows].mean() - y.mean()) < 0.01
    tie = _compare(rp, rj)
    if tie is None:
        assert 0 < bp.best_iteration < 30
        assert len(rp["auc-mean"]) == bp.best_iteration


def test_cv_multiclass_matches_jax():
    _compare(*_run_both("multiclass", rounds=6, nfold=3))


def test_cv_lambdarank_keeps_whole_queries():
    X, y, group = _data("lambdarank")
    rp, rj = _run_both("lambdarank", rounds=6, data=(X, y, group),
                       params=_params("lambdarank", metric="ndcg",
                                      eval_at=[3, 5]), nfold=4)
    qid = np.repeat(np.arange(len(group)), group)
    for b in rp["cvbooster"].boosters:
        rows = b.train_set.used_indices
        kept = np.unique(qid[rows])
        assert np.array_equal(np.sort(np.nonzero(np.isin(qid, kept))[0]),
                              rows)
        assert b.train_set.get_group().sum() == len(rows)
    assert set(rp) == {"ndcg@3-mean", "ndcg@3-stdv", "ndcg@5-mean",
                       "ndcg@5-stdv", "cvbooster"}
    _compare(rp, rj)


def test_cv_against_jax_auto_multiboost():
    """JAX's ``multiboost=auto`` at a learning rate that is not a power
    of two falls back to its per-fold loop: the port's loop equals it."""
    rp, rj = _run_both("binary", rounds=8, metrics="binary_logloss",
                       jax_params={"multiboost": "auto"})
    _compare(rp, rj)


@pytest.mark.parametrize("how", ["list", "splitter"])
def test_cv_given_folds(how):
    X, y, _ = _data("regression")
    if how == "list":
        folds = list(KFold(4, shuffle=True, random_state=3).split(X))
        jfolds = folds
    else:
        folds, jfolds = KFold(4, shuffle=True, random_state=3), \
            KFold(4, shuffle=True, random_state=3)
    rp = lt.cv(_params("regression"), lt.Dataset(X, label=y), 5,
               folds=folds, return_cvbooster=True, device="cpu")
    rj = lgb.cv(_params("regression"), lgb.Dataset(X, label=y), 5,
                folds=jfolds, return_cvbooster=True)
    want = list(KFold(4, shuffle=True, random_state=3).split(X))
    for b, (tr, _) in zip(rp["cvbooster"].boosters, want, strict=True):
        assert np.array_equal(b.train_set.used_indices, tr)
    _compare(rp, rj)


def test_cv_eval_train_metric():
    rp, rj = _run_both("binary", rounds=5, metrics="auc",
                       eval_train_metric=True)
    assert set(rp) == {"training auc-mean", "training auc-stdv",
                       "valid auc-mean", "valid auc-stdv", "cvbooster"}
    _compare(rp, rj)


def test_cvbooster_calls_every_fold():
    X, y, _ = _data("binary")
    r = lt.cv(_params("binary"), lt.Dataset(X, label=y), 4, nfold=3,
              return_cvbooster=True, device="cpu")
    cvb = r["cvbooster"]
    preds = cvb.predict(X[:50])
    assert len(preds) == 3 and all(p.shape == (50,) for p in preds)
    assert cvb.num_trees() == [4, 4, 4]
    assert "cvbooster" not in lt.cv(_params("binary"),
                                    lt.Dataset(X, label=y), 2, nfold=3,
                                    device="cpu")


@pytest.mark.parametrize("param", [{"multiboost": "on"},
                                   {"multiboost_max_batch": 8}])
def test_cv_refuses_batched_multiboost(param):
    X, y, _ = _data("binary", n=300)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        lt.cv(_params("binary", **param), lt.Dataset(X, label=y), 2,
              device="cpu")
    # train reads neither, as the JAX package's train
    lt.train(_params("binary", **param), lt.Dataset(X, label=y), 1,
             device="cpu")


def _eval_lines(text):
    return [re.sub(r"^\[LightGBM-[A-Za-z]+\] \[Info\] ", "", ln)
            for ln in text.splitlines() if re.match(
                r"^\[LightGBM-[A-Za-z]+\] \[Info\] \[\d+\]", ln)]


def test_cv_callbacks_print_and_stop_as_jax(capsys):
    """``print_evaluation`` writes the same lines (the cv 5-tuples, with
    their stdv) and ``early_stopping`` stops at the same iteration."""
    X, y, _ = _data("binary")
    params = _params("binary", metric="auc", verbosity=1,
                     learning_rate=0.5)
    cb = dict(callbacks=None, verbose_eval=2, early_stopping_rounds=2)
    rp = lt.cv(params, lt.Dataset(X, label=y), 30, device="cpu", **cb)
    port_out = capsys.readouterr().out
    rj = lgb.cv(params, lgb.Dataset(X, label=y), 30, **cb)
    jax_out = capsys.readouterr().out
    lp, lj = _eval_lines(port_out), _eval_lines(jax_out)
    assert lp and len(lp) == len(lj)
    assert len(rp["auc-mean"]) == len(rj["auc-mean"]) < 30
    for a, b in zip(lp, lj):
        ha = [float(v) for v in re.findall(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?", a)]
        hb = [float(v) for v in re.findall(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?", b)]
        assert re.sub(r"[\d.e+-]+", "#", a) == re.sub(r"[\d.e+-]+", "#", b)
        np.testing.assert_allclose(ha, hb, rtol=1e-4, atol=1e-5)
