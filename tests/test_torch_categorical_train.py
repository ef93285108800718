"""Categorical features end to end on the CPU, the port against the JAX
package: ``lt.train`` against ``lgb.train`` on a 40-way category with
numeric noise (the data of JAX ``tests/test_categorical.py:171``) for
binary, regression and 3-class objectives at max_bin 255 (the
partitioned learner) and 600 (the serial learner), with a valid set;
the model text's categorical fields; every form of
``categorical_feature``; pandas category frames; the golden categorical
dataset; models carried over from the JAX package; the 256-bin edge.

Tree structure is exact, categorical left sets included, up to a logged
tie (ROADMAP.md Queue 3). Two kinds occur on this data:

* a mirrored split: the many-vs-many search reaches one partition from
  both ends of the category order, and the two directions' gains differ
  by float rounding only, so the packages may put the complementary
  sets on the left. The tree computes the same function (its
  predictions are held within 1e-5) and the trees after it are compared
  as before;
* a numerical threshold tie at 600 bins: two thresholds a few bins
  apart with gains within 1e-5 of each other. The trees after it grow
  from other scores and are not compared.

Leaf values are held within 1e-5, valid histories within 1e-6, both up
to the first tie of the second kind.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt

torch.set_num_threads(2)
ROUNDS = 8


def _data(objective, seed=3, n=6000):
    rng = np.random.RandomState(seed)
    cats = rng.randint(0, 40, n)
    effect = np.where(np.isin(cats, [2, 5, 11, 17, 23, 31]), 2.5, -1.0)
    noise = rng.randn(n, 3)
    z = effect + 0.3 * noise[:, 0] + 0.5 * rng.randn(n)
    X = np.concatenate([cats[:, None].astype(np.float64), noise], axis=1)
    if objective == "binary":
        y = (z > 0).astype(np.float32)
    elif objective == "regression":
        y = z.astype(np.float32)
    else:
        y = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(np.float32)
    return X, y


def _params(objective, max_bin):
    p = {"objective": objective, "num_leaves": 15, "verbosity": -1,
         "learning_rate": 0.2, "min_data_per_group": 20, "max_bin": max_bin}
    if objective == "multiclass":
        p["num_class"] = 3
    return p


def _node(t, s):
    """A node's split: feature, threshold bin (numerical nodes), decision
    type, children and left categories (categorical nodes). A
    categorical node's threshold_bin is its feature's numerical-scan
    threshold, which the JAX merge keeps and nothing reads; there the
    port's float64-rounded scan and JAX's float32 scan may pick
    neighbouring bins, so it is not part of the split."""
    cat = bool(t.decision_type[s] & 1)
    cats = tuple(sorted(t.cat_threshold[s].tolist())) if cat else ()
    return (int(t.split_feature_inner[s]),
            -1 if cat else int(t.threshold_bin[s]),
            int(t.decision_type[s]), int(t.left_child[s]),
            int(t.right_child[s]), cats)


def _same(a, b):
    return a.num_leaves == b.num_leaves and all(
        _node(a, s) == _node(b, s) for s in range(a.num_leaves - 1))


def compare_trees(port_models, jax_models, X, leaf_atol=1e-5):
    """Trees tree by tree (module note). Returns the ties met, (tree,
    node, kind), and the index of the first tree that is not compared
    (None when every tree was)."""
    ties = []
    assert len(port_models) == len(jax_models)
    for i, (a, b) in enumerate(zip(port_models, jax_models)):
        if _same(a, b):
            np.testing.assert_allclose(a.leaf_value, b.leaf_value,
                                       rtol=1e-5, atol=leaf_atol)
            continue
        s = next(s for s in range(min(a.num_leaves, b.num_leaves) - 1)
                 if _node(a, s) != _node(b, s))
        ga, gb = float(a.split_gain[s]), float(b.split_gain[s])
        assert int(a.split_feature_inner[s]) == int(
            b.split_feature_inner[s]), (i, s)
        assert abs(ga - gb) <= 1e-5 * abs(gb), (i, s, ga, gb)
        if a.decision_type[s] & 1:
            # mirrored: complementary left sets, the same function
            assert not set(_node(a, s)[5]) & set(_node(b, s)[5]), (i, s)
            np.testing.assert_allclose(a.predict(X), b.predict(X),
                                       rtol=0, atol=1e-5)
            ties.append((i, s, "mirrored"))
            continue
        ties.append((i, s, "threshold"))
        return ties, i
    return ties, None


CONFIGS = [(o, mb) for o in ("binary", "regression", "multiclass")
           for mb in (255, 600)]


@pytest.fixture(scope="module", params=CONFIGS,
                ids=[f"{o}-{mb}" for o, mb in CONFIGS])
def run(request):
    objective, max_bin = request.param
    X, y = _data(objective)
    Xv, yv = _data(objective, seed=4, n=2000)
    p = _params(objective, max_bin)
    ds = lt.Dataset(X, label=y, categorical_feature=[0])
    port_er, jax_er = {}, {}
    port = lt.train(p, ds, ROUNDS, valid_sets=[ds.create_valid(Xv, label=yv)],
                    evals_result=port_er, verbose_eval=False, device="cpu")
    jds = lgb.Dataset(X, label=y, categorical_feature=[0])
    jb = lgb.train(dict(p, fused_split_kernel="off"), jds,
                   num_boost_round=ROUNDS,
                   valid_sets=[jds.create_valid(Xv, label=yv)],
                   evals_result=jax_er, verbose_eval=False)
    return dict(X=X, port=port, jax=jb, port_er=port_er, jax_er=jax_er,
                max_bin=max_bin)


def test_learner_and_categorical_state(run):
    from lightgbm_tpu_torch.learner import (PartitionedTreeLearner,
                                            SerialTreeLearner)
    lrn = run["port"]._gbdt.learner
    want = PartitionedTreeLearner if run["max_bin"] == 255 \
        else SerialTreeLearner
    assert type(lrn) is want
    assert lrn.params.has_categorical and not lrn.fused
    assert any(t.decision_type[:t.num_leaves - 1].any() & 1
               for t in run["port"].models)


def test_trees_match_jax(run):
    ties, upto = compare_trees(run["port"].models, run["jax"]._gbdt.models,
                               run["X"])
    if upto is None:
        np.testing.assert_allclose(
            run["port"].predict(run["X"], raw_score=True),
            run["jax"].predict(run["X"], raw_score=True), rtol=0, atol=1e-5)


def test_valid_history_matches_jax(run):
    k = run["port"].num_model_per_iteration()
    _, upto = compare_trees(run["port"].models, run["jax"]._gbdt.models,
                            run["X"])
    it = None if upto is None else upto // k
    (pname, ph), = run["port_er"].items()
    (jname, jh), = run["jax_er"].items()
    assert pname == jname and list(ph) == list(jh)
    for metric, hist in jh.items():
        assert len(ph[metric]) == len(hist) == ROUNDS
        np.testing.assert_allclose(ph[metric][:it], hist[:it], rtol=0,
                                   atol=1e-6)


def _text_fields(text):
    """Per tree: decision_type, cat_boundaries, cat_threshold; and the
    header's feature_infos."""
    trees, infos, cur = [], None, None
    for line in text.splitlines():
        if line.startswith("feature_infos="):
            infos = line
        elif line.startswith("Tree="):
            cur = {}
            trees.append(cur)
        elif cur is not None and line.split("=")[0] in (
                "decision_type", "cat_boundaries", "cat_threshold",
                "num_cat"):
            key, val = line.split("=", 1)
            cur[key] = val
    return infos, trees


def test_model_text_categorical_fields_match_jax(run):
    port, jb = run["port"], run["jax"]
    pinfo, ptrees = _text_fields(port.model_to_string())
    jinfo, jtrees = _text_fields(jb.model_to_string())
    assert pinfo == jinfo
    assert ":" in pinfo.split("=", 1)[1].split()[0]   # a:b:c categories
    same = [i for i, (a, b) in enumerate(zip(port.models,
                                             jb._gbdt.models))
            if _same(a, b)]
    assert same
    for i in same:
        assert ptrees[i] == jtrees[i], i
    assert any(int(t.get("num_cat", 0)) for t in ptrees)
    # the text reloads into the same predictions, categorical nodes
    # through their raw categories
    back = lt.Booster(model_str=port.model_to_string(), device="cpu")
    np.testing.assert_array_equal(back.predict(run["X"], raw_score=True),
                                  port.predict(run["X"], raw_score=True))


def test_pred_leaf_equals_the_bin_walk(run):
    """Raw-value prediction of every training row reaches the leaf the
    bin-space walk of its bins reaches, tree by tree."""
    port = run["port"]
    binned = port._gbdt.train_data.binned
    leaves = port.predict(run["X"], pred_leaf=True)
    for j, t in enumerate(port.models):
        np.testing.assert_array_equal(leaves[:, j],
                                      t.predict_leaf_index_binned(binned))


def test_early_stopping_on_a_categorical_valid_set():
    X, y = _data("binary")
    Xv, yv = _data("binary", seed=9, n=1500)
    p = dict(_params("binary", 255), learning_rate=0.6, num_leaves=31)
    ds = lt.Dataset(X, label=y, categorical_feature=[0])
    port = lt.train(p, ds, 40, valid_sets=[ds.create_valid(Xv, label=yv)],
                    early_stopping_rounds=2, verbose_eval=False,
                    device="cpu")
    jds = lgb.Dataset(X, label=y, categorical_feature=[0])
    jb = lgb.train(dict(p, fused_split_kernel="off"), jds,
                   num_boost_round=40,
                   valid_sets=[jds.create_valid(Xv, label=yv)],
                   early_stopping_rounds=2, verbose_eval=False)
    assert 0 < port.best_iteration < port.current_iteration() < 40
    # leaf values carry the learning rate, and so does the float32 gap
    # of their sums: 1e-5 at lr 0.2 is 3e-5 at lr 0.6
    _, upto = compare_trees(port.models, jb._gbdt.models[:len(port.models)],
                            X, leaf_atol=3e-5)
    if upto is None:
        assert port.best_iteration == jb.best_iteration


@pytest.mark.parametrize("form", ["names", "name_prefix", "param",
                                  "param_alias", "train_arg", "string"])
def test_categorical_feature_forms_give_the_index_model(form):
    X, y = _data("binary", n=3000)
    names = ["cat", "a", "b", "c"]
    p = _params("binary", 255)
    ref = lt.train(p, lt.Dataset(X, label=y, feature_name=names,
                                 categorical_feature=[0]), 3, device="cpu")
    kw, tkw = {"feature_name": names}, {}
    if form == "names":
        kw["categorical_feature"] = ["cat"]
    elif form == "name_prefix":
        p = dict(p, categorical_feature="name:cat")
    elif form == "param":
        p = dict(p, categorical_feature="0")
    elif form == "param_alias":
        p = dict(p, cat_feature="0")
    elif form == "train_arg":
        tkw["categorical_feature"] = ["cat"]
    else:
        kw["categorical_feature"] = "0"
    bst = lt.train(p, lt.Dataset(X, label=y, **kw), 3, device="cpu", **tkw)
    assert bst._gbdt.learner.params.has_categorical
    body = bst.model_to_string().split("parameters:")[0]
    assert body == ref.model_to_string().split("parameters:")[0]


def test_unknown_categorical_name_raises():
    X, y = _data("binary", n=500)
    with pytest.raises(lt.LightGBMError, match="nope"):
        lt.train(_params("binary", 255),
                 lt.Dataset(X, label=y, categorical_feature=["nope"]), 1,
                 device="cpu")


def test_pandas_category_frame_gives_the_same_model():
    pd = pytest.importorskip("pandas")
    X, y = _data("binary", n=3000)
    letters = np.asarray([f"c{i:02d}" for i in range(40)])
    df = pd.DataFrame({"cat": pd.Categorical(letters[X[:, 0].astype(int)]),
                       "a": X[:, 1], "b": X[:, 2], "c": X[:, 3]})
    p = _params("binary", 255)
    bst = lt.train(p, lt.Dataset(df, label=y), 3, device="cpu")
    codes = df["cat"].cat.codes.to_numpy().astype(np.float64)
    Xc = np.column_stack([codes, X[:, 1:]])
    ref = lt.train(p, lt.Dataset(Xc, label=y, feature_name=list(df.columns),
                                 categorical_feature=[0]), 3, device="cpu")
    text = bst.model_to_string()
    assert text.split("parameters:")[0] \
        == ref.model_to_string().split("parameters:")[0]
    assert bst.pandas_categorical == [list(letters)]
    # the JAX package writes the same trailer for the same frame
    jb = lgb.train(dict(p, fused_split_kernel="off"), lgb.Dataset(df, label=y),
                   num_boost_round=3, verbose_eval=False)
    assert text.rstrip().splitlines()[-1] \
        == jb.model_to_string().rstrip().splitlines()[-1]
    back = lt.Booster(model_str=text, device="cpu")
    assert back.pandas_categorical == bst.pandas_categorical
    # a frame whose categories come in another order codes the same
    shuffled = df.copy()
    shuffled["cat"] = shuffled["cat"].cat.reorder_categories(
        list(letters[::-1]))
    want = ref.predict(Xc, raw_score=True)
    np.testing.assert_array_equal(back.predict(shuffled, raw_score=True),
                                  want)
    np.testing.assert_array_equal(bst.predict(df, raw_score=True), want)


def test_golden_categorical_dataset_quality():
    """The reference CLI's categorical golden dataset, trained on the
    CPU with its ``train_params`` (``categorical_feature=0,1`` in the
    params): held-out loss within 5% of the reference's recorded
    predictions, the margin of ``tests/test_golden_parity.py``."""
    import os
    from golden_common import DATASETS
    spec = dict(kv.split("=", 1)
                for kv in DATASETS["categorical"]["train_params"])
    n_trees = int(spec.pop("num_trees"))
    Xtr, ytr, Xte, yte = DATASETS["categorical"]["make"]()
    bst = lt.train(spec, lt.Dataset(Xtr, label=ytr), n_trees, device="cpu")
    assert bst._gbdt.learner.params.has_categorical
    here = os.path.dirname(os.path.abspath(__file__))
    ref = np.loadtxt(os.path.join(here, "fixtures", "golden",
                                  "pred_categorical.txt"))
    ours = np.mean(np.abs(bst.predict(Xte) - yte))
    theirs = np.mean(np.abs(ref - yte))
    assert ours < theirs * 1.05, (ours, theirs)


def test_jax_categorical_model_carries_over():
    """A JAX-trained categorical booster and its Dataset through
    ``convert.py``: raw-value predictions equal, and the bin-space walk
    of the port's binned matrix (the valid-set walk) equal to them."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.convert import (bin_mappers_from_state,
                                            trees_from_state)
    from lightgbm_tpu_torch.data import Dataset
    X, y = _data("regression", n=3000)
    p = _params("regression", 255)
    jds = lgb.Dataset(X, label=y, categorical_feature=[0])
    jb = lgb.train(dict(p, fused_split_kernel="off"), jds,
                   num_boost_round=4, verbose_eval=False)
    inner = jds._inner
    ds = Dataset.from_numpy(X, Config.from_params(p), label=y,
                            bin_mappers=bin_mappers_from_state(
                                [m.to_dict() for m in inner.bin_mappers]))
    np.testing.assert_array_equal(ds.binned, np.asarray(inner.binned))
    states = [dict(
        num_leaves=t.num_leaves, split_feature=t.split_feature,
        threshold=t.threshold, decision_type=t.decision_type,
        left_child=t.left_child, right_child=t.right_child,
        leaf_value=t.leaf_value, missing_code=t._missing_code,
        threshold_bin=t.threshold_bin,
        split_feature_inner=t.split_feature_inner,
        cat_threshold=t.cat_threshold,
        cat_bitsets=np.asarray(t.cat_bitsets), num_bin=t._num_bin,
        default_bin=t._default_bin) for t in jb._gbdt.models]
    trees = trees_from_state(states)
    assert any(t.decision_type.any() & 1 for t in trees)
    bst = lt.Booster.from_trees(trees, params=p, device="cpu")
    want = jb.predict(X, raw_score=True)
    np.testing.assert_allclose(bst.predict(X, raw_score=True), want,
                               rtol=0, atol=1e-6)
    score = torch.zeros((len(X), 1))
    for t in trees:
        t.predict_binned_add(score, 0, torch.from_numpy(ds.binned))
    np.testing.assert_allclose(score[:, 0].numpy(), want, rtol=0, atol=1e-5)


def test_wide_categorical_column_never_splits():
    """300 categories at max_bin 1023 (the serial learner): the column
    keeps 300 bins, wider than the 256-bin bitset, so neither package
    splits on it (ROADMAP.md Queue 3, reference-side); rows in bins at
    or above 256 exist, and training's leaf, the bin walk and raw-value
    prediction agree on every row."""
    rng = np.random.RandomState(11)
    n = 20000
    ranks = np.arange(1, 301)
    prob = ranks ** -1.2 / (ranks ** -1.2).sum()
    cats = rng.choice(300, n, p=prob)
    noise = rng.randn(n, 2)
    y = ((cats % 7 == 0) * 2.0 + noise[:, 0] + 0.3 * rng.randn(n) > 0.5) \
        .astype(np.float32)
    X = np.column_stack([cats.astype(np.float64), noise])
    p = dict(_params("binary", 1023), num_leaves=31)
    bst = lt.train(p, lt.Dataset(X, label=y, categorical_feature=[0]), 3,
                   device="cpu")
    jb = lgb.train(dict(p, fused_split_kernel="off"),
                   lgb.Dataset(X, label=y, categorical_feature=[0]),
                   num_boost_round=3, verbose_eval=False)
    ds = bst._gbdt.train_data
    assert ds.feature_mapper(0).num_bin > 256
    assert (ds.binned[:, 0] >= 256).sum() > 0
    for t in list(bst.models) + list(jb._gbdt.models):
        assert 0 not in t.split_feature_inner[:t.num_leaves - 1].tolist()
    leaves = bst.predict(X, pred_leaf=True)
    for j, t in enumerate(bst.models):
        np.testing.assert_array_equal(leaves[:, j],
                                      t.predict_leaf_index_binned(ds.binned))
    # 20000 rows, over three times the other tests': the JAX serial
    # learner's float32 scatter sums round further from the port's
    # float64 ones (1.7e-5 on this data)
    compare_trees(bst.models, jb._gbdt.models, X, leaf_atol=5e-5)
