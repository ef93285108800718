"""The port's model file path on the CPU, against the JAX package and the
reference's own files.

* Every model the reference CLI wrote into ``tests/fixtures/golden/``
  loads in the port: converted predictions within 1e-6 of the
  reference's recorded ``pred_<name>.txt``; raw scores equal to the JAX
  ``LoadedBooster.predict_raw`` to the bit (both add the trees in order
  in float64), converted scores within 2 ulp of JAX's (``exp`` of two
  libraries), leaf indices equal.
* The port's writer gives the JAX writer's text byte for byte for every
  golden model and for a JAX-trained model carried across with
  ``convert.py`` (there except the footer's ``[device_type: ...]``
  line, the one field in which the two packages' configs differ), and
  load -> write is a fixed point.
* A port-trained model loads in the JAX loader and predicts as the
  port does; iteration truncation, feature importance and the JSON dump
  equal JAX's.
* Continued training (``init_model``, a path or a Booster): the seed
  scores equal the JAX engine's ``_raw_add`` to the bit, and the new
  trees match the JAX continued run (structure exact, leaf values at
  ``tests/test_torch_train.py``'s rtol / atol 1e-5).
* The refusals name their ROADMAP items.
"""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.io import model_text as jtext
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import bin_mappers_from_state, trees_from_state
from lightgbm_tpu_torch.data import Dataset
from lightgbm_tpu_torch.io import model_text as ptext
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.predictor import predict_raw

from golden_common import DATASETS

torch.set_num_threads(2)
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
PARAMS = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
GOLDEN = sorted(DATASETS)


def _data(seed=0, n=2000, f=8):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.1, 2] = np.nan            # NaN-missing feature
    X[rng.rand(n) < 0.3, 3] = 0.0               # zero-heavy feature
    y = (1.5 * X[:, 0] - X[:, 1] + 0.5 * np.nan_to_num(X[:, 2])
         + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return X, y


def _golden(name):
    with open(os.path.join(FIXDIR, f"model_{name}.txt")) as f:
        text = f.read()
    _, _, Xte, _ = DATASETS[name]["make"]()
    ref = np.loadtxt(os.path.join(FIXDIR, f"pred_{name}.txt"))
    return text, Xte, ref


def _first_difference(a, b):
    for i, (la, lb) in enumerate(zip(a.split("\n"), b.split("\n"))):
        if la != lb:
            return f"line {i}: {la[:200]!r} != {lb[:200]!r}"
    return f"lengths {len(a)} != {len(b)}"


def _assert_same_text(port, jax_text):
    assert port == jax_text, _first_difference(port, jax_text)


@pytest.fixture(scope="module")
def trained():
    """A port-trained model (5 trees) and its text."""
    X, y = _data()
    bst = lt.train(PARAMS, lt.Dataset(X, label=y), 5, device="cpu")
    return X, y, bst, bst.model_to_string()


# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", GOLDEN)
def test_golden_model_predicts_the_reference_output(name):
    text, Xte, ref = _golden(name)
    bst = lt.Booster(model_str=text, device="cpu")
    np.testing.assert_allclose(bst.predict(Xte), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_model_predicts_as_jax(name):
    text, Xte, _ = _golden(name)
    jb = jtext.load_model_from_string(text)
    bst = lt.Booster(model_str=text, device="cpu")
    raw = bst.predict(Xte, raw_score=True)
    jraw = jb.predict_raw(Xte)
    np.testing.assert_array_equal(raw.reshape(jraw.shape), jraw)
    conv = bst.predict(Xte)
    np.testing.assert_array_max_ulp(conv.reshape(jraw.shape),
                                    jb.predict(Xte), maxulp=2)
    leaf = bst.predict(Xte, pred_leaf=True)
    assert leaf.dtype == np.int32 and leaf.shape == (len(Xte),
                                                     len(jb.models))
    np.testing.assert_array_equal(leaf, jb.predict_leaf_index(Xte))


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_model_text_is_the_jax_writers(name):
    text, _, _ = _golden(name)
    port = lt.Booster(model_str=text, device="cpu")
    jax_bst = lgb.Booster(model_str=text)
    out = port.model_to_string()
    _assert_same_text(out, jax_bst.model_to_string())
    _assert_same_text(lt.Booster(model_str=out, device="cpu")
                      .model_to_string(), out)
    _assert_same_text(
        ptext.save_model_to_string(port._src(), 1, 2),
        jtext.save_model_to_string(jax_bst._src(), 1, 2))


@pytest.mark.parametrize("name", ["categorical", "multiclass", "binary"])
def test_golden_importance_and_dump_are_jaxs(name):
    text, _, _ = _golden(name)
    port = lt.Booster(model_str=text, device="cpu")
    jax_bst = lgb.Booster(model_str=text)
    for kind in ("split", "gain"):
        a, b = port.feature_importance(kind), jax_bst.feature_importance(kind)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.feature_importance("split", 2),
                                  jax_bst.feature_importance("split", 2))
    assert port.dump_model() == jax_bst.dump_model()
    assert port.dump_model(num_iteration=2, start_iteration=1) \
        == jax_bst.dump_model(num_iteration=2, start_iteration=1)
    assert (port.num_trees(), port.current_iteration(),
            port.num_model_per_iteration(), port.num_feature(),
            port.feature_name()) == (
        jax_bst.num_trees(), jax_bst.current_iteration(),
        jax_bst.num_model_per_iteration(), jax_bst.num_feature(),
        jax_bst.feature_name())


def test_iteration_truncation_matches_jax():
    text, Xte, _ = _golden("multiclass")
    jb = jtext.load_model_from_string(text)
    bst = lt.Booster(model_str=text, device="cpu")
    np.testing.assert_array_equal(
        bst.predict(Xte, raw_score=True, num_iteration=3),
        jb.predict_raw(Xte, num_iteration=3))
    np.testing.assert_array_equal(
        bst.predict(Xte, pred_leaf=True, num_iteration=3),
        jb.predict_leaf_index(Xte)[:, :9])
    # iterations 2..5: the model the writer cuts to those iterations
    cut = jtext.load_model_from_string(
        jtext.save_model_to_string(jb, start_iteration=2, num_iteration=4))
    np.testing.assert_array_equal(
        bst.predict(Xte, raw_score=True, start_iteration=2,
                    num_iteration=4), cut.predict_raw(Xte))
    np.testing.assert_array_equal(
        bst.predict(Xte, start_iteration=2, num_iteration=4),
        lt.Booster(model_str=bst.model_to_string(num_iteration=4,
                                                 start_iteration=2),
                   device="cpu").predict(Xte))


def test_categorical_decision_edges_match_jax():
    """CategoricalDecision off the training range: NaN, negative and
    fractional values, categories past the node's words, huge values."""
    text, Xte, _ = _golden("categorical")
    jb = jtext.load_model_from_string(text)
    bst = lt.Booster(model_str=text, device="cpu")
    X = np.repeat(Xte[:12], 8, axis=0)
    edges = [np.nan, -1.0, -0.5, 0.5, 3.999, 31.0, 32.0, 63.5, 64.0, 1e6,
             1e17, 2.0]
    for col in (0, 1):
        X[:len(edges), col] = edges
        X[len(edges):2 * len(edges), col] = edges[::-1]
    np.testing.assert_array_equal(bst.predict(X, raw_score=True),
                                  jb.predict_raw(X)[:, 0])
    np.testing.assert_array_equal(bst.predict(X, pred_leaf=True),
                                  jb.predict_leaf_index(X))


def test_average_output_model_divides_by_iterations():
    text, Xte, _ = _golden("binary")
    avg = text.replace("objective=binary sigmoid:1\n",
                       "objective=binary sigmoid:1\naverage_output\n", 1)
    jb = jtext.load_model_from_string(avg)
    bst = lt.Booster(model_str=avg, device="cpu")
    np.testing.assert_array_equal(bst.predict(Xte, raw_score=True),
                                  jb.predict_raw(Xte)[:, 0])
    np.testing.assert_array_equal(
        bst.predict(Xte, raw_score=True, num_iteration=4),
        jb.predict_raw(Xte, num_iteration=4)[:, 0])
    assert "average_output\n" in bst.model_to_string()


# ----------------------------------------------------------------------
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


def test_carried_jax_model_writes_the_jax_writers_text():
    """A JAX-trained model (NaN and zero-missing columns) carried across
    with its bin mappers: the port's writer over the port's Dataset
    gives the JAX writer's text but for the ``device_type`` line."""
    X, y = _data()
    params = dict(PARAMS, fused_split_kernel="off")
    jb = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=5,
                   verbose_eval=False)
    jg = jb._gbdt
    jg.finalize_trees()
    cfg = Config.from_params(params)
    mappers = bin_mappers_from_state(
        [m.to_dict() for m in jb.train_set._inner.bin_mappers])
    ds = Dataset.from_numpy(X, cfg, label=y, bin_mappers=mappers)
    gbdt = GBDT(cfg, ds, torch.device("cpu"))
    gbdt.init_from_models(trees_from_state(
        [_jax_tree_state(t) for t in jg.models]))
    port = ptext.save_model_to_string(gbdt).split("\n")
    ref = jtext.save_model_to_string(jg).split("\n")
    assert len(port) == len(ref)
    diff = [(a, b) for a, b in zip(port, ref) if a != b]
    assert diff == [("[device_type: cuda]", "[device_type: tpu]")], diff[:3]
    assert json.loads(ptext.dump_model_json(gbdt)) \
        == json.loads(jtext.dump_model_json(jg))
    for kind in ("split", "gain"):
        np.testing.assert_array_equal(
            ptext.feature_importance(gbdt, kind),
            jtext.feature_importance(jg, kind))


def test_port_model_loads_in_jax(trained):
    X, _, bst, text = trained
    jb = lgb.Booster(model_str=text)
    Xq, _ = _data(9, n=700)
    Xq[::7, 0] = np.nan
    Xq[::5, 3] = 0.0
    np.testing.assert_allclose(jb.predict(Xq, raw_score=True),
                               bst.predict(Xq, raw_score=True), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(jb.predict(Xq, pred_leaf=True),
                                  bst.predict(Xq, pred_leaf=True))
    _assert_same_text(jb.model_to_string(), text)


def test_port_model_round_trips_to_the_bit(trained, tmp_path):
    X, _, bst, text = trained
    path = str(tmp_path / "model.txt")
    bst.save_model(path)
    loaded = lt.Booster(model_file=path, device="cpu")
    np.testing.assert_array_equal(loaded.predict(X, raw_score=True),
                                  bst.predict(X, raw_score=True))
    np.testing.assert_array_equal(loaded.predict(X),
                                  bst.predict(X))
    np.testing.assert_array_equal(loaded.predict(X, pred_leaf=True),
                                  bst.predict(X, pred_leaf=True))
    _assert_same_text(loaded.model_to_string(), text)
    assert bst.dump_model() == loaded.dump_model()
    # a loaded model knows features up to the largest one split on
    gain = bst.feature_importance("gain")
    used = loaded.feature_importance("gain")
    np.testing.assert_array_equal(gain[:len(used)], used)
    assert not gain[len(used):].any()
    # sparse rows are densified in fixed chunks
    Xs = np.where(np.abs(X) < 0.5, 0.0, X)
    np.testing.assert_array_equal(
        loaded.predict(sp.csr_matrix(np.nan_to_num(Xs)), raw_score=True),
        loaded.predict(np.nan_to_num(Xs), raw_score=True))


def test_continued_training_matches_jax(trained, tmp_path, monkeypatch):
    """3 trees, then 2 more through ``init_model`` as a path and as a
    Booster: the seed is the JAX engine's ``_raw_add`` to the bit, the
    new trees are JAX's."""
    X, y = _data()
    first = lt.train(PARAMS, lt.Dataset(X, label=y), 3, device="cpu")
    path = str(tmp_path / "init.txt")
    first.save_model(path)
    jinit = jtext.load_model_from_file(path)
    jseed = np.zeros((len(X), 1))
    for i, t in enumerate(jinit.models):       # JAX engine._raw_add
        jseed[:, i % 1] += t.predict(X)
    np.testing.assert_array_equal(
        predict_raw(first.models, X, "cpu").numpy(), jseed)
    with monkeypatch.context() as m:           # the seed before training
        m.setattr(GBDT, "train", lambda self, n: None)
        seeded = lt.train(PARAMS, lt.Dataset(X, label=y), 2,
                          init_model=path, device="cpu")
    np.testing.assert_array_equal(seeded._gbdt.train_score.numpy(),
                                  jseed.astype(np.float32))
    jb = lgb.train(dict(PARAMS, fused_split_kernel="off"),
                   lgb.Dataset(X, label=y), num_boost_round=2,
                   init_model=path, verbose_eval=False)
    jm = jb._gbdt.models
    for init in (path, first):
        bst = lt.train(PARAMS, lt.Dataset(X, label=y), 2, init_model=init,
                       device="cpu")
        assert len(bst.models) == len(jm) == 5
        assert bst.current_iteration() == 5
        for a, b in zip(bst.models[:3], first.models):
            np.testing.assert_array_equal(a.leaf_value, b.leaf_value)
            np.testing.assert_array_equal(a.threshold, b.threshold)
        for a, b in zip(bst.models[3:], jm[3:]):
            assert (a.num_leaves, a.split_feature.tolist(),
                    a.threshold.tolist(), a.decision_type.tolist(),
                    a.left_child.tolist(), a.right_child.tolist()) == (
                b.num_leaves, b.split_feature.tolist(),
                b.threshold.tolist(), (b.decision_type & 3).tolist(),
                b.left_child.tolist(), b.right_child.tolist())
            np.testing.assert_allclose(a.leaf_value, b.leaf_value,
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(bst.predict(X, raw_score=True),
                                   jb.predict(X, raw_score=True), rtol=0,
                                   atol=1e-5)


def test_continued_training_refuses_another_tree_count():
    text, _, _ = _golden("multiclass")
    X, y = _data(n=300)
    with pytest.raises(lt.utils.log.LightGBMError, match="per iteration"):
        lt.train(PARAMS, lt.Dataset(X, label=y), 1,
                 init_model=lt.Booster(model_str=text, device="cpu"),
                 device="cpu")
    with pytest.raises(TypeError):
        lt.train(PARAMS, lt.Dataset(X, label=y), 1, init_model=3,
                 device="cpu")


# ----------------------------------------------------------------------
def _linear_text(text):
    """The model text with its first tree turned into a linear-leaf
    tree (constant leaves, no features)."""
    block = text[text.index("Tree=0"):text.index("Tree=1")]
    n = int(block.split("num_leaves=")[1].split("\n")[0])
    values = block.split("leaf_value=")[1].split("\n")[0]
    lin = block.replace("shrinkage=", "is_linear=1\nleaf_const=" + values
                        + "\nnum_features=" + " ".join(["0"] * n)
                        + "\nleaf_features=\nleaf_coeff=\nshrinkage=")
    return text.replace(block, lin)


def test_linear_trees_parse_but_do_not_predict(trained):
    """The name is from before Queue 1 item 7.5: a linear-leaf tree in
    the model text now parses, writes the JAX writer's text and predicts
    what the JAX predictor predicts (its constant leaves here; the
    trained linear models in tests/test_torch_linear.py)."""
    X, _, _, text = trained
    lin = _linear_text(text)
    bst = lt.Booster(model_str=lin, device="cpu")
    assert bst.models[0].is_linear and not bst.models[1].is_linear
    jb = lgb.Booster(model_str=lin)
    _assert_same_text(bst.model_to_string(), jb.model_to_string())
    np.testing.assert_array_equal(bst.predict(X, raw_score=True),
                                  jb.predict(X, raw_score=True))
    # a linear tree with constant leaves predicts the constant model, its
    # leaf constants rounded to float32 (the linear add chain's type)
    np.testing.assert_allclose(
        bst.predict(X, raw_score=True),
        lt.Booster(model_str=text, device="cpu").predict(
            X, raw_score=True), rtol=1e-6, atol=0)


@pytest.mark.parametrize("kwargs", [{"pred_contrib": True},
                                    {"pred_early_stop": True}])
def test_prediction_refusals_name_queue_1_item_6(trained, kwargs):
    """Queue 1 item 6 landed: what was refused with its ID now predicts
    what the JAX predictor predicts on the same trees (SHAP values to
    1e-9 relative, early-stopped scores to the bit)."""
    from lightgbm_tpu.predictor import predict as jpredict
    X, _, bst, text = trained
    jb = jtext.load_model_from_string(text)
    out = bst.predict(X, raw_score=True, **kwargs)
    ref = jpredict(jb, X, raw_score=True, **kwargs)
    np.testing.assert_allclose(out, ref, rtol=1e-9, atol=1e-12)


def test_data_refusals_name_their_items(tmp_path):
    """``two_round`` files and sparse matrices train (ROADMAP.md Queue 1
    item 7.3, once refused here) as their in-memory dense forms do; so
    do the binary cache, subsets and feature appends (item 7.6, once
    refused here); what is still refused names its item: streaming
    ingestion (12)."""
    X, y = _data(n=300)
    path = str(tmp_path / "train.csv")
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.17g")
    dense = lt.train(PARAMS, lt.Dataset(path), 1, device="cpu")
    two = lt.train(dict(PARAMS, two_round=True), lt.Dataset(path), 1,
                   device="cpu")
    # the same trees; the texts differ in the params echo alone
    assert two.model_to_string().split("parameters:")[0] \
        == dense.model_to_string().split("parameters:")[0]
    Xz = np.nan_to_num(X)
    sparse = lt.train(PARAMS, lt.Dataset(sp.csr_matrix(Xz), label=y), 1,
                      device="cpu")
    np.testing.assert_array_equal(
        sparse.predict(Xz, raw_score=True),
        lt.train(PARAMS, lt.Dataset(Xz, label=y), 1,
                 device="cpu").predict(Xz, raw_score=True))
    ds = lt.Dataset(X, label=y)
    ds.save_binary(str(tmp_path / "b"))
    np.testing.assert_array_equal(
        lt.Dataset(str(tmp_path / "b"))._construct().binned,
        ds._construct().binned)
    assert ds.subset([1, 0]).num_data() == 2
    ds.add_features_from(lt.Dataset(X, label=y))
    assert ds.num_feature() == 2 * X.shape[1]
    from lightgbm_tpu_torch.data.dataset import Dataset as Binned
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        Binned.from_sampled_columns([], [], 0, 0, None)


def test_loaded_booster_needs_the_card_by_default(monkeypatch, trained):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lt.Booster(model_str=trained[3])
    with pytest.raises(TypeError):
        lt.Booster(device="cpu")
