"""The port's first slice as a whole, on the CPU: binary training through
the partitioned learner against the JAX package's training on the same
data, trees carried across from JAX into the port's predictor, import
hygiene, device resolution and the slice's rejections.

Oracles: the JAX serial learner with scatter histograms (the model
oracle on CPU) and the JAX partitioned learner with its Pallas kernels
in interpret mode. Tree structure is exact: split feature, threshold
bin, default_left, children and leaf count. Leaf values are held at
rtol 1e-5 with atol 1e-5, raw predictions at atol 1e-5: the JAX
package's two learners themselves disagree by up to 7.3e-6 in leaf
value on this data (float32 sums reach the leaf outputs through chains
of parent-minus-child subtractions in other orders), so a tighter
absolute bound would test float32 summation order, not the port.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.convert import trees_from_state

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 5
PARAMS = {"objective": "binary", "num_leaves": 15, "verbosity": -1}


def _data(seed=0, n=2000, f=8):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.1, 2] = np.nan            # NaN-missing feature
    X[rng.rand(n) < 0.3, 3] = 0.0               # zero-heavy feature
    y = (1.5 * X[:, 0] - X[:, 1] + 0.5 * np.nan_to_num(X[:, 2])
         + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def trained():
    X, y = _data()
    port = lt.train(PARAMS, lt.Dataset(X, label=y), ROUNDS, device="cpu")
    jax_models = {
        learner: lgb.train(dict(PARAMS, tree_learner=learner,
                                fused_split_kernel="off"),
                           lgb.Dataset(X, label=y),
                           num_boost_round=ROUNDS, verbose_eval=False)
        for learner in ("serial", "partitioned")}
    return X, y, port, jax_models


def _structure(t):
    return (t.num_leaves, t.split_feature_inner.tolist(),
            t.threshold_bin.tolist(), (t.decision_type & 2).tolist(),
            t.left_child.tolist(), t.right_child.tolist())


@pytest.mark.parametrize("learner", ["serial", "partitioned"])
def test_trees_match_jax(trained, learner):
    X, _, port, jax_models = trained
    jb = jax_models[learner]
    jm = jb._gbdt.models
    assert len(port.models) == len(jm) == ROUNDS
    for a, b in zip(jm, port.models):
        assert _structure(b) == _structure(a)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(port.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(port.predict(X), jb.predict(X), rtol=0,
                               atol=1e-5)


def test_monotone_and_regularized_config_matches_jax():
    X, y = _data(1, n=1500, f=5)
    params = dict(PARAMS, num_leaves=7, lambda_l1=0.2, lambda_l2=1.0,
                  max_delta_step=0.8, min_data_in_leaf=30, max_depth=3,
                  monotone_constraints=[1, -1, 0, 0, 0],
                  feature_fraction=0.8)
    port = lt.train(params, lt.Dataset(X, label=y), 3, device="cpu")
    jb = lgb.train(dict(params, fused_split_kernel="off"),
                   lgb.Dataset(X, label=y), num_boost_round=3,
                   verbose_eval=False)
    for a, b in zip(jb._gbdt.models, port.models):
        assert _structure(b) == _structure(a)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-5)


def test_gradients_match_jax():
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.data import Dataset as JDataset
    from lightgbm_tpu.objective.binary import BinaryLogloss as JBinary
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data import Dataset
    from lightgbm_tpu_torch.objective import BinaryLogloss
    X, y = _data(2, n=500)
    p = {"objective": "binary", "verbosity": -1, "scale_pos_weight": 1.7}
    jds = JDataset.from_numpy(X, JConfig.from_params(p), label=y)
    tds = Dataset.from_numpy(X, Config.from_params(p), label=y)
    jo, to = JBinary(JConfig.from_params(p)), BinaryLogloss(
        Config.from_params(p))
    jo.init(jds.metadata, 500)
    to.init(tds.metadata, 500, "cpu")
    score = np.random.RandomState(3).randn(500).astype(np.float32)
    jg, jh = jo.gradients(score)
    tg, th = to.gradients(torch.from_numpy(score))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-7)
    assert to.boost_from_score() == jo.boost_from_score()


def _jax_tree_state(t):
    return dict(num_leaves=t.num_leaves, split_feature=t.split_feature,
                threshold=t.threshold, decision_type=t.decision_type,
                left_child=t.left_child, right_child=t.right_child,
                leaf_value=t.leaf_value, missing_code=t._missing_code,
                threshold_bin=t.threshold_bin,
                split_feature_inner=t.split_feature_inner)


def test_jax_trained_trees_carry_across(trained):
    """convert.trees_from_state: JAX trees as numpy arrays -> the port's
    predictor gives JAX's predictions, NaN and zero rows included."""
    X, _, _, jax_models = trained
    jb = jax_models["serial"]
    trees = trees_from_state([_jax_tree_state(t)
                              for t in jb._gbdt.models])
    bst = lt.Booster.from_trees(trees, params=PARAMS, device="cpu")
    Xq, _ = _data(9, n=700)
    Xq[::7, 0] = np.nan
    Xq[::5, 3] = 0.0
    np.testing.assert_allclose(bst.predict(Xq, raw_score=True),
                               jb.predict(Xq, raw_score=True), rtol=0,
                               atol=1e-12)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_jax_package():
    pkg = os.path.join(REPO, "lightgbm_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg)
             if "_build" not in os.path.relpath(d, pkg).split(os.sep)
             for f in fs if f.endswith(".py")]
    files += [os.path.join(REPO, "chip_smoke.py"),
              os.path.join(REPO, "chip_profile.py"),
              os.path.join(REPO, "chip_hist_levers.py")]
    bad = []
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "lightgbm_tpu"):
                bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, bad


def test_training_leaves_jax_out_of_sys_modules():
    code = (
        "import sys, numpy as np\n"
        "import lightgbm_tpu_torch as lt\n"
        "X = np.random.RandomState(0).randn(300, 4)\n"
        "y = (X[:, 0] > 0).astype(np.float32)\n"
        "b = lt.train({'objective': 'binary', 'num_leaves': 4, "
        "'verbosity': -1}, lt.Dataset(X, label=y), 2, device='cpu')\n"
        "b.predict(X)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'lightgbm_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _data(4, n=200)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lt.train(PARAMS, lt.Dataset(X, label=y), 1)
    with pytest.raises(RuntimeError):
        lt.resolve_device(None)
    assert lt.resolve_device("cpu").type == "cpu"


# the ids the cases had when the list also held the refusals that
# Queue 1 items 7.4 and 7.5 lifted (tests/test_torch_extras.py and
# tests/test_torch_linear.py train those configurations now); items 4,
# 8 and 11 lifted theirs too: those cases (item None) now train, as the
# JAX package's serial learner does (a data-parallel world of one rank
# is the serial learner; tests/test_torch_parallel.py holds the ranks;
# a checkpoint directory, tests/test_torch_robustness.py)
@pytest.mark.parametrize("extra,item", [
    pytest.param({"checkpoint_dir": "ckpt"}, None,
                 id="extra1-Queue 1 item 11"),
    pytest.param({"tree_learner": "data"}, None,
                 id="extra6-Queue 1 item 8"),
    # > 1024 bins: the serial learner, per-phase
    pytest.param({"max_bin": 2000}, None,
                 id="extra8-Queue 1 item 4"),
])
def test_out_of_slice_configs_rejected(extra, item, tmp_path):
    # enough distinct values for more than 1024 bins where asked
    X, y = _data(5, n=5000 if extra.get("max_bin", 0) > 1024 else 200)
    params = dict(PARAMS, **extra)
    if "checkpoint_dir" in extra:
        params["checkpoint_dir"] = str(tmp_path / extra["checkpoint_dir"])
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            lt.train(params, lt.Dataset(X, label=y), 1, device="cpu")
        return
    port = lt.train(params, lt.Dataset(X, label=y), 2, device="cpu")
    if "checkpoint_dir" in extra:
        # the final checkpoint (freq 0: none periodic) is only written on
        # preemption; the run's trees are those of the run without it
        ref = lt.train(PARAMS, lt.Dataset(X, label=y), 2, device="cpu")
        trees = lambda b: b.model_to_string().split(  # noqa: E731
            "parameters:")[0]
        assert trees(port) == trees(ref)
        assert not os.listdir(params["checkpoint_dir"]) \
            if os.path.isdir(params["checkpoint_dir"]) else True
        return
    if "tree_learner" in extra:
        # a world of one rank: the serial learner's trees, to the bit
        # (tests/test_torch_parallel.py holds worlds of 2 against JAX)
        ref = lt.train(PARAMS, lt.Dataset(X, label=y), 2, device="cpu")
        assert type(port._gbdt.learner).__name__ \
            == "MeshPartitionedTreeLearner"
        trees = lambda b: b.model_to_string().split(  # noqa: E731
            "end of trees")[0]
        assert trees(port) == trees(ref)
        return
    jb = lgb.train(dict(params, tree_learner="serial"),
                   lgb.Dataset(X, label=y), num_boost_round=2,
                   verbose_eval=False)
    assert len(port.models) == len(jb._gbdt.models) == 2
    # threshold ties of float64 against float32 sums at 2000 bins on
    # 5000 rows (ROADMAP Queue 3): the trees' split features agree, and
    # where a threshold differs the two gains are within 1e-5
    ties = []
    for a, b in zip(jb._gbdt.models, port.models):
        k = b.num_leaves
        assert int(a.num_leaves) == k
        np.testing.assert_array_equal(np.asarray(a.split_feature)[:k - 1],
                                      b.split_feature_inner[:k - 1])
        diff = np.nonzero(np.asarray(a.threshold_bin)[:k - 1]
                          != b.threshold_bin[:k - 1])[0]
        np.testing.assert_allclose(b.split_gain[diff],
                                   np.asarray(a.split_gain)[diff],
                                   rtol=1e-5)
        if not len(diff):
            np.testing.assert_allclose(b.leaf_value,
                                       np.asarray(a.leaf_value), rtol=0,
                                       atol=5e-5)
        ties.append(len(diff))
    assert ties == [1, 2]


@pytest.mark.parametrize("learner", ["serial", "partitioned"])
def test_categorical_param_trains_like_jax(learner):
    """``categorical_feature`` as a parameter string (the reference CLI's
    form) trains feature 0 as a category: the trees of the JAX learners
    given it as the Dataset argument, categorical nodes included."""
    X, y = _data(7, n=3000)
    X[:, 0] = np.floor(np.abs(X[:, 0]) * 6)
    # a noisy label, so that no split's gain is float rounding alone
    y = ((X[:, 0] % 3 == 1) + X[:, 1]
         + np.random.RandomState(8).randn(len(X)) > 0.5).astype(np.float32)
    params = dict(PARAMS, min_data_per_group=20)
    port = lt.train(dict(params, categorical_feature="0"),
                    lt.Dataset(X, label=y), ROUNDS, device="cpu")
    jb = lgb.train(dict(params, tree_learner=learner,
                        fused_split_kernel="off"),
                   lgb.Dataset(X, label=y, categorical_feature=[0]),
                   num_boost_round=ROUNDS, verbose_eval=False)
    assert any(t.decision_type[:t.num_leaves - 1].any() & 1
               for t in port.models)
    for a, b in zip(jb._gbdt.models, port.models):
        assert _structure(b) == _structure(a)
        assert [sorted(c.tolist()) for c in b.cat_threshold] \
            == [sorted(c.tolist()) for c in a.cat_threshold]
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-5)


def test_leaf_ids_follow_the_partition():
    """The learner's leaf_id (from the final segments and the row ids
    the rows carry) equals a bin-space walk of the tree."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data import Dataset
    from lightgbm_tpu_torch.learner import PartitionedTreeLearner
    X, y = _data(6, n=800)
    cfg = Config.from_params(dict(PARAMS, num_leaves=9))
    ds = Dataset.from_numpy(X, cfg, label=y)
    lrn = PartitionedTreeLearner(ds, cfg, torch.device("cpu"))
    grad = torch.from_numpy(y - 0.5)
    hess = torch.full((800,), 0.25)
    for _ in range(2):   # the second tree starts from a permuted matrix
        tree, leaf_id = lrn.train(grad, hess)
        np.testing.assert_array_equal(
            leaf_id.numpy(), tree.predict_leaf_index_binned(ds.binned))
        grad = grad * 0.5 + 0.1
