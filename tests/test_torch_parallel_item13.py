"""ROADMAP Queue 1 item 13 on the port's parallel learners
(``lightgbm_tpu_torch/parallel/learners.py``, ``learner/comm.py``): a
multi-val dataset on the data and voting learners, and per-node
randomness (extra_trees, by-node sampling) on the data, voting, feature
and mesh-partitioned learners, in a gloo world of 2 rank processes on
the CPU (``torch_parallel_worker.py``, suite "item13") against the JAX
learners on a mesh of 2 CPU devices: the trees at the parity standard
(``tests/test_parallel.py``'s ``_assert_same_tree``), the leaf ids
equal. Also the feature learner's refusal of a multi-val dataset (the
JAX error's words) and the float64 route of the multi-val histogram.
The L1 refit under ``pre_partition`` is in
``tests/test_torch_distributed.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import torch_parallel_worker as W
from lightgbm_tpu import parallel as jpar
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data import Dataset as JDataset
from lightgbm_tpu.parallel.learners import \
    MeshPartitionedTreeLearner as JMeshPartitioned
from lightgbm_tpu.utils.log import LightGBMError as JLightGBMError
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data import Dataset
from lightgbm_tpu_torch.ops.hist_multival_cuda import hist_multival_plain
from lightgbm_tpu_torch.parallel import learners as pl
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(2)
K = 2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return W.spawn_world(str(tmp_path_factory.mktemp("item13_world")),
                         "item13", K)


def _jax_trees(name):
    """The JAX learner of a case on a mesh of K CPU devices: [(tree,
    leaf_id)] a tree."""
    cls_name, data, params, trees, _ = W.ITEM13_CASES[name]
    X, y = W.data_of(data)
    cfg = JConfig.from_params(params)
    ds = JDataset.from_numpy(X, cfg, label=y)
    mesh = jpar.default_mesh(K)
    cls_name, _, mode = cls_name.partition(":")
    lrn = JMeshPartitioned(ds, cfg, mesh=mesh, mode=mode, interpret=True) \
        if mode else getattr(jpar, cls_name)(ds, cfg, mesh=mesh)
    g, h = (jnp.asarray(a) for a in W.grad_hess(y))
    out = []
    for _ in range(trees):
        res = lrn.train(g, h)
        out.append((lrn.to_host_tree(res), np.asarray(res.leaf_id)))
    return out


@pytest.mark.parametrize("name", list(W.ITEM13_CASES))
def test_item13_learner_matches_jax_mesh(world, name):
    port = [world[name, r] for r in range(K)]
    for r in range(1, K):
        for a, b in zip(port[0]["trees"], port[r]["trees"]):
            for key in a:
                np.testing.assert_array_equal(a[key], b[key],
                                              err_msg=f"rank {r} {key}")
    assert port[0]["learner"] == W.ITEM13_CASES[name][0].partition(":")[0]
    ref = _jax_trees(name)
    assert len(ref) == len(port[0]["trees"])
    for rec, (jt, jlid) in zip(port[0]["trees"], ref):
        k = rec["num_leaves"]
        assert k == jt.num_leaves > 2
        np.testing.assert_array_equal(rec["split_feature"],
                                      jt.split_feature_inner[:k - 1])
        np.testing.assert_array_equal(rec["threshold_bin"],
                                      jt.threshold_bin[:k - 1])
        np.testing.assert_allclose(rec["leaf_value"], jt.leaf_value[:k],
                                   rtol=2e-4, atol=2e-6)
        np.testing.assert_array_equal(rec["leaf_id"], jlid)


def test_data_multival_reduces_float64_histograms(world):
    """The data recipe all-reduces the multi-val groups' float64 sums
    with the dense groups' (8-byte values: one all-reduce a split and
    one at the root)."""
    rec = world["data_multival", 0]
    trees = len(rec["trees"])
    splits = sum(t["num_leaves"] - 1 for t in rec["trees"])
    assert rec["calls"]["all_reduce"] == trees + splits
    assert rec["bytes"]["all_reduce"] % 8 == 0
    X, y = W.bosch_problem()
    ds = Dataset.from_numpy(X, Config.from_params(W.MV), label=y)
    g_mv = ds.num_groups - ds.num_dense_groups
    assert g_mv > 0
    # the root's histogram: every group's bins, float64
    assert rec["bytes"]["all_reduce"] >= \
        trees * ds.num_groups * 3 * 8 * 2


def test_feature_learner_refuses_multival_with_jax_words():
    X, y = W.bosch_problem(n=800)
    params = dict(W.MV, tree_learner="feature")
    jds = JDataset.from_numpy(X, JConfig.from_params(params), label=y)
    assert jds.has_multival
    with pytest.raises(JLightGBMError) as jerr:
        jpar.FeatureParallelTreeLearner(jds, JConfig.from_params(params),
                                        mesh=jpar.default_mesh(1))
    cfg = Config.from_params(params)
    ds = Dataset.from_numpy(X, cfg, label=y)
    with pytest.raises(LightGBMError) as err:
        pl.FeatureParallelTreeLearner(ds, cfg, torch.device("cpu"))
    assert str(err.value) == str(jerr.value)
    assert "multi-val" in str(err.value)


@pytest.mark.parametrize("rows", [None, "list"])
def test_multival_float64_route_is_the_unrounded_sum(rows):
    """The float64 route returns the chunk-ordered float64 sum that the
    float32 route rounds once: rounded, it is the float32 histogram to
    the bit."""
    X, y = W.bosch_problem()
    ds = Dataset.from_numpy(X, Config.from_params(W.MV), label=y)
    lay = ds.mv_layout_device(torch.device("cpu"))
    rng = np.random.RandomState(4)
    ghc = torch.from_numpy(np.stack(
        [rng.randn(len(y)), rng.rand(len(y)) + 0.5,
         np.ones(len(y))], 1).astype(np.float32))
    ids = None if rows is None else torch.from_numpy(
        np.sort(rng.choice(len(y), 900, replace=False)).astype(np.int32))
    h32 = hist_multival_plain(lay, ghc, 256, ids)
    h64 = hist_multival_plain(lay, ghc, 256, ids, float64=True)
    assert h64.dtype == torch.float64 and h64.shape == h32.shape
    assert torch.equal(h64.float(), h32)
    assert not torch.equal(h64, h32.double())
