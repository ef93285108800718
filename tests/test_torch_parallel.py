"""The port's parallel learners (``lightgbm_tpu_torch/parallel/learners.py``,
``learner/comm.py``) in a gloo world of 2 rank processes on the CPU,
against the JAX package's learners on a mesh of 2 CPU devices: the
cases of ``tests/test_parallel.py`` (data, feature, voting, the
mesh-partitioned learner on the segment kernels, bagging, non-divisible
rows and features, bundled data).

One world runs every case (``torch_parallel_worker.py``, suite
"parallel"; a ``file://`` rendezvous under ``tmp_path``), with a
30 s group timeout and a 60 s limit on the whole world, whose ranks are
killed on expiry. Every rank grows the same trees; the trees are held to
``tests/test_parallel.py``'s ``_assert_same_tree`` (structure exact,
leaf values at rtol 2e-4 / atol 2e-6) and the leaf ids to equality.
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
from lightgbm_tpu.parallel.partition_rules import \
    plan_feature_shards as jplan
from lightgbm_tpu.parallel.ingest import host_row_range as jhost_row_range
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data import Dataset
from lightgbm_tpu_torch.parallel import create_tree_learner, learners as pl
from lightgbm_tpu_torch.parallel.ingest import (host_row_range,
                                                 shard_bounds, shard_rows)
from lightgbm_tpu_torch.parallel.partition_rules import (
    ROWS, FEATURES, REPLICATED, plan_feature_shards, role_of)

torch.set_num_threads(2)
K = 2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return W.spawn_world(str(tmp_path_factory.mktemp("parallel_world")),
                         "parallel", K)


def _assert_same_tree(rec, ref_tree):
    k = rec["num_leaves"]
    assert k == ref_tree.num_leaves
    np.testing.assert_array_equal(rec["split_feature"],
                                  ref_tree.split_feature_inner[:k - 1])
    np.testing.assert_array_equal(rec["threshold_bin"],
                                  ref_tree.threshold_bin[:k - 1])
    np.testing.assert_allclose(rec["leaf_value"], ref_tree.leaf_value[:k],
                               rtol=2e-4, atol=2e-6)


def _jax_case(name):
    """The JAX learner of a case on a mesh of K CPU devices: [(tree,
    leaf_id)] a tree."""
    cls_name, data, params, trees, bagged = W.LEARNER_CASES[name]
    X, y = W.data_of(data)
    cfg = JConfig.from_params(params)
    ds = JDataset.from_numpy(X, cfg, label=y)
    mesh = jpar.default_mesh(K)
    cls_name, _, mode = cls_name.partition(":")
    lrn = JMeshPartitioned(ds, cfg, mesh=mesh, mode=mode, interpret=True) \
        if mode else getattr(jpar, cls_name)(ds, cfg, mesh=mesh)
    g, h = (jnp.asarray(a) for a in W.grad_hess(y))
    bag = jnp.asarray(W.BAG[:len(y)]) if bagged else None
    out = []
    for _ in range(trees):
        res = lrn.train(g, h, bag_weight=bag)
        out.append((lrn.to_host_tree(res), np.asarray(res.leaf_id)))
    return out


@pytest.mark.parametrize("name", list(W.LEARNER_CASES))
def test_learner_matches_jax_mesh(world, name):
    port = [world[name, r] for r in range(K)]
    for r in range(1, K):
        for a, b in zip(port[0]["trees"], port[r]["trees"]):
            for key in a:
                np.testing.assert_array_equal(a[key], b[key],
                                              err_msg=f"rank {r} {key}")
    assert port[0]["learner"] == W.LEARNER_CASES[name][0].partition(":")[0]
    ref = _jax_case(name)
    assert len(ref) == len(port[0]["trees"])
    for rec, (jt, jlid) in zip(port[0]["trees"], ref):
        _assert_same_tree(rec, jt)
        np.testing.assert_array_equal(rec["leaf_id"], jlid)
    if name.endswith("topk3") or name.endswith("topk6"):
        assert port[0]["trees"][0]["num_leaves"] > 4


def _splits(rec):
    return sum(t["num_leaves"] - 1 for t in rec["trees"])


@pytest.mark.parametrize("name", ["data", "data_600", "feature", "voting",
                                  "mesh_data", "mesh_voting"])
def test_collectives_a_split(world, name):
    """Each recipe's collectives (``learner/comm.py``): the root's, one
    set a split (both children at once), and the leaf-id gather of a
    row-split learner after each tree."""
    rec = world[name, 0]
    calls, nbytes = rec["calls"], rec["bytes"]
    trees, splits = len(rec["trees"]), _splits(rec)
    scans = trees + splits            # the root's and a split's selects
    row_split = not name.startswith("feature")
    gathers = scans + (trees if row_split else 0)
    if name.endswith("voting"):
        # root sums + each select's winners; each select's vote
        assert calls["all_reduce"] == trees + scans
        assert calls["all_gather"] == scans + trees
    elif name.startswith("feature"):
        assert calls == {"all_reduce": 0, "all_gather": scans,
                         "broadcast": trees}
    else:
        # the root's and each smaller child's float64 histogram
        assert calls["all_reduce"] == trees + splits
        assert calls["all_gather"] == gathers
        b = 600 if name == "data_600" else 255
        hist_bytes = 10 * b * 3 * 8
        assert nbytes["all_reduce"] <= (trees + splits) * hist_bytes
    assert calls["broadcast"] == (trees if name.startswith("feature") else 0)


# ---- the parallel layer's host pieces against the JAX package ----------

@pytest.mark.parametrize("n,size", [(3001, 2), (10, 3), (7, 8), (0, 2)])
def test_host_row_range_matches_jax(n, size):
    for r in range(size):
        assert host_row_range(n, r, size) == jhost_row_range(n, r, size)
    blocks = [shard_bounds(n, r, size) for r in range(size)]
    assert blocks[0][0] == 0 and blocks[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))


def test_shard_rows_uploads_the_block():
    """The JAX mesh's blocks (rows padded to a multiple of the ranks),
    without the padding rows; u16 bins as the device copy takes them."""
    arr = np.arange(21, dtype=np.int32).reshape(7, 3)
    got = [shard_rows(arr, "cpu", r, 2) for r in range(2)]
    assert got[0].shape == (4, 3) and got[1].shape == (3, 3)
    np.testing.assert_array_equal(got[0].numpy(), arr[:4])
    np.testing.assert_array_equal(got[1].numpy(), arr[4:])
    assert shard_rows(arr.astype(np.uint16), "cpu", 0, 2).dtype \
        == torch.int16
    wide = np.full((4, 2), 40000, np.uint16)
    assert shard_rows(wide, "cpu", 1, 2).dtype == torch.int32
    assert int(shard_rows(wide, "cpu", 1, 2).min()) == 40000


@pytest.mark.parametrize("data,d", [("sparse", 2), ("sparse", 3),
                                    ("unbalanced", 8), ("dense7", 2)])
def test_feature_shard_plan_matches_jax(data, d):
    X, y = W.data_of(data)
    params = dict(W.SPARSE)
    jcfg = JConfig.from_params(params)
    jds = JDataset.from_numpy(X, jcfg, label=y)
    ds = Dataset.from_numpy(X, Config.from_params(params), label=y)
    from lightgbm_tpu.learner.serial import feature_meta_from_dataset
    jmeta = feature_meta_from_dataset(jds, jcfg)
    group, _, _ = ds.bundle_maps()
    ref = jplan(jmeta, jds.num_features, jds.num_groups, d)
    got = plan_feature_shards(group, ds.num_features, ds.num_groups, d)
    for key in ("d", "f_local", "f_pad", "g_local", "g_pad"):
        assert getattr(got, key) == getattr(ref, key), key
    for key in ("col_perm", "col_live", "feat_perm"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key))
    ref_gid = np.asarray(ref.meta_local.global_id)
    for s in range(d):
        sl = ref_gid[s * ref.f_local:(s + 1) * ref.f_local]
        np.testing.assert_array_equal(got.local_features(s),
                                      sl[sl < ds.num_features])


def test_mode_roles():
    assert role_of("data", "binned") == ROWS
    assert role_of("feature", "binned") == REPLICATED
    assert role_of("feature", "binned_hist") == FEATURES
    assert role_of("voting", "hist") == ROWS
    assert role_of("partitioned-data", "mat") == ROWS
    assert role_of("data", "tree") == REPLICATED
    with pytest.raises(ValueError):
        role_of("pipeline", "binned")


@pytest.mark.parametrize("learner_type,max_bin,want", [
    ("data", 255, "MeshPartitionedTreeLearner"),
    ("voting", 255, "MeshPartitionedTreeLearner"),
    ("data", 600, "DataParallelTreeLearner"),
    ("voting", 600, "VotingParallelTreeLearner"),
    ("feature", 255, "FeatureParallelTreeLearner"),
    ("feature", 600, "FeatureParallelTreeLearner")])
def test_create_tree_learner_routes_the_parallel_modes(learner_type, max_bin,
                                                       want):
    """JAX ``create_tree_learner`` on an accelerator: data and voting on
    the segment kernels when the bins fit a byte, the leaf-id learners
    past that; feature always on the leaf-id layout. Without a process
    group each is a world of one."""
    X, y = W.problem(n=1500)
    cfg = Config.from_params(dict(W.BASE, max_bin=max_bin,
                                  tree_learner=learner_type))
    ds = Dataset.from_numpy(X, cfg, label=y)
    lrn = create_tree_learner(learner_type, ds, cfg, torch.device("cpu"))
    assert type(lrn).__name__ == want
    assert lrn.world_size == 1 and not lrn.fused
    assert lrn.comm.mode == learner_type
    with pytest.raises(ValueError, match="unknown tree_learner"):
        create_tree_learner("pipeline", ds, cfg, torch.device("cpu"))


@pytest.mark.parametrize("learner_type", ["data", "voting", "feature"])
def test_world_of_one_trains_like_jax_serial(learner_type):
    """Without a process group a parallel learner is a world of one, as
    the JAX package's parallel learner on a mesh of one device."""
    import lightgbm_tpu as lgb
    import lightgbm_tpu_torch as lt
    X, y = W.problem(n=2000)
    params = dict(W.BASE, tree_learner=learner_type, max_bin=600)
    port = lt.train(params, lt.Dataset(X, label=y), 3, device="cpu")
    ref = lgb.train(dict(params, num_machines=1, n_devices=1),
                    lgb.Dataset(X, label=y), num_boost_round=3,
                    verbose_eval=False)
    for a, b in zip(ref._gbdt.models, port.models):
        np.testing.assert_array_equal(np.asarray(a.threshold_bin),
                                      b.threshold_bin)
        np.testing.assert_allclose(b.leaf_value, np.asarray(a.leaf_value),
                                   rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("extra", [{"extra_trees": True},
                                   {"feature_fraction_bynode": 0.5}])
@pytest.mark.parametrize("learner_type", ["data", "voting", "feature"])
def test_per_node_randomness_is_refused(learner_type, extra):
    """Refused until Queue 1 item 13 lifted it: per-node randomness on a
    parallel learner now trains. In a world of one the learner draws as
    the JAX learner on a mesh of one device does (a feature-sharded scan
    folds the shard index 0 into its keys): the same trees.
    ``tests/test_torch_parallel_item13.py`` holds two ranks against a
    mesh of two."""
    X, y = W.problem(n=500)
    params = dict(W.BASE, tree_learner=learner_type, **extra)
    cfg = Config.from_params(params)
    ds = Dataset.from_numpy(X, cfg, label=y)
    lrn = create_tree_learner(learner_type, ds, cfg, torch.device("cpu"))
    jcfg = JConfig.from_params(params)
    jds = JDataset.from_numpy(X, jcfg, label=y)
    mesh = jpar.default_mesh(1)
    jname = type(lrn).__name__
    jl = JMeshPartitioned(jds, jcfg, mesh=mesh, mode=learner_type,
                          interpret=True) \
        if jname == "MeshPartitionedTreeLearner" \
        else getattr(jpar, jname)(jds, jcfg, mesh=mesh)
    g, h = W.grad_hess(y)
    for _ in range(2):
        res = jl.train(jnp.asarray(g), jnp.asarray(h))
        tree, lid = lrn.train(torch.from_numpy(g), torch.from_numpy(h))
        rec = W.tree_record(tree)
        _assert_same_tree(rec, jl.to_host_tree(res))
        np.testing.assert_array_equal(lid.numpy(), np.asarray(res.leaf_id))


def test_voting_drops_cegb_and_forced_splits(tmp_path, capsys):
    import json
    X, y = W.problem(n=1500)
    forced = tmp_path / "forced.json"
    forced.write_text(json.dumps({"feature": 0, "threshold": 0.0}))
    cfg = Config.from_params(dict(W.BASE, tree_learner="voting",
                                  cegb_tradeoff=0.5,
                                  cegb_penalty_split=0.1,
                                  forcedsplits_filename=str(forced)))
    ds = Dataset.from_numpy(X, cfg, label=y)
    lrn = pl.VotingParallelTreeLearner(ds, cfg, torch.device("cpu"))
    assert lrn.cegb is None and not lrn.params.cegb_on
    assert lrn.forced_plan == ()
    assert lrn.comm.mode == "voting" and not lrn.comm.float64_hist


# ---- ROADMAP item 3's leftovers: fix_histogram, shard-local totals -----

def test_fix_histogram_matches_jax():
    """The most-frequent bin rebuilt from the leaf totals (JAX
    ``ops/histogram.py:fix_histogram``): the port sums in float64 and
    rounds once, JAX in float32, so they agree within float32 rounding,
    and both give back the bin that was elided."""
    from lightgbm_tpu.ops import histogram as jhist
    from lightgbm_tpu_torch.ops.histogram import fix_histogram
    rng = np.random.RandomState(0)
    f, b = 6, 20
    full = np.stack([rng.randn(f, b), rng.rand(f, b) + 0.1,
                     rng.randint(1, 9, (f, b))], axis=-1).astype(np.float32)
    tot = full[0].astype(np.float64).sum(axis=0)
    full[1:] *= (tot / full[1:].astype(np.float64).sum(axis=1))[:, None, :]
    mfb = rng.randint(0, b, f).astype(np.int32)
    elided = full.copy()
    elided[np.arange(f), mfb] = 0.0
    g, h, c = (np.float32(v) for v in full[0].sum(axis=0))
    got = fix_histogram(torch.from_numpy(elided), g, h, c,
                        torch.from_numpy(mfb)).numpy()
    ref = np.asarray(jhist.fix_histogram(jnp.asarray(elided), g, h, c,
                                         jnp.asarray(mfb)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, full, rtol=1e-4, atol=1e-4)
    keep = np.ones((f, b), bool)
    keep[np.arange(f), mfb] = False
    np.testing.assert_array_equal(got[keep], elided[keep])


@pytest.mark.parametrize("local", [True, False])
def test_debundle_totals_match_jax(local):
    """JAX ``debundle_totals``: rank-local histograms take their own
    totals (group 0's bins summed), reduced ones the leaf's sums."""
    from lightgbm_tpu.ops import histogram as jhist
    from lightgbm_tpu_torch.ops.histogram import debundle_totals
    rng = np.random.RandomState(1)
    hist = np.stack([rng.randn(4, 9), rng.rand(4, 9),
                     rng.randint(0, 5, (4, 9))], -1).astype(np.float32)
    leaf = (np.float32(1.5), np.float32(7.25), np.float32(30.0))
    got = debundle_totals([torch.from_numpy(hist)], [leaf], local)[0]
    ref = jhist.debundle_totals(jnp.asarray(hist), *leaf, local)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float64),
                               rtol=1e-6, atol=1e-6)
