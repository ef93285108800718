"""One rank of the port's parallel tests (``tests/test_torch_parallel.py``,
``tests/test_torch_distributed.py``): joins a gloo world on the CPU
through a ``file://`` rendezvous, runs every case of a suite and pickles
what each case grew to ``<out>/<case>.<rank>.pkl``. It imports neither
JAX nor the JAX package: the tests hold its results against the JAX
learners on a mesh of as many CPU devices.

    python tests/torch_parallel_worker.py RDZV RANK SIZE OUT SUITE

One leg of the elastic drill (``tests/test_torch_elastic_drill.py``):
a 2-rank world (SIZE 2) or one process without a group (SIZE 1) trains
``DRILL_PARAMS`` with the checkpoints under CKPT and the leg's extra
params; a watchdog verdict exits with the elastic exit code and its
``ELASTIC_ABORT`` line (``robustness/elastic.py:elastic_exit``).

    python tests/torch_parallel_worker.py RDZV RANK SIZE OUT elastic LEG CKPT

The data of every case is made here, from a seed, and the tests import
the same functions (``problem``, ``sparse_problem``, ...).
"""

import os
import pickle
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def problem(n=3001, f=10, seed=0):
    """tests/test_parallel.py ``_problem``: a non-divisible row count."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    logit = 2 * X[:, 0] - 1.5 * X[:, 1] + X[:, 2] * X[:, 3]
    y = (logit + rng.randn(n) * 0.3 > 0).astype(np.float32)
    return X, y


def grad_hess(y):
    return (np.asarray(y - 0.5, np.float32),
            np.full(len(y), 0.25, np.float32))


def sparse_problem(n=2400, f=48, bundle_size=4, seed=7):
    """tests/test_parallel.py ``_sparse_problem`` (EFB bundles)."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, f))
    for b0 in range(0, f, bundle_size):
        which = rng.randint(0, bundle_size + 1, size=n)
        rows = np.where(which < bundle_size)[0]
        X[rows, b0 + which[rows]] = rng.randint(1, 8, size=len(rows)) * 0.5
    logit = 3.0 * X[:, 0] - 2.0 * X[:, 1] + X[:, 2] - 0.5 * X[:, 3]
    y = (logit + 0.1 * rng.randn(n) > 0.05).astype(np.float32)
    return X, y


def unbalanced_problem():
    """tests/test_parallel.py ``test_feature_parallel_bundled_unbalanced_
    groups``: one 8-feature bundle and 3 dense features."""
    rng = np.random.RandomState(11)
    n = 1500
    Xb = np.zeros((n, 8))
    which = rng.randint(0, 9, size=n)
    rows = np.where(which < 8)[0]
    Xb[rows, which[rows]] = rng.randint(1, 6, size=len(rows)) * 1.0
    Xd = rng.randn(n, 3)
    X = np.column_stack([Xb, Xd])
    y = (Xd[:, 0] + Xb[:, 0] - Xb[:, 1] + 0.2 * rng.randn(n) > 0
         ).astype(np.float32)
    return X, y


def bosch_problem(n=2500, f=150, density=0.04, seed=3):
    """tests/torch_efb_data.py ``bosch_like`` (JAX ``tests/test_multival.py
    :_bosch_like``): the planner puts it in multi-val groups."""
    rng = np.random.RandomState(seed)
    X = np.where(rng.rand(n, f) < density,
                 rng.randint(1, 9, size=(n, f)) * 0.5, 0.0)
    logit = (3.0 * X[:, 0] - 2.0 * X[:, 1] + X[:, 2] - X[:, 3]
             + 0.5 * X[:, 4])
    y = (logit + 0.3 * rng.randn(n) > 0.2).astype(np.float32)
    return X, y


def roadmap_problem(n=4000, f=20, seed=0):
    """ROADMAP Queue 3 fault 1's data: y = the sum of the first 6
    columns + 0.5 noise > 0."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, :6].sum(axis=1) + 0.5 * rng.randn(n) > 0).astype(np.float32)
    return X, y


BASE = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
SPARSE = dict(BASE, min_data_in_leaf=5)
MV = dict(BASE, min_data_in_leaf=5)
EXTRA = dict(BASE, extra_trees=True)
BYNODE = dict(BASE, feature_fraction_bynode=0.5)
BAG = np.asarray(np.random.RandomState(3).rand(3001) < 0.7, np.float32)

# name -> (learner class name, data, params, trees, bagged)
LEARNER_CASES = {
    "data": ("DataParallelTreeLearner", "dense", BASE, 1, False),
    "data_600": ("DataParallelTreeLearner", "dense",
                 dict(BASE, max_bin=600), 1, False),
    "feature": ("FeatureParallelTreeLearner", "dense", BASE, 1, False),
    "feature_nondiv": ("FeatureParallelTreeLearner", "dense7", BASE, 1,
                       False),
    "voting": ("VotingParallelTreeLearner", "dense", BASE, 1, False),
    "voting_topk3": ("VotingParallelTreeLearner", "dense",
                     dict(BASE, top_k=3), 1, False),
    "mesh_data": ("MeshPartitionedTreeLearner:data", "dense", BASE, 2,
                  False),
    "mesh_voting": ("MeshPartitionedTreeLearner:voting", "dense",
                    dict(BASE, top_k=8), 1, False),
    "mesh_data_bag": ("MeshPartitionedTreeLearner:data", "dense", BASE, 1,
                      True),
    "feature_bundled": ("FeatureParallelTreeLearner", "sparse", SPARSE, 1,
                        False),
    "voting_bundled": ("VotingParallelTreeLearner", "sparse",
                       dict(SPARSE, top_k=48), 1, False),
    "voting_bundled_topk6": ("VotingParallelTreeLearner", "sparse",
                             dict(SPARSE, top_k=6), 1, False),
    "mesh_voting_bundled": ("MeshPartitionedTreeLearner:voting", "sparse",
                            dict(SPARSE, top_k=48), 1, False),
    "feature_unbalanced": ("FeatureParallelTreeLearner", "unbalanced",
                           dict(BASE, num_leaves=11, min_data_in_leaf=5),
                           1, False),
}

# ROADMAP Queue 1 item 13's cases (tests/test_torch_parallel_item13.py):
# multi-val data, per-node randomness
ITEM13_CASES = {
    "data_multival": ("DataParallelTreeLearner", "bosch", MV, 2, False),
    "voting_multival": ("VotingParallelTreeLearner", "bosch",
                        dict(MV, top_k=20), 2, False),
    "data_extra": ("DataParallelTreeLearner", "dense", EXTRA, 2, False),
    "data_bynode": ("DataParallelTreeLearner", "dense", BYNODE, 2, False),
    "voting_extra": ("VotingParallelTreeLearner", "dense",
                     dict(EXTRA, top_k=4), 2, False),
    "voting_bynode": ("VotingParallelTreeLearner", "dense",
                      dict(BYNODE, top_k=4), 2, False),
    "feature_extra": ("FeatureParallelTreeLearner", "dense7", EXTRA, 2,
                      False),
    "feature_bynode": ("FeatureParallelTreeLearner", "dense7",
                       dict(BYNODE, feature_fraction_bynode=0.6), 2, False),
    "mesh_data_bynode": ("MeshPartitionedTreeLearner:data", "dense",
                         dict(BYNODE, extra_trees=True), 2, False),
}

# name -> (params, rounds, data): lt.train over the world
TRAIN_CASES = {
    "train_data": (dict(BASE, learning_rate=0.2, tree_learner="data"), 10,
                   "dense"),
    "train_data_bagging": (dict(BASE, learning_rate=0.2, bagging_freq=1,
                                bagging_fraction=0.7, tree_learner="data"),
                           5, "dense"),
    "train_voting_bundled": (dict(SPARSE, top_k=20, tree_learner="voting"),
                             10, "sparse1600"),
    "train_feature_600": (dict(BASE, tree_learner="feature", max_bin=600),
                          3, "dense"),
}


def data_of(name):
    return {"dense": problem, "dense7": lambda: problem(f=7),
            "sparse": sparse_problem,
            "sparse1600": lambda: sparse_problem(n=1600),
            "unbalanced": unbalanced_problem,
            "bosch": bosch_problem}[name]()


def tree_record(tree):
    k = tree.num_leaves
    return dict(num_leaves=k,
                split_feature=np.asarray(tree.split_feature_inner[:k - 1]),
                threshold_bin=np.asarray(tree.threshold_bin[:k - 1]),
                leaf_value=np.asarray(tree.leaf_value[:k]))


def run_learner_case(name):
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data import Dataset
    from lightgbm_tpu_torch.learner.comm import COMM_BYTES, COMM_CALLS, \
        reset_comm_counts
    from lightgbm_tpu_torch.parallel import learners as pl
    cls_name, data, params, trees, bagged = {**LEARNER_CASES,
                                             **ITEM13_CASES}[name]
    X, y = data_of(data)
    cfg = Config.from_params(params)
    ds = Dataset.from_numpy(X, cfg, label=y)
    cls_name, _, mode = cls_name.partition(":")
    kw = {"mode": mode} if mode else {}
    lrn = getattr(pl, cls_name)(ds, cfg, torch.device("cpu"), **kw)
    g, h = (torch.from_numpy(a) for a in grad_hess(y))
    bag = torch.from_numpy(BAG[:len(y)]) if bagged else None
    reset_comm_counts()
    out = []
    for _ in range(trees):
        tree, lid = lrn.train(g, h, bag_weight=bag)
        rec = tree_record(tree)
        rec["leaf_id"] = lid.numpy().copy()
        out.append(rec)
    return dict(trees=out, learner=type(lrn).__name__,
                calls=dict(COMM_CALLS), bytes=dict(COMM_BYTES))


def run_train_case(name):
    import lightgbm_tpu_torch as lt
    params, rounds, data = TRAIN_CASES[name]
    X, y = data_of(data)
    # the world stays up for the suite's next case
    bst = lt.train(dict(params, elastic_shutdown=False),
                   lt.Dataset(X, label=y), rounds, device="cpu")
    return dict(pred=bst.predict(X), raw=bst.predict(X, raw_score=True),
                trees=[tree_record(t) for t in bst.models],
                learner=type(bst._gbdt.learner).__name__)


# ---- test_torch_distributed.py: bins from the pooled sample ------------

def dist_problem(n=4000, f=5, seed=5):
    """A zero-heavy and a discrete column for the bins; a noisy label, so
    that every split's gain stands above float rounding."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.4, 1] = 0.0
    X[:, 2] = np.round(X[:, 2] * 3)
    y = X[:, 0] + 0.7 * X[:, 3] - 0.3 * X[:, 2] + 0.5 * rng.randn(n) > 0
    return X, y.astype(np.float32)


def mapper_record(ds):
    return [(m.num_bin, np.asarray(m.bin_upper_bound, np.float64).copy(),
             m.missing_type, m.default_bin) for m in ds.bin_mappers]


def l1_label(X, seed=9):
    """A continuous label for the L1-family cases."""
    rng = np.random.RandomState(seed)
    return (X[:, 0] + 0.7 * X[:, 3] - 0.3 * X[:, 2]
            + 0.5 * rng.randn(len(X))).astype(np.float32)


L1_PARAMS = {"objective": "regression_l1", "num_leaves": 15,
             "learning_rate": 0.2, "verbosity": -1}
NDEV_PARAMS = {"objective": "binary", "num_leaves": 15, "top_k": 2,
               "tree_learner": "voting", "n_devices": 2, "verbosity": -1}


def run_dist_case(name, rank, size, out):
    import scipy.sparse as sp
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data import Dataset
    from lightgbm_tpu_torch.parallel import distributed as pd
    from lightgbm_tpu_torch.parallel.ingest import host_row_range
    X, y = dist_problem()
    lo, hi = host_row_range(len(X))
    params = {"objective": "binary", "pre_partition": True,
              "bin_construct_sample_cnt": len(X), "verbosity": -1}
    if name == "dense_bins":
        ds = Dataset.from_numpy(X[lo:hi], Config.from_params(params),
                                label=y[lo:hi])
        return dict(mappers=mapper_record(ds), rows=(lo, hi))
    if name == "sparse_bins":
        ds = Dataset.from_scipy(sp.csr_matrix(X[lo:hi]),
                                Config.from_params(params), label=y[lo:hi])
        return dict(mappers=mapper_record(ds), rows=(lo, hi))
    if name == "n_devices_voting":
        # n_devices=2 over a group of 2 ranks (ROADMAP Queue 3 fault 1)
        import lightgbm_tpu_torch as lt
        Xr, yr = roadmap_problem()
        bst = lt.train(dict(NDEV_PARAMS, elastic_shutdown=False),
                       lt.Dataset(Xr, label=yr), 3, device="cpu")
        return dict(pred=bst.predict(Xr),
                    trees=[tree_record(t) for t in bst.models])
    if name == "serial_checkpoint":
        # a learner of one rank inside the group with checkpoint_dir: every
        # rank would write its own checkpoint into the one directory
        import lightgbm_tpu_torch as lt
        ck = os.path.join(out, "serial_ckpt")
        try:
            lt.train(dict(params, num_leaves=7, tree_learner="serial",
                          pre_partition=False, checkpoint_dir=ck,
                          checkpoint_freq=1, elastic_shutdown=False),
                     lt.Dataset(X, label=y), 2, device="cpu")
        except ValueError as err:
            return dict(error=str(err), written=os.path.exists(ck))
        return dict(error=None, written=os.path.exists(ck))
    if name.startswith("pre_partition_l1"):
        # the L1 leaf refit over every rank's rows (ROADMAP item 13)
        import lightgbm_tpu_torch as lt
        yl = l1_label(X)
        p = dict(params, **L1_PARAMS, tree_learner=name.split("_")[-1],
                 elastic_shutdown=False)
        bst = lt.train(p, lt.Dataset(X[lo:hi], label=yl[lo:hi]), 3,
                       device="cpu")
        return dict(trees=[tree_record(t) for t in bst.models],
                    raw=bst.predict(X, raw_score=True), rows=(lo, hi))
    if name.startswith("pre_partition_"):
        # each rank trains on its own rows, binned from the pooled sample
        import lightgbm_tpu_torch as lt
        p = dict(params, num_leaves=15, learning_rate=0.2,
                 tree_learner=name.split("_")[-1], elastic_shutdown=False)
        bst = lt.train(p, lt.Dataset(X[lo:hi], label=y[lo:hi]), 3,
                       device="cpu")
        return dict(trees=[tree_record(t) for t in bst.models],
                    raw=bst.predict(X, raw_score=True), rows=(lo, hi),
                    learner=type(bst._gbdt.learner).__name__)
    if name == "seed":
        cfg = Config.from_params({"tree_learner": "data",
                                  "data_random_seed": 7 + 5 * rank,
                                  "verbosity": -1})
        return dict(seed=pd.sync_bin_find_seed(cfg))
    if name == "gather":
        sample = np.full((rank + 1, 2), float(rank))
        return dict(pooled=pd.gather_bin_sample(sample))
    raise ValueError(name)


SUITES = {
    "parallel": [("learner", n) for n in LEARNER_CASES],
    "item13": [("learner", n) for n in ITEM13_CASES],
    "distributed": [("dist", n) for n in
                    ("dense_bins", "sparse_bins", "seed", "gather",
                     "pre_partition_data", "pre_partition_voting",
                     "pre_partition_l1_data", "pre_partition_l1_voting",
                     "n_devices_voting", "serial_checkpoint")]
    + [("train", n) for n in TRAIN_CASES],
}

# ---- the elastic drill (tests/test_torch_elastic_drill.py) -------------

DRILL_ROUNDS = 6
DRILL_KILL_ITER = 3
# the data learner past 255 bins (hist_rows and the scan; it grows the
# single process's trees, so a 2 -> 1 reshard resumes it bitwise), short
# watchdog bounds, a checkpoint every iteration
DRILL_PARAMS = {"objective": "binary", "num_leaves": 15,
                "learning_rate": 0.2, "max_bin": 1023,
                "tree_learner": "data", "verbosity": -1,
                "checkpoint_freq": 1, "checkpoint_keep": 10,
                "elastic_heartbeat_ms": 100.0,
                "elastic_heartbeat_timeout_ms": 2000.0,
                "elastic_stall_timeout_ms": 3000.0,
                "elastic_abort_grace_ms": 2000.0,
                "elastic_barrier_s": 20.0}
DRILL_LEGS = {
    "reference": {},
    "kill": {"faults": f"kill_rank@rank=1,iter={DRILL_KILL_ITER}"},
    "resume": {},
    "shrink": {"elastic_resume": True},
    "guard": {},
}


def drill_text(bst):
    """A model's trees: its text before the parameters (which hold each
    leg's paths)."""
    return bst.model_to_string().split("\nparameters:")[0]


def run_drill_leg(rank, size, rdzv, out, leg, ckpt):
    import time
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.robustness.elastic import (ElasticError,
                                                       elastic_exit)
    if size > 1:
        assert lt.init_distributed(rank=rank, world_size=size,
                                   init_method=f"file://{rdzv}",
                                   backend="gloo")
    X, y = problem()
    params = dict(DRILL_PARAMS, checkpoint_dir=ckpt, **DRILL_LEGS[leg])
    t0 = time.monotonic()
    try:
        bst = lt.train(params, lt.Dataset(X, label=y), DRILL_ROUNDS,
                       device="cpu")
    except ElasticError as err:
        elastic_exit(err)
    res = dict(text=drill_text(bst), seconds=time.monotonic() - t0,
               resumed=getattr(bst, "resumed_iteration", None),
               learner=type(bst._gbdt.learner).__name__)
    with open(os.path.join(out, f"{leg}.{rank}.pkl"), "wb") as fh:
        pickle.dump(res, fh)



def spawn_world(out: str, suite: str, size: int = 2,
                limit_s: float = 60.0) -> dict:
    """Run ``suite`` in a world of ``size`` rank processes (a
    ``file://`` rendezvous under ``out``, so parallel test workers never
    share a port), wait at most ``limit_s`` seconds for them all, killing
    every rank on expiry, and return {(case, rank): result}. Raises if a
    rank failed or the world ran out of time."""
    import subprocess
    import time
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("RANK", None)
    rdzv = os.path.join(out, "rdzv")
    logs = [open(os.path.join(out, f"rank{r}.log"), "w") for r in range(size)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), rdzv, str(r), str(size),
         out, suite], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(size)]
    deadline = time.monotonic() + limit_s
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in logs:
            fh.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        tails = []
        for r in range(size):
            with open(os.path.join(out, f"rank{r}.log")) as fh:
                tails.append(f"rank {r} (exit {codes[r]}):\n"
                             + "".join(fh.readlines()[-15:]))
        raise RuntimeError("the world failed or ran out of time:\n"
                           + "\n".join(tails))
    res = {}
    for kind, name in SUITES[suite]:
        for r in range(size):
            with open(os.path.join(out, f"{name}.{r}.pkl"), "rb") as fh:
                res[name, r] = pickle.load(fh)
    return res


def spawn_leg(out, leg, size, ckpt, limit_s=60.0):
    """Run the drill's ``leg`` over ``size`` rank processes (1: one
    process without a group), each killed past ``limit_s``; returns the
    exit codes, each rank's log and the seconds from the first rank's
    exit to the last's."""
    import subprocess
    import time
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("RANK", None)
    env.pop("LGBM_TPU_FAULTS", None)
    rdzv = os.path.join(out, f"rdzv_{leg}")
    paths = [os.path.join(out, f"{leg}_rank{r}.log") for r in range(size)]
    logs = [open(p, "w") for p in paths]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), rdzv, str(r), str(size),
         out, "elastic", leg, ckpt], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(size)]
    deadline = time.monotonic() + limit_s
    ended = [None] * size
    try:
        while None in ended and time.monotonic() < deadline:
            for r, p in enumerate(procs):
                if ended[r] is None and p.poll() is not None:
                    ended[r] = time.monotonic()
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in logs:
            fh.close()
    texts = []
    for p in paths:
        with open(p) as fh:
            texts.append(fh.read())
    done = [t for t in ended if t is not None]
    return ([p.returncode for p in procs], texts,
            max(done) - min(done) if len(done) == size else None)


def main(argv):
    if argv[4] == "elastic":
        torch.set_num_threads(1)
        rdzv, rank, size, out, _, leg, ckpt = argv
        run_drill_leg(int(rank), int(size), rdzv, out, leg, ckpt)
        return
    rdzv, rank, size, out, suite = argv
    rank, size = int(rank), int(size)
    torch.set_num_threads(1)
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.parallel.distributed import shutdown_distributed
    assert lt.init_distributed(rank=rank, world_size=size,
                               init_method=f"file://{rdzv}",
                               backend="gloo")
    for kind, name in SUITES[suite]:
        if kind == "learner":
            res = run_learner_case(name)
        elif kind == "train":
            res = run_train_case(name)
        else:
            res = run_dist_case(name, rank, size, out)
        with open(os.path.join(out, f"{name}.{rank}.pkl"), "wb") as fh:
            pickle.dump(res, fh)
    shutdown_distributed()
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                         "lightgbm_tpu")]
    assert not bad, bad


if __name__ == "__main__":
    main(sys.argv[1:])
