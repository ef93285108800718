"""Communication recipes of the parallel learners on ``torch.distributed``
(port of ``lightgbm_tpu/learner/comm.py``; the reference's parallel tree
learners, ``src/treelearner/{feature,data,voting}_parallel_tree_learner
.cpp``, over its ``Network`` collectives).

A recipe (``Comm``) is the set of hooks the shared per-phase grow loop
calls: how a leaf's histogram is reduced across the ranks
(``reduce_hist``), how the root's sums are made global
(``root_sums``), and how a split is chosen from the leaves' histograms
(``select``). Every hook returns the same values on every rank, so the
loop's control flow is the same everywhere; only the rows (data,
voting) or the histogram features (feature) are split.

The collectives are those that gloo takes on CUDA tensors, so that the
ranks may share one card: ``all_reduce``, ``all_gather`` and
``broadcast``, each counted in ``COMM_CALLS`` / ``COMM_BYTES`` (the
payload one rank sends: JAX ``_count_collective``). In a gloo group a
CUDA tensor is staged through a host copy; NCCL takes it where it lies.

* **data** (``make_data_parallel_comm``): each rank's histogram of its
  rows comes as float64 sums, unrounded; ``reduce_hist`` all-reduces
  them in float64 and rounds once, so the port's summation rule holds
  across ranks (the order of the sum across ranks is gloo's, fixed by
  the world size). The JAX reduce-scatter is an all-reduce here (gloo
  has no reduce-scatter on CUDA tensors): every rank then scans its
  slice of the features (``FeatureShardPlan``) and the winners are
  exchanged by ONE packed ``all_gather`` of a row a leaf
  (``gather_best_split``: max gain, ties to the lower global feature).
  CEGB and forced splits need every feature's row, so they take the
  full-reduce fallback: a replicated scan of the reduced histogram.
  With per-node randomness the root is scanned replicated (JAX
  ``select_root``: the tree's draws over every feature) and a shard's
  scans read its own node table (``learner._node_shard``: the keys
  folded with the rank). A multi-val dataset's histograms come as
  float64 too, beside the dense groups', and are reduced with them.
* **feature** (``make_feature_parallel_comm``): every rank holds every
  row and builds the histograms of its feature shard only; its scan of
  the shard and the packed winner gather. The root's sums (group 0's
  histogram, as the serial learner takes them) are broadcast from the
  rank that holds group 0.
* **voting** (``make_voting_parallel_comm``, PV-Tree): histograms stay
  rank-local; a local scan with ``min_data_in_leaf`` and the hessian
  minimum divided by the ranks, the local top-k, ONE ``all_gather`` of
  (weighted gain, feature) pairs, the global vote, an all-reduce of
  only the winners' histograms (float64), and the full scan of those.
  An EFB dataset debundles its local group histograms with the local
  leaf totals (``debundle_totals(local_hist=True)``). Per-node
  randomness reads the tree's node table in both scans (the winners'
  columns of it in the second), as the JAX recipe passes its draws.

Per split (both children at once): data 1 all-reduce of the smaller
child's [G, B, 3] float64 and 1 all-gather of 2 packed rows (1 all-reduce
in the fallback); feature 1 all-gather; voting 1 all-gather of the votes
and 1 all-reduce of the winners' [2, top_k, B, 3] float64. At the root:
one more of each, and the feature recipe's broadcast of the root's sums
(voting: an all-reduce of them). A row-split learner then gathers the
ranks' leaf ids once a tree when every rank holds every row.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops.split import CAT_TABLE_COLS, O_SCORE

COMM_CALLS = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}
COMM_BYTES = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}


def reset_comm_counts() -> None:
    for d in (COMM_CALLS, COMM_BYTES):
        for k in d:
            d[k] = 0


def _count(name: str, t: torch.Tensor) -> None:
    """Count a collective, and with telemetry on add its payload to
    ``comm.<name>_bytes`` / ``comm.<name>_calls`` (JAX
    ``learner/comm.py:_count_collective``, rendered by
    ``tools/run_report.py`` as the per-op comms table)."""
    from ..observability.telemetry import get_telemetry, traced_bytes
    COMM_CALLS[name] += 1
    COMM_BYTES[name] += t.numel() * t.element_size()
    tel = get_telemetry()
    if tel.enabled:
        tel.count(f"comm.{name}_bytes", traced_bytes(t))
        tel.count(f"comm.{name}_calls", 1)


def _staged(t: torch.Tensor) -> bool:
    """A CUDA tensor in a gloo group goes through a host copy, which
    costs less than gloo's own CUDA path (chip_smoke.py phase 16)."""
    import torch.distributed as dist
    return t.is_cuda and dist.get_backend() == "gloo"


def all_reduce(t: torch.Tensor, size: int) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place (the identity in a world of
    one, where nothing is counted)."""
    if size > 1:
        import torch.distributed as dist
        _count("all_reduce", t)
        if _staged(t):
            h = t.cpu()
            dist.all_reduce(h)
            t.copy_(h)
        else:
            dist.all_reduce(t)
    return t


def all_gather(t: torch.Tensor, size: int) -> torch.Tensor:
    """[size, *t.shape]: every rank's ``t`` in rank order."""
    if size == 1:
        return t[None]
    import torch.distributed as dist
    _count("all_gather", t)
    src = t.contiguous().cpu() if _staged(t) else t.contiguous()
    out = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(out, src)
    return torch.stack(out).to(t.device)


def broadcast(t: torch.Tensor, src: int, size: int) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place."""
    if size > 1:
        import torch.distributed as dist
        _count("broadcast", t)
        if _staged(t):
            h = t.cpu()
            dist.broadcast(h, src)
            t.copy_(h)
        else:
            dist.broadcast(t, src)
    return t


class Comm(NamedTuple):
    """One parallel mode's hooks (JAX ``Comm``).

    ``reduce_hist(h)``: a leaf's histogram as the scans and the cache
    take it: ``h`` is float64 where ``float64_hist`` (the data recipe,
    which all-reduces and rounds once), else float32 (kept local).
    ``root_sums(learner, root_hist)``: the root's (g, h, c) host
    float32 triple, the same on every rank. ``select(learner, hists,
    leaves, meta_t, tables, salts)``: the [K, F, C] scan table of K
    leaves, the same on every rank, whose first-index argmax is the
    split."""
    mode: str
    size: int
    reduce_hist: Callable
    root_sums: Callable
    select: Callable
    float64_hist: bool = False


def serial_root_sums(learner, root_hist) -> tuple:
    """Group 0's bins summed (every group's bins sum to the leaf), as
    the serial learner takes the root's sums."""
    s = root_hist[0].sum(dim=0).cpu().numpy()
    return tuple(np.float32(v) for v in s)


def serial_select(learner, hists, leaves, meta_t, tables, salts):
    return learner.serial_scan(hists, leaves, meta_t, tables, salts)


def gather_best_split(local: torch.Tensor, ids: torch.Tensor, f: int,
                     size: int) -> torch.Tensor:
    """The SyncUpGlobalBestSplit exchange (parallel_tree_learner.h:
    190-213; JAX ``gather_best_split``) as ONE packed ``all_gather``:
    ``local`` [K, F_local, C] is this rank's scan table of its features
    ``ids`` (global ids, [F_local] on the table's device; F_local may be
    0). Each rank sends its best row a leaf with its global feature id
    (bit patterns in float32); every rank returns the [K, F, C] table
    holding each rank's winner at its feature and -inf scores elsewhere,
    so the first-index argmax picks the largest gain, ties to the lower
    global feature id."""
    k, fl, c = local.shape
    dev = local.device
    if fl:
        best = torch.argmax(local[..., O_SCORE], dim=1)
        rows = local[torch.arange(k, device=dev), best]
        gid = ids[best]
    else:   # a rank without features sends a losing row at column f
        rows = torch.zeros((k, c), dtype=local.dtype, device=dev)
        rows[:, O_SCORE] = float("-inf")
        gid = torch.full((k,), f, dtype=torch.int64, device=dev)
    got = all_gather(pack_split(rows, gid), size)   # [size, K, C + 1]
    rows, gids = unpack_split(got)
    full = torch.zeros((k, f + 1, c), dtype=local.dtype, device=dev)
    full[..., O_SCORE] = float("-inf")
    leaf = torch.arange(k, device=dev)[None, :].expand_as(gids)
    full[leaf.reshape(-1), gids.reshape(-1)] = rows.reshape(-1, c)
    return full[:, :f]


def pack_split(rows: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """[K, C] scan-table rows and their [K] global feature ids -> ONE
    float32 [K, C + 1] buffer (the id's int32 bits in the last column;
    JAX ``pack_split``)."""
    return torch.cat([rows, gid.to(torch.int32).view(torch.float32)[:, None]],
                     dim=1)


def unpack_split(buf: torch.Tensor):
    """``pack_split``'s inverse over any leading dims: (rows, int64
    ids)."""
    return buf[..., :-1], buf[..., -1].contiguous().view(torch.int32).long()


def make_sharded_select():
    """Select over a feature-sharded scan: this rank scans its features
    (``learner.shard_ids``, global ids) of the leaves' per-feature
    histograms (``learner.sharded_feature_hists``) and the winners are
    gathered (``gather_best_split``). Shared by the feature recipe and
    the data recipe's reduce-scatter form."""

    def select(learner, hists, leaves, meta_t, tables, salts):
        if learner.comm.mode == "data" and learner._node is not None \
                and tuple(salts) == (0,):
            # the root (salt 0): scanned replicated with the tree's draws
            # over every feature (JAX select_root)
            return learner.serial_scan(hists, leaves, meta_t, tables, salts)
        ids = learner.shard_ids
        fh = learner.sharded_feature_hists(hists, leaves)
        sub_meta, sub_tables = learner.meta_subset(meta_t, tables, ids)
        cols = CAT_TABLE_COLS if learner.params.has_categorical else 8
        local = learner.scan_table(fh, leaves, sub_meta, sub_tables,
                                   learner.params, learner._node_shard,
                                   salts) \
            if len(ids) else torch.zeros(
                (len(hists), 0, cols), dtype=torch.float32,
                device=hists[0].device)
        return gather_best_split(local, ids, learner.num_features,
                                learner.comm.size)

    return select


def make_data_parallel_comm(size: int, sharded: bool) -> Comm:
    """Data-parallel (data_parallel_tree_learner.cpp): float64 local
    histograms all-reduced and rounded once; with ``sharded`` (no CEGB,
    no forced splits) each rank scans its feature shard and the winners
    are gathered, else every rank scans every feature (the full-reduce
    fallback, JAX ``make_data_parallel_comm(plan=None)``)."""

    def reduce_hist(h64):
        return all_reduce(h64, size).float()

    select = make_sharded_select() if sharded else serial_select
    return Comm(mode="data", size=size, reduce_hist=reduce_hist,
                root_sums=serial_root_sums, select=select,
                float64_hist=True)


def make_feature_parallel_comm(size: int) -> Comm:
    """Feature-parallel (feature_parallel_tree_learner.cpp): histograms
    of the rank's feature shard, its scan, the packed winner gather; the
    root's sums broadcast from group 0's rank."""

    def root_sums(learner, root_hist):
        t = torch.zeros(3, dtype=torch.float32, device=root_hist.device)
        if learner.group0_local is not None:
            t.copy_(root_hist[learner.group0_local].sum(dim=0))
        broadcast(t, learner.group0_rank, size)
        return tuple(np.float32(v) for v in t.cpu().numpy())

    return Comm(mode="feature", size=size, reduce_hist=lambda h: h,
                root_sums=root_sums,
                select=make_sharded_select())


def make_voting_parallel_comm(size: int, top_k: int, params_local) -> Comm:
    """PV-Tree (arxiv 1611.01276; voting_parallel_tree_learner.cpp): per
    leaf a local scan with ``params_local`` (min_data / min_hessian over
    the ranks, :57-59), the local top-k by score, ONE ``all_gather`` of
    the (weighted gain, feature) pairs (the 2 * top_k LightSplitInfo
    exchange), the global vote by gain weighted with the local leaf count
    over the mean count (:152-183), an all-reduce of only the winners'
    histograms (float64, rounded once; CopyLocalHistogram +
    ReduceScatter, :186-242) and the full scan of those columns. Both
    children of a split share the two collectives."""

    def root_sums(learner, root_hist):
        t = root_hist[0].double().sum(dim=0)
        all_reduce(t, size)
        return tuple(np.float32(v) for v in t.float().cpu().numpy())

    def select(learner, hists, leaves, meta_t, tables, salts):
        fh = learner.local_feature_hists(hists)
        k_leaves = len(fh)
        f = fh[0].shape[0]
        k = min(int(top_k), f)
        dev = fh[0].device
        # local leaf totals (every feature's bins sum to the leaf)
        loc = torch.stack([h[0].sum(dim=0) for h in fh]).cpu().numpy()
        local_leaves = [(loc[i, 0], loc[i, 1], loc[i, 2]) + tuple(l[3:5])
                        for i, l in enumerate(leaves)]
        node = learner._node
        table = learner.scan_table(fh, local_leaves, meta_t, tables,
                                   params_local, node, salts)
        score = table[..., O_SCORE]                          # [K, F]
        top_gain, top_ids = torch.sort(score, dim=1, descending=True,
                                       stable=True)
        top_gain, top_ids = top_gain[:, :k], top_ids[:, :k]
        mean_cnt = torch.tensor([float(l[2]) / size for l in leaves],
                                dtype=torch.float32, device=dev)
        w = torch.from_numpy(loc[:, 2].astype(np.float32)).to(dev) \
            / torch.clamp(mean_cnt, min=1.0)
        w_gain = torch.where(torch.isfinite(top_gain),
                             top_gain * w[:, None],
                             torch.full_like(top_gain, float("-inf")))
        buf = torch.cat([w_gain, top_ids.to(torch.int32).view(
            torch.float32)], dim=1)                          # [K, 2k]
        got = all_gather(buf, size)                          # [size, K, 2k]
        all_gain = got[..., :k].permute(1, 0, 2).reshape(k_leaves, -1)
        all_ids = got[..., k:].contiguous().view(torch.int32).long() \
            .permute(1, 0, 2).reshape(k_leaves, -1)
        feat_gain = torch.full((k_leaves, f), float("-inf"), device=dev)
        feat_gain = feat_gain.scatter_reduce(1, all_ids, all_gain, "amax")
        win = torch.sort(feat_gain, dim=1, descending=True,
                         stable=True)[1][:, :k]               # [K, k]
        sel = torch.stack([h.index_select(0, win[i]).double()
                           for i, h in enumerate(fh)])
        sel = all_reduce(sel, size).float()                  # [K, k, B, 3]
        full = torch.zeros((k_leaves, f, table.shape[2]),
                           dtype=table.dtype, device=dev)
        full[..., O_SCORE] = float("-inf")
        for i in range(k_leaves):
            sm, st = learner.meta_subset(meta_t, tables, win[i])
            t = learner.scan_table(
                [sel[i]], [leaves[i]], sm, st, learner.params,
                None if node is None else node.index_select(1, win[i]),
                salts[i:i + 1])[0]                           # [k, C]
            b = torch.argmax(t[:, O_SCORE])
            full[i, win[i][b]] = t[b]
        return full

    return Comm(mode="voting", size=size, reduce_hist=lambda h: h,
                root_sums=root_sums, select=select)


def comm_root_hooks(comm: Optional[Comm]):
    """(root_sums, select) of a recipe, or the serial learner's (None:
    no recipe): one definition for both layouts' grow loops."""
    if comm is None:
        return serial_root_sums, serial_select
    return comm.root_sums, comm.select
