"""The batched serial learner: the trees of B models at once over one
shared bin matrix (the learner of ``multiboost/``, the port of the JAX
package's ``jax.vmap`` of the serial ``grow_tree`` along a model axis,
``lightgbm_tpu/multiboost/program.py:135-165``).

It holds each model's ``leaf_id`` [B, N], packed state ``S`` [B, Ks, L]
and ``T`` [B, 9, L-1] and histogram cache [B, L, G, Bins, 3] on the
``leaf_id`` layout, whatever learner ``create_tree_learner`` would give
the dataset on its own (the layout the JAX program runs), over the one
device bin matrix of a ``SerialTreeLearner`` it keeps for the bucket's
static parts (feature metadata, packed layout, the scan). The matrix is
never copied. Each model has its own ``SplitParams`` (the vmapped
numerics of ``multiboost/batch.py:VMAPPED_PARAMS``).

Two routes, chosen once from the dataset and the bucket's config
(``route``), never to get round a failure:

  * **batched** (the fused leaf step's scope: numerical features, no EFB
    bundles or multi-val groups, at most 1024 bins, the full histogram
    cache, no per-node randomness, CEGB or forced splits, and
    ``fused_split_kernel`` not "off"): a tree of every model per
    iteration in three steps: the root histograms of all models in one
    launch (``ops/hist_cuda.py:histogram_rows_batched``), the root scans
    (one scan launch a model, each with its ``Params``), then ``L - 1``
    launches of the model-batched leaf step
    (``ops/split_step_cuda.py:fused_split_step_leaf_batched``) enqueued
    with no host read; ``S``, ``T`` and ``k`` of all models are read
    once. On the CPU, or with ``ops="plain"``, the same steps run the
    plain versions (loops over the models).
  * **per_model** (every other dataset: categorical features, EFB
    groups, multi-val groups, more than 1024 bins, ...): each model's
    tree goes through the serial learner's own loop (its per-phase loop
    for such data), one model after another inside the iteration.

Either way model m's tree is the one the serial learner grows from its
gradients under its params.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..data.dataset import Dataset
from ..ops.hist_cuda import (histogram_rows_batched,
                             histogram_rows_batched_plain, leaf_bin_bytes,
                             leaf_feat_tile, leaf_max_chunks)
from ..observability.telemetry import get_telemetry
from ..ops.histogram import make_ghc
from ..ops.split import SplitParams
from ..ops.split_step_cuda import (LeafBatchScratch, LeafBatchStep,
                                   fused_split_step_leaf_batched_plain,
                                   learner_fused_kernel_on, params_table)
from .serial import SerialTreeLearner
from .split_step import (f32, fused_split_eligible, fused_split_kernel_mode,
                         grown_tree, root_state)


class BucketTooLarge(RuntimeError):
    """The bucket's state does not fit the card's free memory; nothing
    was launched."""


#: more blocks than a cooperative grid of the leaf kernel has on any card
#: this port targets (two an SM)
GRID_BOUND = 1024

#: the SplitParams fields that vary along the model axis
MODEL_PARAMS = ("lambda_l1", "lambda_l2", "max_delta_step",
                "min_data_in_leaf", "min_sum_hessian_in_leaf",
                "min_gain_to_split")


def model_split_params(base: SplitParams, config: Config) -> SplitParams:
    """``base`` (the bucket's) with one model's vmapped numerics, as
    ``split_params_from_config`` reads them (float, never an int cast)."""
    return base._replace(**{f: float(getattr(config, f))
                            for f in MODEL_PARAMS})


class BatchedSerialLearner:
    """B models' trees over one dataset; ``grow(grad, hess, weight)``
    grows one tree a model and returns (trees, leaf_id [B, N] int32)."""

    def __init__(self, dataset: Dataset, config: Config,
                 configs: Sequence[Config], device: torch.device,
                 ops: str = "kernel"):
        self.serial = SerialTreeLearner(dataset, config, device, ops)
        lr = self.serial
        self.dataset = dataset
        self.device = lr.device
        self.plain = lr.plain
        self.models = len(configs)
        self.num_leaves = lr.num_leaves
        self.num_data = lr.num_data
        self.params: List[SplitParams] = [model_split_params(lr.params, c)
                                          for c in configs]
        # the fused leaf step's gate on the card decides the route, on
        # every device alike (the CPU and ops="plain" run the batched
        # plain versions)
        eligible = fused_split_eligible(
            lr.params, cache_hists=lr.mem.mode == "cache", merged=True,
            extra_trees=bool(config.extra_trees),
            ff_bynode=float(config.feature_fraction_bynode),
            mv_groups=lr.mv_groups, num_leaves=lr.num_leaves) \
            and not lr.forced_plan
        self.route = "batched" if learner_fused_kernel_on(
            fused_split_kernel_mode(config.fused_split_kernel),
            eligible=eligible, device=torch.device("cuda"),
            params=lr.params, num_bins_max=lr.num_bins_max, layout="leaf",
            bundled=lr.bundled) else "per_model"
        b, m = self.models, lr.num_bins_max
        if self.route == "batched" and not self.plain:
            self._check_fits(b)
        state = self._state_layout(b)
        self.lid = torch.zeros(state["lid"][0], dtype=state["lid"][1],
                               device=self.device)
        self.hist = self._scratch = None
        if self.route == "batched":
            self.hist = torch.zeros(state["hist"][0], dtype=state["hist"][1],
                                    device=self.device)
            if not self.plain:
                self._scratch = LeafBatchScratch(lr.binned, m, b)
                self._ptable = params_table(self.params, self.device)

    def _state_layout(self, models: int) -> dict:
        """name -> (shape, dtype) of the bucket's own state on the
        batched route: each model's leaf ids and histogram cache."""
        lr = self.serial
        return {"lid": ((models, self.num_data), torch.int32),
                "hist": ((models, self.num_leaves, lr.num_groups,
                          lr.num_bins_max, 3), torch.float32)}

    def device_bytes(self, models: int) -> int:
        """Device bytes of a bucket of ``models`` models on the batched
        route beyond the shared matrix: its state (``_state_layout``),
        each iteration's ghc, gradients, score and weights (12 + 8 + 4 +
        4 B a row a model), and the kernels' scratch
        (``LeafBatchScratch.layout``, its per-block counts taken at
        ``GRID_BOUND`` blocks)."""
        lr = self.serial
        n, f, nb = self.num_data, lr.num_groups, lr.num_bins_max
        tile = leaf_feat_tile(f, nb, leaf_bin_bytes(lr.binned))
        state = sum(int(np.prod(shape)) * dtype.itemsize
                    for shape, dtype in self._state_layout(models).values())
        return state + models * n * (12 + 8 + 4 + 4) \
            + LeafBatchScratch.nbytes(n, f, nb, models,
                                      leaf_max_chunks(f, tile), GRID_BOUND)

    def _check_fits(self, models: int) -> None:
        need = self.device_bytes(models)
        free = torch.cuda.mem_get_info(self.device)[0]
        if need > 0.9 * free:
            raise BucketTooLarge(
                f"a bucket of {models} models needs {need / 2**30:.2f} GiB "
                f"of device memory, {free / 2**30:.2f} GiB are free")

    def describe(self) -> dict:
        return {"route": self.route, "models": self.models,
                "num_leaves": self.num_leaves, "rows": self.num_data,
                "plain": self.plain}

    # ------------------------------------------------------------------
    def grow(self, grad: torch.Tensor, hess: torch.Tensor,
             weight: Optional[torch.Tensor] = None):
        """One tree a model from ``grad``/``hess`` [B, N] float32 and the
        rows' weights ``weight`` [B, N] (bagging draws or fold masks; an
        out-of-bag or masked row carries zero g/h and count 0 and follows
        the splits all the same), or None."""
        if self.route == "per_model":
            return self._grow_per_model(grad, hess, weight)
        ghc = make_ghc(grad, hess, weight)            # [B, N, 3]
        k, S, T, imeta, fmeta = self.root_states(ghc)
        step = self.split_step(k, S, T, ghc, imeta, fmeta)
        for _ in range(self.num_leaves - 1):
            step()
        # telemetry (JAX multiboost/batch.py:392-426): the batched root
        # histogram, a root scan a model, L - 1 batched steps; the roots'
        # sums read and the iteration's one read of every model's state
        tel = get_telemetry()
        tel.count_iter("host.dispatches", 1 + self.models
                       + self.num_leaves - 1)
        tel.count_iter("host.syncs", 2)
        S, T, k = S.cpu(), T.cpu(), k.cpu().tolist()
        trees = [grown_tree(self.serial.pack, {"S": S[m], "T": T[m]}, k[m],
                            self.dataset)[0] for m in range(self.models)]
        return trees, self.lid

    def root_states(self, ghc: torch.Tensor):
        """Every model's root from ``ghc`` [B, N, 3]: the batched root
        histogram into cache row 0, each model's root scan under its
        params and its root state; the leaf ids reset. Returns (k, S, T,
        imeta, fmeta), k [B] all 1."""
        lr = self.serial
        meta_t, tables, imeta, fmeta = lr._tree_meta(None)
        nb = lr.num_bins_max
        if self.plain:
            roots = histogram_rows_batched_plain(lr.binned, ghc, nb)
        else:
            roots = histogram_rows_batched(lr.binned, ghc, nb,
                                           partial=self._scratch.partial)
        self.hist[:, 0] = roots
        # the roots' sums: the serial learner's (group 0's bins summed),
        # model by model, then one host read
        sums = torch.stack([roots[m, 0].sum(dim=0)
                            for m in range(self.models)]).cpu().numpy()
        inf = f32(np.inf)
        states = []
        for m, p in enumerate(self.params):
            root = tuple(f32(v) for v in sums[m])
            table = lr.scan_table([roots[m]], [root + (-inf, inf)], meta_t,
                                  tables, p)[0]
            states.append(root_state(lr.pack, table, *root, self.num_data,
                                     p, self.num_leaves))
        S = torch.stack([st["S"] for st in states])
        T = torch.stack([st["T"] for st in states])
        k = torch.ones((self.models,), dtype=torch.int32, device=self.device)
        self.lid.zero_()
        return k, S, T, imeta, fmeta

    def split_step(self, k, S, T, ghc, imeta, fmeta):
        """One split of every model, as a callable: the model-batched
        kernel's launch, prepared once (``LeafBatchStep``), or its plain
        version."""
        lr = self.serial
        args = (k, S, T, self.lid, self.hist, lr.binned, ghc, imeta, fmeta)
        kw = dict(big_l=self.num_leaves, max_depth=lr.max_depth,
                  b=lr.num_bins_max, has_monotone=lr.has_monotone)
        if self.plain:
            return lambda: fused_split_step_leaf_batched_plain(
                *args, params=self.params, **kw)
        return LeafBatchStep(*args, self._ptable, scratch=self._scratch,
                             **kw)

    def _grow_per_model(self, grad, hess, weight):
        lr = self.serial
        base = lr.params
        trees = []
        try:
            for m, p in enumerate(self.params):
                lr.params = p
                tree, lid = lr.train(
                    grad[m].contiguous(), hess[m].contiguous(),
                    bag_weight=None if weight is None else weight[m])
                self.lid[m].copy_(lid)
                trees.append(tree)
        finally:
            lr.params = base
        return trees, self.lid


__all__ = ["BatchedSerialLearner", "BucketTooLarge", "MODEL_PARAMS",
           "model_split_params"]
