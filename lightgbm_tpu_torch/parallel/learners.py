"""``create_tree_learner`` (port of
``lightgbm_tpu/parallel/learners.py:620-664``;
TreeLearner::CreateTreeLearner, src/treelearner/tree_learner.cpp:13-38).

The port applies the JAX package's accelerator rule
(``learners.py:655``) on every device: ``serial`` gives the partitioned
(segment) learner when the widest feature's bins fit a byte and the
serial (``leaf_id``) learner otherwise; ``partitioned`` always gives the
partitioned learner. On the CPU, which stands in for the card in the
tests, the JAX package sends ``serial`` to its ``SerialTreeLearner``
whatever the bins; this is the one place where the port departs from the
JAX package's CPU routing. A multi-val dataset (EFB pseudo-groups
without a matrix column) pins the serial learner, as in the JAX package
(``learners.py:641, 655``); ``partitioned`` refuses it. The lazy CEGB
penalty pins the serial learner too (``learners.py:640, 655``: its
charged rows stay in place); ``partitioned`` drops it with a warning.
The data, feature and voting learners are ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import torch

from ..config import Config
from ..data.dataset import Dataset
from ..learner.grow_extras import cegb_on
from ..learner.partitioned import PartitionedTreeLearner, _reject
from ..learner.serial import SerialTreeLearner


def create_tree_learner(learner_type: str, dataset: Dataset, config: Config,
                        device: torch.device, ops: str = "kernel"):
    """The tree learner for ``learner_type`` on ``dataset``."""
    if learner_type not in ("serial", "partitioned"):
        _reject(f"tree_learner={learner_type}", "Queue 1 item 8")
    fits_u8 = int(dataset.num_bins_array().max(initial=2)) <= 256
    lazy_on = cegb_on(config)[1]
    if learner_type == "partitioned" or (fits_u8 and not lazy_on
                                         and not dataset.has_multival):
        return PartitionedTreeLearner(dataset, config, device, ops=ops)
    return SerialTreeLearner(dataset, config, device, ops=ops)
