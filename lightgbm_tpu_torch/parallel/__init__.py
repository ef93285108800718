"""The learners' selection and the parallel learners on
``torch.distributed`` (port of ``lightgbm_tpu/parallel/``)."""

from .distributed import (current_world, init_distributed,
                          shutdown_distributed)
from .learners import (DataParallelTreeLearner, FeatureParallelTreeLearner,
                       MeshPartitionedTreeLearner, VotingParallelTreeLearner,
                       create_tree_learner)
