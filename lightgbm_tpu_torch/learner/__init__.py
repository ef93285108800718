"""Tree learners of the port: the partitioned (segment) learner and the
serial (leaf_id) learner."""

from .partitioned import PartitionedTreeLearner
from .serial import SerialTreeLearner
