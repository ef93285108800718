"""Learner selection of the port (port of ``lightgbm_tpu/parallel/``;
the mesh learners are ROADMAP Queue 1 item 8)."""

from .learners import create_tree_learner
