"""Ops of the port: split math, the decision rule, the whole-matrix
histograms (``histogram``), and the hand-written Hopper kernels with
their plain PyTorch versions (``hist_cuda``, ``partition_cuda``,
``split_scan_cuda``, ``split_step_cuda``, ``tree_shap_cuda``)."""

from ._native import LAUNCHES, reset_launch_counts
