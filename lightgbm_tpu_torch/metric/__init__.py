"""Evaluation metrics of the port (float64 torch on the scores' device)."""

from .metrics import Metric, create_metric, create_metrics

__all__ = ["Metric", "create_metric", "create_metrics"]
