"""Structured training telemetry and the live observability plane of
the PyTorch port (copy of the layout of ``lightgbm_tpu/observability/``,
docs/Observability.md), with the SLO engine (``slo.py``) over the
serving engine's counters.

  from lightgbm_tpu_torch.observability import get_telemetry
  from lightgbm_tpu_torch.observability import get_metrics, metrics_text
  from lightgbm_tpu_torch.observability import get_tracer
"""

from .flightrec import (FlightRecorder, active_recorder, arm_recorder,
                        disarm_recorder)
from .metrics import (LogHistogram, MetricsRegistry, get_metrics,
                      maybe_start_exporter, metrics_text,
                      start_exporter, stop_exporter)
from .telemetry import (JsonlSink, RingSink, Telemetry, get_telemetry,
                        telemetry_enabled)
from .tracing import (TraceContext, Tracer, get_tracer,
                      tracing_enabled)

__all__ = ["Telemetry", "RingSink", "JsonlSink", "get_telemetry",
           "telemetry_enabled", "MetricsRegistry", "LogHistogram",
           "get_metrics", "metrics_text", "start_exporter",
           "stop_exporter", "maybe_start_exporter", "FlightRecorder",
           "arm_recorder", "disarm_recorder", "active_recorder",
           "Tracer", "TraceContext", "get_tracer", "tracing_enabled"]
