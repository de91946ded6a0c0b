"""Serving telemetry: span tracer (Perfetto trace-event JSON), metrics
registry (counters / gauges / percentile histograms), roofline drift
tracking (hwmodel-predicted vs measured step time), and structured
logging.  ``Telemetry`` is the facade the runtime takes; everything here
is import-free of the runtime package so it can be used standalone.
Copied from ``repro.obs``: the same names and the same trace format."""
from .drift import DriftRow, RooflineDrift, batch_bucket
from .logger import StructLogger, as_logger
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, percentile
from .telemetry import OFF_TELEMETRY, Telemetry
from .trace import (
    NULL_TRACER,
    PID_ENGINE,
    PID_REQUESTS,
    NullTracer,
    Tracer,
    validate_trace,
)

__all__ = [
    "Counter",
    "DriftRow",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_TRACER",
    "NullTracer",
    "OFF_TELEMETRY",
    "PID_ENGINE",
    "PID_REQUESTS",
    "RooflineDrift",
    "StructLogger",
    "Telemetry",
    "Tracer",
    "as_logger",
    "batch_bucket",
    "percentile",
    "validate_trace",
]
