"""Telemetry registry the monitor publishes to."""

from repro_torch.scaling.metrics import (Counter, Gauge, Histogram,
                                         MetricsRegistry, metric_key)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "metric_key"]
