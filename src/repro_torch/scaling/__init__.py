"""Telemetry registry the monitor publishes to, the canonical service
metric names, and the service's request router."""

from repro_torch.scaling.autoscaler import (M_COMPLETIONS, M_KV_FREE_PAGES,
                                            M_KV_PAGES, M_PREEMPTIONS,
                                            M_QUEUE_DEPTH, M_REQUESTS,
                                            M_SLO_VIOLATIONS, M_UTILIZATION)
from repro_torch.scaling.metrics import (Counter, Gauge, Histogram,
                                         MetricsRegistry, metric_key)

__all__ = ["Counter", "Gauge", "Histogram", "M_COMPLETIONS",
           "M_KV_FREE_PAGES", "M_KV_PAGES", "M_PREEMPTIONS", "M_QUEUE_DEPTH",
           "M_REQUESTS", "M_SLO_VIOLATIONS", "M_UTILIZATION",
           "MetricsRegistry", "metric_key"]
