"""Telemetry + SLO-driven workload scaling (paper §3.5 third service).

``metrics``     dependency-free registry shared by live runtime + simulator
``autoscaler``  scaling policies, hysteresis/cooldown reconciler, live target
``loadgen``     open/closed-loop traffic (Poisson, diurnal, burst) for
                elastic-serving scenarios
``serving``     the service's request router and the live-plane drive loops
"""

from repro_torch.scaling.autoscaler import (M_COMPLETIONS, M_KV_FREE_PAGES,
                                            M_KV_PAGES, M_PREEMPTIONS,
                                            M_QUEUE_DEPTH, M_REQUESTS,
                                            M_SLO_VIOLATIONS, M_UTILIZATION,
                                            Autoscaler, KVPressurePolicy,
                                            LatencySLOPolicy,
                                            OrchestratorScaler,
                                            QueueLengthPolicy,
                                            ScalingDecision, ScalingPolicy,
                                            ScalingSignals,
                                            TargetUtilizationPolicy,
                                            signals_from_registry)
from repro_torch.scaling.loadgen import (ClosedLoopGen, Request, burst_rate,
                                         constant_rate, diurnal_rate,
                                         open_loop)
from repro_torch.scaling.metrics import (Counter, Gauge, Histogram,
                                         MetricsRegistry, TimeSeries,
                                         metric_key)
from repro_torch.scaling.serving import (DriveResult, RequestRouter,
                                         drive_engine_open_loop,
                                         drive_open_loop, get_router,
                                         reset_router, teardown_service,
                                         wait_for_service)

__all__ = [
    "Autoscaler", "ClosedLoopGen", "Counter", "DriveResult", "Gauge",
    "Histogram", "KVPressurePolicy", "LatencySLOPolicy", "M_COMPLETIONS",
    "M_KV_FREE_PAGES", "M_KV_PAGES", "M_PREEMPTIONS", "M_QUEUE_DEPTH",
    "M_REQUESTS", "M_SLO_VIOLATIONS", "M_UTILIZATION", "MetricsRegistry",
    "OrchestratorScaler", "QueueLengthPolicy", "Request", "RequestRouter",
    "ScalingDecision", "ScalingPolicy", "ScalingSignals",
    "TargetUtilizationPolicy", "TimeSeries", "burst_rate", "constant_rate",
    "diurnal_rate", "drive_engine_open_loop", "drive_open_loop",
    "get_router", "metric_key", "open_loop", "reset_router",
    "signals_from_registry", "teardown_service", "wait_for_service",
]
