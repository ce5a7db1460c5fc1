"""SLO-driven workload scaling (a copy of the reference package's
``scaling/autoscaler.py``) — the paper's third orchestration service
(§3.5, Table 3), grown from the ``scale_horizontal`` / ``scale_vertical``
stubs into a reconcile loop.

A ``ScalingPolicy`` maps ``ScalingSignals`` (utilization, queue depth, tail
latency — read from a ``scaling.metrics`` registry) to a desired
replica count.  The ``Autoscaler`` clamps that to [min, max], applies
hysteresis (a dead band around the current count) and per-direction
cooldowns, and hands the decision to a ``ReplicaTarget``:

* ``OrchestratorScaler`` — the live plane: scale-out replicates the service
  task onto a node with free vSlices (orchestrator -> node agent -> CRI
  ``replicate``), scale-in removes the youngest replica;
* the simulator's serving loop — the virtual plane (``ServingSimulator``),
  where provisioning delay models sandbox boot + reconfiguration.

Policies never talk to either plane directly; they are pure functions, so
Fig 14 can evaluate the same policy objects against traces and live runs.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Protocol

from repro_torch.scaling.metrics import MetricsRegistry

# Canonical service metric names (one schema across both planes).
M_REQUESTS = "requests_total"
M_COMPLETIONS = "completions_total"
M_SLO_VIOLATIONS = "slo_violations_total"
M_QUEUE_DEPTH = "queue_depth"
M_REPLICAS = "replicas"
M_UTILIZATION = "utilization"
M_LATENCY = "request_latency_seconds"
M_REPLICAS_SERIES = "replicas_ts"
# cache-memory occupancy (paged KV pool): fraction of pool pages in use,
# free page count, and OOM preemptions forced by pool exhaustion
M_KV_PAGES = "kv_pages_in_use_ratio"
M_KV_FREE_PAGES = "kv_free_pages"
M_PREEMPTIONS = "engine_oom_preemptions_total"
# speculative decode: accepted / offered draft tokens (0..1); per-engine
# from the live engine, folded to a service mean by the drive loop, and an
# input to the simulator's speculative service model
M_SPEC_ACCEPT_RATE = "spec_accept_rate"
# prefix cache: prompt tokens served from cached KV pages / total prompt
# tokens (0..1); per-engine from the live engine, folded to a service mean
# by the drive loop, and an input to the simulator's TTFT model
M_PREFIX_HIT_RATE = "prefix_hit_rate"


@dataclass
class ScalingSignals:
    """Inputs to a policy decision, all service-scoped."""
    replicas: int = 1
    utilization: float = 0.0        # busy replica fraction, 0..1
    queue_depth: float = 0.0        # requests waiting for a replica
    p95_latency_s: float = math.nan
    kv_pressure: float = 0.0        # KV pool pages in use, 0..1


def signals_from_registry(reg: MetricsRegistry, service: str,
                          ) -> ScalingSignals:
    return ScalingSignals(
        replicas=max(1, int(reg.gauge(M_REPLICAS, service=service).value)),
        utilization=reg.gauge(M_UTILIZATION, service=service).value,
        queue_depth=reg.gauge(M_QUEUE_DEPTH, service=service).value,
        p95_latency_s=reg.histogram(M_LATENCY, service=service)
        .quantile(0.95),
        kv_pressure=reg.gauge(M_KV_PAGES, service=service).value,
    )


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------
class ScalingPolicy:
    name = "base"

    def desired_replicas(self, s: ScalingSignals) -> int:
        raise NotImplementedError


@dataclass
class TargetUtilizationPolicy(ScalingPolicy):
    """Classic proportional control: keep busy fraction near ``target``."""
    target: float = 0.7
    name: str = "target-util"

    def desired_replicas(self, s: ScalingSignals) -> int:
        if s.utilization <= 0:
            return s.replicas if s.queue_depth > 0 else 1
        return max(1, math.ceil(s.replicas * s.utilization / self.target))


@dataclass
class QueueLengthPolicy(ScalingPolicy):
    """Bound waiting work: allow ``target_per_replica`` queued requests per
    replica (plus the in-service ones)."""
    target_per_replica: float = 2.0
    name: str = "queue-len"

    def desired_replicas(self, s: ScalingSignals) -> int:
        in_service = s.utilization * s.replicas
        outstanding = s.queue_depth + in_service
        return max(1, math.ceil(outstanding / (1 + self.target_per_replica)))


@dataclass
class LatencySLOPolicy(ScalingPolicy):
    """Scale on the tail: grow multiplicatively while p95 breaches the SLO,
    shrink one replica at a time when comfortably under it and idle-ish."""
    slo_p95_s: float = 0.5
    headroom: float = 0.5           # shrink only when p95 < headroom * SLO
    idle_utilization: float = 0.5   # ... and utilization below this
    growth: float = 1.5
    name: str = "latency-slo"

    def desired_replicas(self, s: ScalingSignals) -> int:
        p95 = s.p95_latency_s
        if not math.isnan(p95) and p95 > self.slo_p95_s:
            return max(s.replicas + 1, math.ceil(s.replicas * self.growth))
        under_slo = math.isnan(p95) or p95 < self.headroom * self.slo_p95_s
        if (under_slo and s.utilization < self.idle_utilization
                and s.queue_depth == 0):
            return max(1, s.replicas - 1)
        return s.replicas


@dataclass
class KVPressurePolicy(ScalingPolicy):
    """Compose any policy with cache-memory pressure: when the paged KV
    pool runs hot, add a replica even while latency/queue still look fine
    — pool exhaustion means OOM preemptions (wasted recomputation) are
    about to burn throughput.  Memory pressure is a *leading* indicator;
    tail latency only moves after the preemptions start."""
    inner: ScalingPolicy = field(default_factory=QueueLengthPolicy)
    high_watermark: float = 0.85
    name: str = "kv-pressure"

    def desired_replicas(self, s: ScalingSignals) -> int:
        desired = self.inner.desired_replicas(s)
        if s.kv_pressure > self.high_watermark:
            desired = max(desired, s.replicas + 1)
        return desired


# ---------------------------------------------------------------------------
# Disaggregated serving: per-role replica counts under one slice budget
# ---------------------------------------------------------------------------
@dataclass
class RoleMix:
    """A per-role replica plan: how many prefill / decode replicas, and
    the vertical size (``vfpga_num`` slices) each replica gets."""
    prefill: int = 1
    decode: int = 1
    prefill_vfpga: int = 1
    decode_vfpga: int = 1

    @property
    def total_slices(self) -> int:
        return (self.prefill * self.prefill_vfpga
                + self.decode * self.decode_vfpga)


@dataclass
class RoleMixPolicy:
    """Per-role replica counts for prefill/decode disaggregation.

    Prefill demand follows queue depth (prompts wait for a prefill
    slot); decode demand follows KV pressure (resident lanes hold pool
    pages).  When the plan exceeds ``slice_budget``, vertical size is
    shed first — trading ``vfpga_num`` against the role mix, the
    paper's vertical-scaling knob — and only then does the *less*
    pressured role lose replicas, floored at ``min_each`` so neither
    side of the pipeline ever disappears.
    """
    slice_budget: int = 8
    vfpga_num: int = 2              # preferred per-replica vertical size
    queue_per_prefill: float = 2.0  # queued prompts one prefill absorbs
    kv_high: float = 0.85           # decode grows above this pressure
    min_each: int = 1
    name: str = "role-mix"

    def desired_mix(self, s: ScalingSignals) -> RoleMix:
        prefill = max(self.min_each,
                      math.ceil(s.queue_depth
                                / max(self.queue_per_prefill, 1e-9)))
        decode = max(self.min_each,
                     math.ceil(s.replicas * s.kv_pressure / self.kv_high)
                     if s.kv_pressure > 0 else self.min_each)
        mix = RoleMix(prefill=prefill, decode=decode,
                      prefill_vfpga=self.vfpga_num,
                      decode_vfpga=self.vfpga_num)
        # normalized pressure decides which role shrinks when slices are
        # scarce: queue pressure protects prefill, KV pressure decode
        queue_pressure = s.queue_depth / max(self.queue_per_prefill, 1e-9)
        kv_pressure = s.kv_pressure / self.kv_high
        while mix.total_slices > self.slice_budget:
            if mix.prefill_vfpga > 1 or mix.decode_vfpga > 1:
                # vertical first: shrink the fatter role's replicas
                if mix.prefill_vfpga >= mix.decode_vfpga:
                    mix.prefill_vfpga -= 1
                else:
                    mix.decode_vfpga -= 1
                continue
            shrink_prefill = (queue_pressure <= kv_pressure
                              and mix.prefill > self.min_each)
            if shrink_prefill:
                mix.prefill -= 1
            elif mix.decode > self.min_each:
                mix.decode -= 1
            elif mix.prefill > self.min_each:
                mix.prefill -= 1
            else:
                break                   # floor reached on both roles
        return mix


# ---------------------------------------------------------------------------
# Reconciler
# ---------------------------------------------------------------------------
class ReplicaTarget(Protocol):
    def current_replicas(self) -> int: ...
    def scale_to(self, n: int) -> None: ...


@dataclass
class ScalingDecision:
    t: float
    current: int
    desired: int
    applied: bool
    reason: str = ""


class Autoscaler:
    """Policy + bounds + hysteresis/cooldown; emits replica targets.

    ``reconcile`` is plane-agnostic: the orchestrator's background thread
    calls it with wall time, the serving simulator with virtual time.
    """

    def __init__(self, policy: ScalingPolicy, *, min_replicas: int = 1,
                 max_replicas: int = 8, scale_up_cooldown_s: float = 0.0,
                 scale_down_cooldown_s: float = 30.0,
                 tolerance: float = 0.0):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        self.policy = policy
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.scale_up_cooldown_s = scale_up_cooldown_s
        self.scale_down_cooldown_s = scale_down_cooldown_s
        self.tolerance = tolerance
        self._last_scale_up = -math.inf
        self._last_scale_down = -math.inf
        self.decisions: List[ScalingDecision] = []

    def reconcile(self, signals: ScalingSignals, now: float,
                  ) -> Optional[int]:
        """Return the replica count to converge to, or None to hold."""
        current = signals.replicas
        desired = self.policy.desired_replicas(signals)
        desired = max(self.min_replicas, min(self.max_replicas, desired))

        if desired != current and self.tolerance > 0:
            # dead band: ignore small relative drifts (anti-flap)
            if abs(desired - current) / max(current, 1) <= self.tolerance:
                desired = current

        if desired == current:
            self.decisions.append(ScalingDecision(now, current, desired,
                                                  False, "steady"))
            return None
        if desired > current:
            if now - self._last_scale_up < self.scale_up_cooldown_s:
                self.decisions.append(ScalingDecision(
                    now, current, desired, False, "up-cooldown"))
                return None
            self._last_scale_up = now
            # growing re-arms the shrink guard: a flapping workload should
            # not shrink immediately after a burst ends
            self._last_scale_down = now
        else:
            if now - self._last_scale_down < self.scale_down_cooldown_s:
                self.decisions.append(ScalingDecision(
                    now, current, desired, False, "down-cooldown"))
                return None
            self._last_scale_down = now
        self.decisions.append(ScalingDecision(now, current, desired, True,
                                              "scale"))
        return desired


# ---------------------------------------------------------------------------
# Live-plane target: replica set over the orchestrator
# ---------------------------------------------------------------------------
class OrchestratorScaler:
    """ReplicaTarget driving ``Orchestrator.scale_horizontal`` /
    ``scale_in`` for one service (a base task plus clones).

    Scale-out clones the base task's live snapshot onto the node the
    orchestrator's ``PlacementPolicy`` scores best (free vSlices first,
    then warm program caches, spread across failure domains — the paper's
    replicate command, placement-aware); scale-in removes the youngest
    replica, never the base —
    draining it first (``drain_timeout_s``) so in-flight sequences finish
    at their request boundary instead of being requeued and recomputed.
    """

    def __init__(self, orch, base_cid: str, service: str = "svc",
                 drain_timeout_s: float = 10.0):
        self.orch = orch
        self.base_cid = base_cid
        self.service = service
        self.drain_timeout_s = drain_timeout_s
        self.replica_cids: List[str] = []
        self._lock = threading.Lock()   # serializes scale_to convergence

    def current_replicas(self) -> int:
        """Lock-free snapshot read: the serving loop polls this every tick
        and must never block behind an in-flight multi-second scale_to
        (each replicate is a live checkpoint-clone)."""
        alive = 0
        for c in [self.base_cid] + list(self.replica_cids):
            dep = self.orch.deployments.get(c)
            if dep is not None and dep.status == "running":
                alive += 1
        return max(1, alive)

    def scale_to(self, n: int) -> None:
        with self._lock:
            while self.current_replicas() < n:
                # scale-out placement goes through the scheduler's unified
                # PlacementPolicy: warm program-cache affinity + failure-
                # domain anti-affinity against the service's live replicas
                node = self.orch.place_replica(self.base_cid)
                if node is None:
                    break               # cluster full: partial convergence
                new_cid = self.orch.scale_horizontal(self.base_cid, node)
                self.replica_cids.append(new_cid)
            # pick scale-in victims under the lock, but drain+remove them
            # outside it: a drain blocks for up to drain_timeout_s and must
            # not stall a concurrent scale-out decision behind the lock.
            # A popped victim no longer counts toward current_replicas()
            victims = []
            while self.current_replicas() > n and self.replica_cids:
                victims.append(self.replica_cids.pop())
        for victim in victims:
            self.orch.scale_in(victim, drain_s=self.drain_timeout_s)
        with self._lock:
            now_n = self.current_replicas()
            self.orch.metrics.gauge(
                M_REPLICAS, service=self.service).set(now_n)
            self.orch.metrics.series(
                M_REPLICAS_SERIES, service=self.service).record(now_n)
