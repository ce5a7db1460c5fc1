"""Discrete-event cluster simulator (paper §5.6, Figs 11–13); a copy of the
reference package's ``core/simulator.py``.  Its costs (``SimParams``,
``ServingParams``) are the reference's modelling constants, not numbers
measured on any device.

Replays (synthetic) Borg-like traces against a simulated vSlice cluster.
The *same* ``FunkyScheduler`` + ``PlacementPolicy`` engine used by the live
runtime drives placement decisions — ``SimulatedCluster`` exposes the same
enriched view (synthetic failure domains, a warm program-cache model that
skips reconfiguration on warm deploys, per-node utilization gauges in the
virtual-clock registry); Funky-specific overheads (boot, reconfiguration, sync
wait, evict/resume/migrate/checkpoint byte costs) are inserted per event,
parameterized by the micro-benchmarks measured on the live runtime —
exactly the paper's methodology.

Modeling notes (matching §5.6):
* every job occupies one vSlice while running; an ``acceleration_rate`` r
  shortens its work to ``dur * (1 - r + r/speedup)`` with speedup = 1.6;
* worst case for Funky: the job's full memory footprint is dirty and must be
  saved/restored on every evict/checkpoint (capped at 8 GiB device memory);
* failures: a job fails once at ``fail_frac`` of its work; with periodic
  checkpointing it resumes from the latest snapshot, else restarts.
"""

from __future__ import annotations

import heapq
import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.placement import M_NODE_UTILIZATION
from repro_torch.core.scheduler import (Action, FunkyScheduler, Policy,
                                        SchedTask, TaskState)
from repro_torch.core.traces import TraceJob
from repro_torch.scaling.autoscaler import (M_COMPLETIONS, M_KV_PAGES,
                                            M_LATENCY, M_PREEMPTIONS,
                                            M_PREFIX_HIT_RATE, M_QUEUE_DEPTH,
                                            M_REPLICAS, M_REPLICAS_SERIES,
                                            M_REQUESTS, M_SLO_VIOLATIONS,
                                            M_SPEC_ACCEPT_RATE,
                                            M_UTILIZATION, Autoscaler,
                                            signals_from_registry)
from repro_torch.scaling.loadgen import ClosedLoopGen, Request
from repro_torch.scaling.metrics import MetricsRegistry


@dataclass
class SimParams:
    host_bw: float = 10e9           # device<->host, bytes/s (PCIe-ish)
    net_bw: float = 12.5e9          # node<->node, bytes/s (100 Gb/s)
    disk_bw: float = 0.5e9          # SSD write, bytes/s
    boot_s: float = 0.05            # sandbox boot (measured: unikernel-like)
    reconfig_s: float = 0.5         # program load/compile on deploy
    sync_wait_s: float = 0.1        # request-boundary wait (chunked)
    accel_speedup: float = 1.6      # measured FPGA-vs-CPU factor (paper)
    checkpoint_interval_s: Optional[float] = None
    acceleration_rate: float = 1.0  # fraction of work accelerable (Fig 11)


@dataclass
class SimJobState:
    job: TraceJob
    work: float                     # effective seconds of work required
    progress: float = 0.0           # completed work, seconds
    ckpt_progress: float = 0.0      # progress at last snapshot
    run_start: Optional[float] = None
    epoch: int = 0                  # invalidates stale finish/fail events
    failed_once: bool = False
    submit_t: float = 0.0
    first_start_t: Optional[float] = None
    finish_t: Optional[float] = None
    evictions: int = 0
    migrations: int = 0
    busy_until: float = 0.0         # overhead window before compute starts


class SimulatedCluster:
    """Enriched ClusterView over simulated nodes: synthetic failure
    domains (round-robin across ``failure_domains`` when given, else every
    node its own domain) and a warm program-cache model (a node that ever
    compiled a job's programs stays warm — compile caches persist) — so
    the simulator's ``PlacementPolicy`` sees the same signal shapes as the
    live orchestrator's view."""

    def __init__(self, num_nodes: int, slices_per_node: int,
                 failure_domains: Optional[int] = None):
        self.capacity = {f"node{i}": slices_per_node
                         for i in range(num_nodes)}
        self.used: Dict[str, int] = {n: 0 for n in self.capacity}
        self.placement: Dict[str, str] = {}
        self.domains = {
            n: (f"dom{i % failure_domains}" if failure_domains else n)
            for i, n in enumerate(self.capacity)}
        self.warm: Dict[str, set] = {n: set() for n in self.capacity}

    def nodes(self) -> List[str]:
        return list(self.capacity)

    def free_slices(self, node: str) -> int:
        return self.capacity[node] - self.used[node]

    def running_tasks(self, node: str):  # unused by scheduler internals
        return []

    # -- enriched view (placement layer) --------------------------------
    def failure_domain(self, node: str) -> str:
        return self.domains[node]

    def warm_programs(self, node: str) -> set:
        return self.warm[node]

    def is_warm(self, node: str, programs) -> bool:
        return bool(programs) and set(programs) <= self.warm[node]

    def occupy(self, node: str, tid: str, programs=()):
        self.used[node] += 1
        self.placement[tid] = node
        self.warm[node].update(programs)

    def release(self, tid: str):
        node = self.placement.pop(tid, None)
        if node is not None:
            self.used[node] -= 1


class Simulator:
    def __init__(self, jobs: List[TraceJob], num_nodes: int,
                 slices_per_node: int = 1, policy: Policy = Policy.PRE_MG,
                 params: Optional[SimParams] = None,
                 placement=None, failure_domains: Optional[int] = None):
        self.jobs = jobs
        self.params = params or SimParams()
        self.cluster = SimulatedCluster(num_nodes, slices_per_node,
                                        failure_domains=failure_domains)
        self.states: Dict[str, SimJobState] = {}
        self.tasks: Dict[str, SchedTask] = {}
        self._heap: list = []
        self._seq = itertools.count()
        self.now = 0.0
        self.events_processed = 0
        # same telemetry schema as the live plane, virtual-clock timestamps
        self.metrics = MetricsRegistry(clock=lambda: self.now)
        # the *same* placement engine as the live plane, reading the
        # enriched SimulatedCluster view + this simulator's registry
        if placement is None:
            from repro_torch.core.placement import PlacementPolicy
            placement = PlacementPolicy(registry=self.metrics)
        self.sched = FunkyScheduler(policy, placement=placement)

    # ------------------------------------------------------------------
    def _push(self, t: float, kind: str, payload=None):
        heapq.heappush(self._heap, (t, next(self._seq), kind, payload))

    def _effective_work(self, job: TraceJob) -> float:
        r = self.params.acceleration_rate
        return job.duration * (1 - r + r / self.params.accel_speedup)

    # -- overhead helpers ------------------------------------------------------
    def _evict_cost(self, st: SimJobState) -> float:
        return (self.params.sync_wait_s
                + st.job.memory_bytes / self.params.host_bw)

    def _resume_cost(self, st: SimJobState) -> float:
        return st.job.memory_bytes / self.params.host_bw

    def _migrate_cost(self, st: SimJobState) -> float:
        return st.job.memory_bytes / self.params.net_bw

    def _ckpt_cost(self, st: SimJobState) -> float:
        return (self.params.sync_wait_s
                + st.job.memory_bytes / self.params.disk_bw)

    # ------------------------------------------------------------------
    def run(self) -> dict:
        for job in self.jobs:
            self._push(job.submit_time, "submit", job)
        if self.params.checkpoint_interval_s:
            self._push(self.params.checkpoint_interval_s, "ckpt_tick")

        while self._heap:
            t, _, kind, payload = heapq.heappop(self._heap)
            self.now = max(self.now, t)
            self.events_processed += 1
            getattr(self, f"_on_{kind}")(payload)
            self._schedule()
        return self._report()

    # -- event handlers ---------------------------------------------------------
    def _on_submit(self, job: TraceJob):
        st = SimJobState(job=job, work=self._effective_work(job),
                         submit_t=self.now)
        self.states[job.jid] = st
        task = SchedTask(tid=job.jid, priority=job.priority,
                         submit_time=self.now,
                         group=getattr(job, "group", None))
        progs = getattr(job, "programs", ())
        if progs:
            task.meta["programs"] = tuple(progs)
        self.tasks[job.jid] = task
        self.sched.submit(task)
        self.metrics.counter("sim_jobs_submitted_total").inc()

    def _start_running(self, st: SimJobState, overhead: float):
        st.run_start = self.now + overhead
        st.busy_until = st.run_start
        if st.first_start_t is None:
            st.first_start_t = st.run_start
        st.epoch += 1
        remaining = st.work - st.progress
        fail_at = None
        if (st.job.fail_frac is not None and not st.failed_once):
            fail_point = st.job.fail_frac * st.work
            if fail_point > st.progress:
                fail_at = st.run_start + (fail_point - st.progress)
        finish_at = st.run_start + remaining
        if fail_at is not None and fail_at < finish_at:
            self._push(fail_at, "fail", (st.job.jid, st.epoch))
        else:
            self._push(finish_at, "finish", (st.job.jid, st.epoch))

    def _pause(self, st: SimJobState):
        """Accumulate progress and stop the clock for this job."""
        if st.run_start is not None:
            st.progress += max(0.0, self.now - st.run_start)
            st.progress = min(st.progress, st.work)
            st.run_start = None
        st.epoch += 1            # cancels in-flight finish/fail events

    def _on_finish(self, payload):
        jid, epoch = payload
        st = self.states[jid]
        if epoch != st.epoch or st.run_start is None:
            return               # stale event (task was evicted/failed)
        st.progress = st.work
        st.finish_t = self.now
        self.cluster.release(jid)
        self.sched.task_done(jid)
        self.tasks[jid].state = TaskState.DONE
        self.metrics.counter("sim_jobs_completed_total").inc()
        self.metrics.histogram("job_latency_seconds",
                               window_s=float("inf")).observe(
            self.now - st.submit_t)

    def _on_fail(self, payload):
        jid, epoch = payload
        st = self.states[jid]
        if epoch != st.epoch or st.run_start is None:
            return
        st.failed_once = True
        self._pause(st)
        # lose progress back to the last snapshot (or zero)
        st.progress = st.ckpt_progress
        self.cluster.release(jid)
        self.sched.task_done(jid)
        task = self.tasks[jid]
        task.state = TaskState.WAITING
        task.node_id = None
        self.sched.submit(task)   # restore/restart via normal scheduling

    def _on_ckpt_tick(self, _):
        p = self.params
        for jid, st in self.states.items():
            if st.run_start is not None and st.finish_t is None \
                    and self.now >= st.busy_until:
                # pause for the snapshot, then continue
                self._pause(st)
                st.ckpt_progress = st.progress
                self._start_running(st, self._ckpt_cost(st))
        # keep ticking while jobs remain unsubmitted or unfinished
        pending = (len(self.states) < len(self.jobs)
                   or any(s.finish_t is None for s in self.states.values()))
        if pending:
            self._push(self.now + p.checkpoint_interval_s, "ckpt_tick")

    # -- scheduling ----------------------------------------------------------
    def _schedule(self):
        actions = self.sched.schedule_once(self.cluster)
        for a in actions:
            st = self.states[a.tid]
            if a.kind == "deploy":
                progs = getattr(st.job, "programs", ())
                # warm program cache: the node already compiled this job's
                # bitstreams, so deploy skips reconfiguration (the paper's
                # warmed-up-FPGA behavior the placement layer optimizes for)
                warm = self.cluster.is_warm(a.node, progs)
                self.cluster.occupy(a.node, a.tid, programs=progs)
                self._start_running(
                    st, self.params.boot_s
                    + (0.0 if warm else self.params.reconfig_s))
            elif a.kind == "evict":
                self._pause(st)
                st.evictions += 1
                self.cluster.release(a.tid)
                # eviction overhead occupies the *evicted* task's timeline
                st.busy_until = self.now + self._evict_cost(st)
            elif a.kind == "resume":
                self.cluster.occupy(a.node, a.tid)
                self._start_running(st, self._resume_cost(st))
            elif a.kind == "migrate":
                st.migrations += 1
                self.cluster.occupy(
                    a.node, a.tid, programs=getattr(st.job, "programs", ()))
                self._start_running(
                    st, self._migrate_cost(st) + self._resume_cost(st))
            self.metrics.counter("sim_actions_total", kind=a.kind).inc()
        self.metrics.gauge("wait_queue_depth").set(
            len(self.sched.wait_queue))
        cap = sum(self.cluster.capacity.values())
        if cap:
            self.metrics.gauge("cluster_utilization").set(
                sum(self.cluster.used.values()) / cap)
            for n, c in self.cluster.capacity.items():
                self.metrics.gauge(M_NODE_UTILIZATION, node=n).set(
                    self.cluster.used[n] / c)

    # -- reporting ---------------------------------------------------------------
    def _report(self) -> dict:
        done = [s for s in self.states.values() if s.finish_t is not None]
        if not done:
            return {"completed": 0}
        makespan = max(s.finish_t for s in done) - min(
            s.submit_t for s in self.states.values())
        lat = [s.finish_t - s.submit_t for s in done]
        exec_t = [s.finish_t - s.first_start_t for s in done
                  if s.first_start_t is not None]
        by_prio: Dict[int, list] = {}
        for s in done:
            by_prio.setdefault(s.job.priority, []).append(
                s.finish_t - s.submit_t)
        return {
            "completed": len(done),
            "makespan_s": makespan,
            "throughput_per_min": len(done) / (makespan / 60.0),
            "mean_latency_s": sum(lat) / len(lat),
            "mean_exec_s": sum(exec_t) / max(len(exec_t), 1),
            "latency_by_priority": {
                p: sum(v) / len(v) for p, v in sorted(by_prio.items())},
            "evictions": sum(s.evictions for s in self.states.values()),
            "migrations": sum(s.migrations for s in self.states.values()),
            "events": self.events_processed,
        }


# ---------------------------------------------------------------------------
# Elastic-serving simulation: autoscaler in the loop (Fig 14)
# ---------------------------------------------------------------------------
@dataclass
class ServingParams:
    provision_delay_s: float = 0.55     # sandbox boot + reconfiguration
    control_interval_s: float = 1.0     # autoscaler reconcile period
    slo_latency_s: float = 0.5          # per-request latency SLO
    hist_window_s: float = 10.0         # signal window for tail latency


@dataclass
class KVModelParams:
    """Cache-memory occupancy model for the serving simulator, mirroring
    the live engine's paged KV pool: a request holds its prompt pages for
    its whole service time and grows by one page per ``page_tokens``
    generated tokens.  When the (service-wide ``active * pool_pages``)
    pool exhausts, the growing request is OOM-preempted back to the queue
    head — the same recomputation rule as the live engine — so memory
    pressure shows up both as the ``kv_pages_in_use_ratio`` signal and as
    preemption-inflated latency."""
    pool_pages: int = 64                # per replica
    page_tokens: int = 8
    prompt_tokens: int = 16
    default_tokens: int = 8             # requests without n_tokens

    def prompt_pages(self) -> int:
        return max(1, -(-self.prompt_tokens // self.page_tokens))

    def total_pages(self, req: Request) -> int:
        n = (req.n_tokens if getattr(req, "n_tokens", None)
             else self.default_tokens)
        return max(1, -(-(self.prompt_tokens + n) // self.page_tokens))


def spec_tokens_per_iteration(spec_k: int, accept_rate: float) -> float:
    """Expected tokens committed per speculative iteration under a
    per-token acceptance probability ``accept_rate``: the accepted prefix
    is geometric, so E = sum_{i=0..k} a^i (1 at a=0 — plain decode — and
    k+1 at a=1, the forced-accept ceiling)."""
    a = min(max(accept_rate, 0.0), 1.0)
    return sum(a ** i for i in range(spec_k + 1))


def engine_service_model(ttft_s: float, tbt_s: float,
                         default_tokens: int = 8, *, spec_k: int = 0,
                         spec_accept_rate: float = 0.0,
                         prefix_hit_rate: float = 0.0):
    """Service-time function from engine-reported latencies.

    ``ttft_s``/``tbt_s`` come from the live engine's ``request_ttft_seconds``
    / ``request_tbt_seconds`` histograms, so the simulator's SLO attainment
    is grounded in on-device measurements (the paper's §5.6 methodology:
    overheads measured live, replayed at trace scale) instead of an assumed
    exponential service time.  Requests carrying ``n_tokens`` get
    ``ttft + (n-1) * tbt``; others fall back to ``default_tokens``.

    ``spec_k``/``spec_accept_rate`` model a *hypothetical* speculative
    deployment from plain-engine calibration: one iteration commits
    ``spec_tokens_per_iteration`` tokens on average, so the per-token time
    shrinks by that factor.  (Calibrating ``tbt_s`` from a live speculative
    engine already folds the speedup in — leave them 0 then.)

    ``prefix_hit_rate`` models a prefix cache: that fraction of prompt
    tokens is served from cached KV pages instead of prefill compute, so
    the time-to-first-token shrinks proportionally (TTFT is prefill-bound
    for the short-generation serving mixes fig 14/15 replay).  Calibrate
    it from the live drive loop's folded ``prefix_hit_rate`` gauge.
    """
    speedup = (spec_tokens_per_iteration(spec_k, spec_accept_rate)
               if spec_k > 0 else 1.0)
    hit = min(max(prefix_hit_rate, 0.0), 1.0)

    def service_time(req: Request) -> float:
        n = req.n_tokens if getattr(req, "n_tokens", None) else default_tokens
        return ttft_s * (1.0 - hit) + max(0, n - 1) * tbt_s / speedup
    return service_time


def disaggregated_service_model(ttft_s: float, tbt_s: float,
                                default_tokens: int = 8, *,
                                transfer_s: float = 0.0,
                                fallback_rate: float = 0.0):
    """Role-aware service-time function for a disaggregated deployment.

    Models the decode pool's occupancy per request: prefill runs on a
    separate replica class, so a decode server holds a lane only for its
    ``(n-1) * tbt`` generation tail plus the KV handoff install
    (``transfer_s``, the TransferQueue's EWMA install cost).  The
    TTFT-aware admission path refuses ``fallback_rate`` of handoffs —
    those lanes decode their first tokens on the prefill side, which
    shows up here as the fallback fraction of prefill time landing back
    on the pool (the aggregated-fallback guarantee: at ``fallback_rate
    = 1`` this degrades exactly to ``engine_service_model``, never
    worse).  Calibrate all four inputs from the live disaggregated
    arm's histograms and ``TransferQueue.stats()``.
    """
    fb = min(max(fallback_rate, 0.0), 1.0)

    def service_time(req: Request) -> float:
        n = req.n_tokens if getattr(req, "n_tokens", None) else default_tokens
        return (max(0, n - 1) * tbt_s
                + (1.0 - fb) * transfer_s + fb * ttft_s)
    return service_time


class ServingSimulator:
    """Discrete-event M/G/n serving loop with the autoscaler in the loop.

    Requests (from ``scaling.loadgen``) queue FIFO for ``replicas``
    identical servers.  Every ``control_interval_s`` the ``Autoscaler``
    reads the canonical service signals from this simulator's virtual-clock
    ``MetricsRegistry`` — exactly the signals the live orchestrator's
    reconcile loop reads — and retargets the replica count.  Scale-out pays
    ``provision_delay_s`` (boot + reconfigure, as measured on the live
    runtime); scale-in removes idle replicas immediately and drains busy
    ones at their next request boundary, the paper's request-boundary rule.
    """

    def __init__(self, requests: List[Request], *,
                 autoscaler: Optional[Autoscaler] = None,
                 initial_replicas: int = 1, service: str = "svc",
                 params: Optional[ServingParams] = None,
                 closed_gen: Optional[ClosedLoopGen] = None,
                 service_time_fn=None,
                 kv_model: Optional[KVModelParams] = None,
                 spec_accept_rate: Optional[float] = None,
                 prefix_hit_rate: Optional[float] = None,
                 trace: bool = False):
        self.params = params or ServingParams()
        self.autoscaler = autoscaler
        self.service = service
        self.closed_gen = closed_gen
        # speculation acceptance assumed by the service model (published
        # as the canonical gauge so policies see the same signal shape the
        # live drive loop folds from per-engine gauges)
        self.spec_accept_rate = spec_accept_rate
        # prefix-cache hit rate assumed by the service model (published as
        # the canonical gauge, mirroring the live loop's service-mean fold)
        self.prefix_hit_rate = prefix_hit_rate
        # default: the trace's pre-drawn exponential demand; engine-served
        # figures pass engine_service_model(...) instead
        self._service_time = service_time_fn or (lambda r: r.service_s)
        self.now = 0.0
        self.metrics = MetricsRegistry(clock=lambda: self.now)
        if trace:
            raise NotImplementedError(
                "simulator tracing (trace=True) is not ported yet")
        self.active = initial_replicas          # provisioned servers
        self.provisioning = 0                   # servers booting
        self._provision_cancel = 0
        self.draining = 0                       # busy servers to retire
        self.busy = 0
        self.queue: deque = deque()
        self._heap: list = []
        self._seq = itertools.count()
        self._pending_arrivals = 0
        self._latencies: List[float] = []
        self.violations = 0
        self.events_processed = 0
        # paged KV occupancy model (optional): pages held per in-service
        # request, epochs invalidate depart/grow events after a preemption
        self.kv = kv_model
        self._kv_used = 0
        self._kv_held: Dict[str, int] = {}
        self._kv_epoch: Dict[str, int] = {}
        self.kv_preemptions = 0
        self.kv_peak_occupancy = 0.0
        for r in requests:
            self._push(r.arrival_t, "arrive", r)
        self._record_replicas()

    # -- plumbing ----------------------------------------------------------
    def _push(self, t: float, kind: str, payload=None):
        if kind == "arrive":
            self._pending_arrivals += 1
        heapq.heappush(self._heap, (t, next(self._seq), kind, payload))

    def _work_remains(self) -> bool:
        return bool(self._pending_arrivals or self.busy or self.queue)

    def _committed(self) -> int:
        """Replica count once all in-flight transitions settle: booting
        servers land (minus cancelled boots), draining servers retire."""
        return (self.active + self.provisioning - self._provision_cancel
                - self.draining)

    def _record_replicas(self):
        self.metrics.gauge(M_REPLICAS, service=self.service).set(
            self._committed())
        self.metrics.series(M_REPLICAS_SERIES, service=self.service,
                            capacity=65536).record(self.active)

    def _kv_capacity(self) -> int:
        return max(self.active, 1) * self.kv.pool_pages

    def _kv_occupancy(self) -> float:
        return self._kv_used / max(self._kv_capacity(), 1)

    def _publish_signals(self):
        self.metrics.gauge(M_QUEUE_DEPTH, service=self.service).set(
            len(self.queue))
        self.metrics.gauge(M_UTILIZATION, service=self.service).set(
            self.busy / max(self.active, 1))
        if self.kv is not None:
            self.metrics.gauge(M_KV_PAGES, service=self.service).set(
                self._kv_occupancy())
        if self.spec_accept_rate is not None:
            self.metrics.gauge(M_SPEC_ACCEPT_RATE,
                               service=self.service).set(
                self.spec_accept_rate)
        if self.prefix_hit_rate is not None:
            self.metrics.gauge(M_PREFIX_HIT_RATE,
                               service=self.service).set(
                self.prefix_hit_rate)
        self._record_replicas()

    # -- event handlers ----------------------------------------------------
    def _dispatch(self):
        while self.queue and self.busy < self.active:
            if self.kv is not None:
                # memory-based admission: an idle server alone is not
                # enough, the prompt's pages must fit in the pool
                need = self.kv.prompt_pages()
                if self._kv_used + need > self._kv_capacity():
                    break
            req = self.queue.popleft()
            self.busy += 1
            dur = self._service_time(req)
            epoch = self._kv_epoch.get(req.rid, 0)
            if self.kv is not None:
                need = self.kv.prompt_pages()
                self._kv_used += need
                self._kv_held[req.rid] = need
                self.kv_peak_occupancy = max(self.kv_peak_occupancy,
                                             self._kv_occupancy())
                extra = self.kv.total_pages(req) - need
                for i in range(extra):
                    # decode crosses one page boundary per page_tokens
                    # tokens; spread the growth across the service time
                    self._push(self.now + dur * (i + 1) / (extra + 1),
                               "kv_grow", (req, epoch))
            self._push(self.now + dur, "depart", (req, epoch))

    def _on_arrive(self, req: Request):
        self._pending_arrivals -= 1
        self.metrics.counter(M_REQUESTS, service=self.service).inc()
        self.queue.append(req)
        self._dispatch()

    def _on_kv_grow(self, payload):
        req, epoch = payload
        if (req.rid not in self._kv_held
                or epoch != self._kv_epoch.get(req.rid, 0)):
            return                       # departed or already preempted
        if self._kv_used < self._kv_capacity():
            self._kv_used += 1
            self._kv_held[req.rid] += 1
            self.kv_peak_occupancy = max(self.kv_peak_occupancy,
                                         self._kv_occupancy())
            return
        # pool exhausted: OOM-preempt this request back to the queue head
        # (deterministic recomputation, like the live engine) — its pages
        # free up, its depart event is invalidated by the epoch bump
        self._kv_used -= self._kv_held.pop(req.rid)
        self._kv_epoch[req.rid] = epoch + 1
        self.busy -= 1
        self.queue.appendleft(req)
        self.kv_preemptions += 1
        self.metrics.counter(M_PREEMPTIONS, service=self.service).inc()
        self._dispatch()

    def _on_depart(self, payload):
        req, epoch = payload
        if epoch != self._kv_epoch.get(req.rid, 0):
            return                       # stale: request was OOM-preempted
        if self.kv is not None:
            self._kv_used -= self._kv_held.pop(req.rid, 0)
        self.busy -= 1
        latency = self.now - req.arrival_t
        self._latencies.append(latency)
        self.metrics.counter(M_COMPLETIONS, service=self.service).inc()
        self.metrics.histogram(M_LATENCY, service=self.service,
                               window_s=self.params.hist_window_s,
                               ).observe(latency)
        if latency > self.params.slo_latency_s:
            self.violations += 1
            self.metrics.counter(M_SLO_VIOLATIONS,
                                 service=self.service).inc()
        if self.closed_gen is not None:
            nxt = self.closed_gen.on_complete(req, self.now)
            if nxt is not None:
                self._push(nxt.arrival_t, "arrive", nxt)
        if self.draining > 0:
            # request-boundary decommission of a surplus replica
            self.draining -= 1
            self.active -= 1
            self._record_replicas()
        else:
            self._dispatch()

    def _on_provision(self, _):
        if self._provision_cancel > 0:       # retargeted down mid-boot
            self._provision_cancel -= 1
            self.provisioning -= 1
            return
        self.provisioning -= 1
        self.active += 1
        self._record_replicas()
        self._dispatch()

    def _scale_towards(self, desired: int):
        committed = self._committed()
        if desired > committed:
            grow = desired - committed
            # un-drain busy servers first: cheapest capacity there is
            undrain = min(grow, self.draining)
            self.draining -= undrain
            grow -= undrain
            for _ in range(grow):
                if self._provision_cancel > 0:
                    self._provision_cancel -= 1   # revive a cancelled boot
                else:
                    self.provisioning += 1
                    self._push(self.now + self.params.provision_delay_s,
                               "provision")
        elif desired < committed:
            shrink = committed - desired
            cancel = min(shrink,
                         self.provisioning - self._provision_cancel)
            self._provision_cancel += cancel
            shrink -= cancel
            idle = max(0, self.active - self.busy)
            immediate = min(shrink, idle)
            self.active -= immediate
            # the rest retire at their next request boundary; committed
            # already counts existing drains, so this never re-applies an
            # earlier shrink
            self.draining += shrink - immediate
        self._record_replicas()

    def _on_control(self, _):
        self._publish_signals()
        if self.autoscaler is not None:
            signals = signals_from_registry(self.metrics, self.service)
            desired = self.autoscaler.reconcile(signals, self.now)
            if desired is not None:
                self._scale_towards(desired)
        if self._work_remains():
            self._push(self.now + self.params.control_interval_s, "control")

    # -- driver ------------------------------------------------------------
    def run(self) -> dict:
        self._push(0.0, "control")
        while self._heap:
            t, _, kind, payload = heapq.heappop(self._heap)
            self.now = max(self.now, t)
            self.events_processed += 1
            getattr(self, f"_on_{kind}")(payload)
        return self.report()

    def report(self) -> dict:
        lat = sorted(self._latencies)

        def q(p):
            if not lat:
                return float("nan")
            return lat[min(len(lat) - 1, int(p * len(lat)))]

        replicas_ts = self.metrics.series(M_REPLICAS_SERIES,
                                          service=self.service,
                                          capacity=65536)
        n = len(lat)
        out = {
            "completed": n,
            "slo_attainment": (n - self.violations) / n if n else
            float("nan"),
            "mean_latency_s": sum(lat) / n if n else float("nan"),
            "p50_latency_s": q(0.50),
            "p95_latency_s": q(0.95),
            "p99_latency_s": q(0.99),
            "mean_replicas": replicas_ts.time_weighted_mean(),
            "max_replicas": max((v for _, v in replicas_ts.points()),
                                default=self.active),
            "events": self.events_processed,
            "horizon_s": self.now,
        }
        if self.kv is not None:
            out["kv_preemptions"] = self.kv_preemptions
            out["kv_peak_occupancy"] = self.kv_peak_occupancy
        return out
