"""The per-request serving path's frontend and the live-plane drive loops
(the reference's ``scaling/serving.py``).

* ``RequestRouter`` — intake, KV-aware and role-aware pop, completion,
  requeue, lease transfer and crash replay.  Requests are published to the router; every ``EngineServeTask``
  replica's continuous-batching engine pulls admissible requests from it
  in ``pump`` and reports completions back, so the latencies in the
  registry are engine-measured, not modeled.
* ``drive_engine_open_loop`` — replays an open-loop trace through the
  router while the orchestrator's autoscaler scales the service; SLO
  attainment comes from the engine-reported end-to-end latencies.
* ``drive_open_loop`` — the modeled-completion driver (each RUNNING
  replica retires ``service_rate`` requests/s in the load generator).

Either way, every scaling action underneath is the real machinery —
checkpoint-clone replicate and kill+delete through node agents and CRI —
and the orchestrator's autoscaler reconcile thread consumes the canonical
service signals from the registry.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.scaling.autoscaler import (M_COMPLETIONS, M_KV_FREE_PAGES,
                                            M_KV_PAGES, M_LATENCY,
                                            M_PREFIX_HIT_RATE, M_QUEUE_DEPTH,
                                            M_REQUESTS, M_SLO_VIOLATIONS,
                                            M_SPEC_ACCEPT_RATE,
                                            M_UTILIZATION)
from repro_torch.scaling.loadgen import Request
from repro_torch.scaling.metrics import metric_key


@dataclass
class DriveResult:
    served: int
    violations: int
    max_replicas: int
    # rid -> prompt of every request the engine drive submitted, so a
    # caller can serve the same requests again on another engine
    prompts: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def attainment(self) -> float:
        if not self.served:
            return float("nan")
        return (self.served - self.violations) / self.served


class RequestRouter:
    """Intake + bookkeeping shared by the engine replicas of one service.

    **KV-aware routing** (``kv_aware=True``, needs a registry): a pop
    tagged with an ``engine_id`` prefers the replica with the most free KV
    pages (the per-engine ``kv_free_pages`` gauge every paged engine
    publishes).  A non-preferred replica is deferred exactly once and
    served on its next pop, so preference never starves a replica.

    **Prefix-hit-aware routing**: engines with a prefix cache register a
    probe (``register_prefix_probe``) that reports how many tokens of a
    prompt their radix tree already holds.  A pop then prefers the replica
    with the warmest matching prefix for the request at the head of the
    queue.  Warmth is capped by free-page headroom: a warm replica whose
    pool has fallen below half the best replica's free pages loses its
    preference, and the router falls back to the free-page balance above.

    With a tracer (``tracer=``), each submitted request starts a trace
    (trace id = rid) with a ``router.queue`` span ending at its pop;
    engines sharing the tracer hang their spans off the same trace, so one
    request is one connected tree.  A replayed or requeued request's new
    trace links back to its predecessor (relation ``recovers``).

    **Role-aware routing** (disaggregated serving): replicas declare a
    role via ``register_engine_role``.  ``decode`` replicas never pop
    fresh prompts (their work arrives through the KV transfer queue);
    with several ``prefill`` replicas, prompts route by bucketed prompt
    length (a fixed bucket -> replica assignment), so each replica's
    per-bucket prefill program stays hot.  ``transfer_lease`` follows a
    lane across a handoff, so crash replay keeps conserving requests, and
    ``replay_request`` replays one request lost to a torn transfer.

    Every popped request holds a lease until its engine completes or
    requeues it; ``complete`` counts each request once.  ``fail_engine``
    replays a crashed replica's leases, recording each request's
    committed tokens, and ``complete`` checks that the replayed completion
    starts with them (``replay_mismatches`` counts those that do not).
    With a fault plan (``chaos=``), the ``router.pop`` site may delay a
    pop.
    """

    def __init__(self, service: str = "svc", registry=None,
                 kv_aware: bool = True, tracer=None, chaos=None):
        self.service = service
        self.registry = registry
        self.kv_aware = kv_aware
        self.tracer = tracer            # repro_torch.obs.Tracer, optional
        self.chaos = chaos              # repro_torch.chaos.FaultPlan
        self.closed = False
        self._lock = threading.Lock()
        self._pending: deque = deque()
        self._deferred: set = set()     # engines already held back once
        # engine_id -> prompt -> matched-token count (prefix-cache warmth)
        self._prefix_probes: Dict[str, Callable] = {}
        # disaggregated serving: engine_id -> role / prompt buckets
        self._roles: Dict[str, str] = {}
        self._role_buckets: Dict[str, tuple] = {}
        self._leases: Dict[str, tuple] = {}   # rid -> (req, engine_id)
        self.completed: Dict[str, object] = {}   # rid -> CompletedRequest
        self.duplicates = 0
        # rid -> tokens committed before the crash that replayed it
        self.replayed: Dict[str, list] = {}
        self.replay_mismatches = 0

    @property
    def in_flight(self) -> int:
        return len(self._leases)

    def submit(self, req) -> None:
        with self._lock:
            if self.closed:
                raise RuntimeError(f"router {self.service} is closed")
            if req.arrival_t is None and self.registry is not None:
                req.arrival_t = self.registry.clock()
            if (self.tracer is not None
                    and getattr(req, "trace", None) is None):
                req.trace = self.tracer.start_trace(
                    "request", trace_id=req.rid, service=self.service)
            if getattr(req, "trace", None) is not None:
                req._router_span = req.trace.span("router.queue",
                                                  service=self.service)
            self._pending.append(req)
        if self.registry is not None:
            self.registry.counter(M_REQUESTS, service=self.service).inc()

    def register_prefix_probe(self, engine_id: str, probe: Callable) -> None:
        """Install a replica's prefix-cache warmth probe:
        ``probe(prompt) -> matched token count``.  Engines with a prefix
        cache call this from ``pump``; idempotent."""
        with self._lock:
            self._prefix_probes[engine_id] = probe

    def register_engine_role(self, engine_id: str, role: str,
                             buckets: tuple = ()) -> None:
        """Declare a replica's serving role (and its prompt buckets, for
        bucketed prefill routing).  Engines call this from ``pump``;
        idempotent."""
        with self._lock:
            self._roles[engine_id] = role
            self._role_buckets[engine_id] = tuple(buckets)

    def _prefill_preferred(self, engine_id: str) -> bool:
        """Bucketed prompt-length routing between prefill replicas: the
        head request's bucket maps onto the sorted prefill replica ids, so
        each replica keeps to its own buckets' prefill programs."""
        prefills = sorted(e for e, r in self._roles.items()
                          if r == "prefill")
        if len(prefills) < 2 or engine_id not in prefills:
            return True
        buckets = sorted(set(self._role_buckets.get(engine_id) or ()))
        if not buckets:
            return True
        plen = int(np.asarray(self._pending[0].prompt).reshape(-1).shape[0])
        fit = [i for i, b in enumerate(buckets) if b >= plen]
        idx = fit[0] if fit else len(buckets) - 1
        return prefills[idx % len(prefills)] == engine_id

    def _free_pages(self) -> Dict[str, float]:
        if self.registry is None:
            return {}
        return {lbl["engine"]: v for lbl, v in
                self.registry.labeled_gauge_values(
                    M_KV_FREE_PAGES, service=self.service)
                if "engine" in lbl}

    def _kv_preferred(self, engine_id: str) -> bool:
        """True unless another engine publishes strictly more free pages
        (unknown engines and registry-less routers are always preferred)."""
        per_engine = self._free_pages()
        if not per_engine or engine_id not in per_engine:
            return True
        return per_engine[engine_id] >= max(per_engine.values())

    def _preferred(self, engine_id: str) -> bool:
        """Routing preference for the request at the head of the queue:
        the warmest matching prefix first (capped by free-page headroom, so
        hit skew cannot starve the cold replicas), free KV pages as the
        fallback."""
        if self._prefix_probes:
            head = self._pending[0]
            warmth = {}
            for eid, probe in self._prefix_probes.items():
                try:
                    warmth[eid] = int(probe(head.prompt))
                except Exception:  # noqa: BLE001 - replica mid-evacuation
                    warmth[eid] = 0
            best = max(warmth.values(), default=0)
            if best > 0:
                warm = {e for e, w in warmth.items() if w == best}
                free = self._free_pages()
                if free:
                    # headroom cap: a warm replica running low on pages
                    # loses its preference (the prefill saving would be
                    # paid back in OOM preemptions)
                    bar = max(free.values()) / 2.0
                    warm = {e for e in warm if free.get(e, bar) >= bar}
                if warm:
                    return engine_id in warm
        return self._kv_preferred(engine_id)

    def pop(self, n: int, engine_id: Optional[str] = None) -> list:
        if n <= 0:
            return []
        if self.chaos is not None:
            self.chaos.maybe_delay("router.pop", key=engine_id or "")
        with self._lock:
            role = self._roles.get(engine_id) if engine_id else None
            if role == "decode":
                # decode replicas receive work through the KV transfer
                # queue, never fresh prompts
                return []
            if role == "prefill":
                if (self._pending
                        and not self._prefill_preferred(engine_id)):
                    if engine_id not in self._deferred:
                        self._deferred.add(engine_id)
                        return []
            elif (self.kv_aware and engine_id is not None and self._pending
                    and not self._preferred(engine_id)):
                if engine_id not in self._deferred:
                    self._deferred.add(engine_id)
                    return []
            self._deferred.discard(engine_id)
            out = []
            while self._pending and len(out) < n:
                req = self._pending.popleft()
                self._leases[req.rid] = (req, engine_id)
                rsp = getattr(req, "_router_span", None)
                if rsp is not None:
                    rsp.annotate(engine=engine_id).end()
                    req._router_span = None
                out.append(req)
            return out

    def complete(self, record) -> None:
        with self._lock:
            self._leases.pop(record.rid, None)
            if record.rid in self.completed:
                # exactly-once guard: a replayed request that the dead
                # replica already terminated must not count twice
                self.duplicates += 1
                if self.registry is not None:
                    self.registry.counter("router_duplicate_completions",
                                          service=self.service).inc()
                return
            pre = self.replayed.get(record.rid)
            if pre is not None and list(record.tokens[:len(pre)]) != pre:
                # replay determinism check: tokens committed before the
                # crash must be a prefix of the replayed completion
                self.replay_mismatches += 1
                if self.registry is not None:
                    self.registry.record_event(
                        "replay_mismatch", rid=record.rid,
                        committed=pre, got=list(record.tokens))
            self.completed[record.rid] = record

    def transfer_lease(self, rid: str, engine_id: str) -> None:
        """Move a popped request's lease to the replica now holding its
        lane (a KV handoff): a crash of the new owner replays it, the old
        owner's no longer does."""
        with self._lock:
            lease = self._leases.get(rid)
            if lease is not None:
                self._leases[rid] = (lease[0], engine_id)

    def replay_request(self, req) -> None:
        """One request lost in transit (a torn KV transfer): drop its lease
        and replay it.  Its committed tokens are recorded, so ``complete``
        checks that the recompute reproduces them as a prefix, and the
        exactly-once guard rejects a double completion."""
        with self._lock:
            self._leases.pop(req.rid, None)
            self.replayed[req.rid] = list(req.committed or [])
            tr = getattr(req, "trace", None)
            if tr is not None:
                req._prev_trace = tr
                tr.finish(torn_transfer=True)
                req.trace = None
            self._requeue_locked([req], reason="replayed")
            if self.registry is not None:
                self.registry.record_event(
                    "router_replay", service=self.service,
                    engine="kv.transfer", replayed=1)

    def requeue(self, reqs: list) -> None:
        """Return popped-but-unfinished requests (a killed replica's) to
        the head of the queue; their arrival times stick."""
        with self._lock:
            self._requeue_locked(reqs, reason="requeued")

    def _requeue_locked(self, reqs: list, reason: str) -> None:
        for req in reqs:
            self._leases.pop(req.rid, None)
        if self.closed:
            return
        for req in reqs:
            if (self.tracer is not None
                    and getattr(req, "trace", None) is None):
                req.trace = self.tracer.start_trace(
                    "request", trace_id=req.rid, service=self.service,
                    **{reason: True})
                # link the recovery trace back to the pre-crash or
                # pre-evacuation one: one timeline per request
                prev = getattr(req, "_prev_trace", None)
                if prev is not None:
                    req.trace.link(prev, relation="recovers")
                    req._prev_trace = None
            if getattr(req, "trace", None) is not None:
                req._router_span = req.trace.span(
                    "router.queue", service=self.service, **{reason: True})
        self._pending.extendleft(reversed(reqs))

    def fail_engine(self, engine_id: str) -> int:
        """Replica crash recovery: replay every request the dead engine
        still holds a lease on.  Each re-enters the queue (head) with its
        committed tokens recorded, so ``complete`` can verify the replayed
        run reproduces them as a prefix and the exactly-once guard rejects
        double completion.  Returns the number of requests replayed."""
        with self._lock:
            self._prefix_probes.pop(engine_id, None)
            self._roles.pop(engine_id, None)
            self._role_buckets.pop(engine_id, None)
            reqs = [req for req, eng in self._leases.values()
                    if eng == engine_id]
            for req in reqs:
                self.replayed[req.rid] = list(req.committed or [])
                tr = getattr(req, "trace", None)
                if tr is not None:
                    req._prev_trace = tr
                    tr.finish(crashed=True, engine=engine_id)
                    req.trace = None
            self._requeue_locked(reqs, reason="replayed")
            if self.registry is not None and reqs:
                self.registry.record_event(
                    "router_replay", service=self.service,
                    engine=engine_id, replayed=len(reqs))
            return len(reqs)

    def pending_count(self) -> int:
        return len(self._pending)

    def outstanding(self) -> int:
        with self._lock:
            return len(self._pending) + self.in_flight

    def close(self) -> None:
        self.closed = True


# Engine replicas are instantiated by the runtime from a TaskImage, a
# plain config, so tasks find their router here by service name instead
# of carrying a handle.
_ROUTERS: Dict[str, RequestRouter] = {}
_ROUTERS_LOCK = threading.Lock()


def get_router(service: str, registry=None, tracer=None) -> RequestRouter:
    with _ROUTERS_LOCK:
        r = _ROUTERS.get(service)
        if r is None:
            r = RequestRouter(service, registry=registry, tracer=tracer)
            _ROUTERS[service] = r
        if registry is not None and r.registry is None:
            r.registry = registry
        if tracer is not None and r.tracer is None:
            r.tracer = tracer
        return r


def reset_router(service: str) -> RequestRouter:
    """Fresh router for a new run (tests, chip_smoke)."""
    with _ROUTERS_LOCK:
        r = RequestRouter(service)
        _ROUTERS[service] = r
        return r


def drive_engine_open_loop(orch, scaler, requests: List[Request], *,
                           duration_s: float, slo_s: float,
                           service: str = "svc", prompt_len: int = 16,
                           slots_per_replica: int = 4,
                           latency_window_s: float = 3.0,
                           tokens_range: tuple = (4, 9),
                           tick_s: float = 0.05, drain_timeout_s: float = 60.0,
                           on_tick: Optional[Callable] = None) -> DriveResult:
    """Replay an open-loop trace through the per-request serving path.

    Arrivals become ``ServeRequest``s on the service's router; the engine
    replicas terminate them on-device and report TTFT/TBT/e2e into
    ``orch.metrics``.  This loop only feeds the router and publishes the
    service-level queue/utilization gauges the autoscaler reads.
    """
    from repro_torch.serve.engine import ServeRequest

    reg = orch.metrics
    # pin the shared window config before engines observe into it
    reg.histogram(M_LATENCY, window_s=latency_window_s, service=service)
    router = get_router(service, registry=reg)
    rng = np.random.Generator(np.random.Philox(1234))
    pending = deque(sorted(requests, key=lambda r: r.arrival_t))
    t0 = time.time()
    max_replicas = 1
    last_report = 0.0
    deadline = None
    prompts: Dict[str, np.ndarray] = {}
    while True:
        now = time.time() - t0
        while pending and pending[0].arrival_t <= now:
            r = pending.popleft()
            n_tok = (r.n_tokens if getattr(r, "n_tokens", None)
                     else int(rng.integers(*tokens_range)))
            prompts[r.rid] = rng.integers(0, 512, prompt_len)
            router.submit(ServeRequest(
                rid=r.rid, prompt=prompts[r.rid],
                max_new_tokens=n_tok, arrival_t=reg.clock(), slo_s=slo_s))
        if not pending and router.outstanding() == 0 and now > duration_s:
            break
        if not pending and deadline is None and now > duration_s:
            deadline = time.time() + drain_timeout_s
        if deadline is not None and time.time() > deadline:
            break                        # replicas wedged; report what we have
        n_rep = scaler.current_replicas()
        max_replicas = max(max_replicas, n_rep)
        reg.gauge(M_QUEUE_DEPTH, service=service).set(router.pending_count())
        cap = max(1, n_rep * slots_per_replica)
        reg.gauge(M_UTILIZATION, service=service).set(
            min(1.0, router.in_flight / cap))
        # cache-memory occupancy: fold per-engine KV pool gauges into the
        # service-level pressure signal (worst replica wins — that is the
        # one about to OOM-preempt), so the autoscaler sees memory
        # pressure alongside queue depth and tail latency
        svc_key = metric_key(M_KV_PAGES, {"service": service})
        kv = [v for k, v in
              reg.gauge_values(M_KV_PAGES, service=service).items()
              if k != svc_key]
        if kv:
            reg.gauge(M_KV_PAGES, service=service).set(max(kv))
        # speculation acceptance: service-level mean of the per-engine
        # gauges (an efficiency signal, so the mean — not the worst — is
        # what capacity planning and the simulator's service model want);
        # killed replicas tombstone their gauge with NaN — skip those
        spec_key = metric_key(M_SPEC_ACCEPT_RATE, {"service": service})
        sv = [v for k2, v in
              reg.gauge_values(M_SPEC_ACCEPT_RATE, service=service).items()
              if k2 != spec_key and not np.isnan(v)]
        if sv:
            reg.gauge(M_SPEC_ACCEPT_RATE, service=service).set(
                sum(sv) / len(sv))
        # prefix-cache hit rate: same NaN-skipping service mean — an
        # efficiency signal the simulator's TTFT model consumes
        px_key = metric_key(M_PREFIX_HIT_RATE, {"service": service})
        pv = [v for k2, v in
              reg.gauge_values(M_PREFIX_HIT_RATE, service=service).items()
              if k2 != px_key and not np.isnan(v)]
        if pv:
            reg.gauge(M_PREFIX_HIT_RATE, service=service).set(
                sum(pv) / len(pv))
        if on_tick is not None and now - last_report >= 1.0:
            last_report = now
            on_tick(now, n_rep, router.pending_count(),
                    reg.histogram(M_LATENCY, service=service).quantile(0.95))
        time.sleep(tick_s)
    router.close()
    completed = list(router.completed.values())
    violations = sum(1 for c in completed if c.e2e_s > slo_s)
    return DriveResult(served=len(completed), violations=violations,
                       max_replicas=max_replicas, prompts=prompts)


def wait_for_service(cluster, orch, cid: str, timeout_s: float = 120.0,
                     ) -> str:
    """Block until the service task is deployed AND its guest finished
    setup (first step taken); returns the node it landed on."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        node = orch._sched_tasks[cid].node_id
        if node is not None and orch.deployments[cid].status == "running":
            rec = cluster.nodes[node].runtime.tasks.get(cid)
            if rec is not None and rec.guest_state.step > 0:
                return node
        time.sleep(0.1)
    raise TimeoutError(f"service {cid} failed to start in {timeout_s}s")


def drive_open_loop(orch, scaler, requests: List[Request], *,
                    duration_s: float, service_rate: float, slo_s: float,
                    service: str = "svc", latency_window_s: float = 3.0,
                    tick_s: float = 0.05,
                    on_tick: Optional[Callable] = None) -> DriveResult:
    """Replay an open-loop trace against the live cluster in wall time.

    ``on_tick(now, replicas, queue_len, p95)`` fires about once a second
    for progress reporting.
    """
    reg = orch.metrics
    lat_hist = reg.histogram(M_LATENCY, window_s=latency_window_s,
                             service=service)
    pending = deque(sorted(requests, key=lambda r: r.arrival_t))
    queue: deque = deque()
    t0 = time.time()
    served = violations = 0
    max_replicas = 1
    last_report = 0.0
    while True:
        now = time.time() - t0
        # drain arrivals before testing the exit so requests landing in
        # the final tick window are still admitted and counted; arrivals
        # enter requests_total here (completions at serve time), matching
        # the simulator's arrival/departure split
        while pending and pending[0].arrival_t <= now:
            queue.append(pending.popleft())
            reg.counter(M_REQUESTS, service=service).inc()
        if now > duration_s and not pending and not queue:
            break
        n_rep = scaler.current_replicas()
        max_replicas = max(max_replicas, n_rep)
        capacity = max(1, int(n_rep * service_rate * tick_s))
        used = 0
        while queue and used < capacity:
            r = queue.popleft()
            used += 1
            served += 1
            latency = max(0.0, now - r.arrival_t)
            lat_hist.observe(latency)
            reg.counter(M_COMPLETIONS, service=service).inc()
            if latency > slo_s:
                violations += 1
                reg.counter(M_SLO_VIOLATIONS, service=service).inc()
        reg.gauge(M_QUEUE_DEPTH, service=service).set(len(queue))
        reg.gauge(M_UTILIZATION, service=service).set(
            min(1.0, used / max(capacity, 1)))
        if on_tick is not None and now - last_report >= 1.0:
            last_report = now
            on_tick(now, n_rep, len(queue), lat_hist.quantile(0.95))
        time.sleep(tick_s)
    return DriveResult(served=served, violations=violations,
                       max_replicas=max_replicas)


def teardown_service(orch, scaler):
    """Quiesce the reconcile/scheduler threads, converge to one replica
    (real kill+delete scale-in), then remove whatever is still running."""
    orch.stop()
    scaler.scale_to(1)
    for cid, dep in list(orch.deployments.items()):
        if dep.status == "running":
            try:
                orch.scale_in(cid)
            except Exception:  # noqa: BLE001 - node may be gone
                pass
