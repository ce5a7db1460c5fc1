"""The service-scoped request frontend of the per-request serving path:
``RequestRouter`` (the reference's ``scaling/serving.py``, its intake,
KV-aware pop, completion, requeue and crash replay; prefix-warmth probes,
engine roles, lease transfer and the open-loop drive loops are not ported
yet).

Requests are published to the router; every ``EngineServeTask`` replica's
continuous-batching engine pulls admissible requests from it in ``pump``
and reports completions back, so the latencies in the registry are
engine-measured, not modeled.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

from repro_torch.scaling.autoscaler import M_KV_FREE_PAGES, M_REQUESTS


class RequestRouter:
    """Intake + bookkeeping shared by the engine replicas of one service.

    **KV-aware routing** (``kv_aware=True``, needs a registry): a pop
    tagged with an ``engine_id`` prefers the replica with the most free KV
    pages (the per-engine ``kv_free_pages`` gauge every paged engine
    publishes).  A non-preferred replica is deferred exactly once and
    served on its next pop, so preference never starves a replica.

    Every popped request holds a lease until its engine completes or
    requeues it; ``complete`` counts each request once.  ``fail_engine``
    replays a crashed replica's leases, recording each request's
    committed tokens, and ``complete`` checks that the replayed completion
    starts with them (``replay_mismatches`` counts those that do not).
    """

    def __init__(self, service: str = "svc", registry=None,
                 kv_aware: bool = True):
        self.service = service
        self.registry = registry
        self.kv_aware = kv_aware
        self.closed = False
        self._lock = threading.Lock()
        self._pending: deque = deque()
        self._deferred: set = set()     # engines already held back once
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
            self._pending.append(req)
        if self.registry is not None:
            self.registry.counter(M_REQUESTS, service=self.service).inc()

    def _kv_preferred(self, engine_id: str) -> bool:
        """True unless another engine publishes strictly more free pages
        (unknown engines and registry-less routers are always preferred)."""
        if self.registry is None:
            return True
        per_engine = {lbl["engine"]: v for lbl, v in
                      self.registry.labeled_gauge_values(
                          M_KV_FREE_PAGES, service=self.service)
                      if "engine" in lbl}
        if not per_engine or engine_id not in per_engine:
            return True
        return per_engine[engine_id] >= max(per_engine.values())

    def pop(self, n: int, engine_id: Optional[str] = None) -> list:
        if n <= 0:
            return []
        with self._lock:
            if (self.kv_aware and engine_id is not None and self._pending
                    and not self._kv_preferred(engine_id)):
                if engine_id not in self._deferred:
                    self._deferred.add(engine_id)
                    return []
            self._deferred.discard(engine_id)
            out = []
            while self._pending and len(out) < n:
                req = self._pending.popleft()
                self._leases[req.rid] = (req, engine_id)
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

    def requeue(self, reqs: list) -> None:
        """Return popped-but-unfinished requests (a killed replica's) to
        the head of the queue; their arrival times stick."""
        with self._lock:
            self._requeue_locked(reqs)

    def _requeue_locked(self, reqs: list) -> None:
        for req in reqs:
            self._leases.pop(req.rid, None)
        if not self.closed:
            self._pending.extendleft(reversed(reqs))

    def fail_engine(self, engine_id: str) -> int:
        """Replica crash recovery: replay every request the dead engine
        still holds a lease on.  Each re-enters the queue (head) with its
        committed tokens recorded, so ``complete`` can verify the replayed
        run reproduces them as a prefix and the exactly-once guard rejects
        double completion.  Returns the number of requests replayed."""
        with self._lock:
            reqs = [req for req, eng in self._leases.values()
                    if eng == engine_id]
            for req in reqs:
                self.replayed[req.rid] = list(req.committed or [])
            self._requeue_locked(reqs)
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


def get_router(service: str, registry=None) -> RequestRouter:
    with _ROUTERS_LOCK:
        r = _ROUTERS.get(service)
        if r is None:
            r = RequestRouter(service, registry=registry)
            _ROUTERS[service] = r
        if registry is not None and r.registry is None:
            r.registry = registry
        return r


def reset_router(service: str) -> RequestRouter:
    """Fresh router for a new run (tests, chip_smoke)."""
    with _ROUTERS_LOCK:
        r = RequestRouter(service)
        _ROUTERS[service] = r
        return r
