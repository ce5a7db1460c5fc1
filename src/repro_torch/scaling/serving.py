"""The service-scoped request frontend of the per-request serving path:
``RequestRouter`` (the reference's ``scaling/serving.py``, its intake,
KV-aware pop, completion and requeue; prefix-warmth probes, engine roles
and the open-loop drive loops are not ported yet).

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
    requeues it; ``complete`` counts each request once.
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
                # exactly-once guard: a request served twice counts once
                self.duplicates += 1
                return
            self.completed[record.rid] = record

    def requeue(self, reqs: list) -> None:
        """Return popped-but-unfinished requests (a killed replica's) to
        the head of the queue; their arrival times stick."""
        with self._lock:
            for req in reqs:
                self._leases.pop(req.rid, None)
            if not self.closed:
                self._pending.extendleft(reversed(reqs))

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
