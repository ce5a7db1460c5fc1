"""Prefill/decode disaggregation: the KV transfer queue (the reference's
``serve/disagg.py``).

A ``prefill`` replica admits fresh prompts (prefill is the long, bursty
EXECUTE) and, as soon as a lane's first token is committed, offers the
lane to this queue.  Admission is **TTFT-aware**: the lane moves only when
a decode replica has slot and page headroom *and* the predicted queue wait
keeps the handoff stall under the target; otherwise the offer is refused,
the prefill replica keeps decoding the lane itself (aggregated fallback)
and offers it again at its next step boundary.  Disaggregation therefore
never does worse than the aggregated engine's schedule.

The payload (``KVHandoff``) is the lane's pages gathered into a staging
buffer by one EXECUTE and read back to the host (exactly the pages the
lane maps), its committed tokens and its position; the importer maps fresh
pages of its own pool, uploads and scatters the staged pages, and installs
the lane's token and position.  The exporter donates the lane's committed
pages to its prefix tree first (the rule of retirement), so siblings and
an OOM recompute there still hit.

Greedy decode is deterministic, and the paged decode reads a lane's
logical cache through its block table whatever physical pages hold it, so
a handoff never changes a token against the aggregated engine.

Fault site ``kv.transfer`` fires between dequeue and install: a torn
transfer loses the lane (the prefill side already released it), so the
request replays through its router lease — nothing lost, nothing
duplicated, the same tokens by deterministic recompute.
"""

from __future__ import annotations

import time
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from repro_torch.chaos.faults import InjectedCrash, TransientFault

M_HANDOFF = "handoff_total"
M_HANDOFF_FALLBACK = "handoff_fallback_total"
M_TRANSFER_BYTES = "kv_transfer_bytes_total"


@dataclass
class KVHandoff:
    """A serialized in-flight lane, in transit between replicas.  ``pages``
    holds CPU tensors only: nothing in transit keeps device memory of
    either replica alive."""
    req: Any                    # the live ServeRequest (lease continuity)
    rid: str
    tokens: List[int]           # committed tokens (aliased by req.committed)
    tbts: List[float]
    pos: int                    # absolute next-write position
    bucket: int                 # prompt bucket the lane prefilled at
    limit: int                  # effective generation cap
    n_pages: int
    pages: Any                  # CPU tree: (exporter max_blocks, *page)
    admit_t: float
    first_token_t: float
    last_token_t: float
    src_engine: str
    export_t: float


class TransferQueue:
    """Moves freshly prefilled lanes from prefill to decode replicas.

    Engines join via ``engine.attach_transfer(queue)``; the prefill side
    calls ``pump_source`` at its step boundary, the decode side
    ``pump_dest`` before stepping.  ``ttft_target_s`` bounds the predicted
    transfer wait (an EWMA of observed install costs × queue depth); offers
    that would exceed it are refused and counted as fallbacks.
    """

    def __init__(self, router=None, registry=None, *, service: str = "svc",
                 ttft_target_s: Optional[float] = None, chaos=None):
        self.router = router
        self.registry = registry
        self.service = service
        self.ttft_target_s = ttft_target_s
        self.chaos = chaos
        self._clock = (registry.clock if registry is not None
                       else time.perf_counter)
        self._q: deque = deque()
        # weak references: an engine holds its queue (``engine.transfer``),
        # so strong ones both ways would be a cycle keeping a dropped
        # replica's monitor and device buffers alive until the collector
        self._decode_refs: List[weakref.ref] = []
        self._source_refs: List[weakref.ref] = []
        # EWMA of the observed per-handoff install cost, seeding the
        # queue-wait prediction; None until the first install lands
        self._ewma_install_s: Optional[float] = None
        self.torn = 0
        if registry is not None:
            self._c_handoff = registry.counter(M_HANDOFF, service=service)
            self._c_fallback = registry.counter(M_HANDOFF_FALLBACK,
                                                service=service)
            self._c_bytes = registry.counter(M_TRANSFER_BYTES,
                                             service=service)
        else:
            self._c_handoff = self._c_fallback = self._c_bytes = None

    # -- membership ------------------------------------------------------
    def register(self, engine) -> None:
        side = (self._decode_refs if engine.role == "decode"
                else self._source_refs)
        if not any(r() is engine for r in side):
            side.append(weakref.ref(engine))

    @property
    def decode_engines(self) -> List[Any]:
        return [e for e in (r() for r in self._decode_refs) if e is not None]

    @property
    def source_engines(self) -> List[Any]:
        return [e for e in (r() for r in self._source_refs) if e is not None]

    # -- TTFT-aware admission --------------------------------------------
    def predicted_wait_s(self) -> float:
        """Predicted wait of a lane enqueued now: queue depth (plus the
        newcomer) times the EWMA install cost."""
        if self._ewma_install_s is None:
            return 0.0
        return (len(self._q) + 1) * self._ewma_install_s

    def would_admit(self, n_pages: int) -> bool:
        """True when some decode replica has room for an ``n_pages`` lane
        (a free slot *and* free pages beyond what the queued transfers will
        take) and the predicted queue wait stays under the TTFT target,
        when one is set.  A slot- or page-saturated decode side refuses on
        the spot: the lane decodes where it is instead of stalling in the
        queue behind lanes that retire at decode speed."""
        pending_pages = sum(h.n_pages for h in self._q)
        depth = len(self._q)
        if not any(len(e._free) > depth
                   and e.pool.can_admit(n_pages + pending_pages)
                   for e in self.decode_engines):
            return False
        if (self.ttft_target_s is not None
                and self.predicted_wait_s() > self.ttft_target_s):
            return False
        return True

    # -- prefill side ----------------------------------------------------
    def pump_source(self, engine) -> int:
        """Offer every exportable lane of a prefill replica; a refused
        offer falls back to aggregated decode on the spot."""
        moved = 0
        for st in engine.exportable_lanes():
            if not self.would_admit(len(st.blocks)):
                if self._c_fallback is not None:
                    self._c_fallback.inc()
                continue
            handoff = engine.export_lane(st)
            self._q.append(handoff)
            if self._c_handoff is not None:
                self._c_handoff.inc()
            if self._c_bytes is not None:
                self._c_bytes.inc(handoff.n_pages * engine.page_bytes)
            moved += 1
        return moved

    # -- decode side -----------------------------------------------------
    def pump_dest(self, engine) -> int:
        """Install queued handoffs into a decode replica's free slots.  A
        torn transfer (``kv.transfer`` fault) loses the lane in transit:
        the request replays through its router lease and recomputes."""
        installed = 0
        while self._q and engine._free:
            handoff = self._q[0]
            if not engine.pool.can_admit(handoff.n_pages):
                break
            self._q.popleft()
            t0 = self._clock()
            try:
                if self.chaos is not None:
                    self.chaos.raise_if("kv.transfer", key=handoff.rid)
                ok = engine.import_lane(handoff)
            except (TransientFault, InjectedCrash):
                self.torn += 1
                if self.registry is not None:
                    self.registry.record_event(
                        "kv_transfer_torn", rid=handoff.rid,
                        src=handoff.src_engine, dst=engine.engine_id)
                if self.router is not None:
                    self.router.replay_request(handoff.req)
                continue
            if not ok:
                self._q.appendleft(handoff)   # lost the slot/page race
                break
            dt = self._clock() - t0
            self._ewma_install_s = (
                dt if self._ewma_install_s is None
                else 0.9 * self._ewma_install_s + 0.1 * dt)
            if self.router is not None:
                self.router.transfer_lease(handoff.rid, engine.engine_id)
            installed += 1
        return installed

    # -- introspection ---------------------------------------------------
    def __len__(self) -> int:
        return len(self._q)

    def stats(self) -> Dict[str, Any]:
        return {"queued": len(self._q),
                "torn": self.torn,
                "ewma_install_s": self._ewma_install_s,
                "decode_engines": [e.engine_id
                                   for e in self.decode_engines],
                "source_engines": [e.engine_id
                                   for e in self.source_engines]}
