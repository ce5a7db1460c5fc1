"""Deterministic, seeded fault injection for the live plane.

A ``FaultPlan`` is a list of ``FaultSpec`` injection points evaluated at
named *sites* threaded through the stack behind no-op hooks:

    agent.deploy / agent.evict / agent.resume / agent.migrate_in /
    agent.checkpoint / agent.restore / agent.replicate_in / agent.update /
    agent.drain / agent.remove
                            node-agent ops (kind: crash | error | delay)
    monitor.execute         per-EXECUTE dispatch (kind: error | delay |
                            crash)
    ckpt.save               per-buffer write during save_snapshot
                            (kind: torn | error — torn raises mid-write,
                            before the manifest publishes)
    ckpt.corrupt            after a successful publish (kind: corrupt —
                            flips a byte in one on-disk buffer file)
    ckpt.restore            before a restore reads (kind: error)
    router.pop              request intake (kind: delay)
    kv.transfer             KV handoff install on the decode replica
                            (kind: torn | error | delay — a torn transfer
                            loses the lane in transit; the request
                            replays through its router lease)

Every decision is a pure function of (seed, spec list, per-site event
counts), so two runs with the same plan over the same events fire
identically.  Components built without a plan (``chaos=None``) skip the
hook entirely.

Exception taxonomy:

* ``TransientFault`` — retryable; the monitor's EXECUTE retry loop catches
  exactly this.
* ``InjectedFault`` — a transient injected by a plan (subclass).
* ``InjectedCrash`` — simulated process death mid-operation; never retried.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class TransientFault(RuntimeError):
    """An error worth retrying (injected or environmental)."""


class InjectedFault(TransientFault):
    """Transient failure raised by a FaultPlan."""


class InjectedCrash(RuntimeError):
    """Simulated hard crash (process death) raised by a FaultPlan."""


@dataclass
class FaultSpec:
    """One injection point.

    Triggering (first match wins, evaluated per matching event):
      ``at``    fire on the Nth matching event at ``site`` (1-based);
      ``every`` fire on every Nth matching event;
      ``prob``  fire with this probability (seeded — deterministic).
    ``match`` filters events by substring of the event key (cid, program
    id, path...); empty matches all.  ``max_fires`` bounds total fires.
    """

    site: str
    kind: str = "error"             # error | crash | delay | torn | corrupt
    at: Optional[int] = None
    every: Optional[int] = None
    prob: float = 0.0
    match: str = ""
    max_fires: int = 1
    delay_s: float = 0.0
    note: str = ""
    fires: int = field(default=0, compare=False)


class FaultPlan:
    """Seeded, thread-safe schedule of faults. ``check`` is the only hook
    primitive; ``raise_if`` and ``maybe_delay`` turn its verdict into the
    site's reaction."""

    def __init__(self, specs: Optional[List[FaultSpec]] = None, *,
                 seed: int = 0, registry=None):
        self.specs = list(specs or [])
        self.seed = seed
        self.rng = random.Random(seed)
        self.registry = registry
        self.fired: List[Tuple[str, str, str]] = []   # (site, kind, key)
        self._counts: dict = {}
        self._lock = threading.Lock()

    def add(self, spec: FaultSpec) -> "FaultPlan":
        with self._lock:
            self.specs.append(spec)
        return self

    def check(self, site: str, key: str = "") -> Optional[FaultSpec]:
        """Count one event at ``site`` and return the spec that fires on
        it, if any (at most one per event; specs are evaluated in order)."""
        with self._lock:
            hit = None
            for spec in self.specs:
                if spec.site != site or spec.match not in key:
                    continue
                ck = (site, spec.match)
                n = self._counts[ck] = self._counts.get(ck, 0) + 1
                if spec.fires >= spec.max_fires:
                    continue
                fire = ((spec.at is not None and n == spec.at)
                        or (spec.every is not None and n % spec.every == 0)
                        or (spec.prob > 0
                            and self.rng.random() < spec.prob))
                if fire and hit is None:
                    spec.fires += 1
                    hit = spec
                    self.fired.append((site, spec.kind, key))
            if hit is not None and self.registry is not None:
                self.registry.record_event("fault_injected", site=site,
                                           fault=hit.kind, key=key,
                                           note=hit.note)
            return hit

    # -- convenience wrappers -------------------------------------------
    def raise_if(self, site: str, key: str = "") -> None:
        """error -> InjectedFault, crash/torn -> InjectedCrash,
        delay -> sleep."""
        spec = self.check(site, key)
        if spec is None:
            return
        if spec.kind == "delay":
            import time
            time.sleep(spec.delay_s)
            return
        if spec.kind in ("crash", "torn"):
            raise InjectedCrash(f"injected crash at {site} ({key})")
        raise InjectedFault(f"injected fault at {site} ({key})")

    def maybe_delay(self, site: str, key: str = "") -> None:
        """delay -> sleep; any other kind is counted and ignored (a site
        whose only sensible reaction is a stall)."""
        spec = self.check(site, key)
        if spec is not None and spec.kind == "delay":
            import time
            time.sleep(spec.delay_s)
