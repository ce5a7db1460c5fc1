"""Unified placement layer: one scoring engine for every placement decision
(a copy of the reference package's ``core/placement.py``).

Before this module, placement logic lived in four call sites — the
scheduler's ``_select_node``/``_find_victim``, the autoscaler's scale-out
path (``Orchestrator._pick_free_node``), the straggler probe's migration
choice, and the trace simulator's ``_schedule`` — so scale-out ignored warm
program caches and failure domains, and migration ran off a private probe
nobody else could observe.  Now all four delegate to a single
``PlacementPolicy`` over an *enriched* cluster view:

* **free vSlices** (capacity-first, like the old max-free rule);
* **failure domains** — ``view.failure_domain(node)``; replicas of one
  ``ServiceGroup`` are spread across domains (anti-affinity is
  lexicographically dominant: a node whose domain already hosts a group
  member is only chosen when no conflict-free node has a free slice);
* **warm program caches** — ``view.warm_programs(node)`` (the node-level
  ``ProgramCache.program_ids()``); a node already holding the service's
  compiled programs skips bitstream reconfiguration, so at equal capacity
  the warm node wins;
* **per-node utilization / progress-rate gauges** read from the shared
  ``scaling.metrics`` registry (the same schema on both planes).

``MigrationController`` replaces ``check_stragglers``'s private probe: node
agents publish per-task progress into the registry
(``task_progress_steps`` series, ``node_utilization`` /
``node_progress_rate`` gauges) and the controller decides evict+migrate
purely from those metrics — live plane and simulator see the same signal
shapes under their respective clocks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.scheduler import SchedTask, TaskState
from repro_torch.scaling.metrics import metric_key

# Canonical per-node / per-task metric names (shared with the simulator).
M_NODE_UTILIZATION = "node_utilization"           # used / total slices, 0..1
M_NODE_PROGRESS_RATE = "node_progress_rate"       # mean guest steps/s
M_TASK_PROGRESS = "task_progress_steps"           # TimeSeries of step counts
M_NODE_KV_FREE = "node_kv_free_pages"             # free KV pool pages


def _median(values: List[float]) -> float:
    """Proper median: mean of the two middle elements for even counts (the
    old straggler probe took the upper element, biasing the threshold)."""
    vals = sorted(values)
    n = len(vals)
    if n == 0:
        return math.nan
    mid = n // 2
    if n % 2:
        return vals[mid]
    return (vals[mid - 1] + vals[mid]) / 2.0


# ---------------------------------------------------------------------------
# Service groups
# ---------------------------------------------------------------------------
@dataclass
class ServiceGroup:
    """Replicas of one service, as the scheduler sees them.

    Tasks carry their group id in ``SchedTask.group`` (the orchestrator
    assigns the base task's cid to every replica it clones; traces may tag
    jobs explicitly).  The group is what anti-affinity spreads across
    failure domains and what group-aware victim selection protects."""

    gid: str
    members: List[SchedTask] = field(default_factory=list)

    def domains(self, domain_fn) -> Dict[str, int]:
        """Failure-domain occupancy of the group's placed members."""
        out: Dict[str, int] = {}
        for t in self.members:
            if t.node_id is not None:
                d = domain_fn(t.node_id)
                out[d] = out.get(d, 0) + 1
        return out

    @staticmethod
    def gather(tasks: Iterable[SchedTask]) -> Dict[str, "ServiceGroup"]:
        groups: Dict[str, ServiceGroup] = {}
        for t in tasks:
            if t.group is None:
                continue
            groups.setdefault(t.group, ServiceGroup(t.group)) \
                  .members.append(t)
        return groups


# ---------------------------------------------------------------------------
# Placement policy
# ---------------------------------------------------------------------------
@dataclass
class PlacementWeights:
    """Soft scoring knobs.  Defaults keep capacity first (one free slice
    outweighs any warmth/utilization signal), warmth as the tie-breaker.
    Group anti-affinity is *not* a weight — it orders lexicographically
    above the score, so replicas spread whenever capacity allows."""

    free_slices: float = 1.0        # per free slice
    warm_cache: float = 0.5         # x (wanted ∩ cached)/wanted
    utilization: float = 0.25       # x node_utilization gauge (penalty)
    progress_rate: float = 0.25     # x normalized node_progress_rate (bonus)
    # role-aware scoring (disaggregated serving): prefill replicas want
    # free compute (extra weight on free slices), decode replicas want
    # free KV pages (normalized node_kv_free_pages gauge)
    role_compute: float = 0.5       # x free slices, prefill tasks only
    role_memory: float = 0.5        # x normalized kv-free, decode tasks only


class PlacementPolicy:
    """Scores candidate nodes from an enriched ``ClusterView``.

    The view must provide the scheduler's ``nodes``/``free_slices``; it
    *may* additionally provide ``failure_domain(node)`` and
    ``warm_programs(node)`` (every node defaults to its own domain and a
    cold cache).  A ``scaling.metrics`` registry, when attached,
    contributes per-node utilization and progress-rate signals.  With none
    of the enrichments present the policy reduces exactly to the old
    most-free-slices rule, so existing trace results are unchanged.
    """

    def __init__(self, weights: Optional[PlacementWeights] = None,
                 registry=None):
        self.weights = weights or PlacementWeights()
        self.registry = registry

    # -- view accessors (degrade gracefully on plain ClusterViews) -------
    @staticmethod
    def domain_of(view, node: str) -> str:
        fn = getattr(view, "failure_domain", None)
        return fn(node) if fn is not None else node

    @staticmethod
    def warm_programs(view, node: str) -> Tuple[str, ...]:
        fn = getattr(view, "warm_programs", None)
        if fn is None:
            return ()
        try:
            return tuple(fn(node))
        except Exception:  # noqa: BLE001 - node may have just failed
            return ()

    # -- scoring ----------------------------------------------------------
    def _progress_rates(self) -> Dict[str, float]:
        """One registry scan per placement decision (not per candidate)."""
        if self.registry is None:
            return {}
        return {k: v for k, v in
                self.registry.gauge_values(M_NODE_PROGRESS_RATE).items()
                if v > 0}

    def score(self, task: SchedTask, node: str, view, free: int,
              rates: Optional[Dict[str, float]] = None) -> float:
        w = self.weights
        s = w.free_slices * free
        wanted = task.meta.get("programs") if task.meta else None
        if wanted:
            warm = self.warm_programs(view, node)
            if warm:
                wanted_set = set(wanted)
                s += w.warm_cache * (len(wanted_set & set(warm))
                                     / len(wanted_set))
        role = task.meta.get("role") if task.meta else None
        if role == "prefill":
            # prefill replicas are compute-bound (the long fused prompt
            # EXECUTE): bias further toward nodes with spare slices
            s += w.role_compute * free
        elif role == "decode" and self.registry is not None:
            # decode replicas are memory-bound (resident KV pages): bias
            # toward nodes advertising free pool pages
            kv = self.registry.gauge_values(M_NODE_KV_FREE)
            mx = max(kv.values(), default=0.0)
            if mx > 0:
                key = metric_key(M_NODE_KV_FREE, {"node": node})
                s += w.role_memory * (kv.get(key, 0.0) / mx)
        if self.registry is not None:
            s -= w.utilization * self.registry.gauge(
                M_NODE_UTILIZATION, node=node).value
            if rates is None:
                rates = self._progress_rates()
            if rates:
                key = metric_key(M_NODE_PROGRESS_RATE, {"node": node})
                s += w.progress_rate * (rates.get(key, 0.0)
                                        / max(rates.values()))
        return s

    def _group_conflicts(self, task: SchedTask, view,
                         running: Iterable[SchedTask]) -> Dict[str, int]:
        """Failure-domain occupancy of the task's group peers."""
        if task.group is None:
            return {}
        group = ServiceGroup.gather(
            t for t in running if t.tid != task.tid).get(task.group)
        if group is None:
            return {}
        return group.domains(lambda n: self.domain_of(view, n))

    # -- the four former call sites --------------------------------------
    def select_node(self, task: SchedTask, view, reserved: Dict[str, int],
                    *, running: Iterable[SchedTask] = (),
                    allow_migrate: bool = True) -> Optional[str]:
        """Most suitable node with a free slice (Alg 1 L4, enriched).

        Evicted tasks prefer (or, when the policy cannot migrate contexts,
        are pinned to) the node holding their context — unchanged from the
        scheduler's old ``_select_node``.  Exception: a task evicted *for
        migration* (``meta["migrate_from"]`` names its old node, set by the
        straggler path) must not take that fast path — its own freed slice
        would resume it straight back onto the degraded node — so it is
        scored over the other candidates, falling back to the flagged node
        only when nothing else has room.
        """
        def free(n: str) -> int:
            return view.free_slices(n) - reserved.get(n, 0)

        avoid = task.meta.get("migrate_from") if task.meta else None
        if task.state is TaskState.EVICTED and task.node_id is not None:
            if not (allow_migrate and avoid == task.node_id):
                if free(task.node_id) > 0:
                    return task.node_id
                if not allow_migrate:
                    return None        # PRE_EV cannot migrate contexts
        free_by_node = {n: free(n) for n in view.nodes()}
        candidates = [n for n in free_by_node if free_by_node[n] > 0]
        if allow_migrate and avoid is not None:
            others = [n for n in candidates if n != avoid]
            if others:
                candidates = others
        if not candidates:
            return None
        conflicts = self._group_conflicts(task, view, running)
        rates = self._progress_rates()
        return max(candidates,
                   key=lambda n: (-conflicts.get(self.domain_of(view, n), 0),
                                  self.score(task, n, view,
                                             free_by_node[n], rates), n))

    def find_victim(self, task: SchedTask, run_queue: List[SchedTask],
                    evicting: set) -> Optional[SchedTask]:
        """Lowest-priority preemptible running task strictly below ``task``
        — group-aware: a group's *last* running replica is only victimized
        when every other candidate is also some group's last replica, so
        preemption never takes a whole service down while an alternative
        exists."""
        groups = ServiceGroup.gather(run_queue)
        best = None
        best_key = None
        for i, t in enumerate(run_queue):
            if t.tid in evicting or not t.preemptible:
                continue
            if t.priority >= task.priority:
                continue
            last_of_group = (t.group is not None
                             and len(groups[t.group].members) <= 1)
            key = (last_of_group, t.priority, i)
            if best_key is None or key < best_key:
                best, best_key = t, key
        return best


# ---------------------------------------------------------------------------
# Metrics-driven migration
# ---------------------------------------------------------------------------
@dataclass
class MigrationDecision:
    cid: str
    node: Optional[str]
    rate: float
    median: float
    reason: str = "straggler"


@dataclass
class MigrationConfig:
    min_relative_rate: float = 0.5      # straggler if rate < x * median
    min_window_s: float = 1.0           # rate window
    min_peers: int = 3                  # need >= this many measurable rates


class MigrationController:
    """Evict+migrate decisions from the shared metrics registry.

    Producers (node agents on the live plane, the simulator under its
    virtual clock) publish each task's guest step counter through
    ``observe``; the controller derives progress *rates* from the
    registry's ``task_progress_steps`` series, folds them into per-node
    ``node_progress_rate`` gauges, and flags tasks progressing below
    ``min_relative_rate`` x the peer median.  The caller (orchestrator)
    executes the evictions; the scheduler's placement then migrates the
    contexts — the same engine as every other placement decision.
    """

    def __init__(self, registry, config: Optional[MigrationConfig] = None):
        self.registry = registry
        self.config = config or MigrationConfig()
        # points recorded before a task's last migration measure the old
        # node; ignore them so a freshly migrated task is not re-flagged
        self._reset_t: Dict[str, float] = {}
        # nodes whose progress-rate gauge we own: zeroed once they go idle
        # so a drained node never keeps a stale placement bonus
        self._known_nodes: set = set()

    # -- producer side ----------------------------------------------------
    def observe(self, cid: str, step: Optional[int]):
        """Publish one progress sample; node attribution happens at
        ``decide`` time from the caller's running map."""
        if step is None:
            return
        self.registry.series(M_TASK_PROGRESS, cid=cid).record(float(step))

    def reset(self, cid: str):
        """Ignore a task's prior history (it was just migrated/evicted)."""
        self._reset_t[cid] = self.registry.clock()

    def forget(self, cid: str):
        """Drop a finished task's series from the registry — progress
        history must not grow unboundedly with every task ever probed."""
        self.registry.drop_series(M_TASK_PROGRESS, cid=cid)
        self._reset_t.pop(cid, None)

    # -- decision side -----------------------------------------------------
    def _rate(self, cid: str, min_window_s: float) -> Optional[float]:
        pts = self.registry.series(M_TASK_PROGRESS, cid=cid).points()
        cutoff = self._reset_t.get(cid)
        if cutoff is not None:
            pts = [(t, v) for t, v in pts if t >= cutoff]
        if len(pts) < 2:
            return None
        t1, s1 = pts[-1]
        # a task that has never taken a guest step is still booting
        # (deploy/compile), not straggling — it has no measurable rate,
        # and a zero-rate sample here would mis-flag it for eviction
        if s1 <= 0:
            return None
        for t0, s0 in reversed(pts[:-1]):
            if t1 - t0 >= min_window_s:
                return (s1 - s0) / (t1 - t0)
        return None

    def decide(self, running: Dict[str, Optional[str]], *,
               min_relative_rate: Optional[float] = None,
               min_window_s: Optional[float] = None,
               ) -> List[MigrationDecision]:
        """``running`` maps cid -> node for tasks eligible to migrate."""
        cfg = self.config
        rel = (cfg.min_relative_rate if min_relative_rate is None
               else min_relative_rate)
        win = cfg.min_window_s if min_window_s is None else min_window_s
        rates: Dict[str, float] = {}
        for cid in running:
            r = self._rate(cid, win)
            if r is not None:
                rates[cid] = r
        # fold per-task rates into the per-node latency gauge the placement
        # scorer (and operators) read; nodes with no measurable tasks are
        # zeroed so an idle node never coasts on a stale bonus
        by_node: Dict[str, List[float]] = {}
        for cid, r in rates.items():
            node = running.get(cid)
            if node is not None:
                by_node.setdefault(node, []).append(r)
        nodes_now = {n for n in running.values() if n is not None}
        for node in nodes_now | self._known_nodes:
            rs = by_node.get(node)
            self.registry.gauge(M_NODE_PROGRESS_RATE, node=node).set(
                sum(rs) / len(rs) if rs else 0.0)
        self._known_nodes |= nodes_now
        if len(rates) < cfg.min_peers:
            return []
        med = _median(list(rates.values()))
        if not med or med <= 0 or math.isnan(med):
            return []
        out = []
        for cid, r in rates.items():
            if r < rel * med:
                out.append(MigrationDecision(cid=cid, node=running.get(cid),
                                             rate=r, median=med))
        return out
