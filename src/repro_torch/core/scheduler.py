"""Funky preemptive task scheduler (paper Algorithm 1 + Table 5 policies);
a copy of the reference package's ``core/scheduler.py``.

Policies:
    FCFS    deploy in arrival order, never reorder, never preempt
    NO_PRE  priority-sorted wait queue, no eviction
    PRE_EV  + evict lower-priority running tasks; evicted tasks resume on
            the node that holds their context
    PRE_MG  + migrate evicted tasks to other nodes when their home is busy

The scheduler is a pure policy engine over an abstract ``ClusterView`` and
emits ``Action``s — the *same* engine drives the live runtime (Fig 10) and
the trace simulator (Figs 11/13), which is how the paper's two evaluations
stay consistent.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Any, Iterable, List, Optional, Protocol


class Policy(str, enum.Enum):
    FCFS = "FCFS"
    NO_PRE = "NO_PRE"
    PRE_EV = "PRE_EV"
    PRE_MG = "PRE_MG"


class TaskState(str, enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    EVICTED = "evicted"
    DONE = "done"


@dataclass
class SchedTask:
    tid: str
    priority: int = 0
    submit_time: float = 0.0
    state: TaskState = TaskState.WAITING
    node_id: Optional[str] = None       # where it runs / where context lives
    preemptible: bool = True
    # service-group id: replicas of one service share it, so placement can
    # spread them across failure domains and victim selection never takes a
    # group's last running replica while an alternative exists
    group: Optional[str] = None
    meta: dict = field(default_factory=dict)


@dataclass
class Action:
    kind: str                           # deploy | evict | resume | migrate
    tid: str
    node: Optional[str] = None
    src_node: Optional[str] = None


class ClusterView(Protocol):
    def nodes(self) -> List[str]: ...
    def free_slices(self, node: str) -> int: ...
    def running_tasks(self, node: str) -> List[SchedTask]: ...


class FunkyScheduler:
    def __init__(self, policy: Policy = Policy.PRE_MG, placement=None):
        self.policy = Policy(policy)
        if placement is None:
            # lazy import: placement builds on SchedTask/TaskState above
            from repro_torch.core.placement import PlacementPolicy
            placement = PlacementPolicy()
        self.placement = placement
        self.wait_queue: List[SchedTask] = []
        self.run_queue: List[SchedTask] = []
        self._seq = itertools.count()

    # ------------------------------------------------------------------
    def submit(self, task: SchedTask):
        task.meta.setdefault("seq", next(self._seq))
        task.state = TaskState.WAITING if task.state is not TaskState.EVICTED \
            else TaskState.EVICTED
        self.wait_queue.append(task)

    def task_done(self, tid: str):
        self.run_queue = [t for t in self.run_queue if t.tid != tid]

    # ------------------------------------------------------------------
    def _sorted_wait(self) -> List[SchedTask]:
        if self.policy is Policy.FCFS:
            return sorted(self.wait_queue,
                          key=lambda t: (t.submit_time, t.meta["seq"]))
        return sorted(self.wait_queue,
                      key=lambda t: (-t.priority, t.submit_time, t.meta["seq"]))

    def _select_node(self, task: SchedTask, view: ClusterView,
                     reserved: dict) -> Optional[str]:
        """Most suitable node with a free slice (Alg 1 L4) — delegated to
        the unified ``PlacementPolicy`` (warm-cache affinity, failure-domain
        anti-affinity, per-node telemetry)."""
        return self.placement.select_node(
            task, view, reserved, running=self.run_queue,
            allow_migrate=self.policy is Policy.PRE_MG)

    def _find_victim(self, task: SchedTask, view: ClusterView,
                     evicting: set) -> Optional[SchedTask]:
        """Preemption victim — delegated to the group-aware policy."""
        return self.placement.find_victim(task, self.run_queue, evicting)

    # ------------------------------------------------------------------
    def schedule_once(self, view: ClusterView) -> List[Action]:
        """One pass of Algorithm 1 over the wait queue."""
        actions: List[Action] = []
        reserved: dict = {}
        evicting: set = set()
        preempt = self.policy in (Policy.PRE_EV, Policy.PRE_MG)

        for task in self._sorted_wait():
            node = self._select_node(task, view, reserved)
            if node is None and preempt:
                victim = self._find_victim(task, view, evicting)
                if victim is not None:
                    # L5-8: evict the low-priority task, keep its context
                    actions.append(Action("evict", victim.tid,
                                          node=victim.node_id))
                    evicting.add(victim.tid)
                    victim_node = victim.node_id
                    victim.state = TaskState.EVICTED
                    self.run_queue.remove(victim)
                    self.wait_queue.append(victim)
                    # incoming may be resumable only on its own node (PRE_EV)
                    if (task.state is TaskState.EVICTED
                            and task.node_id is not None
                            and self.policy is not Policy.PRE_MG
                            and task.node_id != victim_node):
                        continue
                    node = victim_node
            if node is None:
                if self.policy is Policy.FCFS:
                    break              # strict FCFS: head-of-line blocking
                continue

            if task.state is TaskState.EVICTED:
                if task.node_id == node:
                    actions.append(Action("resume", task.tid, node=node))
                else:
                    actions.append(Action("migrate", task.tid, node=node,
                                          src_node=task.node_id))
            else:
                actions.append(Action("deploy", task.tid, node=node))
            reserved[node] = reserved.get(node, 0) + 1
            task.state = TaskState.RUNNING
            task.node_id = node
            task.meta.pop("migrate_from", None)   # migration flag consumed
            self.wait_queue.remove(task)
            self.run_queue.append(task)
        return actions
