"""Node agent: forwards orchestrator requests to the container engine via
CRI, attaching Funky metadata as annotations (paper §3.5, Table 3).  Each
operation and the node's slice occupancy are published into the shared
telemetry registry (``node_ops_total`` by node and op, ``node_free_slices``
by node).  The introspection calls (free and total slices, task status,
progress and programs, the node's warm program cache) are what the
orchestrator's scheduler and placement layer read."""

from __future__ import annotations

import time
from typing import Optional

from repro_torch.chaos import InjectedFault
from repro_torch.core.cri import (A_PREEMPTIBLE, A_PRIORITY, A_REPLICA_OF,
                                  A_SNAPSHOT, A_SOURCE_NODE, A_VFPGA_NUM,
                                  ContainerConfig, ContainerEngine)
from repro_torch.core.runtime import TaskStatus
from repro_torch.scaling.metrics import MetricsRegistry


class NodeFailed(RuntimeError):
    pass


class NodeAgent:
    def __init__(self, node_id: str, engine: ContainerEngine,
                 metrics: Optional[MetricsRegistry] = None,
                 failure_domain: Optional[str] = None,
                 chaos=None):
        self.node_id = node_id
        self.engine = engine
        self.chaos = chaos
        self.failed = False
        self._hb = time.time()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # failure/tenant domain label for replica anti-affinity (rack, PDU,
        # host...); defaults to the node itself — every node its own domain
        self.failure_domain = failure_domain or node_id

    def _count_op(self, op: str):
        self.metrics.counter("node_ops_total", node=self.node_id,
                             op=op).inc()
        self.metrics.gauge("node_free_slices", node=self.node_id).set(
            self.engine.runtime.allocator.free_count())

    # -- health ---------------------------------------------------------------
    def heartbeat(self) -> float:
        if self.failed:
            raise NodeFailed(self.node_id)
        self._hb = time.time()
        return self._hb

    def fail(self):
        """Simulate a node crash: the agent stops responding."""
        self.failed = True

    def _check(self):
        if self.failed:
            raise NodeFailed(self.node_id)

    def _chaos(self, op: str, cid: str = ""):
        """Fault-plan hook for site ``agent.<op>``: kind ``crash`` marks
        the whole node failed (and surfaces as ``NodeFailed``), ``error``
        raises a retryable ``InjectedFault``, ``delay`` sleeps."""
        if self.chaos is None:
            return
        spec = self.chaos.check(f"agent.{op}", key=f"{self.node_id}:{cid}")
        if spec is None:
            return
        if spec.kind == "delay":
            time.sleep(spec.delay_s)
            return
        if spec.kind == "crash":
            self.fail()
            raise NodeFailed(self.node_id)
        raise InjectedFault(
            f"injected fault at agent.{op} ({self.node_id}:{cid})")

    # -- orchestration ops -> CRI (Table 3) -----------------------------------
    def deploy(self, cid: str, image_ref: str, priority: int = 0,
               preemptible: bool = True):
        self._check()
        self._chaos("deploy", cid)
        self.engine.CreateContainer(ContainerConfig(
            cid=cid, image_ref=image_ref, annotations={
                A_PREEMPTIBLE: "true" if preemptible else "false",
                A_PRIORITY: str(priority),
            }))
        self.engine.StartContainer(cid)
        self._count_op("deploy")

    def evict(self, cid: str):
        self._check()
        self._chaos("evict", cid)
        self.engine.StopContainer(cid)
        self._count_op("evict")

    def resume(self, cid: str):
        self._check()
        self._chaos("resume", cid)
        self.engine.StartContainer(cid)
        self._count_op("resume")

    def migrate_in(self, cid: str, image_ref: str, source_node: str):
        self._check()
        self._chaos("migrate_in", cid)
        self.engine.CreateContainer(ContainerConfig(
            cid=cid, image_ref=image_ref,
            annotations={A_SOURCE_NODE: source_node}))
        self.engine.StartContainer(cid)
        self._count_op("migrate_in")

    def checkpoint(self, cid: str) -> str:
        self._check()
        self._chaos("checkpoint", cid)
        path = self.engine.CheckpointContainer(cid)
        self._count_op("checkpoint")
        return path

    def restore(self, cid: str, snapshot_path: str, image_ref: str = ""):
        self._check()
        self._chaos("restore", cid)
        self.engine.CreateContainer(ContainerConfig(
            cid=cid, image_ref=image_ref,
            annotations={A_SNAPSHOT: snapshot_path}))
        self.engine.StartContainer(cid)
        self._count_op("restore")

    def replicate_in(self, new_cid: str, source_cid: str, source_node: str,
                     image_ref: str = ""):
        self._check()
        self._chaos("replicate_in", new_cid)
        self.engine.CreateContainer(ContainerConfig(
            cid=new_cid, image_ref=image_ref, annotations={
                A_REPLICA_OF: source_cid, A_SOURCE_NODE: source_node}))
        self.engine.StartContainer(new_cid)
        self._count_op("replicate_in")

    def update(self, cid: str, vfpga_num: int):
        self._check()
        self._chaos("update", cid)
        self.engine.UpdateContainerResources(
            cid, {A_VFPGA_NUM: str(vfpga_num)})
        self._count_op("update")

    def drain(self, cid: str, timeout_s: float = 30.0) -> dict:
        """Scale-in prelude: stop the replica's admissions and let its
        in-flight lanes finish (request-boundary decommission) before the
        kill.  Falls through after ``timeout_s`` — the subsequent remove
        then requeues whatever is still unfinished."""
        self._check()
        self._chaos("drain", cid)
        stats = self.engine.DrainContainer(cid, timeout_s=timeout_s)
        self._count_op("drain")
        return stats

    def remove(self, cid: str):
        """Scale-in: kill the replica and delete its record."""
        self._check()
        self._chaos("remove", cid)
        self.engine.RemoveContainer(cid)
        self._count_op("remove")

    # -- introspection --------------------------------------------------------
    def free_slices(self) -> int:
        self._check()
        return self.engine.runtime.allocator.free_count()

    def num_slices(self) -> int:
        return len(self.engine.runtime.allocator.slices)

    def task_status(self, cid: str) -> Optional[TaskStatus]:
        self._check()
        rec = self.engine.runtime.tasks.get(cid)
        return rec.status if rec else None

    def latest_snapshot(self, cid: str) -> Optional[str]:
        rec = self.engine.runtime.tasks.get(cid)
        return rec.latest_snapshot if rec else None

    def task_progress(self, cid: str) -> Optional[int]:
        """Guest step counter — published into the shared registry as the
        ``task_progress_steps`` series the ``MigrationController`` reads."""
        self._check()
        rec = self.engine.runtime.tasks.get(cid)
        return rec.guest_state.step if rec else None

    def warm_programs(self) -> tuple:
        """Program ids resident in this node's compile ("bitstream") cache
        — the placement layer's warm-cache affinity signal: a node already
        holding a service's programs skips reconfiguration on deploy."""
        self._check()
        return tuple(self.engine.runtime.programs.program_ids())

    def task_programs(self, cid: str) -> Optional[tuple]:
        """Program ids a task's guest needs; the orchestrator caches them
        per image so future replicas can be steered toward warm nodes.
        ``None`` while the guest is still booting (setup not finished —
        ask again later); an empty tuple is a definitive "no programs"."""
        self._check()
        rec = self.engine.runtime.tasks.get(cid)
        if rec is None or rec.status is TaskStatus.CREATED:
            return None
        return tuple(rec.task.program_ids())
