"""Funky runtime: the OCI-style low-level task runtime (paper §3.5).

The OCI lifecycle (create/start/kill/delete) plus the Funky commands of
Table 3 that this slice ports:

    evict <cid>      save device context to host RAM, free the slot
    resume <cid>     re-acquire a slot and restore the context

``kill`` runs the task's ``on_kill`` hook (a serving replica hands its
unfinished requests back to the router).

(checkpoint, restore, replicate and update come with the checkpoint and
orchestration slices.)  One runtime runs per worker node; each task gets a
driver thread (the guest vCPU) that calls ``task.step()`` through a
run-gate, so orchestration commands always land on request boundaries.
"""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core.guest import FunkyCL
from repro_torch.core.monitor import Monitor, MonitorState, NoSliceAvailable
from repro_torch.core.programs import ProgramCache
from repro_torch.core.state import GuestState
from repro_torch.core.tasks import GuestTask, TaskImage
from repro_torch.core.vslice import SliceAllocator
from repro_torch.scaling.metrics import MetricsRegistry


class TaskStatus(enum.Enum):
    CREATED = "created"
    RUNNING = "running"
    EVICTED = "evicted"
    DONE = "done"
    FAILED = "failed"
    REMOVED = "removed"


@dataclass
class TaskRecord:
    cid: str
    image: TaskImage
    task: GuestTask
    monitor: Monitor
    guest_state: GuestState
    status: TaskStatus = TaskStatus.CREATED
    annotations: dict = field(default_factory=dict)
    driver: Optional[threading.Thread] = None
    run_gate: threading.Event = field(default_factory=threading.Event)
    stop_flag: bool = False
    step_lock: threading.Lock = field(default_factory=threading.Lock)
    error: Optional[BaseException] = None
    boot_seconds: float = 0.0
    timeline: list = field(default_factory=list)

    def log(self, event: str, **kw):
        self.timeline.append((time.time(), event, kw))


class FunkyRuntime:
    def __init__(self, node_id: str, allocator: SliceAllocator,
                 telemetry=None, chaos=None):
        self.node_id = node_id
        self.allocator = allocator
        # fault-injection plan (repro_torch.chaos.FaultPlan); threaded into
        # every Monitor this runtime builds
        self.chaos = chaos
        self.tasks: Dict[str, TaskRecord] = {}
        self._lock = threading.Lock()
        # node-level program ("bitstream") cache shared by the node's tasks
        self.programs = ProgramCache()
        self.telemetry = (telemetry if telemetry is not None
                          else MetricsRegistry())

    # ------------------------------------------------------------------
    # OCI lifecycle
    # ------------------------------------------------------------------
    def create(self, cid: str, image: TaskImage,
               annotations: Optional[dict] = None) -> TaskRecord:
        t0 = time.perf_counter()
        annotations = dict(annotations or {})
        rec = TaskRecord(
            cid=cid, image=image, task=image.instantiate(),
            monitor=Monitor(cid, self.allocator, programs=self.programs,
                            telemetry=self.telemetry, chaos=self.chaos),
            guest_state=GuestState(seed=image.seed),
            annotations=annotations,
        )
        rec.boot_seconds = time.perf_counter() - t0
        rec.log("create", node=self.node_id)
        with self._lock:
            self.tasks[cid] = rec
        return rec

    def start(self, cid: str):
        rec = self.tasks[cid]
        if rec.status is TaskStatus.EVICTED:
            return self.resume(cid)
        rec.log("start", node=self.node_id)
        self._spawn_driver(rec, restore=False)

    def _spawn_driver(self, rec: TaskRecord, restore: bool):
        rec.run_gate.set()
        rec.stop_flag = False

        def drive():
            cl = FunkyCL(rec.monitor)
            try:
                rec.task.setup(cl, rec.guest_state, restore=restore)
                rec.status = TaskStatus.RUNNING
                done = False
                while not done:
                    rec.run_gate.wait()
                    if rec.stop_flag:
                        return
                    with rec.step_lock:
                        # re-check under the lock: we may have been parked
                        # (evict) while waiting to acquire it
                        if not rec.run_gate.is_set():
                            continue
                        done = rec.task.step(cl, rec.guest_state)
                rec.task.teardown(cl, rec.guest_state)
                rec.status = TaskStatus.DONE
                rec.log("done", step=rec.guest_state.step)
            except NoSliceAvailable as e:
                rec.status = TaskStatus.FAILED
                rec.error = e
                rec.log("failed", error="NoSliceAvailable")
            except Exception as e:  # noqa: BLE001 - reported via the record
                rec.status = TaskStatus.FAILED
                rec.error = e
                rec.log("failed", error=repr(e))

        rec.driver = threading.Thread(
            target=drive, name=f"driver-{rec.cid}", daemon=True)
        rec.driver.start()

    def _park_driver(self, rec: TaskRecord):
        """Block the driver between steps (cooperative pause)."""
        rec.run_gate.clear()
        # wait until the in-flight step (if any) finishes its enqueues
        with rec.step_lock:
            pass

    def kill(self, cid: str):
        rec = self.tasks[cid]
        rec.stop_flag = True
        rec.run_gate.set()
        if rec.driver is not None:
            rec.driver.join(timeout=30)
        if rec.monitor.state is MonitorState.RUNNING:
            rec.monitor.vfpga_exit()
        try:
            rec.task.on_kill()
        except Exception:  # noqa: BLE001 - best-effort cleanup hook
            pass
        rec.status = TaskStatus.REMOVED
        rec.log("kill")

    def delete(self, cid: str):
        with self._lock:
            self.tasks.pop(cid, None)

    # ------------------------------------------------------------------
    # Funky commands (Table 3)
    # ------------------------------------------------------------------
    def evict(self, cid: str, setup_timeout: float = 300.0) -> dict:
        rec = self.tasks[cid]
        # A task may still be booting (setup); eviction waits for the
        # context to exist, like the paper's sync-before-evict.
        deadline = time.time() + setup_timeout
        while rec.status is TaskStatus.CREATED and time.time() < deadline:
            time.sleep(0.005)
        if rec.status is not TaskStatus.RUNNING:
            raise RuntimeError(f"evict: {cid} is {rec.status}")
        t0 = time.perf_counter()
        self._park_driver(rec)
        stats = rec.monitor.evict()
        rec.status = TaskStatus.EVICTED
        stats["total_seconds"] = time.perf_counter() - t0
        rec.log("evict", **stats)
        return stats

    def resume(self, cid: str) -> dict:
        """Resume an evicted task on this node."""
        t0 = time.perf_counter()
        rec = self.tasks[cid]
        stats = rec.monitor.resume(self.allocator)
        rec.status = TaskStatus.RUNNING
        if rec.driver is None or not rec.driver.is_alive():
            self._spawn_driver(rec, restore=True)
        else:
            rec.run_gate.set()
        stats["total_seconds"] = time.perf_counter() - t0
        rec.log("resume", node=self.node_id, **stats)
        return stats

    # ------------------------------------------------------------------
    def status(self, cid: str) -> TaskStatus:
        return self.tasks[cid].status

    def wait(self, cid: str, timeout: float = 300.0) -> TaskStatus:
        rec = self.tasks[cid]
        deadline = time.time() + timeout
        while time.time() < deadline:
            if rec.status in (TaskStatus.DONE, TaskStatus.FAILED,
                              TaskStatus.REMOVED):
                return rec.status
            time.sleep(0.005)
        return rec.status
