"""Funky runtime: the OCI-style low-level task runtime (paper §3.5).

Beyond the OCI lifecycle (create/start/kill/delete) it implements the five
Funky commands of Table 3:

    evict <cid>                  save device context to host RAM, free slot
    resume <cid[, node_id]>      resume locally or migrate from node_id
    checkpoint <cid>             snapshot VM+device state to disk
    replicate <cid, node_id>     clone a (possibly running) task onto a node
    update <cid, vfpga_num>      vertical scaling

plus ``restore`` (re-create a task from a disk snapshot), ``drain``
(request-boundary decommission) and ``crash`` (a hard failure: unlike
``kill``, no ``on_kill`` hook runs).

One runtime runs per worker node; each task gets a driver thread (the
guest vCPU) that calls ``task.step()`` through a run-gate, so orchestration
commands always land on request boundaries.  Every command appends its
timings to the task's ``timeline``.
"""

from __future__ import annotations

import enum
import os
import tempfile
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
    priority: int = 0
    preemptible: bool = True
    vfpga_num: int = 1
    annotations: dict = field(default_factory=dict)
    driver: Optional[threading.Thread] = None
    run_gate: threading.Event = field(default_factory=threading.Event)
    stop_flag: bool = False
    step_lock: threading.Lock = field(default_factory=threading.Lock)
    error: Optional[BaseException] = None
    latest_snapshot: Optional[str] = None
    boot_seconds: float = 0.0
    timeline: list = field(default_factory=list)

    def log(self, event: str, **kw):
        self.timeline.append((time.time(), event, kw))


class FunkyRuntime:
    def __init__(self, node_id: str, allocator: SliceAllocator,
                 ckpt_root: Optional[str] = None, telemetry=None,
                 chaos=None):
        self.node_id = node_id
        self.allocator = allocator
        # snapshots go to <ckpt_root>/<cid>-step<n>; created at the first
        # checkpoint (default: funky-ckpt under the temp directory)
        self.ckpt_root = (ckpt_root if ckpt_root is not None else
                          os.path.join(tempfile.gettempdir(), "funky-ckpt"))
        # fault-injection plan (repro_torch.chaos.FaultPlan); threaded into
        # every Monitor this runtime builds and into the checkpoint writer
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
            priority=int(annotations.get("priority", 0)),
            preemptible=annotations.get("preemptible", "true") == "true",
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
                        # (evict/checkpoint) while waiting to acquire it
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

    def drain(self, cid: str, timeout_s: float = 30.0) -> dict:
        """Graceful decommission: flip the task into its draining state
        (no new admissions) and wait until the work it already holds has
        finished — request-boundary scale-in without requeueing.  Tasks
        with no drain hook return at once; a wedged drain times out and
        the caller falls back to the hard kill."""
        rec = self.tasks[cid]
        if rec.status is not TaskStatus.RUNNING:
            return {"drained": True, "waited_s": 0.0}
        if type(rec.task).drain is GuestTask.drain:
            return {"drained": True, "waited_s": 0.0}
        t0 = time.perf_counter()
        rec.task.drain()
        # the driver notices the drained state on its next step and runs
        # teardown, flipping the status off RUNNING
        deadline = t0 + timeout_s
        while (time.perf_counter() < deadline
               and rec.status is TaskStatus.RUNNING):
            time.sleep(0.005)
        stats = {"drained": rec.status is not TaskStatus.RUNNING
                 or rec.task.drained,
                 "waited_s": time.perf_counter() - t0}
        rec.log("drain", **stats)
        return stats

    def _stop_driver(self, rec: TaskRecord):
        rec.stop_flag = True
        rec.run_gate.set()
        if rec.driver is not None:
            rec.driver.join(timeout=30)
        if rec.monitor.state is MonitorState.RUNNING:
            rec.monitor.vfpga_exit()

    def kill(self, cid: str):
        rec = self.tasks[cid]
        self._stop_driver(rec)
        try:
            rec.task.on_kill()
        except Exception:  # noqa: BLE001 - best-effort cleanup hook
            pass
        rec.status = TaskStatus.REMOVED
        rec.log("kill")

    def crash(self, cid: str):
        """Simulated hard crash of one task: the driver is stopped and the
        slice freed, but — unlike ``kill`` — the graceful ``on_kill`` hook
        never runs, so nothing is evacuated or requeued from inside the
        task.  Recovery must come from outside (router lease replay and a
        snapshot restore)."""
        rec = self.tasks[cid]
        self._stop_driver(rec)
        rec.status = TaskStatus.FAILED
        rec.log("crash")

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

    def resume(self, cid: str,
               source: Optional["FunkyRuntime"] = None) -> dict:
        """Resume an evicted task; if ``source`` is a remote runtime, pull
        the task context from it first (migration, Table 3)."""
        t0 = time.perf_counter()
        if source is not None and source is not self:
            rec = source.migrate_out(cid)
            rec.monitor.allocator = self.allocator
            with self._lock:
                self.tasks[cid] = rec
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

    def migrate_out(self, cid: str) -> TaskRecord:
        """Hand the full evicted context to a peer runtime."""
        rec = self.tasks[cid]
        if rec.status is TaskStatus.RUNNING:
            self.evict(cid)
        rec.stop_flag = True
        rec.run_gate.set()
        if rec.driver is not None:
            rec.driver.join(timeout=30)
        rec.driver = None
        rec.run_gate = threading.Event()
        rec.stop_flag = False
        with self._lock:
            self.tasks.pop(cid, None)
        rec.log("migrate_out", node=self.node_id)
        return rec

    def _await_setup(self, rec: TaskRecord, timeout: float = 300.0):
        """Snapshots are only meaningful once the guest finished setup()."""
        deadline = time.time() + timeout
        while rec.status is TaskStatus.CREATED and time.time() < deadline:
            time.sleep(0.005)
        if rec.status is TaskStatus.CREATED:
            raise RuntimeError(f"{rec.cid}: setup did not finish in time")

    def checkpoint(self, cid: str, keep_running: bool = True) -> str:
        """Snapshot the task to ``<ckpt_root>/<cid>-step<n>``, incremental
        against its previous snapshot; returns the path.  The timeline
        entry splits the seconds: park (wait for the request boundary),
        d2h (SYNC plus the dirty buffers' copies), then the writer's
        write, fsync and sha256."""
        from repro_torch.ckpt.checkpoint import save_snapshot

        rec = self.tasks[cid]
        self._await_setup(rec)
        if rec.status in (TaskStatus.DONE, TaskStatus.FAILED,
                          TaskStatus.REMOVED):
            raise RuntimeError(
                f"checkpoint: {cid} already {rec.status.value} "
                "(device context released)")
        t0 = time.perf_counter()
        self._park_driver(rec)
        t1 = time.perf_counter()
        try:
            snap = rec.monitor.checkpoint(rec.guest_state,
                                          keep_running=keep_running)
            t2 = time.perf_counter()
            path = os.path.join(self.ckpt_root, f"{cid}-step{snap.step}")
            stats = save_snapshot(path, snap, image=rec.image,
                                  prev_path=rec.latest_snapshot,
                                  chaos=self.chaos)
            rec.latest_snapshot = path
            rec.log("checkpoint", path=path, bytes=snap.nbytes(),
                    park_seconds=t1 - t0, d2h_seconds=t2 - t1,
                    total_seconds=time.perf_counter() - t0, **{
                        k: v for k, v in stats.items() if k != "seconds"})
            return path
        finally:
            if keep_running:
                rec.run_gate.set()
            else:
                rec.status = TaskStatus.EVICTED

    def restore(self, cid: str, snapshot_path: str) -> TaskRecord:
        """Re-create a task from a disk snapshot and resume it here.

        Verifies digests; a corrupt snapshot falls back along its
        incremental ``prev_path`` chain to the last-good ancestor (each
        skip recorded as a ``restore_fallback`` event).  Raises
        ``CheckpointCorruptError`` only when no ancestor verifies."""
        from repro_torch.ckpt.checkpoint import load_latest_good

        t0 = time.perf_counter()
        if self.chaos is not None:
            self.chaos.raise_if("ckpt.restore",
                                key=f"{self.node_id}:{cid}")
        load_stats: dict = {}
        snap, image, used_path, skipped = load_latest_good(snapshot_path,
                                                           load_stats)
        for bad_path, reason in skipped:
            self.telemetry.record_event(
                "restore_fallback", task=cid, node=self.node_id,
                skipped=bad_path, reason=reason, used=used_path)
        rec = TaskRecord(
            cid=cid, image=image, task=image.instantiate(),
            monitor=Monitor(cid, self.allocator, programs=self.programs,
                            telemetry=self.telemetry, chaos=self.chaos),
            guest_state=snap.guest_state.clone(),
        )
        rec.monitor.load_snapshot(snap)
        with self._lock:
            self.tasks[cid] = rec
        rec.status = TaskStatus.EVICTED
        rec.latest_snapshot = used_path
        rec.log("restore", path=used_path, fallbacks=len(skipped),
                **load_stats)
        resumed = self.resume(cid)
        rec.log("restored", h2d_seconds=resumed["resume_seconds"],
                total_seconds=time.perf_counter() - t0)
        return rec

    def replicate(self, cid: str, target: "FunkyRuntime",
                  new_cid: str) -> str:
        """Horizontal scaling: clone a running task onto another node.  The
        clone adopts the source's host copies (no disk) and starts its own
        guest from them."""
        t0 = time.perf_counter()
        rec = self.tasks[cid]
        self._await_setup(rec)
        self._park_driver(rec)
        try:
            snap = rec.monitor.checkpoint(rec.guest_state, keep_running=True)
        finally:
            rec.run_gate.set()
        t1 = time.perf_counter()
        clone = TaskRecord(
            cid=new_cid, image=rec.image, task=rec.image.instantiate(),
            monitor=Monitor(new_cid, target.allocator,
                            programs=target.programs,
                            telemetry=target.telemetry,
                            chaos=target.chaos),
            guest_state=snap.guest_state.clone(),
            priority=rec.priority, preemptible=rec.preemptible,
        )
        clone.monitor.load_snapshot(snap)
        with target._lock:
            target.tasks[new_cid] = clone
        clone.log("replicate_from", source=cid, node=target.node_id)
        resumed = target.resume(new_cid)
        clone.log("replicated", d2h_seconds=t1 - t0,
                  h2d_seconds=resumed["resume_seconds"],
                  total_seconds=time.perf_counter() - t0)
        return new_cid

    def update(self, cid: str, vfpga_num: int):
        """Vertical scaling: adjust the task's vSlice allowance."""
        rec = self.tasks[cid]
        rec.vfpga_num = vfpga_num
        rec.task.on_update(vfpga_num)
        rec.log("update", vfpga_num=vfpga_num)

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
