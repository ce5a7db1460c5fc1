"""The Funky monitor: a thin per-task hypervisor layer (paper §3.2, §3.4).

One ``Monitor`` supervises one guest task:

* **worker thread** — drains the shared request queue, validates every
  request (buffer ownership, program registration, vSlice memory cap) and
  performs the delegated device work on the vSlice's ``torch.device``;
  async by construction — the guest only blocks on SYNC.
* **monitor-side commands** — ``evict`` / ``resume`` / ``checkpoint`` /
  ``migrate_out``, invoked by the Funky runtime (the paper's monitor thread
  exposing an IPC interface).  All of them synchronize to a request boundary
  first — FPGAs (and device programs) cannot be suspended mid-flight — and the
  measured *sync wait* is recorded (Fig 9).

State management follows §3.4 exactly: only DIRTY buffers are saved on
evict; ``checkpoint`` optionally keeps the task running; freed device memory
is zeroed (here: references dropped and the table cleared) before the slot is
handed to another tenant.
"""

from __future__ import annotations

import enum
import queue
import threading
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import torch

from repro_torch.chaos import (DEFAULT_EXECUTE_RETRY, RetryPolicy,
                               TransientFault, retry_call)
from repro_torch.core.programs import Program, ProgramCache
from repro_torch.core.requests import (Completion, Direction, FunkyRequest,
                                       RequestKind)
from repro_torch.core.state import (BufferTable, GuestState, TaskSnapshot,
                                    abstract_tree, same_avals, to_device,
                                    tree_bytes)
from repro_torch.core.vslice import SliceAllocator, VSlice
from repro_torch.device import synchronize
from repro_torch.scaling.metrics import MetricsRegistry


class MonitorError(RuntimeError):
    pass


class NoSliceAvailable(MonitorError):
    pass


class DeviceMemoryExceeded(MonitorError):
    pass


class MonitorState(enum.Enum):
    CREATED = "created"
    RUNNING = "running"
    EVICTED = "evicted"
    EXITED = "exited"


class Monitor:
    def __init__(self, task_id: str, allocator: SliceAllocator,
                 programs: Optional[ProgramCache] = None,
                 telemetry: Optional[MetricsRegistry] = None,
                 tracer: Any = None, chaos: Any = None,
                 retry: Optional[RetryPolicy] = None):
        self.task_id = task_id
        # fault injection plan (repro_torch.chaos.FaultPlan) + EXECUTE retry
        # policy; transient EXECUTE failures are retried with backoff
        # *before* any output buffer is written, so a retry is idempotent
        self.chaos = chaos
        self.retry = retry if retry is not None else DEFAULT_EXECUTE_RETRY
        # optional span tracer; guests that submit requests carrying a
        # ``span`` get queue-wait/device/sync child spans hung off it
        self.tracer = tracer
        self.allocator = allocator
        self.programs = programs if programs is not None else ProgramCache()
        # this task's own programs: the node cache may hold another task's
        # program under the same id, and an EXECUTE runs the task's own
        self._task_programs: Dict[str, Program] = {}
        self.buffers = BufferTable()
        self.request_queue: "queue.Queue[FunkyRequest]" = queue.Queue()
        self.vslice: Optional[VSlice] = None
        self.state = MonitorState.CREATED
        self._worker: Optional[threading.Thread] = None
        self._last_completion: Optional[Completion] = None
        self._lock = threading.Lock()
        self.metrics: dict = defaultdict(float)
        self.metrics_hist: dict = defaultdict(list)
        # shared node/cluster registry (scaling service); per-task local
        # dicts above stay as the micro-benchmark source (Figs 4-9).
        # Handles are resolved once: inc()/observe() are lock-free, so the
        # per-request dispatch loop never touches the registry lock.
        self.telemetry = (telemetry if telemetry is not None
                          else MetricsRegistry())
        self._tel_count = {
            k.value: self.telemetry.counter("monitor_requests_total",
                                            kind=k.value)
            for k in RequestKind if k is not RequestKind.SHUTDOWN}
        self._tel_hist = {
            k.value: self.telemetry.histogram("monitor_request_seconds",
                                              kind=k.value)
            for k in RequestKind if k is not RequestKind.SHUTDOWN}
        self._tel_sync_wait = self.telemetry.histogram(
            "monitor_sync_wait_seconds")
        self._tel_queue_wait = self.telemetry.histogram(
            "monitor_queue_wait_seconds")
        self._tel_h2d_bytes = self.telemetry.counter(
            "monitor_transfer_bytes_total", direction="h2d")
        self._tel_d2h_bytes = self.telemetry.counter(
            "monitor_transfer_bytes_total", direction="d2h")
        self._tel_exec_retries = self.telemetry.counter(
            "monitor_execute_retries_total")
        self._tel_exec_failed = self.telemetry.counter(
            "monitor_execute_failed_total")
        # execute-signature cache (hot path): (program_id, buffer wiring,
        # const shapes) -> (CompiledEntry, donate_argnums, in spec tokens).
        # A hit skips the per-request tree_map over every arg leaf AND
        # the ProgramCache fingerprint walk; spec tokens (bumped only on
        # shape-changing writes) invalidate it when a buffer is reshaped.
        self._exec_cache: dict = {}

    # ------------------------------------------------------------------
    # Hypercalls (paper §3.2): vfpga_init / vfpga_free
    # ------------------------------------------------------------------
    def vfpga_init(self, program: Program, abstract_args: tuple,
                   donate_argnums: tuple = ()) -> VSlice:
        """Acquire a vSlice and 'reconfigure' it (register the program)."""
        t0 = time.perf_counter()
        vs = self.allocator.vfpga_init(self.task_id, program.program_id)
        if vs is None:
            raise NoSliceAvailable(
                f"no free vSlice on node {self.allocator.node_id}")
        self.vslice = vs
        self.programs.register(program)
        self._task_programs[program.program_id] = program
        entry = self.programs.get_or_compile(
            program, abstract_args, donate_argnums)
        self.metrics["reconfig_seconds"] += time.perf_counter() - t0
        self.metrics_hist["reconfig"].append(entry.compile_seconds)
        self._spawn_worker()
        self.state = MonitorState.RUNNING
        return vs

    def register_program(self, program: Program, abstract_args: tuple,
                         donate_argnums: tuple = ()):
        """Additional programs on the already-acquired slice."""
        self.programs.register(program)
        self._task_programs[program.program_id] = program
        self.programs.get_or_compile(program, abstract_args,
                                     donate_argnums)

    def vfpga_exit(self):
        """Release the slot; zero device memory (paper: isolation, §3.4)."""
        self._stop_worker()
        self.buffers.zero_and_clear()
        # fresh buffers restart spec tokens at zero; drop stale signatures
        self._exec_cache.clear()
        if self.vslice is not None:
            self.allocator.vfpga_free(self.vslice)
            self.vslice = None
        self.state = MonitorState.EXITED

    # ------------------------------------------------------------------
    # Guest-facing request submission (exitless I/O queue)
    # ------------------------------------------------------------------
    def submit(self, req: FunkyRequest) -> Completion:
        if self.state is not MonitorState.RUNNING:
            raise MonitorError(f"monitor not running (state={self.state})")
        if req.span is not None:
            req.enqueue_t = req.span.trace.clock()
        self.request_queue.put(req)
        return req.completion

    # ------------------------------------------------------------------
    # Worker thread
    # ------------------------------------------------------------------
    def _spawn_worker(self):
        t0 = time.perf_counter()
        self._device = self.vslice.device
        self._worker = threading.Thread(
            target=self._worker_loop, name=f"funky-worker-{self.task_id}",
            daemon=True)
        self._worker.start()
        self.metrics_hist["worker_spawn"].append(time.perf_counter() - t0)

    def _stop_worker(self):
        if self._worker is None:
            return
        req = FunkyRequest(kind=RequestKind.SHUTDOWN)
        self.request_queue.put(req)
        self._worker.join()
        self._worker = None

    def _worker_loop(self):
        # a worker that cannot select its card answers every request with
        # that error, so the guest fails instead of waiting forever
        start_error = None
        if self._device.type == "cuda":
            try:
                torch.cuda.set_device(self._device)
            except BaseException as e:  # noqa: BLE001 - forwarded to guest
                start_error = e
        while True:
            req = self.request_queue.get()
            if req.kind is RequestKind.SHUTDOWN:
                req.completion.set()
                return
            t0 = time.perf_counter()
            # queue wait: from request construction (the guest submits
            # immediately after) to the worker picking it up
            qw = max(0.0, t0 - req.completion.submitted_at)
            req.completion.phases = {"kind": req.kind.value,
                                     "queue_wait_s": qw}
            if req.span is not None:
                tc = req.span.trace.clock()
                req.span.child("monitor.queue_wait",
                               t0=req.enqueue_t if req.enqueue_t is not None
                               else tc).end(tc)
                req.mon_span = req.span.child(
                    f"monitor.{req.kind.value.lower()}", t0=tc)
            try:
                if start_error is not None:
                    raise start_error
                value, error = self._handle_with_retry(req), None
            except BaseException as e:  # noqa: BLE001 - forwarded to guest
                value, error = None, e
                if req.mon_span is not None:
                    req.mon_span.annotate(error=repr(e))
            dt = time.perf_counter() - t0
            # phases must be complete before set() wakes the guest
            req.completion.phases["total_s"] = dt
            if req.mon_span is not None:
                req.mon_span.end()
            req.completion.set(value, error=error)
            self._tel_queue_wait.observe(qw)
            self.metrics[f"n_{req.kind.value}"] += 1
            self.metrics_hist[req.kind.value].append(dt)
            self._tel_count[req.kind.value].inc()
            self._tel_hist[req.kind.value].observe(dt)
            self._last_completion = req.completion

    def _handle_with_retry(self, req: FunkyRequest) -> Any:
        """EXECUTEs get bounded retry-with-backoff on ``TransientFault``:
        injection and the device call both happen *before* any
        ``on_execute_write``, so a failed attempt left no partial state.
        Other request kinds fail straight through to the guest."""
        if req.kind is not RequestKind.EXECUTE:
            return self._handle(req)

        def on_retry(attempt, backoff_s, exc):
            self._tel_exec_retries.inc()
            self.telemetry.record_event(
                "execute_retry", task=self.task_id,
                program=req.program_id, attempt=attempt,
                backoff_s=backoff_s, error=repr(exc))
            if req.mon_span is not None:
                req.mon_span.child("monitor.retry", attempt=attempt,
                                   backoff_s=backoff_s,
                                   error=repr(exc)).end()

        try:
            return retry_call(lambda: self._handle(req), self.retry,
                              on_retry=on_retry)
        except TransientFault as e:
            self._tel_exec_failed.inc()
            self.telemetry.record_event(
                "execute_failed", task=self.task_id,
                program=req.program_id,
                attempts=self.retry.max_attempts, error=repr(e))
            raise

    # -- request handlers ------------------------------------------------
    def _handle(self, req: FunkyRequest) -> Any:
        if req.kind is RequestKind.MEMORY:
            return self._do_memory(req)
        if req.kind is RequestKind.TRANSFER:
            return self._do_transfer(req)
        if req.kind is RequestKind.EXECUTE:
            return self._do_execute(req)
        if req.kind is RequestKind.SYNC:
            return self._do_sync(req)
        raise MonitorError(f"unknown request {req}")

    def _validate_buffs(self, ids):
        for i in ids:
            if i not in self.buffers:
                raise MonitorError(
                    f"task {self.task_id}: unknown/foreign buffer {i!r}")

    def _do_memory(self, req: FunkyRequest):
        new_bytes = tree_bytes(req.spec)
        cap = self.vslice.mem_cap_bytes if self.vslice else 0
        if self.buffers.total_bytes() + new_bytes > cap:
            raise DeviceMemoryExceeded(
                f"vSlice memory cap {cap} exceeded by buffer "
                f"{req.buff_id!r} (+{new_bytes} bytes)")
        self.buffers.register(req.buff_id, req.spec, paged=req.paged)
        return req.buff_id

    def _do_transfer(self, req: FunkyRequest):
        self._validate_buffs([req.buff_id])
        # the transfer call blocks on the device: h2d is the copy-in (a
        # copy even on a CPU device, so an in-place EXECUTE never writes
        # the guest's host array), d2h waits for every queued kernel
        # writing the buffer and then copies out — both count as the
        # request's device phase
        t0 = time.perf_counter()
        if req.direction is Direction.H2D:
            nbytes = tree_bytes(req.host_value)
            dev = to_device(req.host_value, self._device)
            synchronize(self._device)
            self.buffers.on_h2d(req.buff_id, req.host_value, dev)
            self._tel_h2d_bytes.inc(nbytes)
            out = None
        else:
            out = self.buffers.on_d2h(req.buff_id)
            nbytes = tree_bytes(out)
            self._tel_d2h_bytes.inc(nbytes)
        device_s = time.perf_counter() - t0
        req.completion.phases.update(bytes=nbytes, device_s=device_s,
                                     direction=req.direction.value)
        if req.mon_span is not None:
            req.mon_span.annotate(buff=req.buff_id, bytes=nbytes,
                                  direction=req.direction.value)
        return out

    @staticmethod
    def _const_sig(c) -> tuple:
        """Shape/dtype signature of a const arg (values are runtime inputs
        to the compiled program, so only the aval matters)."""
        shape = getattr(c, "shape", None)
        if shape is None:
            return (type(c).__name__,)
        return (tuple(shape), str(getattr(c, "dtype", "")))

    def _do_execute(self, req: FunkyRequest):
        t_prep0 = time.perf_counter()
        if self.chaos is not None:
            self.chaos.raise_if("monitor.execute",
                                key=f"{self.task_id}:{req.program_id}")
        self._validate_buffs(list(req.in_buffs) + list(req.out_buffs))
        program = self._task_programs.get(req.program_id)
        if program is None:
            raise MonitorError(f"program {req.program_id!r} not registered")
        key = (req.program_id, req.in_buffs, req.out_buffs, req.donate,
               tuple(self._const_sig(c) for c in req.const_args))
        # spec tokens cover the out buffers too: an h2d that reshapes a
        # pure-output buffer must invalidate the entry, or a stable-marked
        # write would skip the nbytes walk and corrupt memory-cap accounting
        watched = req.in_buffs + tuple(
            b for b in req.out_buffs if b not in req.in_buffs)
        tokens = tuple(self.buffers.get(i).spec_token for i in watched)
        cached = self._exec_cache.get(key)
        hit = cached is not None and cached[1] == tokens
        if hit:
            entry = cached[0]
            self.metrics["exec_sig_cache_hits"] += 1
        else:
            args_abs = tuple(self.buffers.get(i).device_value
                             for i in req.in_buffs) + tuple(req.const_args)
            abstract = abstract_tree(args_abs)
            donate_argnums = ()
            if req.donate:
                donate_argnums = tuple(
                    i for i, b in enumerate(req.in_buffs)
                    if b in req.out_buffs)
            entry = self.programs.get_or_compile(program, abstract,
                                                 donate_argnums)
        args = tuple(self.buffers.get(i).device_value for i in req.in_buffs)
        args = args + tuple(req.const_args)
        # device phase: the program call is the only point this path
        # touches the accelerator; everything around it is host work.
        # CUDA launches are asynchronous — the call returns before the
        # kernels finish — so the phase must close at
        # torch.cuda.synchronize, not at dispatch: otherwise the compute tail
        # blocks under some *later* request (usually the next EXECUTE's
        # dispatch or a d2h TRANSFER) and gets misattributed as host time
        t_run0 = time.perf_counter()
        prep_s = t_run0 - t_prep0
        sp = req.mon_span
        if sp is not None:
            tc = sp.trace.clock()
            sp.child("execute.sig_lookup", t0=sp.start_t,
                     hit=hit, program=req.program_id).end(tc)
            dev_sp = sp.child("execute.device", t0=tc,
                              program=req.program_id)
        out = entry.compiled(*args)
        synchronize(self._device)
        device_s = time.perf_counter() - t_run0
        if sp is not None:
            dev_sp.end()
            sp.annotate(program=req.program_id, sig_hit=hit)
        req.completion.phases.update(prep_s=prep_s, device_s=device_s,
                                     sig_hit=hit, program=req.program_id)
        if len(req.out_buffs) == 1:
            outs = (out,)
        else:
            outs = tuple(out)
            if len(outs) != len(req.out_buffs):
                raise MonitorError(
                    f"program {req.program_id} returned {len(outs)} outputs "
                    f"for {len(req.out_buffs)} out_buffs")
        for buff_id, val in zip(req.out_buffs, outs):
            # a hit means the same entry produced these shapes last time;
            # on a miss, a buffer whose aval is unchanged keeps its spec
            # token, so steady-state programs converge to cache hits
            # instead of re-fingerprinting forever
            stable = hit or same_avals(
                self.buffers.get(buff_id).device_value, val)
            dp = (None if req.dirty_pages is None
                  else req.dirty_pages.get(buff_id))
            self.buffers.on_execute_write(buff_id, val, stable=stable,
                                          dirty_pages=dp)
        if not hit:
            # keyed on the PRE-execute tokens: stable writes leave them
            # unchanged (next call hits), while a shape-changing write
            # bumps its buffer past the stored value, so the stale entry
            # can never be replayed against the new shape
            self._exec_cache[key] = (entry, tokens)
        return None

    def _do_sync(self, req: FunkyRequest):
        # Worker is serial: everything enqueued earlier already dispatched.
        # Wait on the device only when buffers were written since the last
        # SYNC drained — otherwise the table is already quiescent (Fig 9
        # sync-wait budget).
        t0 = time.perf_counter()
        synced = sum(1 for i in self.buffers.take_unsynced()
                     if self.buffers.get(i).device_value is not None)
        if synced:
            synchronize(self._device)
        req.completion.phases.update(synced_buffers=synced,
                                     device_s=time.perf_counter() - t0)
        if req.mon_span is not None:
            req.mon_span.annotate(synced_buffers=synced)
        return None

    # ------------------------------------------------------------------
    # Monitor-thread commands (evict / resume / checkpoint), paper §3.4
    # ------------------------------------------------------------------
    def sync_barrier(self) -> float:
        """Wait for all in-flight requests; returns the sync wait seconds."""
        t0 = time.perf_counter()
        req = FunkyRequest(kind=RequestKind.SYNC)
        self.request_queue.put(req)
        req.completion.wait()
        dt = time.perf_counter() - t0
        self.metrics_hist["sync_wait"].append(dt)
        self._tel_sync_wait.observe(dt)
        return dt

    def evict(self) -> dict:
        """Save FPGA context to host memory, release the slot (paper evict)."""
        with self._lock:
            if self.state is not MonitorState.RUNNING:
                raise MonitorError(f"cannot evict from {self.state}")
            t0 = time.perf_counter()
            sync_wait = self.sync_barrier()
            stats = self.buffers.evict_device_state()
            self._stop_worker()
            if self.vslice is not None:
                self.allocator.vfpga_free(self.vslice)
                self.vslice = None
            self.state = MonitorState.EVICTED
            stats["sync_wait_seconds"] = sync_wait
            stats["evict_seconds"] = time.perf_counter() - t0
            self.metrics_hist["evict"].append(stats["evict_seconds"])
            return stats

    def resume(self, allocator: Optional[SliceAllocator] = None) -> dict:
        """Re-acquire a slot (same or different node) and restore buffers."""
        with self._lock:
            if self.state is not MonitorState.EVICTED:
                raise MonitorError(f"cannot resume from {self.state}")
            t0 = time.perf_counter()
            if allocator is not None:
                self.allocator = allocator
            vs = self.allocator.vfpga_init(self.task_id)
            if vs is None:
                raise NoSliceAvailable(
                    f"no free vSlice on node {self.allocator.node_id}")
            self.vslice = vs
            stats = self.buffers.restore_device_state(vs.device)
            self._spawn_worker()
            self.state = MonitorState.RUNNING
            stats["resume_seconds"] = time.perf_counter() - t0
            self.metrics_hist["resume"].append(stats["resume_seconds"])
            return stats

    def checkpoint(self, guest_state: GuestState,
                   keep_running: bool = True) -> TaskSnapshot:
        """Snapshot VM+device state; optionally keep the task running."""
        with self._lock:
            t0 = time.perf_counter()
            if self.state is MonitorState.RUNNING:
                self.sync_barrier()
                for i in self.buffers.dirty_ids():
                    self.buffers.on_d2h(i)
                if not keep_running:
                    stats = self.buffers.evict_device_state()
                    self._stop_worker()
                    if self.vslice is not None:
                        self.allocator.vfpga_free(self.vslice)
                        self.vslice = None
                    self.state = MonitorState.EVICTED
                    del stats
            snap = TaskSnapshot(
                task_id=self.task_id,
                guest_state=guest_state.clone(),
                buffers=self.buffers.host_snapshot(),
                program_ids=self.programs.program_ids(),
                step=guest_state.step,
                versions=self.buffers.versions(),
                buffer_specs=self.buffers.spec_map(),
                paged=self.buffers.paged_ids(),
            )
            self.metrics_hist["checkpoint"].append(time.perf_counter() - t0)
            return snap

    def load_snapshot(self, snap: TaskSnapshot):
        """Initialize buffers from a snapshot (restore, replicate).  Buffers
        stay on the host until ``resume`` re-materializes them on a
        slice."""
        self.buffers.load_snapshot(snap.buffers, snap.buffer_specs,
                                   snap.paged, snap.versions)
        self.state = MonitorState.EVICTED
