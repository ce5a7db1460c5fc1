"""FunkyCL: the OpenCL-compatible guest library (paper §3.3, Table 1).

The guest task sees the standard OpenCL host-API surface; each call is
converted to a hypercall or a Funky request exactly as in Table 1:

    clCreateProgramWithBinary  -> vfpga_init (slot acquire + reconfigure)
    clReleaseProgram           -> vfpga_exit (when refcount drops to zero)
    clCreateBuffer             -> MEMORY(buff_id, spec)
    clEnqueueMigrateMemObjects -> TRANSFER(queue, buff_id, ...)
    clEnqueueKernel            -> EXECUTE(queue, kernel, args)   [async]
    clFinish                   -> SYNC(queue)

Zero-copy note (§3.3): on real Funky the unikernel's single address space
lets the monitor translate guest pointers once; here host pytrees are handed
to the worker by reference through the queue — no serialization happens on
the TRANSFER path either.

Guest code never picks a device itself: it allocates on ``cl.device``, the
device of the vSlice it was given (OpenCL's ``clGetDeviceIDs``), and every
transfer and launch flows through the monitor for isolation and state
tracking.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from repro_torch.core.monitor import Monitor
from repro_torch.core.programs import Program
from repro_torch.core.requests import (Completion, Direction, FunkyRequest,
                                       RequestKind)


class FunkyCL:
    def __init__(self, monitor: Monitor):
        self._monitor = monitor
        self._program_refs: dict[str, int] = {}
        self._pending: list[Completion] = []

    @property
    def device(self) -> torch.device:
        """The device of the task's vSlice (the allocator's device before
        the first program acquires a slice)."""
        vs = self._monitor.vslice
        return vs.device if vs is not None else self._monitor.allocator.device

    # ------------------------------------------------------------------
    # Program objects
    # ------------------------------------------------------------------
    def clCreateProgramWithBinary(self, program: Program,
                                  abstract_args: tuple,
                                  donate_argnums: tuple = ()) -> str:
        """Acquire a vFPGA and configure user logic (Table 1)."""
        if self._monitor.vslice is None:
            self._monitor.vfpga_init(program, abstract_args, donate_argnums)
        else:
            self._monitor.register_program(program, abstract_args,
                                           donate_argnums)
        pid = program.program_id
        self._program_refs[pid] = self._program_refs.get(pid, 0) + 1
        return pid

    def clReleaseProgram(self, program_id: str):
        """Decrement refcount; release the vFPGA when it reaches zero."""
        self._program_refs[program_id] -= 1
        if all(v <= 0 for v in self._program_refs.values()):
            self.clFinish()
            self._monitor.vfpga_exit()

    # ------------------------------------------------------------------
    # Buffers & transfers
    # ------------------------------------------------------------------
    def clCreateBuffer(self, buff_id: str, spec: Any,
                       paged: bool = False) -> str:
        """Register a buffer; ``spec`` is a tree of meta tensors.
        ``paged=True`` registers a page pool (every leaf's axis 0 is the
        page axis): EXECUTEs can then report ``dirty_pages`` so evict and
        checkpoint save only the pages actually written."""
        req = FunkyRequest(kind=RequestKind.MEMORY, buff_id=buff_id,
                           spec=spec, paged=paged)
        self._track(self._monitor.submit(req))
        return buff_id

    def clEnqueueMigrateMemObjects(self, buff_id: str,
                                   host_value: Any = None,
                                   to_device: bool = True,
                                   span: Any = None) -> Completion:
        req = FunkyRequest(
            kind=RequestKind.TRANSFER, buff_id=buff_id,
            direction=Direction.H2D if to_device else Direction.D2H,
            host_value=host_value, span=span)
        return self._track(self._monitor.submit(req))

    # ------------------------------------------------------------------
    # Kernels
    # ------------------------------------------------------------------
    def clEnqueueKernel(self, program_id: str, in_buffs: Sequence[str],
                        out_buffs: Sequence[str],
                        const_args: tuple = (),
                        donate: bool = False,
                        dirty_pages: Optional[dict] = None,
                        span: Any = None) -> Completion:
        """Async kernel launch; kernel args travel with the EXECUTE request
        (clSetKernelArg coalescing, paper §4).  ``donate=True`` donates
        inputs that are also outputs: the program may write them in place
        (no device copy) — register the program with matching
        donate_argnums so the first EXECUTE hits the warm entry.
        ``dirty_pages`` maps a paged out buffer to the page ids this launch
        writes."""
        req = FunkyRequest(
            kind=RequestKind.EXECUTE, program_id=program_id,
            in_buffs=tuple(in_buffs), out_buffs=tuple(out_buffs),
            const_args=tuple(const_args), donate=donate,
            dirty_pages=dirty_pages, span=span)
        return self._track(self._monitor.submit(req))

    def clFinish(self) -> None:
        req = FunkyRequest(kind=RequestKind.SYNC)
        self._monitor.submit(req).wait()
        for c in self._pending:
            c.wait()
        self._pending.clear()

    # ------------------------------------------------------------------
    # Convenience (non-OpenCL helpers used by the tasks)
    # ------------------------------------------------------------------
    def write_buffer(self, buff_id: str, host_value: Any,
                     span: Any = None) -> Completion:
        return self.clEnqueueMigrateMemObjects(buff_id, host_value,
                                               to_device=True, span=span)

    def read_buffer(self, buff_id: str, span: Any = None) -> Any:
        return self.clEnqueueMigrateMemObjects(
            buff_id, to_device=False, span=span).wait()

    def _track(self, c: Completion) -> Completion:
        self._pending.append(c)
        if len(self._pending) > 1024:
            self._pending = [p for p in self._pending if not p.done]
        return c
