"""Funky requests (paper Table 2) — the four primitive device operations.

Every device interaction of a guest task is one of:

    MEMORY(buff_id, spec, size)          allocate/register a device buffer
    TRANSFER(queue, buff_id, src, size)  host<->device data movement
    EXECUTE(queue, program, args)        launch a compiled program
    SYNC(queue, req_id)                  await completion

Requests travel on a shared queue between the guest and the monitor's worker
thread (the paper's lock-free exitless-I/O rings; here a ``queue.Queue``
crossing a real thread boundary).  Each request carries a ``Completion``
future the guest can wait on — EXECUTE/TRANSFER are *asynchronous* unless the
guest SYNCs, mirroring the OpenCL command-queue model.
"""

from __future__ import annotations

import enum
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional


class RequestKind(enum.Enum):
    MEMORY = "MEMORY"
    TRANSFER = "TRANSFER"
    EXECUTE = "EXECUTE"
    SYNC = "SYNC"
    SHUTDOWN = "SHUTDOWN"      # internal: stop the worker thread


class Direction(enum.Enum):
    H2D = "h2d"
    D2H = "d2h"


class Completion:
    """Future for one request."""

    __slots__ = ("_event", "value", "error", "submitted_at", "completed_at",
                 "phases", "error_seen")

    def __init__(self):
        self._event = threading.Event()
        self.value: Any = None
        self.error: Optional[BaseException] = None
        # exactly-once failure surfacing: a completion may be awaited at
        # its issue site (sync reads) or at a later step boundary (async
        # EXECUTEs); whoever raises the error first sets this so the other
        # path doesn't re-raise or double-count it
        self.error_seen = False
        self.submitted_at = time.perf_counter()
        self.completed_at: Optional[float] = None
        # per-phase wall-time attribution filled in by the monitor worker
        # before set(): queue_wait_s always; EXECUTE adds prep_s (signature
        # lookup + compile), device_s and sig_hit; TRANSFER adds bytes and
        # direction; SYNC adds synced buffer count.  Populated whether or
        # not tracing is enabled, so the engine can compute its
        # host/device split without a tracer.
        self.phases: Optional[dict] = None

    def set(self, value: Any = None, error: Optional[BaseException] = None):
        self.value = value
        self.error = error
        self.completed_at = time.perf_counter()
        self._event.set()

    def wait(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("request did not complete")
        if self.error is not None:
            raise self.error
        return self.value

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def latency(self) -> Optional[float]:
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at


_req_counter = itertools.count(1)


@dataclass
class FunkyRequest:
    kind: RequestKind
    req_id: int = field(default_factory=lambda: next(_req_counter))
    completion: Completion = field(default_factory=Completion)

    # MEMORY
    buff_id: Optional[str] = None
    spec: Any = None                    # abstract tree (meta tensors)
    paged: bool = False                 # page-granular dirtiness (axis 0)

    # TRANSFER
    direction: Optional[Direction] = None
    host_value: Any = None              # h2d payload (host pytree)

    # EXECUTE
    program_id: Optional[str] = None
    in_buffs: tuple = ()
    out_buffs: tuple = ()
    const_args: tuple = ()              # small scalars passed by value
    # opt-in: donate inputs that are also outputs, so in-place updates
    # (KV caches, decode state) don't copy the buffer every step.  The
    # program must have been registered with matching donate_argnums or
    # the first EXECUTE pays a recompile.
    donate: bool = False
    # {out_buff_id: page ids written} for paged out buffers; a paged out
    # buffer absent from the dict is treated as fully dirtied
    dirty_pages: Optional[dict] = None

    # SYNC
    upto_req_id: Optional[int] = None   # None = all outstanding

    # tracing (optional): parent span in the submitter's trace; the
    # monitor worker hangs queue-wait/execute/transfer child spans off it.
    span: Any = None
    enqueue_t: Optional[float] = None   # trace-clock time at submit
    mon_span: Any = None                # set by the worker loop for handlers

    def __repr__(self) -> str:  # compact for logs
        return f"<{self.kind.value} #{self.req_id} buff={self.buff_id} prog={self.program_id}>"
