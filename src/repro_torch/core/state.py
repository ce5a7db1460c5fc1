"""Buffer state machine and task snapshots (paper §3.4).

Each logical buffer (params, KV caches, prompts, ...) is tracked with one
of three states:

    INIT   allocated, no meaningful device contents
    SYNC   device contents mirrored by a host copy (or reproducible from one)
    DIRTY  device contents newer than any host copy

Eviction saves **only DIRTY buffers**.  Values are nests (dict / list /
tuple) of tensors; abstract specs are the same nests of ``meta`` tensors.

Unlike JAX arrays, tensors are mutable and programs may update donated
buffers in place.  So every crossing between host and device *copies*:
``to_host`` and ``to_device`` never alias (on a CPU device ``.numpy()`` and
``torch.from_numpy`` would share memory, and an in-place EXECUTE would
silently rewrite the saved host copy).  Host copies are CPU tensors.

Paged buffers (the engine's KV pool: every leaf's axis 0 is the page
axis) track dirtiness per page: evict and checkpoint pull only the pages
written since the last host sync and merge them into the host copy.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map, tree_structure


class BufferState(enum.Enum):
    INIT = "init"
    SYNC = "sync"
    DIRTY = "dirty"


def tree_bytes(tree: Any) -> int:
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "nbytes"):
            total += int(leaf.nbytes)
    return total


def to_host(tree: Any) -> Any:
    """CPU-tensor copy of a device tree (never a view of device memory)."""
    return tree_map(lambda x: x.detach().to("cpu", copy=True), tree)


def to_device(tree: Any, device: torch.device) -> Any:
    """Contiguous copy of a host tree (numpy arrays, tensors or scalars) on
    ``device``; never aliases the host memory."""
    def put(x):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x)
        return t.detach().to(device, copy=True).contiguous()
    return tree_map(put, tree)


def abstract_tree(tree: Any) -> Any:
    """Meta-tensor stand-ins (shape and dtype only) for the tensors of a
    tree; other leaves pass through."""
    return tree_map(
        lambda x: (torch.empty(x.shape, dtype=x.dtype, device="meta")
                   if isinstance(x, torch.Tensor) else x), tree)


def same_avals(a: Any, b: Any) -> bool:
    """True when two trees have identical structure and leaf shape/dtype
    (values ignored) — the invariant the monitor's execute-signature cache
    keys on."""
    if a is None or b is None:
        return False
    if tree_structure(a) != tree_structure(b):
        return False
    return all(
        getattr(x, "shape", None) == getattr(y, "shape", None)
        and getattr(x, "dtype", None) == getattr(y, "dtype", None)
        for x, y in zip(tree_leaves(a), tree_leaves(b)))


@dataclass
class Buffer:
    buff_id: str
    spec: Any                           # tree of meta tensors
    state: BufferState = BufferState.INIT
    device_value: Any = None            # tree of device tensors (or None)
    host_value: Any = None              # tree of host values (or None)
    nbytes: int = 0
    version: int = 0                    # bumped on every device-side write
    spec_token: int = 0                 # bumped only when shapes may change
    # page-granular dirtiness (paged buffers only): every leaf's axis 0 is
    # the page axis; ``page_dirty`` holds ids written since the last host
    # sync, and ``None`` means "unknown — treat every page as dirty"
    paged: bool = False
    page_dirty: Optional[set] = None
    # True while host_value is shared with a TaskSnapshot: the next merge
    # copies the host leaves before patching them
    host_shared: bool = False

    def __post_init__(self):
        if not self.nbytes:
            self.nbytes = tree_bytes(self.spec)

    @property
    def n_pages(self) -> int:
        leaves = tree_leaves(self.device_value if self.device_value
                             is not None else self.spec)
        return int(leaves[0].shape[0]) if leaves else 0

    def mark_pages_dirty(self, page_ids) -> None:
        if page_ids is None:
            self.page_dirty = None          # degraded to whole-buffer dirty
        elif self.page_dirty is not None:
            self.page_dirty.update(int(p) for p in page_ids)

    def merge_dirty_pages_to_host(self) -> int:
        """Pull only the dirty pages d2h and merge them into the host copy.

        Returns the bytes actually saved; falls back to a full ``to_host``
        when no host copy exists or dirtiness is unknown.  Clears the dirty
        set: the host copy is current afterwards.
        """
        n = self.n_pages
        if (not self.paged or self.host_value is None
                or self.page_dirty is None or n == 0):
            self.host_value = to_host(self.device_value)
            self.host_shared = False    # fresh tensors, nothing shared
            saved = self.nbytes
        elif not self.page_dirty:
            saved = 0
        else:
            ids = torch.as_tensor(sorted(self.page_dirty), dtype=torch.int64)
            cow = self.host_shared

            def merge(host_leaf, dev_leaf):
                out = torch.as_tensor(host_leaf).clone() if cow \
                    else host_leaf
                out[ids] = dev_leaf[ids.to(dev_leaf.device)].to("cpu")
                return out

            self.host_value = tree_map(merge, self.host_value,
                                       self.device_value)
            self.host_shared = False
            saved = int(round(self.nbytes * len(ids) / n))
        self.page_dirty = set() if self.paged else None
        return saved


class BufferTable:
    """Per-task buffer registry with state transitions (monitor-owned)."""

    def __init__(self):
        self._buffers: Dict[str, Buffer] = {}
        # buffers written (h2d or execute) since the last SYNC drain; the
        # monitor's SYNC waits on the device only when this is non-empty
        self._unsynced: set = set()

    # -- registry -------------------------------------------------------------
    def register(self, buff_id: str, spec: Any,
                 paged: bool = False) -> Buffer:
        if buff_id in self._buffers:
            raise KeyError(f"buffer {buff_id!r} already exists")
        b = Buffer(buff_id=buff_id, spec=spec, paged=paged)
        self._buffers[buff_id] = b
        return b

    def get(self, buff_id: str) -> Buffer:
        return self._buffers[buff_id]

    def __contains__(self, buff_id: str) -> bool:
        return buff_id in self._buffers

    def ids(self):
        return list(self._buffers)

    def total_bytes(self) -> int:
        return sum(b.nbytes for b in self._buffers.values())

    # -- transitions ----------------------------------------------------------
    def on_h2d(self, buff_id: str, host_value: Any, device_value: Any):
        b = self.get(buff_id)
        # same-shaped overwrites (streamed prompts/batches) keep the spec
        # token so downstream execute-signature cache entries stay warm
        if not same_avals(b.device_value, device_value):
            b.spec_token += 1
        b.host_value = host_value
        b.device_value = device_value
        b.state = BufferState.SYNC
        b.nbytes = tree_bytes(device_value)
        b.version += 1
        if b.paged:
            b.page_dirty = set()        # host copy just became current
            b.host_shared = True        # the guest's tree: copy, not patch
        self._unsynced.add(buff_id)

    def on_d2h(self, buff_id: str) -> Any:
        b = self.get(buff_id)
        if b.paged:
            b.merge_dirty_pages_to_host()
        else:
            b.host_value = to_host(b.device_value)
        b.state = BufferState.SYNC
        return b.host_value

    def on_execute_write(self, buff_id: str, device_value: Any,
                         stable: bool = False, dirty_pages=None):
        """``stable=True`` marks a write whose shapes are known to match the
        previous contents (same program, same signature): the per-leaf byte
        walk is skipped and the spec token is preserved, so the monitor's
        execute-signature cache stays valid.  ``dirty_pages`` names the
        pages a paged buffer's write touched; omitting it on a paged buffer
        degrades that buffer to whole-buffer dirtiness."""
        b = self.get(buff_id)
        b.device_value = device_value
        b.state = BufferState.DIRTY
        if not stable:
            b.nbytes = tree_bytes(device_value)
            b.spec_token += 1
        if b.paged:
            b.mark_pages_dirty(dirty_pages)
        b.version += 1
        self._unsynced.add(buff_id)

    # -- sync tracking --------------------------------------------------------
    def take_unsynced(self) -> list:
        """Ids written since the last drain; clears the pending set."""
        out = list(self._unsynced)
        self._unsynced.clear()
        return out

    def unsynced_count(self) -> int:
        return len(self._unsynced)

    # -- evict / restore --------------------------------------------------------
    def dirty_ids(self):
        return [i for i, b in self._buffers.items()
                if b.state is BufferState.DIRTY]

    def evict_device_state(self) -> dict:
        """Save DIRTY buffers to host, drop all device references.

        Paged buffers save only their dirty pages (merged into the prior
        host copy); the clean remainder counts as skipped, as a SYNC buffer
        does.  Returns stats {saved_bytes, skipped_bytes, n_dirty,
        paged_saved_pages, paged_total_pages}.
        """
        saved = skipped = n_dirty = 0
        paged_saved = paged_total = 0
        for b in self._buffers.values():
            if b.state is BufferState.DIRTY:
                if b.paged:
                    n = b.n_pages
                    n_dirty_pages = (n if b.page_dirty is None
                                     else len(b.page_dirty))
                    part = b.merge_dirty_pages_to_host()
                    saved += part
                    skipped += b.nbytes - part
                    paged_saved += n_dirty_pages
                    paged_total += n
                else:
                    b.host_value = to_host(b.device_value)
                    saved += b.nbytes
                b.state = BufferState.SYNC
                n_dirty += 1
            else:
                skipped += b.nbytes
            b.device_value = None
        self._unsynced.clear()          # every device ref was just dropped
        return {"saved_bytes": saved, "skipped_bytes": skipped,
                "n_dirty": n_dirty, "paged_saved_pages": paged_saved,
                "paged_total_pages": paged_total}

    def restore_device_state(self, device: torch.device) -> dict:
        """Re-materialize device buffers from (copies of) the host copies."""
        restored = 0
        for b in self._buffers.values():
            if b.host_value is not None:
                b.device_value = to_device(b.host_value, device)
                b.state = BufferState.SYNC
                if b.paged:
                    b.page_dirty = set()    # device mirrors the host copy
                restored += b.nbytes
                self._unsynced.add(b.buff_id)
        return {"restored_bytes": restored}

    def host_snapshot(self) -> dict:
        """Host-side view for checkpointing: {buff_id: host tree}.

        The snapshot shares the live host copies (no copy).  Only a paged
        buffer's dirty-page merge writes a host copy in place, so paged
        buffers are flagged to copy their host leaves on the next merge."""
        out = {}
        for i, b in self._buffers.items():
            if b.host_value is not None:
                out[i] = b.host_value
                if b.paged:
                    b.host_shared = True
        return out

    def versions(self) -> dict:
        return {i: b.version for i, b in self._buffers.items()}

    def spec_map(self) -> dict:
        """Abstract registry of every buffer (incl. INIT ones)."""
        return {i: b.spec for i, b in self._buffers.items()}

    def paged_ids(self) -> tuple:
        return tuple(i for i, b in self._buffers.items() if b.paged)

    def load_snapshot(self, snap: dict, specs: dict | None = None,
                      paged=(), versions: dict | None = None):
        """Adopt a snapshot's host trees (restore, replicate).  The trees
        stay shared with the snapshot and with any table it was taken
        from, so a paged buffer copies its host leaves before its first
        dirty-page merge patches them.  Write versions carry over, so an
        incremental checkpoint of the adopted state references only the
        buffers written no time since the snapshot."""
        for i, spec in (specs or {}).items():
            if i not in self._buffers:
                self._buffers[i] = Buffer(buff_id=i, spec=spec,
                                          paged=i in paged)
        for i, host_value in snap.items():
            if i not in self._buffers:
                self._buffers[i] = Buffer(buff_id=i, spec=None, nbytes=0,
                                          paged=i in paged)
            b = self._buffers[i]
            b.host_value = host_value
            b.state = BufferState.SYNC
            b.nbytes = tree_bytes(host_value)
            b.version = (versions or {}).get(i, 0)
            if b.paged:
                b.page_dirty = set()
                b.host_shared = True

    def zero_and_clear(self):
        """Release everything (monitor zeroes freed device memory, §3.4)."""
        self._buffers.clear()
        self._unsynced.clear()


@dataclass
class GuestState:
    """The "VM state" of a task: everything the guest needs to resume
    (step counter, RNG seed, data-stream position, user dict)."""
    step: int = 0
    seed: int = 0
    data_position: int = 0
    user: dict = field(default_factory=dict)

    def clone(self) -> "GuestState":
        return GuestState(self.step, self.seed, self.data_position,
                          dict(self.user))


@dataclass
class TaskSnapshot:
    """A full checkpoint: buffers + guest (VM) state + provenance."""
    task_id: str
    guest_state: GuestState
    buffers: dict                       # buff_id -> host tree
    program_ids: tuple = ()
    created_at: float = field(default_factory=time.time)
    step: int = 0
    versions: dict = field(default_factory=dict)   # buff_id -> write version
    buffer_specs: dict = field(default_factory=dict)  # full registry
    paged: tuple = ()                   # ids of paged buffers (page pools)

    def nbytes(self) -> int:
        return tree_bytes(self.buffers)
