"""vSlice: the virtualized accelerator slot (paper's vFPGA).

A vSlice is a lease on a ``torch.device`` with a memory budget (the Alveo
U50's 8 GiB HBM maps to ``mem_cap_bytes``).  The node-local
``SliceAllocator`` implements the two hypercalls:

    vfpga_init(task)  -> acquire a free slot (+ program "reconfiguration")
    vfpga_free(slot)  -> release it (device memory zeroed by the monitor)

The device defaults to the CUDA card; a host without one raises unless the
caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclass
class VSlice:
    node_id: str
    slice_id: int
    device: torch.device
    mem_cap_bytes: int
    owner: Optional[str] = None         # task id
    configured_program: Optional[str] = None   # "bitstream" currently loaded

    @property
    def name(self) -> str:
        return f"{self.node_id}/vslice{self.slice_id}"


class SliceAllocator:
    """Per-node vSlice pool."""

    def __init__(self, node_id: str, num_slices: int,
                 mem_cap_bytes: int = 8 << 30, device: DeviceLike = "cuda"):
        dev = resolve_device(device)
        self._lock = threading.Lock()
        self.node_id = node_id
        self.device = dev
        self.slices = [
            VSlice(node_id=node_id, slice_id=i, device=dev,
                   mem_cap_bytes=mem_cap_bytes)
            for i in range(num_slices)
        ]

    def vfpga_init(self, task_id: str, program_id: Optional[str] = None
                   ) -> Optional[VSlice]:
        """Acquire a free slot for ``task_id``; None if all busy."""
        with self._lock:
            for s in self.slices:
                if s.owner is None:
                    s.owner = task_id
                    s.configured_program = program_id
                    return s
        return None

    def vfpga_free(self, vslice: VSlice):
        with self._lock:
            vslice.owner = None
            vslice.configured_program = None

    def free_count(self) -> int:
        with self._lock:
            return sum(1 for s in self.slices if s.owner is None)

    def owned_by(self, task_id: str):
        with self._lock:
            return [s for s in self.slices if s.owner == task_id]
