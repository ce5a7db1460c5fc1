"""Funky core on PyTorch: vSlice, monitor, FunkyCL, guest tasks, runtime."""

from repro_torch.core.guest import FunkyCL
from repro_torch.core.monitor import (DeviceMemoryExceeded, Monitor,
                                      MonitorError, MonitorState,
                                      NoSliceAvailable)
from repro_torch.core.programs import Program, ProgramCache
from repro_torch.core.requests import (Completion, Direction, FunkyRequest,
                                       RequestKind)
from repro_torch.core.runtime import FunkyRuntime, TaskRecord, TaskStatus
from repro_torch.core.state import (Buffer, BufferState, BufferTable,
                                    GuestState, TaskSnapshot, tree_bytes)
from repro_torch.core.tasks import GuestTask, ServeTask, TaskImage
from repro_torch.core.vslice import SliceAllocator, VSlice

__all__ = [
    "Buffer", "BufferState", "BufferTable", "Completion",
    "DeviceMemoryExceeded", "Direction", "FunkyCL", "FunkyRequest",
    "FunkyRuntime", "GuestState", "GuestTask", "Monitor", "MonitorError",
    "MonitorState", "NoSliceAvailable", "Program", "ProgramCache",
    "RequestKind", "ServeTask", "SliceAllocator", "TaskImage", "TaskRecord",
    "TaskSnapshot", "TaskStatus", "VSlice", "tree_bytes",
]
