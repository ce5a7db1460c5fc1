"""Funky core on PyTorch: vSlice, monitor, FunkyCL, guest tasks, runtime,
the CRI layer and the node agent, and the orchestration control plane
(scheduler, placement, orchestrator, cluster assembly, trace simulator)."""

from repro_torch.core.cluster import Cluster, Node, make_cluster
from repro_torch.core.cri import ContainerConfig, ContainerEngine
from repro_torch.core.guest import FunkyCL
from repro_torch.core.monitor import (DeviceMemoryExceeded, Monitor,
                                      MonitorError, MonitorState,
                                      NoSliceAvailable)
from repro_torch.core.node_agent import NodeAgent, NodeFailed
from repro_torch.core.orchestrator import Deployment, Orchestrator
from repro_torch.core.placement import (MigrationConfig, MigrationController,
                                        MigrationDecision, PlacementPolicy,
                                        PlacementWeights, ServiceGroup)
from repro_torch.core.programs import Program, ProgramCache
from repro_torch.core.requests import (Completion, Direction, FunkyRequest,
                                       RequestKind)
from repro_torch.core.runtime import FunkyRuntime, TaskRecord, TaskStatus
from repro_torch.core.scheduler import (Action, FunkyScheduler, Policy,
                                        SchedTask, TaskState)
from repro_torch.core.state import (Buffer, BufferState, BufferTable,
                                    GuestState, TaskSnapshot, tree_bytes)
from repro_torch.core.tasks import (EngineServeTask, GuestTask, ServeTask,
                                    TaskImage, TrainTask)
from repro_torch.core.vslice import SliceAllocator, VSlice

__all__ = [
    "Action", "Buffer", "BufferState", "BufferTable", "Cluster", "Completion",
    "ContainerConfig", "ContainerEngine", "Deployment",
    "DeviceMemoryExceeded", "Direction", "EngineServeTask", "FunkyCL",
    "FunkyRequest", "FunkyRuntime", "FunkyScheduler", "GuestState",
    "GuestTask", "MigrationConfig", "MigrationController",
    "MigrationDecision", "Monitor", "MonitorError", "MonitorState", "Node",
    "NoSliceAvailable", "NodeAgent", "NodeFailed", "Orchestrator",
    "PlacementPolicy", "PlacementWeights", "Policy", "Program",
    "ProgramCache", "RequestKind", "SchedTask", "ServeTask", "ServiceGroup",
    "SliceAllocator", "TaskImage", "TaskRecord", "TaskSnapshot", "TaskState",
    "TaskStatus", "TrainTask", "VSlice", "make_cluster", "tree_bytes",
]
