"""Cluster assembly: leader + worker nodes, wired per the paper's Figure 1
(the reference package's ``core/cluster.py`` on the port).

``make_cluster`` builds N worker nodes — each with a vSlice allocator, a
Funky runtime daemon, a container engine and a node agent — plus the leader's
orchestrator.  Every vSlice of every node leases the same ``device`` (as
multiple vFPGAs map onto one card's slots); isolation and accounting are
enforced by the monitors.  The device defaults to the CUDA card; a host
without one raises unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.cri import ContainerEngine
from repro_torch.core.node_agent import NodeAgent
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.runtime import FunkyRuntime
from repro_torch.core.scheduler import Policy
from repro_torch.core.tasks import TaskImage
from repro_torch.core.vslice import SliceAllocator
from repro_torch.device import DeviceLike
from repro_torch.scaling.metrics import MetricsRegistry


@dataclass
class Node:
    node_id: str
    allocator: SliceAllocator
    runtime: FunkyRuntime
    engine: ContainerEngine
    agent: NodeAgent


@dataclass
class Cluster:
    nodes: Dict[str, Node]
    orchestrator: Orchestrator
    images: Dict[str, TaskImage]
    ckpt_root: str

    @property
    def metrics(self) -> MetricsRegistry:
        """Cluster-wide telemetry (monitors, agents, orchestrator)."""
        return self.orchestrator.metrics

    def agent(self, node_id: str) -> NodeAgent:
        return self.nodes[node_id].agent

    def stop(self):
        self.orchestrator.stop()


def make_cluster(num_nodes: int = 3, slices_per_node: int = 1,
                 images: Optional[Dict[str, TaskImage]] = None,
                 policy: Policy = Policy.PRE_MG,
                 mem_cap_bytes: int = 8 << 30,
                 checkpoint_interval: Optional[float] = None,
                 ckpt_root: Optional[str] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 failure_domains: Optional[int] = None,
                 straggler_interval: Optional[float] = None,
                 tracer=None, chaos=None,
                 device: DeviceLike = None) -> Cluster:
    """``failure_domains=k`` spreads the nodes round-robin over ``k``
    synthetic failure domains (rack/PDU model) for replica anti-affinity;
    the default gives every node its own domain.  ``chaos`` (a
    ``repro_torch.chaos.FaultPlan``) is threaded into every runtime,
    monitor and node agent for deterministic fault injection.  ``device``
    is what every node's ``SliceAllocator`` leases (default: the card)."""
    images = images or {}
    ckpt_root = ckpt_root or tempfile.mkdtemp(prefix="funky-ckpt-")
    metrics = metrics if metrics is not None else MetricsRegistry()
    engines: Dict[str, ContainerEngine] = {}
    nodes: Dict[str, Node] = {}
    for i in range(num_nodes):
        nid = f"node{i}"
        alloc = SliceAllocator(nid, slices_per_node,
                               mem_cap_bytes=mem_cap_bytes, device=device)
        rt = FunkyRuntime(nid, alloc,
                          ckpt_root=os.path.join(ckpt_root, nid),
                          telemetry=metrics, chaos=chaos)
        eng = ContainerEngine(rt, images, peers=engines)
        engines[nid] = eng
        domain = (f"dom{i % failure_domains}" if failure_domains else None)
        agent = NodeAgent(nid, eng, metrics=metrics, failure_domain=domain,
                          chaos=chaos)
        nodes[nid] = Node(nid, alloc, rt, eng, agent)
    orch = Orchestrator({n: nd.agent for n, nd in nodes.items()},
                        policy=policy,
                        checkpoint_interval=checkpoint_interval,
                        metrics=metrics,
                        straggler_interval=straggler_interval,
                        tracer=tracer)
    return Cluster(nodes=nodes, orchestrator=orch, images=images,
                   ckpt_root=ckpt_root)
