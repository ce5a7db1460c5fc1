"""CRI-compatible layer (paper §3.5, Table 3).

Funky-specific metadata travels in CRI **annotations** (unstructured
key-value pairs in the CRI message structure) so the spec is never violated:

    funky.io/preemptible   "true" | "false"
    funky.io/priority      int
    funky.io/source-node   node that holds the task's context (migrate/restore)
    funky.io/snapshot      checkpoint path (restore)
    funky.io/replica-of    source cid (horizontal scaling)
    funky.io/vfpga-num     vertical-scaling target

The ``ContainerEngine`` (containerd stand-in) translates CRI calls into
Funky OCI runtime commands exactly per Table 3:

    CreateContainer + StartContainer   create + start (deploy)
    StopContainer                      evict (preemptible) | kill
    StartContainer (evicted)           resume
    Create + Start, source-node        resume from a peer (migrate)
    Create + Start, snapshot           restore
    Create + Start, replica-of         replicate
    CheckpointContainer                checkpoint
    UpdateContainerResources           update
    DrainContainer                     drain
    RemoveContainer                    kill (if running) + delete
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core.runtime import FunkyRuntime, TaskStatus
from repro_torch.core.tasks import TaskImage

A_PREEMPTIBLE = "funky.io/preemptible"
A_PRIORITY = "funky.io/priority"
A_SOURCE_NODE = "funky.io/source-node"
A_SNAPSHOT = "funky.io/snapshot"
A_REPLICA_OF = "funky.io/replica-of"
A_VFPGA_NUM = "funky.io/vfpga-num"


@dataclass
class ContainerConfig:
    """CRI CreateContainerRequest (subset)."""
    cid: str
    image_ref: str
    annotations: Dict[str, str] = field(default_factory=dict)


class ContainerEngine:
    """CRI RuntimeService -> Funky OCI runtime command translation."""

    def __init__(self, runtime: FunkyRuntime, images: Dict[str, TaskImage],
                 peers: Optional[Dict[str, "ContainerEngine"]] = None):
        self.runtime = runtime
        self.images = images
        self.peers = peers if peers is not None else {}
        self._pending: Dict[str, dict] = {}      # cid -> deferred create info

    # -- CRI RuntimeService ------------------------------------------------
    def CreateContainer(self, config: ContainerConfig) -> str:
        ann = config.annotations
        if A_SNAPSHOT in ann or A_SOURCE_NODE in ann or A_REPLICA_OF in ann:
            # migrate / restore / replicate target: defer to StartContainer
            self._pending[config.cid] = {
                "image_ref": config.image_ref, "annotations": dict(ann)}
            return config.cid
        image = self.images[config.image_ref]
        self.runtime.create(config.cid, image, annotations={
            "preemptible": ann.get(A_PREEMPTIBLE, "true"),
            "priority": ann.get(A_PRIORITY, "0"),
        })
        return config.cid

    def StartContainer(self, cid: str):
        pending = self._pending.pop(cid, None)
        if pending is not None:
            ann = pending["annotations"]
            if A_SNAPSHOT in ann:                       # restore
                self.runtime.restore(cid, ann[A_SNAPSHOT])
                return
            if A_REPLICA_OF in ann:                     # horizontal scaling
                src_engine = self.peers[ann[A_SOURCE_NODE]]
                src_engine.runtime.replicate(
                    ann[A_REPLICA_OF], self.runtime, new_cid=cid)
                return
            # migrate: pull context from the source node's runtime
            src_engine = self.peers[ann[A_SOURCE_NODE]]
            self.runtime.resume(cid, source=src_engine.runtime)
            return
        rec = self.runtime.tasks[cid]
        if rec.status is TaskStatus.EVICTED:
            self.runtime.resume(cid)                    # resume
        else:
            self.runtime.start(cid)                     # deploy

    def StopContainer(self, cid: str):
        rec = self.runtime.tasks[cid]
        if rec.preemptible and rec.status in (TaskStatus.CREATED,
                                              TaskStatus.RUNNING):
            # evict waits for setup/sync (the request-boundary rule)
            self.runtime.evict(cid)                     # evict, keep context
        else:
            self.runtime.kill(cid)

    def CheckpointContainer(self, cid: str) -> str:
        return self.runtime.checkpoint(cid)

    def UpdateContainerResources(self, cid: str,
                                 annotations: Dict[str, str]):
        if A_VFPGA_NUM in annotations:
            self.runtime.update(cid, int(annotations[A_VFPGA_NUM]))

    def DrainContainer(self, cid: str, timeout_s: float = 30.0) -> dict:
        """Graceful-decommission prelude to RemoveContainer: stop the
        task's admissions and wait (bounded) for held work to finish."""
        if cid not in self.runtime.tasks:
            return {"drained": True, "waited_s": 0.0}
        return self.runtime.drain(cid, timeout_s=timeout_s)

    def RemoveContainer(self, cid: str):
        rec = self.runtime.tasks.get(cid)
        if rec and rec.status is TaskStatus.RUNNING:
            self.runtime.kill(cid)
        self.runtime.delete(cid)
