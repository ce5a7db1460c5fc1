"""CRI/OCI command mapping (paper Table 3) in the port: every orchestration
service maps to its CRI call and annotations, and ``ContainerEngine``
translates it to the right ``FunkyRuntime`` command.  The cases of
``tests/test_cri.py`` on two hand-wired nodes (no orchestrator), with
``serve`` and ``engine-serve`` images of yi-9b-smoke on ``device="cpu"``.

An engine-serve replica runs until its router is closed, so a lifecycle
command always finds it running: no timing decides an outcome.  Also:
the node agent's chaos sites (``agent.<op>``: crash, error, delay) and
its ``node_ops_total`` counter and ``node_free_slices`` gauge.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.chaos import FaultPlan, FaultSpec, InjectedFault  # noqa: E402
from repro_torch.core import (ContainerEngine, FunkyRuntime,  # noqa: E402
                              NodeAgent, NodeFailed, SliceAllocator,
                              TaskImage, TaskStatus)
from repro_torch.core.cri import (A_PREEMPTIBLE, A_PRIORITY,  # noqa: E402
                                  A_REPLICA_OF, A_SNAPSHOT, A_SOURCE_NODE,
                                  A_VFPGA_NUM, ContainerConfig)
from repro_torch.scaling.metrics import MetricsRegistry  # noqa: E402
from repro_torch.scaling.serving import reset_router  # noqa: E402
from repro_torch.serve.engine import ServeRequest  # noqa: E402

ARCH = "yi-9b-smoke"
SPEC = [4, 6, 3, 5]                     # max_new_tokens per request


def _images():
    return {
        "serve": TaskImage(name="serve", kind="serve", arch=ARCH,
                           prompt_len=8, global_batch=2, total_steps=4,
                           tokens_per_step=2),
        "engine": TaskImage(name="engine", kind="engine-serve", arch=ARCH,
                            prompt_len=8, global_batch=2, max_new_tokens=6,
                            page_size=4, total_steps=10 ** 9),
    }


def make_nodes(tmp_path, n=2, chaos=None):
    """``make_cluster``'s wiring minus the orchestrator: per node a
    SliceAllocator, a FunkyRuntime with its own checkpoint root, a
    ContainerEngine sharing the peers map, and a NodeAgent."""
    reg = MetricsRegistry()
    images = _images()
    engines, agents = {}, {}
    for i in range(n):
        nid = f"node{i}"
        rt = FunkyRuntime(nid, SliceAllocator(nid, 1, device="cpu"),
                          ckpt_root=str(tmp_path / nid), telemetry=reg,
                          chaos=chaos)
        engines[nid] = ContainerEngine(rt, images, peers=engines)
        agents[nid] = NodeAgent(nid, engines[nid], metrics=reg, chaos=chaos)
    return agents, reg


def _requests():
    rng = np.random.Generator(np.random.Philox(17))
    return [ServeRequest(rid=f"r{i}", prompt=rng.integers(0, 100, 8),
                         max_new_tokens=n) for i, n in enumerate(SPEC)]


def _serve_all(router, timeout=120):
    """Submit the requests, wait until every one completed, close."""
    for r in _requests():
        router.submit(r)
    deadline = time.time() + timeout
    while router.outstanding() > 0 and time.time() < deadline:
        time.sleep(0.005)
    router.close()
    assert sorted(router.completed) == [f"r{i}" for i in range(len(SPEC))]
    assert router.duplicates == 0
    assert {rid: len(c.tokens) for rid, c in router.completed.items()} == \
        {f"r{i}": n for i, n in enumerate(SPEC)}


def _await_running(rt, cid, timeout=60):
    deadline = time.time() + timeout
    while rt.status(cid) is TaskStatus.CREATED and time.time() < deadline:
        time.sleep(0.005)
    assert rt.status(cid) is TaskStatus.RUNNING, rt.tasks[cid].error


def test_deploy_maps_to_create_start(tmp_path):
    agents, _ = make_nodes(tmp_path)
    agents["node0"].deploy("c1", "serve", priority=3, preemptible=True)
    rt = agents["node0"].engine.runtime
    assert rt.tasks["c1"].priority == 3
    assert rt.tasks["c1"].preemptible
    assert rt.wait("c1", timeout=120) == TaskStatus.DONE
    agents["node0"].deploy("c1b", "serve", preemptible=False)
    assert not rt.tasks["c1b"].preemptible
    assert rt.wait("c1b", timeout=120) == TaskStatus.DONE


def test_stop_container_evicts_preemptible(tmp_path):
    agents, _ = make_nodes(tmp_path)
    router = reset_router("engine")
    a0 = agents["node0"]
    rt = a0.engine.runtime
    a0.deploy("c2", "engine")
    a0.evict("c2")                          # StopContainer -> evict
    assert rt.status("c2") == TaskStatus.EVICTED
    assert rt.allocator.free_count() == 1
    a0.resume("c2")                         # StartContainer -> resume
    _serve_all(router)
    assert rt.wait("c2", timeout=120) == TaskStatus.DONE


def test_stop_container_kills_non_preemptible(tmp_path):
    agents, _ = make_nodes(tmp_path)
    router = reset_router("engine")
    a0 = agents["node0"]
    a0.deploy("c2k", "engine", preemptible=False)
    _await_running(a0.engine.runtime, "c2k")
    a0.evict("c2k")                         # StopContainer -> kill
    assert a0.task_status("c2k") == TaskStatus.REMOVED
    router.close()


def test_migrate_uses_source_node_annotation(tmp_path):
    agents, _ = make_nodes(tmp_path)
    router = reset_router("engine")
    a0, a1 = agents["node0"], agents["node1"]
    a0.deploy("c3", "engine")
    a0.evict("c3")
    # CreateContainer(cid*, node_id*) -> StartContainer: Table 3 migrate row
    a1.migrate_in("c3", "engine", source_node="node0")
    rt1 = a1.engine.runtime
    assert "c3" not in a0.engine.runtime.tasks
    assert a0.free_slices() == 1 and a1.free_slices() == 0
    _serve_all(router)
    assert rt1.wait("c3", timeout=120) == TaskStatus.DONE


def test_checkpoint_and_restore_annotations(tmp_path):
    agents, _ = make_nodes(tmp_path)
    router = reset_router("engine")
    a0, a1 = agents["node0"], agents["node1"]
    a0.deploy("c4", "engine")
    path = a0.checkpoint("c4")              # CheckpointContainer
    assert path.startswith(str(tmp_path / "node0"))
    assert a0.latest_snapshot("c4") == path
    a0.engine.runtime.kill("c4")
    a1.restore("c5", path)                  # snapshot annotation
    rt1 = a1.engine.runtime
    assert rt1.tasks["c5"].latest_snapshot == path
    _serve_all(router)
    assert rt1.wait("c5", timeout=120) == TaskStatus.DONE


def test_replicate_annotations(tmp_path):
    agents, _ = make_nodes(tmp_path)
    router = reset_router("engine")
    a0, a1 = agents["node0"], agents["node1"]
    a0.deploy("c6", "engine")
    a1.replicate_in("c6-r", "c6", source_node="node0")
    assert a1.task_status("c6-r") is TaskStatus.RUNNING
    assert a0.task_status("c6") is TaskStatus.RUNNING
    _serve_all(router)
    assert a1.engine.runtime.wait("c6-r", timeout=120) == TaskStatus.DONE
    assert a0.engine.runtime.wait("c6", timeout=120) == TaskStatus.DONE


def test_update_vfpga_num(tmp_path):
    agents, _ = make_nodes(tmp_path)
    a0 = agents["node0"]
    a0.deploy("c7", "serve")
    a0.update("c7", 4)                      # UpdateContainerResources
    rt0 = a0.engine.runtime
    assert rt0.tasks["c7"].vfpga_num == 4
    assert rt0.wait("c7", timeout=120) == TaskStatus.DONE


def test_drain_then_remove(tmp_path):
    """DrainContainer finishes the held lanes without a requeue; then
    RemoveContainer deletes the record."""
    agents, _ = make_nodes(tmp_path)
    router = reset_router("engine")
    a0 = agents["node0"]
    a0.deploy("c8", "engine")
    _serve_all(router)
    stats = a0.drain("c8")
    assert stats["drained"]
    assert a0.task_status("c8") is TaskStatus.DONE
    a0.remove("c8")
    assert a0.task_status("c8") is None
    assert a0.drain("c8") == {"drained": True, "waited_s": 0.0}


def test_annotations_are_plain_kv_pairs():
    cfgmsg = ContainerConfig(cid="x", image_ref="img", annotations={
        A_PREEMPTIBLE: "true", A_PRIORITY: "2", A_SOURCE_NODE: "node0",
        A_SNAPSHOT: "/p", A_REPLICA_OF: "y", A_VFPGA_NUM: "2"})
    for k, v in cfgmsg.annotations.items():
        assert isinstance(k, str) and isinstance(v, str)
        assert k.startswith("funky.io/")    # namespaced, CRI-compliant


# ---------------------------------------------------------------------------
# Node agent: chaos sites, health, telemetry
# ---------------------------------------------------------------------------
def test_agent_crash_site_fails_the_node(tmp_path):
    plan = FaultPlan([FaultSpec(site="agent.deploy", kind="crash", at=1,
                                match="node1")])
    agents, _ = make_nodes(tmp_path, chaos=plan)
    a1 = agents["node1"]
    with pytest.raises(NodeFailed):
        a1.deploy("x", "serve")
    assert a1.failed
    with pytest.raises(NodeFailed):
        a1.heartbeat()
    with pytest.raises(NodeFailed):
        a1.free_slices()
    assert "x" not in a1.engine.runtime.tasks       # never reached CRI
    assert agents["node0"].heartbeat() > 0


def test_agent_error_and_delay_sites(tmp_path):
    plan = FaultPlan([FaultSpec(site="agent.deploy", kind="error", at=1),
                      FaultSpec(site="agent.update", kind="delay", at=1,
                                delay_s=0.05)])
    agents, _ = make_nodes(tmp_path, chaos=plan)
    a0 = agents["node0"]
    with pytest.raises(InjectedFault):
        a0.deploy("y", "serve")
    assert not a0.failed and "y" not in a0.engine.runtime.tasks
    a0.deploy("y", "serve")                  # the retry lands
    t0 = time.perf_counter()
    a0.update("y", 2)
    assert time.perf_counter() - t0 >= 0.05
    assert [f[:2] for f in plan.fired] == [("agent.deploy", "error"),
                                           ("agent.update", "delay")]
    assert a0.engine.runtime.wait("y", timeout=120) == TaskStatus.DONE


def test_agent_publishes_ops_and_free_slices(tmp_path):
    agents, reg = make_nodes(tmp_path)
    router = reset_router("engine")
    a0 = agents["node0"]
    def free_gauge():
        return [v for k, v in reg.snapshot()["gauges"].items()
                if k == "node_free_slices{node=node0}"]

    a0.deploy("z", "engine")
    a0.evict("z")                           # waits for setup, frees
    assert free_gauge() == [1.0]
    a0.resume("z")                          # takes the slice again
    assert free_gauge() == [0.0]
    _serve_all(router)
    a0.drain("z")
    a0.remove("z")
    assert free_gauge() == [1.0]
    ops = {k: v for k, v in reg.snapshot()["counters"].items()
           if k.startswith("node_ops_total")}
    for op in ("deploy", "evict", "resume", "drain", "remove"):
        assert ops[f"node_ops_total{{node=node0,op={op}}}"] == 1, op
