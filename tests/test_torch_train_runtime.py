"""Train images through the port's control plane on ``device="cpu"``.

* The core state-management property (paper §3.4, the reference's
  ``tests/test_preemption_equivalence.py``): a ``TrainTask`` evicted and
  resumed, migrated, or checkpointed and restored *mid-accumulation*
  (``chunk_idx`` 1 of 2, ``grad_acc`` DIRTY) ends with ``final_params``
  bit-identical to an uninterrupted run.  The interruption lands exactly
  there: a ``TrainTask`` whose driver parks itself (the run gate the
  runtime's own park clears) after that chunk.
* The train-image cases of ``tests/test_runtime_cluster.py``
  (``train-small`` deployed to done beside a serve image, evict + migrate
  + checkpoint + restore, priority preemption), of ``tests/test_cri.py``
  (its ``img`` train image through every Table 3 mapping of the node
  agent) and ``tests/test_straggler.py::test_straggler_detected_and_
  migrated``; where the outcome is deterministic, final params equal an
  uninterrupted run's.
"""

import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.chaos import FaultPlan, FaultSpec  # noqa: E402
from repro_torch.core import (Policy, TaskImage, TaskStatus,  # noqa: E402
                              TrainTask, make_cluster)
from repro_torch.core.scheduler import TaskState  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

IMG = TaskImage(name="t", kind="train", arch="yi-9b-smoke", seq_len=16,
                global_batch=4, total_steps=10, chunks=2, seed=7)
SMALL = TaskImage(name="train-small", kind="train", arch="yi-9b-smoke",
                  seq_len=16, global_batch=4, total_steps=15, chunks=2)
SERVE = TaskImage(name="serve-small", kind="serve", arch="yi-9b-smoke",
                  prompt_len=8, global_batch=2, total_steps=10,
                  tokens_per_step=2)


def _slow():
    """A delay on every EXECUTE keeps a task running long enough for a
    command to land; it changes no value."""
    return FaultPlan([FaultSpec(site="monitor.execute", kind="delay",
                                every=1, max_fires=10 ** 6, delay_s=0.005)])


def _cluster(tmp_path, images, **kw):
    kw.setdefault("chaos", _slow())
    return make_cluster(slices_per_node=1, images=images, device="cpu",
                        ckpt_root=str(tmp_path), **kw)


def _done(rt, cid, timeout=120):
    rec = rt.tasks[cid]
    assert rt.wait(cid, timeout=timeout) is TaskStatus.DONE, rec.error
    assert rec.guest_state.step == rec.image.total_steps
    return rec.guest_state.user["final_params"]


def _assert_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


class _Parking(TrainTask):
    """A TrainTask that parks its driver after the chunk that leaves the
    guest at (step, chunk_idx) == ``at``: it clears the run gate the
    runtime's park clears, so the next command finds it exactly there."""

    def __init__(self, image, rec, at):
        super().__init__(image)
        self._rec, self._at = rec, at
        self.parked = threading.Event()

    def step(self, cl, gs):
        done = super().step(cl, gs)
        if (gs.step, gs.user.get("chunk_idx", 0)) == self._at:
            self._rec.run_gate.clear()
            self.parked.set()
        return done


def _start_parked(rt, cid, image, at=(2, 1)):
    rec = rt.create(cid, image)
    rec.task = _Parking(image, rec, at)
    rt.start(cid)
    assert rec.task.parked.wait(60), rec.error
    assert (rec.guest_state.step, rec.guest_state.user["chunk_idx"]) == at
    return rec


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    cl = _cluster(tmp_path_factory.mktemp("ref"), {"t": IMG}, num_nodes=1,
                  chaos=None)
    rt = cl.nodes["node0"].runtime
    rt.create("ref", IMG)
    rt.start("ref")
    params = _done(rt, "ref")
    small = SMALL
    rt.create("small", small)
    rt.start("small")
    return {"t": params, "train-small": _done(rt, "small")}


# ---------------------------------------------------------------------------
# tests/test_preemption_equivalence.py, mid-accumulation
# ---------------------------------------------------------------------------

def test_evict_resume_is_transparent(reference, tmp_path):
    cl = _cluster(tmp_path, {"t": IMG}, num_nodes=1)
    rt = cl.nodes["node0"].runtime
    _start_parked(rt, "x", IMG)
    stats = rt.evict("x")
    # params, opt_state (count and moments), grad_acc, loss: all DIRTY
    assert stats["n_dirty"] >= 4
    assert rt.tasks["x"].guest_state.user["chunk_idx"] == 1
    rt.resume("x")
    _assert_equal(_done(rt, "x"), reference["t"])


def test_evict_frees_the_device_state_at_once(tmp_path):
    """With the cyclic garbage collector off, the tensors an evict drops
    die at once: nothing of the port (a tree helper's closure, say) holds
    device memory in a reference cycle until a collection."""
    import gc
    import weakref

    cl = _cluster(tmp_path, {"t": IMG}, num_nodes=1)
    rt = cl.nodes["node0"].runtime
    rec = _start_parked(rt, "x", IMG)
    table = rec.monitor.buffers
    gc.collect()
    gc.disable()
    try:
        refs = [weakref.ref(t) for i in table.ids()
                for t in tree_leaves(table.get(i).device_value)]
        assert len(refs) > 10
        rt.evict("x")
        assert not [r for r in refs if r() is not None]
    finally:
        gc.enable()
    rt.resume("x")
    _done(rt, "x")


def test_migration_is_transparent(reference, tmp_path):
    cl = _cluster(tmp_path, {"t": IMG}, num_nodes=2)
    rt0, rt1 = cl.nodes["node0"].runtime, cl.nodes["node1"].runtime
    _start_parked(rt0, "x", IMG)
    rt0.evict("x")
    rt1.resume("x", source=rt0)
    assert "x" not in rt0.tasks
    _assert_equal(_done(rt1, "x"), reference["t"])


def test_checkpoint_restore_is_transparent(reference, tmp_path):
    cl = _cluster(tmp_path, {"t": IMG}, num_nodes=2)
    rt0, rt1 = cl.nodes["node0"].runtime, cl.nodes["node1"].runtime
    _start_parked(rt0, "x", IMG)
    path = rt0.checkpoint("x", keep_running=False)
    rt0.kill("x")
    rec = rt1.restore("y", path)           # crash-restart on another node
    assert rec.guest_state.user["chunk_idx"] == 1
    assert int(rec.monitor.buffers.get("opt_state").host_value["count"]) == 2
    _assert_equal(_done(rt1, "y"), reference["t"])


def test_int8_moments_survive_checkpoint_restore(tmp_path):
    """The int8 state (moments, f32 row scales, the int32 count) round-trips
    through a format-v2 snapshot mid-accumulation."""
    from repro_torch.train import OptConfig

    img = TaskImage(name="q", kind="train", arch="mamba2-1.3b-smoke",
                    seq_len=16, global_batch=4, total_steps=4, chunks=2,
                    seed=3, opt=OptConfig(warmup_steps=2, decay_steps=100,
                                          moment_dtype="int8"))
    cl = _cluster(tmp_path, {"q": img}, num_nodes=2)
    rt0, rt1 = cl.nodes["node0"].runtime, cl.nodes["node1"].runtime
    rt0.create("u", img)
    rt0.start("u")
    want = _done(rt0, "u")
    _start_parked(rt0, "x", img, at=(1, 1))
    path = rt0.checkpoint("x", keep_running=False)
    rt0.kill("x")
    rec = rt1.restore("y", path)
    st = rec.monitor.buffers.get("opt_state").host_value
    assert set(st) == {"m", "v", "m_scale", "v_scale", "count"}
    assert tree_leaves(st["m"])[0].dtype == torch.int8
    assert st["count"].dtype == torch.int32
    _assert_equal(_done(rt1, "y"), want)


# ---------------------------------------------------------------------------
# tests/test_runtime_cluster.py: the train-image cases
# ---------------------------------------------------------------------------

def test_orchestrated_deploy_to_done(tmp_path):
    cl = _cluster(tmp_path, {"train-small": SMALL, "serve-small": SERVE},
                  num_nodes=2, policy=Policy.PRE_MG, chaos=None)
    try:
        orch = cl.orchestrator
        orch.start(tick_interval=0.01)
        orch.submit("train-small", priority=0)
        orch.submit("serve-small", priority=1)
        assert orch.wait_all(timeout=300)
        for cid, d in orch.deployments.items():
            assert d.status == "done", (cid, d.status)
    finally:
        cl.stop()


def test_evict_migrate_checkpoint_restore(reference, tmp_path):
    cl = _cluster(tmp_path, {"train-small": SMALL}, num_nodes=2)
    rt0, rt1 = cl.nodes["node0"].runtime, cl.nodes["node1"].runtime
    rt0.create("m1", SMALL)
    rt0.start("m1")
    stats = rt0.evict("m1")
    assert stats["n_dirty"] >= 1
    assert rt0.status("m1") == TaskStatus.EVICTED
    # migrate to node1 and finish there
    rt1.resume("m1", source=rt0)
    _assert_equal(_done(rt1, "m1"), reference["train-small"])

    # checkpoint -> kill -> restore elsewhere
    rt0.create("c1", SMALL)
    rt0.start("c1")
    path = rt0.checkpoint("c1")
    rt0.kill("c1")
    rt1.restore("c2", path)
    _assert_equal(_done(rt1, "c2"), reference["train-small"])


def test_preemption_priority_end_to_end(tmp_path):
    """A high-priority task evicts a low-priority one on a 1-slot cluster;
    the preempted task still ends with an uninterrupted run's params."""
    images = {
        # 60 steps (the reference's 30) keep the low task running until
        # the scheduler acts on a loaded host
        "long": TaskImage(name="long", kind="train", arch="yi-9b-smoke",
                          seq_len=16, global_batch=4, total_steps=60,
                          chunks=1),
        "short": TaskImage(name="short", kind="train", arch="yi-9b-smoke",
                           seq_len=16, global_batch=4, total_steps=2,
                           chunks=1),
    }
    cl = _cluster(tmp_path, images, num_nodes=1, policy=Policy.PRE_EV,
                  chaos=None)
    try:
        orch = cl.orchestrator
        orch.start(tick_interval=0.01)
        low = orch.submit("long", priority=0)
        rt = cl.nodes["node0"].runtime
        deadline = time.time() + 60
        while not (low in rt.tasks and rt.tasks[low].guest_state.step >= 1):
            assert time.time() < deadline, "the low task did not start"
            time.sleep(0.002)
        high = orch.submit("short", priority=5)
        assert orch.wait_all(timeout=300)
        assert "evict" in [e for _, e, _ in orch.events]
        assert orch.deployments[low].status == "done"
        assert orch.deployments[high].status == "done"
        got = rt.tasks[low].guest_state.user["final_params"]
    finally:
        cl.stop()
    rt = _cluster(tmp_path / "u", images, num_nodes=1,
                  chaos=None).nodes["node0"].runtime
    rt.create("u", images["long"])
    rt.start("u")
    _assert_equal(_done(rt, "u"), got)


# ---------------------------------------------------------------------------
# tests/test_cri.py: the img train image through the node agent
# ---------------------------------------------------------------------------

@pytest.fixture
def cri(tmp_path):
    cl = _cluster(tmp_path, {"img": SMALL}, num_nodes=2)
    yield cl
    cl.stop()


def test_cri_deploy_maps_to_create_start(cri, reference):
    agent = cri.agent("node0")
    agent.deploy("c1", "img", priority=3, preemptible=True)
    rt = cri.nodes["node0"].runtime
    assert rt.tasks["c1"].priority == 3
    assert rt.tasks["c1"].preemptible
    _assert_equal(_done(rt, "c1"), reference["train-small"])


def test_cri_stop_container_evicts_preemptible(cri, reference):
    agent = cri.agent("node0")
    agent.deploy("c2", "img")
    rt = cri.nodes["node0"].runtime
    agent.evict("c2")                       # StopContainer -> evict
    assert rt.status("c2") == TaskStatus.EVICTED
    agent.resume("c2")                      # StartContainer -> resume
    _assert_equal(_done(rt, "c2"), reference["train-small"])


def test_cri_migrate_uses_source_node_annotation(cri, reference):
    a0, a1 = cri.agent("node0"), cri.agent("node1")
    a0.deploy("c3", "img")
    a0.evict("c3")
    # CreateContainer(cid*, node_id*) -> StartContainer: Table 3 migrate row
    a1.migrate_in("c3", "img", source_node="node0")
    _assert_equal(_done(cri.nodes["node1"].runtime, "c3"),
                  reference["train-small"])
    assert "c3" not in cri.nodes["node0"].runtime.tasks


def test_cri_checkpoint_and_restore_annotations(cri, reference):
    a0, a1 = cri.agent("node0"), cri.agent("node1")
    a0.deploy("c4", "img")
    path = a0.checkpoint("c4")              # CheckpointContainer
    assert path
    a0.engine.runtime.kill("c4")
    a1.restore("c5", path)                  # snapshot annotation
    _assert_equal(_done(cri.nodes["node1"].runtime, "c5"),
                  reference["train-small"])


def test_cri_replicate_annotations(cri):
    """The clone starts from the source's state and trains on the same
    batch stream: both end with the same params."""
    a0, a1 = cri.agent("node0"), cri.agent("node1")
    a0.deploy("c6", "img")
    a1.replicate_in("c6-r", "c6", source_node="node0")
    _assert_equal(_done(cri.nodes["node1"].runtime, "c6-r"),
                  _done(cri.nodes["node0"].runtime, "c6"))


def test_cri_update_vfpga_num(cri):
    a0 = cri.agent("node0")
    a0.deploy("c7", "img")
    a0.update("c7", 4)                      # UpdateContainerResources
    rt0 = cri.nodes["node0"].runtime
    assert rt0.tasks["c7"].vfpga_num == 4
    _done(rt0, "c7")


# ---------------------------------------------------------------------------
# tests/test_straggler.py::test_straggler_detected_and_migrated
# ---------------------------------------------------------------------------

class SlowTrainTask(TrainTask):
    """Simulates a degraded node: every step stalls."""

    def step(self, cl, gs):
        time.sleep(0.6)
        return super().step(cl, gs)


class SlowImage(TaskImage):
    def instantiate(self):
        if getattr(self, "_slow", False):
            return SlowTrainTask(self)
        return super().instantiate()


def test_straggler_detected_and_migrated(tmp_path):
    img = SlowImage(name="j", kind="train", arch="yi-9b-smoke", seq_len=16,
                    global_batch=4, total_steps=40, chunks=1)
    slow_img = SlowImage(name="j-slow", kind="train", arch="yi-9b-smoke",
                         seq_len=16, global_batch=4, total_steps=40, chunks=1)
    slow_img._slow = True
    cl = _cluster(tmp_path, {"j": img, "j-slow": slow_img}, num_nodes=4,
                  policy=Policy.PRE_MG, chaos=None)
    orch = cl.orchestrator
    orch.start(tick_interval=0.02)
    fast = [orch.submit("j") for _ in range(3)]
    slow = orch.submit("j-slow")
    # let everything boot and make measurable progress
    deadline = time.time() + 300
    acted = []
    while time.time() < deadline and not acted:
        time.sleep(1.0)
        if all(orch._sched_tasks[c].state == TaskState.RUNNING
               or orch.deployments[c].status == "done"
               for c in fast + [slow]):
            acted = orch.check_stragglers(min_relative_rate=0.5)
        # fast tasks may finish before detection; that's fine if slow acted
        if orch.deployments[slow].status == "done":
            break
    events = [e for _, e, _ in orch.events]
    if acted:
        assert slow in acted
        assert "straggler_evicted" in events
    assert orch.wait_all(timeout=600)
    orch.stop()
    cl.stop()
