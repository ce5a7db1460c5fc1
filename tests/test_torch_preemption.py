"""The core state-management property (paper §3.4) in the port: a task
that is evicted, migrated, checkpointed and restored mid-run serves exactly
what an uninterrupted run serves, and what the JAX package serves.

yi-9b-smoke in float32 (an f32 variant of yi-9b registered in both
packages' ``ARCHS`` for this module) on ``device="cpu"``.  Both packages
serve on the same weights: the JAX engine's ``params``, converted with
``params_from_jax``, are what the port's ``init_params`` programs return
here (``build_model`` is wrapped for the module).

- ``ServeTask``: the three cases of ``tests/test_preemption_equivalence.py``
  (evict/resume, migration, checkpoint -> kill -> restore on the other
  node); the served tokens equal an uninterrupted run and the reference's
  ``generate``.  A restored task's next checkpoint is incremental against
  the snapshot it came from.
- ``EngineServeTask`` behind ``RequestRouter``, on two hand-wired nodes:
  checkpoint -> node failure (``NodeAgent.fail``, ``FunkyRuntime.crash``,
  ``RequestRouter.fail_engine``) -> restore on the other node, under
  schedules 1, 3 and 4 of ``tests/test_chaos.py`` (a plain crash; a torn
  second checkpoint, after which the first restores; a corrupted newest
  snapshot, which falls back along the chain); replicate; and drain then
  remove.  Every request completes once with the JAX engine's tokens: no
  duplicates, no replay mismatches.

Waits poll for progress (completions, steps); no sleep decides an outcome.
Where an outcome depends on which replica does what, drivers are parked at
step boundaries: the crashed replica always holds a lease, and each of two
replicas leases requests while the other is parked.
"""

import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jcfg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
import repro_torch.models as tmodels  # noqa: E402
from repro_torch.chaos import (FaultPlan, FaultSpec,  # noqa: E402
                               InjectedCrash)
from repro_torch.ckpt import snapshot_candidates  # noqa: E402
from repro_torch.core import (ContainerEngine, FunkyRuntime,  # noqa: E402
                              NodeAgent, SliceAllocator, TaskImage,
                              TaskStatus)
from repro_torch.scaling.metrics import MetricsRegistry  # noqa: E402
from repro_torch.scaling.serving import reset_router  # noqa: E402
from repro_torch.serve.engine import ServeRequest  # noqa: E402
from repro_torch.testing import params_from_jax  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ARCH = "yi-9b-f32-smoke"
PROMPT_LEN = 8
PAGE = 4
MAX_NEW = 6
SLOTS = 2
SPEC = [4, 6, 3, 5, 4, 6]              # max_new_tokens per request

SERVE = TaskImage(name="t", kind="serve", arch=ARCH, prompt_len=PROMPT_LEN,
                  global_batch=2, total_steps=10, tokens_per_step=2, seed=0)
N_TOKENS = SERVE.total_steps * SERVE.tokens_per_step


def _engine_image(name):
    return TaskImage(name=name, kind="engine-serve", arch=ARCH,
                     prompt_len=PROMPT_LEN, global_batch=SLOTS,
                     max_new_tokens=MAX_NEW, page_size=PAGE,
                     total_steps=10 ** 9)


def make_requests(cls=ServeRequest, seed=17):
    rng = np.random.Generator(np.random.Philox(seed))
    return [cls(rid=f"r{i}", prompt=rng.integers(0, 100, PROMPT_LEN),
                max_new_tokens=n) for i, n in enumerate(SPEC)]


@pytest.fixture(scope="module")
def ref():
    """The f32 arch in both packages; the JAX engine's weights and its
    transcript of the workload; the reference ``generate`` tokens of the
    ServeTask batch; the port's ``init_params`` returning those weights."""
    from repro.core import FunkyCL as JFunkyCL
    from repro.core import Monitor as JMonitor
    from repro.core import SliceAllocator as JSliceAllocator
    from repro.models import build_model as jbuild_model
    from repro.serve.engine import ContinuousBatchingEngine as JEngine
    from repro.serve.engine import ServeRequest as JServeRequest
    from repro.serve.serve_step import generate as jgenerate
    from repro.train import make_batch as jmake_batch

    mp = pytest.MonkeyPatch()
    for mod in (jcfg, tcfg):
        base = mod.ARCHS["yi-9b"]
        mp.setitem(mod.ARCHS, "yi-9b-f32", dataclasses.replace(
            base, name="yi-9b-f32", dtype="float32"))
    mon = JMonitor("ref", JSliceAllocator("n0", 1))
    eng = JEngine(ARCH, JFunkyCL(mon), slots=SLOTS, prompt_len=PROMPT_LEN,
                  max_new_tokens=MAX_NEW, page_size=PAGE)
    eng.setup()
    np_params = jax.tree.map(np.asarray, eng.cl.read_buffer("params"))
    for r in make_requests(JServeRequest):
        eng.submit(r)
    eng.run_until_drained()
    tokens = {rid: list(rec.tokens) for rid, rec in eng.completed.items()}
    mon.vfpga_exit()

    jc = jcfg.get_arch(ARCH)
    prompt = jmake_batch(jc, jcfg.base.ShapeConfig(
        "p", "train", PROMPT_LEN, SERVE.global_batch), 0)["tokens"]
    gen = jgenerate(jbuild_model(jc), jax.tree.map(jnp.asarray, np_params),
                    {"tokens": jnp.asarray(prompt)}, N_TOKENS + 1)
    shared = params_from_jax(np_params)

    name = tcfg.get_arch(ARCH).name
    orig = tmodels.build_model

    def build_model(cfg, **kw):
        bundle = orig(cfg, **kw)
        if cfg.name != name:
            return bundle

        def init(seed, device=None):
            if device is not None and torch.device(device).type == "meta":
                return bundle.init(seed, device=device)
            return tree_map(lambda t: t.clone().to(device), shared)
        return dataclasses.replace(bundle, init=init)

    mp.setattr(tmodels, "build_model", build_model)
    yield {"tokens": tokens,
           "last_token": np.asarray(gen)[:, N_TOKENS].tolist()}
    mp.undo()


# ---------------------------------------------------------------------------
# ServeTask: evict/resume, migration, checkpoint -> kill -> restore
# ---------------------------------------------------------------------------
def _runtime(node, tmp_path):
    # a delay on every EXECUTE keeps the task running for a few hundred ms
    # after its setup, where each command below lands; it changes no value
    plan = FaultPlan([FaultSpec(site="monitor.execute", kind="delay",
                                every=1, max_fires=10 ** 6, delay_s=0.01)])
    return FunkyRuntime(node, SliceAllocator(node, 1, device="cpu"),
                        ckpt_root=str(tmp_path / node), chaos=plan)


def _last_token(rt, cid):
    assert rt.wait(cid, timeout=120) is TaskStatus.DONE, rt.tasks[cid].error
    assert rt.tasks[cid].guest_state.step == SERVE.total_steps
    return rt.tasks[cid].guest_state.user["last_token"]


def test_uninterrupted_serve_matches_reference_generate(ref, tmp_path):
    rt = _runtime("node0", tmp_path)
    rt.create("ref", SERVE)
    rt.start("ref")
    assert _last_token(rt, "ref") == ref["last_token"]


def test_evict_resume_is_transparent(ref, tmp_path):
    rt = _runtime("node0", tmp_path)
    rt.create("x", SERVE)
    rt.start("x")
    stats = rt.evict("x")                   # waits for setup, then parks
    assert rt.tasks["x"].guest_state.step < SERVE.total_steps
    assert stats["saved_bytes"] > 0
    rt.resume("x")
    assert _last_token(rt, "x") == ref["last_token"]


def test_migration_is_transparent(ref, tmp_path):
    rt0, rt1 = _runtime("node0", tmp_path), _runtime("node1", tmp_path)
    rt0.create("x", SERVE)
    rt0.start("x")
    rt0.evict("x")
    assert rt0.tasks["x"].guest_state.step < SERVE.total_steps
    rt1.resume("x", source=rt0)
    assert "x" not in rt0.tasks and rt0.allocator.free_count() == 1
    assert _last_token(rt1, "x") == ref["last_token"]


def test_checkpoint_restore_is_transparent(ref, tmp_path):
    rt0, rt1 = _runtime("node0", tmp_path), _runtime("node1", tmp_path)
    rt0.create("x", SERVE)
    rt0.start("x")
    path = rt0.checkpoint("x", keep_running=False)
    assert rt0.tasks["x"].status is TaskStatus.EVICTED
    rt0.kill("x")
    rt1.restore("y", path)                  # crash-restart on another node
    assert _last_token(rt1, "y") == ref["last_token"]
    kinds = [e[1] for e in rt1.tasks["y"].timeline]
    assert kinds[:3] == ["restore", "resume", "restored"]


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_restored_task_checkpoints_incrementally(ref, tmp_path):
    """Write versions survive a restore: the restored task's next
    checkpoint references only the buffers it has not written since
    (weights, prompt), rewrites the rest, and restores to the reference's
    tokens."""
    rt0, rt1 = _runtime("node0", tmp_path), _runtime("node1", tmp_path)
    rt0.create("x", SERVE)
    rt0.start("x")
    p1 = rt0.checkpoint("x", keep_running=False)
    rt0.kill("x")
    m1 = _manifest(p1)
    rt1.restore("y", p1)
    gs = rt1.tasks["y"].guest_state
    _await(lambda: gs.step > m1["step"], "a step after the restore")
    p2 = rt1.checkpoint("y", keep_running=False)
    rt1.kill("y")
    m2 = _manifest(p2)
    assert m2["prev_path"] == os.path.abspath(p1)
    v1, v2 = m1["versions"], m2["versions"]
    unchanged = {b for b in v1 if v2[b] == v1[b]}
    assert unchanged == {"params", "prompt"}
    assert all(v2[b] > v1[b] for b in set(v1) - unchanged), (v1, v2)
    referenced = {b for b, f in m2["buffers"].items()
                  if os.path.dirname(f) == os.path.abspath(p1)}
    assert referenced == unchanged
    rt0.restore("z", p2)
    assert _last_token(rt0, "z") == ref["last_token"]


# ---------------------------------------------------------------------------
# EngineServeTask on two nodes
# ---------------------------------------------------------------------------
def make_nodes(tmp_path, name, chaos=None):
    reg = MetricsRegistry()
    if chaos is not None:
        chaos.registry = reg
    images = {name: _engine_image(name)}
    engines, agents = {}, {}
    for nid in ("node0", "node1"):
        rt = FunkyRuntime(nid, SliceAllocator(nid, 1, device="cpu"),
                          ckpt_root=str(tmp_path / nid), telemetry=reg,
                          chaos=chaos)
        engines[nid] = ContainerEngine(rt, images, peers=engines)
        agents[nid] = NodeAgent(nid, engines[nid], metrics=reg, chaos=chaos)
    return agents, reg


def _await(cond, what, timeout=120):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.002)
    assert cond(), f"timed out waiting for {what}"


def _finish(router, agents_cids):
    _await(lambda: router.outstanding() == 0, "every request")
    router.close()
    for agent, cid in agents_cids:
        rt = agent.engine.runtime
        assert rt.wait(cid, timeout=120) is TaskStatus.DONE, \
            rt.tasks[cid].error


def _assert_conserved(router, ref):
    """Zero lost, zero duplicated, the JAX engine's tokens."""
    assert sorted(router.completed) == sorted(ref["tokens"])
    assert router.duplicates == 0
    assert router.replay_mismatches == 0
    got = {rid: list(rec.tokens) for rid, rec in router.completed.items()}
    assert got == ref["tokens"]


def _hold_with_a_lease(rec, router, after):
    """From inside the replica's driver: once ``after`` requests have
    completed, park the driver at the end of every step that leaves a
    lease held.  A checkpoint releases it for a step or two; a crash then
    always finds leases to replay."""
    step = rec.task.step

    def held_step(cl, gs):
        done = step(cl, gs)
        if len(router.completed) >= after and router.in_flight > 0:
            rec.run_gate.clear()
        return done
    rec.task.step = held_step


@pytest.mark.parametrize("schedule", [1, 3, 4])
def test_checkpoint_crash_replay_restore(ref, tmp_path, schedule):
    name = f"crash-{schedule}"
    plan = FaultPlan(seed=schedule)
    agents, reg = make_nodes(tmp_path, name, chaos=plan)
    a0, a1 = agents["node0"], agents["node1"]
    rt0 = a0.engine.runtime
    router = reset_router(name)
    a0.deploy("e", name)
    rec0 = rt0.tasks["e"]
    _hold_with_a_lease(rec0, router, after=2 if schedule == 1 else 1)
    for r in make_requests():
        router.submit(r)
    _await(lambda: not rec0.run_gate.is_set(), "the first completions")
    p1 = a0.checkpoint("e")
    if schedule == 3:
        # the second checkpoint is torn mid-write: only hidden debris
        plan.add(FaultSpec(site="ckpt.save", kind="torn", at=1))
        with pytest.raises(InjectedCrash):
            a0.checkpoint("e")
    if schedule == 4:
        # a later step, so the second snapshot chains to the first
        gs = rt0.tasks["e"].guest_state
        step1 = int(p1.rsplit("-step", 1)[1])
        _await(lambda: gs.step > step1, "a later step")
        plan.add(FaultSpec(site="ckpt.corrupt", kind="corrupt", at=1))
        p2 = a0.checkpoint("e")             # published, then bit-flipped
        assert p2 != p1
        assert [e for e in rt0.tasks["e"].timeline
                if e[1] == "checkpoint"][-1][2]["reused_buffers"] >= 1
    roots = [a.engine.runtime.ckpt_root for a in agents.values()]
    newest = snapshot_candidates(roots, "e")[0]
    assert newest == (p2 if schedule == 4 else p1)
    # node0 fails hard while it holds a lease: no on_kill hook, the
    # router replays the lease with the tokens it had committed
    _await(lambda: not rec0.run_gate.is_set(), "a held lease")
    a0.fail()
    rt0.crash("e")
    replayed = router.fail_engine("e")
    assert replayed >= 1 and replayed == len(router.replayed)
    assert any(router.replayed.values()), router.replayed
    a1.restore("e", newest)
    rec = a1.engine.runtime.tasks["e"]
    assert rec.latest_snapshot == p1
    _finish(router, [(a1, "e")])
    _assert_conserved(router, ref)
    kinds = [e[1] for e in reg.flight_record()["events"]]
    assert ("restore_fallback" in kinds) == (schedule == 4)
    assert "router_replay" in kinds


def test_replicate_serves_from_both_replicas(ref, tmp_path):
    name = "replicate"
    agents, _ = make_nodes(tmp_path, name)
    a0, a1 = agents["node0"], agents["node1"]
    rt0, rt1 = a0.engine.runtime, a1.engine.runtime
    router = reset_router(name)
    a0.deploy("r0", name)
    a1.replicate_in("r1", "r0", source_node="node0")
    # one replica at a time pulls, so each leases requests of its own
    reqs = make_requests()
    rt0._park_driver(rt0.tasks["r0"])
    for r in reqs[:SLOTS]:
        router.submit(r)
    _await(lambda: router.pending_count() == 0, "r1's leases")
    rt1._park_driver(rt1.tasks["r1"])
    for r in reqs[SLOTS:]:
        router.submit(r)
    rt0.tasks["r0"].run_gate.set()
    _await(lambda: router.pending_count() < len(reqs) - SLOTS,
           "r0's leases")
    rt1.tasks["r1"].run_gate.set()
    _finish(router, [(a0, "r0"), (a1, "r1")])
    _assert_conserved(router, ref)
    served = [a.engine.runtime.tasks[c].guest_state.user["completed"]
              for a, c in ((a0, "r0"), (a1, "r1"))]
    assert sum(served) == len(SPEC) and min(served) >= 1, served


def test_drain_then_remove_requeues_nothing(ref, tmp_path, monkeypatch):
    name = "drain"
    agents, _ = make_nodes(tmp_path, name)
    a0 = agents["node0"]
    router = reset_router(name)
    requeued = []
    orig = router.requeue
    monkeypatch.setattr(router, "requeue",
                        lambda reqs: (requeued.extend(reqs), orig(reqs)))
    a0.deploy("r0", name)
    for r in make_requests():
        router.submit(r)
    _await(lambda: router.in_flight > 0, "a leased request")
    stats = a0.drain("r0")
    assert stats["drained"] and a0.task_status("r0") is TaskStatus.DONE
    assert router.in_flight == 0            # held lanes finished, no lease
    held = set(router.completed)
    assert held and router.pending_count() == len(SPEC) - len(held)
    a0.remove("r0")
    assert a0.task_status("r0") is None and requeued == []
    a0.deploy("r1", name)                   # a new replica serves the rest
    _finish(router, [(a0, "r1")])
    _assert_conserved(router, ref)
