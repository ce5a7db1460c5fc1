"""The port's control plane on a live in-process cluster: ``make_cluster`` ->
``Orchestrator`` (``FunkyScheduler``, ``PlacementPolicy``, autoscaler) ->
``NodeAgent`` -> ``ContainerEngine`` -> ``FunkyRuntime``, on
``device="cpu"``.

yi-9b-smoke in float32 (an f32 variant of yi-9b registered in both
packages' ``ARCHS`` for this module).  Both packages serve on the same
weights: the JAX engine's ``params``, converted with ``params_from_jax``,
are what the port's ``init_params`` programs return here (``build_model``
is wrapped for the module).  A replica the orchestrator creates gets them
from its snapshot (replicate, restore); a resubmitted one redraws them from
its image's seed, which on the CPU means the wrapped ``init`` writes the
shared weights again.

- The serve-image cases of ``tests/test_runtime_cluster.py``.
- The orchestrator soak schedules of ``tests/test_chaos.py``: a node crash
  mid-decode after a checkpoint (1), and a corrupted newest snapshot that
  falls back to the previous one (4).
- The slice as a whole, through ``drive_engine_open_loop``: batch tasks
  fill the cluster, the service preempts one by Algorithm 1, the
  autoscaler scales it out and back in; and once a replica's node fails
  while it holds leases (replay, resubmit).  Every request completes once
  with the JAX engine's tokens for its prompt.

Waits poll conditions with generous deadlines; no sleep decides an
outcome.  Where an outcome needs a replica to hold a lease, its driver is
parked at the end of a step that leaves one held.  Every test stops its
cluster in ``finally``.
"""

import dataclasses
import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jcfg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
import repro_torch.models as tmodels  # noqa: E402
from repro_torch.chaos import FaultPlan, FaultSpec  # noqa: E402
from repro_torch.core import (NodeFailed, Policy, TaskImage,  # noqa: E402
                              TaskStatus, make_cluster)
from repro_torch.scaling import (Autoscaler, OrchestratorScaler,  # noqa: E402
                                 QueueLengthPolicy, burst_rate,
                                 drive_engine_open_loop, open_loop,
                                 reset_router, teardown_service,
                                 wait_for_service)
from repro_torch.serve.engine import ServeRequest  # noqa: E402
from repro_torch.testing import params_from_jax  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ARCH = "yi-9b-f32-smoke"
PROMPT_LEN = 8
PAGE = 4
MAX_NEW = 6
SLOTS = 2
SPEC = [4, 6, 3, 5, 4, 6]              # max_new_tokens per soak request
DRIVE_SEED = 1234                      # drive_engine_open_loop's prompts


def _engine_image(name):
    return TaskImage(name=name, kind="engine-serve", arch=ARCH,
                     prompt_len=PROMPT_LEN, global_batch=SLOTS,
                     max_new_tokens=MAX_NEW, page_size=PAGE,
                     total_steps=10 ** 9)


def _serve_image(name, total_steps=10):
    return TaskImage(name=name, kind="serve", arch=ARCH,
                     prompt_len=PROMPT_LEN, global_batch=2,
                     total_steps=total_steps, tokens_per_step=2)


def make_requests(cls=ServeRequest, seed=17):
    rng = np.random.Generator(np.random.Philox(seed))
    return [cls(rid=f"r{i}", prompt=rng.integers(0, 100, PROMPT_LEN),
                max_new_tokens=n) for i, n in enumerate(SPEC)]


# the drive workloads: a burst that queues past one replica's two lanes
DRIVES = {
    "scale": lambda: open_loop(burst_rate(10.0, 60.0, 0.0, 0.05), 0.1,
                               seed=41, tokens_range=(4, 7)),
    "fail": lambda: open_loop(burst_rate(8.0, 20.0, 0.0, 0.1), 2.0,
                              seed=43, tokens_range=(4, 7)),
}


def drive_requests(reqs):
    """The requests ``drive_engine_open_loop`` submits for ``reqs``: its
    prompts are drawn in arrival order from ``Philox(1234)``."""
    rng = np.random.Generator(np.random.Philox(DRIVE_SEED))
    return [(r.rid, rng.integers(0, 512, PROMPT_LEN), r.n_tokens)
            for r in sorted(reqs, key=lambda r: r.arrival_t)]


@pytest.fixture(scope="module")
def ref():
    """The f32 arch in both packages; the JAX engine's weights and its
    transcript of every workload here; the port's ``init_params``
    returning those weights."""
    from repro.core import FunkyCL as JFunkyCL
    from repro.core import Monitor as JMonitor
    from repro.core import SliceAllocator as JSliceAllocator
    from repro.serve.engine import ContinuousBatchingEngine as JEngine
    from repro.serve.engine import ServeRequest as JServeRequest

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
    for w, make in DRIVES.items():
        for rid, prompt, n in drive_requests(make()):
            eng.submit(JServeRequest(rid=f"{w}:{rid}", prompt=prompt,
                                     max_new_tokens=n))
    eng.run_until_drained()
    tokens = {rid: list(rec.tokens) for rid, rec in eng.completed.items()}
    mon.vfpga_exit()
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
    yield {"soak": {r.rid: tokens[r.rid] for r in make_requests()},
           **{w: {rid.split(":", 1)[1]: t for rid, t in tokens.items()
                  if rid.startswith(f"{w}:")} for w in DRIVES}}
    mp.undo()


def _await(cond, what, timeout=120):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.002)
    assert cond(), f"timed out waiting for {what}"


def _events(orch):
    return [e[1] for e in orch.events]


def _assert_served(router, want):
    """Zero lost, zero duplicated, the JAX engine's tokens."""
    assert sorted(router.completed) == sorted(want)
    assert router.duplicates == 0
    assert router.replay_mismatches == 0
    got = {rid: list(rec.tokens) for rid, rec in router.completed.items()}
    assert got == want


def _hold_own_lease(rec, router):
    """From inside the replica's driver: park it at the end of every step
    after which it still holds a lease of its own.  A checkpoint releases
    it for a step; a crash then always finds leases to replay."""
    step = rec.task.step

    def held_step(cl, gs):
        done = step(cl, gs)
        with router._lock:
            own = any(eng == rec.cid for _, eng in router._leases.values())
        if own:
            rec.run_gate.clear()
        return done
    rec.task.step = held_step


def _slow_plan(match):
    """A delay on every EXECUTE of the matching tasks keeps them running
    long enough for the command under test to land; it changes no
    value."""
    return FaultPlan([FaultSpec(site="monitor.execute", kind="delay",
                                every=1, max_fires=10 ** 6, delay_s=0.01,
                                match=match)])


# ---------------------------------------------------------------------------
# make_cluster and the node agent's introspection
# ---------------------------------------------------------------------------
@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")


def test_make_cluster_defaults_to_the_card(no_card, tmp_path):
    with pytest.raises(RuntimeError):
        make_cluster(num_nodes=1, ckpt_root=str(tmp_path))
    cl = make_cluster(num_nodes=2, slices_per_node=2, device="cpu",
                      ckpt_root=str(tmp_path), failure_domains=1)
    try:
        assert {n.allocator.device.type for n in cl.nodes.values()} == \
            {"cpu"}
        assert [cl.agent(n).failure_domain for n in cl.nodes] == \
            ["dom0", "dom0"]
        assert cl.agent("node0").num_slices() == 2
        assert cl.metrics is cl.orchestrator.metrics
    finally:
        cl.stop()
    from repro_torch.obs import Tracer

    tracer = Tracer()
    cl = make_cluster(num_nodes=1, device="cpu", ckpt_root=str(tmp_path),
                      tracer=tracer)
    try:
        assert cl.orchestrator.tracer is tracer
        assert tracer.find("cluster") is not None
    finally:
        cl.stop()


def test_node_agent_introspection(ref, tmp_path):
    cl = make_cluster(num_nodes=2, slices_per_node=1, device="cpu",
                      images={"s": _serve_image("s")},
                      ckpt_root=str(tmp_path))
    try:
        a0, a1 = cl.agent("node0"), cl.agent("node1")
        assert (a0.failure_domain, a1.failure_domain) == ("node0", "node1")
        assert a0.warm_programs() == () and a0.task_programs("x") is None
        a0.deploy("t", "s")
        rt0 = a0.engine.runtime
        assert rt0.wait("t", timeout=120) is TaskStatus.DONE
        assert a0.task_programs("t") == ("init_params", "prefill", "decode")
        assert set(a0.warm_programs()) == {"init_params", "prefill",
                                           "decode"}
        assert a0.task_progress("t") == 10
        assert a1.task_progress("t") is None
        a1.fail()
        for call in (a1.warm_programs, lambda: a1.task_progress("t"),
                     lambda: a1.task_programs("t")):
            with pytest.raises(NodeFailed):
                call()
        assert a1.num_slices() == 1        # hardware inventory, no health
    finally:
        cl.stop()


def test_tasks_of_two_models_run_their_own_programs():
    """Two tasks on one node register different ``init_params`` programs
    with one signature (a seed): each EXECUTE runs its own task's program,
    while the node cache counts the second registration as warm."""
    from repro_torch.core import (FunkyCL, Monitor, Program, ProgramCache,
                                  SliceAllocator)

    alloc, cache = SliceAllocator("n0", 2, device="cpu"), ProgramCache()
    got = []
    for width in (3, 5):
        cl = FunkyCL(Monitor(f"t{width}", alloc, programs=cache))
        cl.clCreateProgramWithBinary(Program(
            "init_params", lambda seed, w=width: torch.full((w,), seed)),
            (0,))
        cl.clCreateBuffer("params", torch.empty(width, device="meta"))
        cl.clEnqueueKernel("init_params", (), ("params",), const_args=(7,))
        cl.clFinish()
        got.append(cl.read_buffer("params").tolist())
    assert got == [[7] * 3, [7] * 5]
    assert cache.stats["hits"] >= 1 and cache.program_ids() == \
        ("init_params",)


# ---------------------------------------------------------------------------
# tests/test_runtime_cluster.py, serve images
# ---------------------------------------------------------------------------
@pytest.fixture
def cluster(ref, tmp_path):
    images = {"serve-small": _serve_image("serve-small"),
              "serve-other": TaskImage(name="serve-other", kind="serve",
                                       arch=ARCH, prompt_len=PROMPT_LEN,
                                       global_batch=4, total_steps=6,
                                       tokens_per_step=3)}
    cl = make_cluster(num_nodes=2, slices_per_node=1, images=images,
                      policy=Policy.PRE_MG, device="cpu",
                      ckpt_root=str(tmp_path), chaos=_slow_plan(""))
    try:
        yield cl
    finally:
        cl.stop()


def _last_token(rt, cid, steps=10):
    assert rt.wait(cid, timeout=120) is TaskStatus.DONE, rt.tasks[cid].error
    assert rt.tasks[cid].guest_state.step == steps
    return rt.tasks[cid].guest_state.user["last_token"]


def test_orchestrated_deploy_to_done(cluster):
    orch = cluster.orchestrator
    orch.start(tick_interval=0.01)
    orch.submit("serve-other", priority=0)
    orch.submit("serve-small", priority=1)
    assert orch.wait_all(timeout=120)
    for cid, d in orch.deployments.items():
        assert d.status == "done", (cid, d.status)
    assert _events(orch).count("deploy") == 2


def test_evict_migrate_checkpoint_restore(cluster):
    rt0 = cluster.nodes["node0"].runtime
    rt1 = cluster.nodes["node1"].runtime
    img = cluster.images["serve-small"]

    rt0.create("u", img)
    rt0.start("u")
    want = _last_token(rt0, "u")
    rt0.create("m1", img)
    rt0.start("m1")
    stats = rt0.evict("m1")
    assert stats["n_dirty"] >= 1
    assert rt0.status("m1") == TaskStatus.EVICTED
    # migrate to node1 and finish there
    rt1.resume("m1", source=rt0)
    assert _last_token(rt1, "m1") == want

    # checkpoint -> kill -> restore elsewhere
    rt0.create("c1", img)
    rt0.start("c1")
    path = rt0.checkpoint("c1")
    rt0.kill("c1")
    rt1.restore("c2", path)
    assert _last_token(rt1, "c2") == want


def test_replicate_horizontal_scaling(cluster):
    rt0 = cluster.nodes["node0"].runtime
    rt1 = cluster.nodes["node1"].runtime
    img = cluster.images["serve-small"]
    rt0.create("s1", img)
    rt0.start("s1")
    new_cid = rt0.replicate("s1", rt1, new_cid="s1-rep")
    assert _last_token(rt1, new_cid) == _last_token(rt0, "s1")


def test_vertical_scaling_update(cluster):
    rt0 = cluster.nodes["node0"].runtime
    img = cluster.images["serve-small"]
    rt0.create("v1", img)
    rt0.start("v1")
    rt0.update("v1", vfpga_num=2)
    assert rt0.tasks["v1"].vfpga_num == 2
    assert rt0.wait("v1", timeout=120) == TaskStatus.DONE


def test_node_failure_recovery(ref, tmp_path):
    cl = make_cluster(num_nodes=2, slices_per_node=1, device="cpu",
                      images={"s": _serve_image("s", total_steps=40)},
                      policy=Policy.PRE_MG, ckpt_root=str(tmp_path),
                      chaos=_slow_plan(""))
    try:
        orch = cl.orchestrator
        orch.start(tick_interval=0.01)
        cid = orch.submit("s")
        node = wait_for_service(cl, orch, cid, timeout_s=120)
        orch.checkpoint(cid)
        orch.handle_node_failure(node)
        assert orch.wait_all(timeout=120)
        assert orch.deployments[cid].status == "done"
        assert "restored" in _events(orch)
        other = "node1" if node == "node0" else "node0"
        rt = cl.nodes[other].runtime
        assert rt.tasks[cid].guest_state.step == 40
    finally:
        cl.stop()


def test_preemption_priority_end_to_end(ref, tmp_path):
    """High-priority task evicts a low-priority one on a 1-slot cluster."""
    images = {"long": _serve_image("long", total_steps=200),
              "short": _serve_image("short", total_steps=2)}
    cl = make_cluster(num_nodes=1, slices_per_node=1, images=images,
                      policy=Policy.PRE_EV, device="cpu",
                      ckpt_root=str(tmp_path), chaos=_slow_plan(""))
    try:
        orch = cl.orchestrator
        orch.start(tick_interval=0.01)
        low = orch.submit("long", priority=0)
        rt = cl.nodes["node0"].runtime
        _await(lambda: low in rt.tasks
               and rt.tasks[low].guest_state.step >= 1, "the low task")
        high = orch.submit("short", priority=5)
        assert orch.wait_all(timeout=300)
        assert "evict" in _events(orch)    # the low task was preempted
        assert orch.deployments[low].status == "done"
        assert orch.deployments[high].status == "done"
        assert rt.tasks[low].guest_state.step == 200
    finally:
        cl.stop()


# ---------------------------------------------------------------------------
# tests/test_chaos.py's orchestrator soak schedules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("schedule", [1, 4])
def test_soak_checkpoint_crash_replay_restore(ref, tmp_path, schedule):
    """Schedule 1: checkpoint, then hard-crash the serving node while it
    holds leases; they replay through the router and the restored replica
    finishes everything.  Schedule 4: the newest of two checkpoints is
    bit-flipped after publishing; the restore falls back to the first."""
    name = f"soak-{schedule}"
    plan = FaultPlan(seed=schedule)
    cl = make_cluster(num_nodes=2, slices_per_node=1, device="cpu",
                      images={name: _engine_image(name)},
                      ckpt_root=str(tmp_path), chaos=plan)
    plan.registry = cl.metrics
    router = reset_router(name)
    router.registry = cl.metrics
    orch = cl.orchestrator
    orch.start(tick_interval=0.01)
    try:
        cid = orch.submit(name)
        node = wait_for_service(cl, orch, cid, timeout_s=120)
        rec = cl.nodes[node].runtime.tasks[cid]
        _hold_own_lease(rec, router)
        for r in make_requests():
            router.submit(r)
        _await(lambda: not rec.run_gate.is_set(), "a held lease")
        p1 = orch.checkpoint(cid)
        if schedule == 4:
            # a later step, so the second snapshot chains to the first
            step1 = int(p1.rsplit("-step", 1)[1])
            _await(lambda: rec.guest_state.step > step1, "a later step")
            plan.add(FaultSpec(site="ckpt.corrupt", kind="corrupt", at=1))
            p2 = orch.checkpoint(cid)      # published, then bit-flipped
            assert p2 != p1
        assert orch._latest_snapshot_any(cid) == (p2 if schedule == 4
                                                  else p1)
        _await(lambda: not rec.run_gate.is_set(), "a held lease")
        orch.handle_node_failure(node)
        _await(lambda: router.outstanding() == 0, "every request")
        _assert_served(router, ref["soak"])
        events = _events(orch)
        assert "restored" in events and "router_replay" in events
        assert router.replayed and any(router.replayed.values())
        kinds = [e[1] for e in cl.metrics.flight_record()["events"]]
        assert ("restore_fallback" in kinds) == (schedule == 4)
        other = "node1" if node == "node0" else "node0"
        assert cl.nodes[other].runtime.tasks[cid].latest_snapshot == p1
    finally:
        router.close()
        cl.stop()


# ---------------------------------------------------------------------------
# the slice as a whole: make_cluster -> Orchestrator -> ... -> engine
# ---------------------------------------------------------------------------
def _last_tokens(cl, cids):
    out = {}
    for n in cl.nodes.values():
        for cid in cids:
            rec = n.runtime.tasks.get(cid)
            if rec is not None and rec.status is TaskStatus.DONE:
                out[cid] = rec.guest_state.user["last_token"]
    return out


def test_service_preempts_then_scales_out_and_in(ref, tmp_path):
    """Two batch tasks fill both slices; the service (priority 5) gets one
    by an Algorithm 1 eviction, and the evicted batch task finishes where
    a slice frees with the tokens of the uninterrupted one.  Then a burst
    through ``drive_engine_open_loop`` makes the autoscaler replicate the
    service, and the drained backlog makes it scale back in.

    The router holds the burst's backlog until the drive has seen both
    replicas (its ``on_tick`` report): otherwise, on a loaded host, the
    one replica could drain the 0.1 s burst before the clone lands, and
    the drive would end without ever counting two replicas.

    The drive closes the router at its end, and a replica on a closed,
    empty router ends by itself: the close waits until ``teardown_service``
    has removed the service, or the replica could end, and be reaped as
    done, before the teardown."""
    name = "svc-a"
    cl = make_cluster(num_nodes=2, slices_per_node=1, device="cpu",
                      images={name: _engine_image(name),
                              "batch": _serve_image("batch",
                                                    total_steps=120)},
                      policy=Policy.PRE_MG, ckpt_root=str(tmp_path),
                      chaos=_slow_plan("batch-"))
    orch = cl.orchestrator
    router = reset_router(name)
    router.registry = orch.metrics
    close = router.close
    scaler = None
    orch.start(tick_interval=0.01)
    try:
        batch = [orch.submit("batch", cid=f"batch-{i}") for i in range(2)]
        for b in batch:
            _await(lambda: any(
                b in n.runtime.tasks
                and n.runtime.tasks[b].guest_state.step >= 1
                for n in cl.nodes.values()), f"{b} running")
        svc = orch.submit(name, priority=5)
        wait_for_service(cl, orch, svc, timeout_s=120)
        evicted = [e[2]["cid"] for e in orch.events if e[1] == "evict"]
        assert len(evicted) == 1 and evicted[0] in batch
        _await(lambda: all(orch.deployments[b].status == "done"
                           for b in batch), "the batch tasks")
        assert {"resume", "migrate"} & set(_events(orch))
        last = _last_tokens(cl, batch)
        assert len(last) == 2 and last[batch[0]] == last[batch[1]]

        scaler = OrchestratorScaler(orch, svc, service=name,
                                    drain_timeout_s=30.0)
        asc = Autoscaler(QueueLengthPolicy(0.5), min_replicas=1,
                         max_replicas=2, scale_down_cooldown_s=0.3)
        orch.attach_autoscaler(asc, scaler, service=name, interval_s=0.02)
        two_seen = threading.Event()
        pop = router.pop

        def held_pop(n, engine_id=None):
            return pop(n, engine_id=engine_id) if two_seen.is_set() else []

        def on_tick(now, n_rep, pending, p95):
            if n_rep == 2:
                two_seen.set()

        router.pop = held_pop
        router.close = lambda: None
        res = drive_engine_open_loop(
            orch, scaler, DRIVES["scale"](), duration_s=0.1, slo_s=10.0,
            service=name, prompt_len=PROMPT_LEN, slots_per_replica=SLOTS,
            tick_s=0.01, drain_timeout_s=120.0, on_tick=on_tick)
        _await(lambda: "scale_in" in _events(orch), "the scale-in")
        assert res.max_replicas == 2 and "replicate" in _events(orch)
        assert res.served == len(ref["scale"])
        want = {rid: p for rid, p, _ in drive_requests(DRIVES["scale"]())}
        assert all(np.array_equal(res.prompts[r], p)
                   for r, p in want.items())
        _assert_served(router, ref["scale"])
    finally:
        if scaler is not None:
            teardown_service(orch, scaler)
        close()
        cl.stop()
    assert orch.deployments[svc].status == "removed"


def test_service_survives_a_replica_node_failure(ref, tmp_path):
    """Scaled out to two replicas, the clone's node fails while the clone
    holds leases: they replay through the router, the clone is
    resubmitted (no snapshot) onto the spare node, and every request
    completes once with the JAX engine's tokens."""
    name = "svc-b"
    cl = make_cluster(num_nodes=3, slices_per_node=1, device="cpu",
                      images={name: _engine_image(name)},
                      policy=Policy.PRE_MG, ckpt_root=str(tmp_path))
    orch = cl.orchestrator
    router = reset_router(name)
    router.registry = orch.metrics
    scaler = OrchestratorScaler(orch, "task-0001", service=name)
    orch.start(tick_interval=0.01)
    out = {}

    def drive():
        try:
            out["res"] = drive_engine_open_loop(
                orch, scaler, DRIVES["fail"](), duration_s=2.0, slo_s=10.0,
                service=name, prompt_len=PROMPT_LEN,
                slots_per_replica=SLOTS, tick_s=0.01,
                drain_timeout_s=120.0)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            out["error"] = e

    driver = None
    try:
        svc = orch.submit(name, priority=5)
        assert svc == scaler.base_cid
        wait_for_service(cl, orch, svc, timeout_s=120)
        asc = Autoscaler(QueueLengthPolicy(0.5), min_replicas=1,
                         max_replicas=2, scale_down_cooldown_s=1e9)
        orch.attach_autoscaler(asc, scaler, service=name, interval_s=0.02)
        driver = threading.Thread(target=drive, name="test-drive")
        driver.start()
        _await(lambda: scaler.replica_cids, "the scale-out")
        clone = scaler.replica_cids[0]
        node = orch._sched_tasks[clone].node_id
        rec = cl.nodes[node].runtime.tasks[clone]
        _hold_own_lease(rec, router)
        _await(lambda: not rec.run_gate.is_set(), "the clone's lease")
        orch.handle_node_failure(node)
        driver.join(timeout=300)
        assert not driver.is_alive() and "error" not in out, out
        assert out["res"].served == len(ref["fail"])
        events = _events(orch)
        assert "resubmitted" in events and "router_replay" in events
        after = orch.events[events.index("resubmitted"):]
        assert any(e[1] == "deploy" and e[2]["cid"] == clone for e in after)
        assert orch._sched_tasks[clone].node_id not in (None, node)
        assert router.replayed and any(router.replayed.values())
        _assert_served(router, ref["fail"])
    finally:
        router.close()
        if driver is not None:
            driver.join(timeout=300)
        teardown_service(orch, scaler)
        cl.stop()
