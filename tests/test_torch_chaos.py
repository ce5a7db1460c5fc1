"""Deterministic fault injection and recovery on the port (the cases of
``tests/test_chaos.py`` that no other ``test_torch_*`` file carries), on
the CPU at yi-9b-smoke with pages of 4.

Mapping of ``tests/test_chaos.py``, by what each case asserts:

=====================================================  ====================
reference case                                         port case
=====================================================  ====================
test_fault_plan_deterministic                          here
test_fault_plan_at_every_match                         here
test_fault_plan_records_registry_events                here
test_retry_call_backoff_and_deadline                   here
test_monitor_execute_retry_bit_exact                   here (engine level;
                                                       the monitor alone:
                                                       test_torch_monitor::
                                                       test_execute_retries_
                                                       transient_faults)
test_monitor_execute_retry_exhaustion_fails_request    here (engine level;
                                                       test_torch_monitor::
                                                       test_execute_fails_
                                                       after_the_retry_
                                                       budget)
test_pipelined_execute_error_surfaces_exactly_once     here (kind error; a
                                                       crash: test_torch_
                                                       engine::test_failed_
                                                       execute_raises_once_
                                                       and_replays)
test_delayed_pipelined_execute_carried_to_next_        here
boundary
test_soak_node_crash_mid_decode (schedule 1)           test_torch_cluster::
                                                       test_soak_checkpoint_
                                                       crash_replay_restore
                                                       [1]; test_torch_
                                                       preemption::test_
                                                       checkpoint_crash_
                                                       replay_restore[1]
test_soak_transient_execute_faults (schedule 2)        here
test_soak_torn_checkpoint_then_crash (schedule 3)      test_torch_preemption
                                                       ::test_checkpoint_
                                                       crash_replay_
                                                       restore[3]
test_soak_corrupt_snapshot_falls_back (schedule 4)     test_torch_cluster
                                                       [4]; test_torch_
                                                       preemption[4]
test_soak_restore_failure_retried (schedule 5)         here
test_replay_links_recovery_traces                      test_torch_obs::test_
                                                       replay_links_
                                                       recovery_traces
test_duplicate_completion_guard                        here
=====================================================  ====================

Also here: the ``router.pop`` and ``kv.transfer`` sites of the port's
``FaultPlan`` (their reactions, and a delayed pop that changes nothing).
The soak schedules run ``make_cluster(device="cpu")``; the engine cases
drive the engine synchronously, so every outcome is decided by the order
of calls, and the soaks wait on conditions with deadlines, never on a
sleep's length.  Tokens are held to a fault-free run of the same weights.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.chaos import (FaultPlan, FaultSpec,  # noqa: E402
                               InjectedCrash, InjectedFault, RetryPolicy,
                               retry_call)
from repro_torch.core import (FunkyCL, Monitor, SliceAllocator,  # noqa: E402
                              TaskImage, make_cluster)
from repro_torch.scaling.metrics import MetricsRegistry  # noqa: E402
from repro_torch.scaling.serving import (RequestRouter,  # noqa: E402
                                         reset_router, wait_for_service)
from repro_torch.serve.engine import (CompletedRequest,  # noqa: E402
                                      ContinuousBatchingEngine,
                                      ServeRequest)

ARCH = "yi-9b-smoke"
PROMPT_LEN = 8
PAGE = 4
MAX_NEW = 6
SLOTS = 2
SPEC = [4, 6, 3, 5, 4, 6]              # max_new_tokens per request


def make_requests(seed=17):
    rng = np.random.Generator(np.random.Philox(seed))
    return [ServeRequest(rid=f"r{i}",
                         prompt=rng.integers(0, 100, PROMPT_LEN),
                         max_new_tokens=n)
            for i, n in enumerate(SPEC)]


# ---------------------------------------------------------------------------
# FaultPlan / retry unit layer
# ---------------------------------------------------------------------------
def _drive(plan, n=40):
    return [plan.check("monitor.execute", key=f"t:{i}") is not None
            for i in range(n)]


def test_fault_plan_deterministic():
    """Same seed and specs over the same event sequence: the same fires."""
    mk = lambda: FaultPlan([FaultSpec(site="monitor.execute",  # noqa: E731
                                      prob=0.3, max_fires=5)], seed=42)
    a, b = _drive(mk()), _drive(mk())
    assert a == b and sum(a) == 5          # max_fires bounds total fires
    c = _drive(FaultPlan([FaultSpec(site="monitor.execute", prob=0.3,
                                    max_fires=5)], seed=43))
    assert a != c                          # and the seed matters


def test_fault_plan_at_every_match():
    plan = FaultPlan([
        FaultSpec(site="agent.deploy", at=2),
        FaultSpec(site="monitor.execute", every=3, max_fires=2,
                  match="svc-a"),
    ])
    fires = [plan.check("agent.deploy", key=f"n{i}") is not None
             for i in range(4)]
    assert fires == [False, True, False, False]
    # match filters the event count too: svc-b events don't advance svc-a
    assert plan.check("monitor.execute", key="svc-b:p") is None
    hits = [plan.check("monitor.execute", key="svc-a:p") is not None
            for i in range(9)]
    assert hits == [False, False, True] * 2 + [False, False, False]
    assert [f[0] for f in plan.fired] == ["agent.deploy",
                                          "monitor.execute",
                                          "monitor.execute"]


def test_fault_plan_records_registry_events():
    reg = MetricsRegistry()
    plan = FaultPlan([FaultSpec(site="ckpt.save", at=1, kind="torn")],
                     registry=reg)
    with pytest.raises(InjectedCrash):
        plan.raise_if("ckpt.save", key="/ck/p:buf")
    kinds = [e[1] for e in reg.flight_record()["events"]]
    assert "fault_injected" in kinds


def test_retry_call_backoff_and_deadline():
    sleeps = []
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise InjectedFault("boom")
        return "ok"

    pol = RetryPolicy(max_attempts=4, base_backoff_s=0.1, max_backoff_s=1.0)
    assert retry_call(flaky, pol, sleep=sleeps.append) == "ok"
    assert sleeps == [0.1, 0.2]            # exponential
    # exhaustion re-raises the transient; non-retryable passes through
    with pytest.raises(InjectedFault):
        retry_call(lambda: (_ for _ in ()).throw(InjectedFault("x")),
                   RetryPolicy(max_attempts=2, base_backoff_s=0),
                   sleep=lambda s: None)
    with pytest.raises(ValueError):
        retry_call(lambda: (_ for _ in ()).throw(ValueError("v")), pol,
                   sleep=sleeps.append)


def test_router_pop_and_kv_transfer_sites():
    """``router.pop`` only delays (any other kind is ignored there);
    ``kv.transfer`` raises InjectedFault on error, InjectedCrash on crash
    or torn, and sleeps on delay."""
    plan = FaultPlan([FaultSpec(site="router.pop", kind="delay", at=1,
                                delay_s=0.001, match="e0"),
                      FaultSpec(site="router.pop", kind="error", at=1,
                                match="e1")])
    plan.maybe_delay("router.pop", key="e0")
    plan.maybe_delay("router.pop", key="e1")   # error at a delay-only site
    assert [f[1] for f in plan.fired] == ["delay", "error"]
    for kind, exc in (("error", InjectedFault), ("crash", InjectedCrash),
                      ("torn", InjectedCrash)):
        p = FaultPlan([FaultSpec(site="kv.transfer", kind=kind, at=1)])
        with pytest.raises(exc):
            p.raise_if("kv.transfer", key="r0")
    p = FaultPlan([FaultSpec(site="kv.transfer", kind="delay", at=1,
                             delay_s=0.001)])
    p.raise_if("kv.transfer", key="r0")
    assert p.fired == [("kv.transfer", "delay", "r0")]


# ---------------------------------------------------------------------------
# The engine under monitor faults: a transient costs a retry, never a token
# ---------------------------------------------------------------------------
def _engine_factory(chaos=None, registry=None, retries=3, **eng_kw):
    reg = registry if registry is not None else MetricsRegistry()
    mon = Monitor("eng-chaos", SliceAllocator("n0", 1, device="cpu"),
                  telemetry=reg, chaos=chaos,
                  retry=RetryPolicy(max_attempts=retries,
                                    base_backoff_s=0.001,
                                    max_backoff_s=0.01))
    eng = ContinuousBatchingEngine(ARCH, FunkyCL(mon), slots=SLOTS,
                                   prompt_len=PROMPT_LEN,
                                   max_new_tokens=MAX_NEW, registry=reg,
                                   page_size=PAGE, **eng_kw)
    eng.setup()
    return mon, eng


@pytest.fixture(scope="module")
def baseline_tokens():
    """Fault-free per-request tokens: greedy decode is deterministic, so
    neither faults, batching nor the replica may change them."""
    mon, eng = _engine_factory()
    for r in make_requests():
        eng.submit(r)
    eng.run_until_drained()
    ref = {rid: list(rec.tokens) for rid, rec in eng.completed.items()}
    mon.vfpga_exit()
    assert sorted(ref) == [f"r{i}" for i in range(len(SPEC))]
    return ref


def test_monitor_execute_retry_bit_exact(baseline_tokens):
    reg = MetricsRegistry()
    plan = FaultPlan([FaultSpec(site="monitor.execute", kind="error",
                                every=11, max_fires=2)],
                     seed=1, registry=reg)
    mon, eng = _engine_factory(chaos=plan, registry=reg)
    for r in make_requests():
        eng.submit(r)
    eng.run_until_drained()
    got = {rid: list(rec.tokens) for rid, rec in eng.completed.items()}
    mon.vfpga_exit()
    assert got == baseline_tokens
    assert len(plan.fired) == 2
    snap = reg.snapshot()
    assert snap["counters"]["monitor_execute_retries_total"] == 2
    kinds = [e[1] for e in reg.flight_record()["events"]]
    assert kinds.count("execute_retry") == 2


def test_monitor_execute_retry_exhaustion_fails_request():
    """A persistent fault exhausts the bounded retries and surfaces as a
    structured failure, not a hang."""
    reg = MetricsRegistry()
    plan = FaultPlan([FaultSpec(site="monitor.execute", kind="error",
                                every=1, max_fires=10,
                                match="decode_step")], registry=reg)
    mon, eng = _engine_factory(chaos=plan, registry=reg)
    eng.submit(make_requests()[0])
    with pytest.raises(InjectedFault):
        eng.run_until_drained()
    mon.vfpga_exit()
    snap = reg.snapshot()
    assert snap["counters"]["monitor_execute_failed_total"] >= 1
    kinds = [e[1] for e in reg.flight_record()["events"]]
    assert "execute_failed" in kinds


def test_pipelined_execute_error_surfaces_exactly_once(baseline_tokens):
    """A pipelined fused EXECUTE that errors after the step that submitted
    it surfaces exactly once; the engine rolls the span back, resubmits it
    and finishes bit-exactly.  The loop is the engine's own, called in
    order: no timing decides when the failure is seen."""
    reg = MetricsRegistry()
    plan = FaultPlan([FaultSpec(site="monitor.execute", kind="error",
                                at=3, max_fires=1, match="decode_multi")],
                     seed=7, registry=reg)
    # retries=1: InjectedFault is transient, so the monitor's default
    # retry loop would absorb it before it reached the engine
    mon, eng = _engine_factory(chaos=plan, registry=reg, retries=1,
                               fuse_steps=4, async_depth=1)
    for r in make_requests():
        eng.submit(r)
    raises = 0
    guard = 0
    while not eng.idle:
        try:
            eng.step()
        except InjectedFault:
            raises += 1
        guard += 1
        assert guard < 10000, "engine did not drain"
    got = {rid: list(rec.tokens) for rid, rec in eng.completed.items()}
    eng.pool.check_invariants()
    mon.vfpga_exit()
    assert len(plan.fired) == 1
    assert raises == 1, f"EXECUTE failure surfaced {raises} times, want 1"
    assert got == baseline_tokens


def test_delayed_pipelined_execute_carried_to_next_boundary(baseline_tokens):
    """A fused EXECUTE that is merely slow is not done at the boundary of
    the step that submitted it: it is carried forward, folded into the
    attribution exactly once, and never taken for a failure."""
    reg = MetricsRegistry()
    plan = FaultPlan([FaultSpec(site="monitor.execute", kind="delay",
                                delay_s=0.05, at=2, max_fires=2,
                                match="decode")], seed=8)
    mon, eng = _engine_factory(chaos=plan, registry=reg, fuse_steps=4,
                               async_depth=1)
    key = "monitor_requests_total{kind=EXECUTE}"
    execs0 = reg.snapshot()["counters"][key]       # setup's init programs
    for r in make_requests():
        eng.submit(r)
    eng.run_until_drained()
    got = {rid: list(rec.tokens) for rid, rec in eng.completed.items()}
    split = eng.host_device_split()
    mon.vfpga_exit()
    assert len(plan.fired) >= 1
    assert got == baseline_tokens
    # every EXECUTE the engine issued was folded exactly once, and the
    # queue-wait denominator counts EXECUTEs only
    assert (sum(eng.program_execs.values())
            == reg.snapshot()["counters"][key] - execs0)
    assert eng._attr_execs == split["execs"] <= sum(
        eng.program_execs.values())


# ---------------------------------------------------------------------------
# Chaos soak: seeded schedules over the live cluster
# ---------------------------------------------------------------------------
def _soak(plan, inject, tmp_path, *, seed=17):
    """Deploy one engine-serve replica on a two-node CPU cluster, feed it
    the requests, run the schedule's ``inject(ctx)`` hook, and wait until
    every request terminated.  Returns (router, orch, registry)."""
    reg = MetricsRegistry()
    if plan is not None and plan.registry is None:
        plan.registry = reg
    name = f"chaos-svc-{seed}-{id(plan)}"
    img = TaskImage(name=name, kind="engine-serve", arch=ARCH,
                    prompt_len=PROMPT_LEN, global_batch=SLOTS,
                    total_steps=10 ** 9, max_new_tokens=MAX_NEW,
                    page_size=PAGE)
    cluster = make_cluster(num_nodes=2, slices_per_node=1,
                           images={name: img}, metrics=reg, chaos=plan,
                           ckpt_root=str(tmp_path), device="cpu")
    router = reset_router(name)
    router.registry = reg
    orch = cluster.orchestrator
    orch.start(tick_interval=0.01)
    try:
        cid = orch.submit(name)
        node = wait_for_service(cluster, orch, cid, timeout_s=120)
        for r in make_requests(seed):
            router.submit(r)
        inject({"cluster": cluster, "orch": orch, "router": router,
                "cid": cid, "node": node, "plan": plan})
        _await(lambda: router.outstanding() == 0, "every request", 240)
        return router, orch, reg
    finally:
        router.close()
        cluster.stop()


def _await(cond, what, timeout=120):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.002)
    assert cond(), f"timed out waiting for {what}"


def _assert_conserved(router, baseline_tokens):
    """Zero lost, zero duplicated, bit-exact against the fault-free run."""
    assert sorted(router.completed) == sorted(baseline_tokens)
    assert router.duplicates == 0
    assert router.replay_mismatches == 0
    got = {rid: list(rec.tokens) for rid, rec in router.completed.items()}
    assert got == baseline_tokens


def test_soak_transient_execute_faults(baseline_tokens, tmp_path):
    """Schedule 2: seeded transient EXECUTE faults throughout the run,
    absorbed by the monitor's retry loop, invisible to clients."""
    plan = FaultPlan([FaultSpec(site="monitor.execute", kind="error",
                                every=7, max_fires=3, match="task-")],
                     seed=2)
    router, _, reg = _soak(plan, lambda ctx: None, tmp_path)
    _assert_conserved(router, baseline_tokens)
    assert len(plan.fired) == 3
    assert reg.snapshot()["counters"][
        "monitor_execute_retries_total"] == 3


def test_soak_restore_failure_retried(baseline_tokens, tmp_path):
    """Schedule 5: the restore fails transiently on its first attempt; the
    orchestrator's bounded retry with backoff lands it on the second."""
    plan = FaultPlan([FaultSpec(site="ckpt.restore", kind="error", at=1)],
                     seed=5)

    def inject(ctx):
        router = ctx["router"]
        _await(lambda: len(router.completed) >= 1, "a completion")
        ctx["orch"].checkpoint(ctx["cid"])
        ctx["orch"].handle_node_failure(ctx["node"])

    router, orch, _ = _soak(plan, inject, tmp_path)
    _assert_conserved(router, baseline_tokens)
    events = [e[1] for e in orch.events]
    assert "restored" in events
    retries = [e for e in orch.events if e[1] == "action_retry"
               and e[2].get("action") == "restore"]
    assert len(retries) == 1


# ---------------------------------------------------------------------------
# The router's exactly-once guard
# ---------------------------------------------------------------------------
def test_duplicate_completion_guard():
    """A dead replica's late completion of a replayed request does not
    count twice, and a replay that diverges from the committed prefix is
    flagged."""
    router = RequestRouter("dup-svc")
    req = make_requests()[0]
    router.submit(req)
    router.pop(1, engine_id="eng-a")
    req.committed = [5, 6]
    router.fail_engine("eng-a")
    router.pop(1, engine_id="eng-b")
    rec = CompletedRequest(rid=req.rid, tokens=[5, 6, 7], arrival_t=0,
                           admit_t=0, first_token_t=0, finish_t=1)
    router.complete(rec)
    router.complete(rec)                   # late duplicate from the dead one
    assert router.duplicates == 1
    assert len(router.completed) == 1
    assert router.replay_mismatches == 0

    router2 = RequestRouter("dup-svc2")
    req2 = make_requests()[1]
    router2.submit(req2)
    router2.pop(1, engine_id="eng-a")
    req2.committed = [9, 9]
    router2.fail_engine("eng-a")
    router2.pop(1, engine_id="eng-b")
    bad = CompletedRequest(rid=req2.rid, tokens=[1, 2, 3], arrival_t=0,
                           admit_t=0, first_token_t=0, finish_t=1)
    router2.complete(bad)
    assert router2.replay_mismatches == 1


def test_delayed_router_pop_changes_nothing(baseline_tokens):
    """A router whose pops are delayed by the plan serves the same tokens
    through an engine's pump loop."""
    plan = FaultPlan([FaultSpec(site="router.pop", kind="delay", every=2,
                                max_fires=3, delay_s=0.001)])
    mon, eng = _engine_factory()
    router = RequestRouter("pop-svc", registry=eng.registry, chaos=plan)
    for r in make_requests():
        router.submit(r)
    while router.outstanding() > 0 and eng.pump(router):
        pass
    mon.vfpga_exit()
    assert len(plan.fired) == 3
    assert {rid: list(c.tokens) for rid, c in router.completed.items()} \
        == baseline_tokens
