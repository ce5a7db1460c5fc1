"""The port's placement layer (``repro_torch.core.placement``): every case
of ``tests/test_placement.py`` (its hypothesis state machine included),
then exact parity of ``PlacementPolicy.select_node`` with the reference's.

Unified placement layer: warm-cache affinity, failure-domain
anti-affinity, group-aware victim selection, the scale-out path through
``Orchestrator.place_replica``, the metrics-driven ``MigrationController``,
and a hypothesis state machine over ``FunkyScheduler``/``PlacementPolicy``
invariants (no slice oversubscription within a pass, no lost/duplicated
tasks across evict/resume/migrate, anti-affinity honored when feasible)."""

import math

import pytest

try:
    from hypothesis import settings
    from hypothesis import strategies as st
    from hypothesis.stateful import RuleBasedStateMachine, invariant, rule
    HAS_HYPOTHESIS = True
except ImportError:      # property tests skip; the rest of the module runs
    HAS_HYPOTHESIS = False

torch = pytest.importorskip("torch")

from repro_torch.core.orchestrator import Orchestrator  # noqa: E402
from repro_torch.core.placement import (M_NODE_PROGRESS_RATE,  # noqa: E402
                                        M_TASK_PROGRESS, MigrationController,
                                        PlacementPolicy, ServiceGroup,
                                        _median)
from repro_torch.core.scheduler import (FunkyScheduler, Policy,  # noqa: E402
                                        SchedTask, TaskState)
from repro_torch.scaling.metrics import MetricsRegistry  # noqa: E402


class RichView:
    """Enriched fake ClusterView: capacity + failure domains + warm caches."""

    def __init__(self, capacity, domains=None, warm=None):
        self.capacity = dict(capacity)
        self.used = {n: 0 for n in capacity}
        self.domains = domains or {n: n for n in capacity}
        self.warm = {n: set() for n in capacity}
        for n, progs in (warm or {}).items():
            self.warm[n] = set(progs)

    def nodes(self):
        return list(self.capacity)

    def free_slices(self, node):
        return self.capacity[node] - self.used[node]

    def running_tasks(self, node):
        return []

    def failure_domain(self, node):
        return self.domains[node]

    def warm_programs(self, node):
        return self.warm[node]


# ---------------------------------------------------------------------------
# scoring: warmth and anti-affinity
# ---------------------------------------------------------------------------
def test_warm_cache_breaks_free_slice_ties():
    """Equal free slices: the node already holding the task's compiled
    programs wins (the name tie-break would otherwise pick n1)."""
    view = RichView({"n0": 2, "n1": 2},
                    warm={"n0": {"prefill_8", "decode_step"}})
    pol = PlacementPolicy()
    task = SchedTask(tid="t", meta={"programs": ("prefill_8",
                                                 "decode_step")})
    assert pol.select_node(task, view, {}) == "n0"
    # without the warm hint, the old most-free rule (name tie-break) holds
    cold = SchedTask(tid="t2")
    assert pol.select_node(cold, view, {}) == "n1"


def test_capacity_outweighs_warmth():
    view = RichView({"n0": 3, "n1": 3},
                    warm={"n0": {"prefill_8"}})
    view.used["n0"] = 2                      # warm but nearly full
    task = SchedTask(tid="t", meta={"programs": ("prefill_8",)})
    assert PlacementPolicy().select_node(task, view, {}) == "n1"


def test_group_replicas_spread_across_failure_domains():
    """Replicas of one service land in distinct domains when capacity
    allows; only once every domain is occupied do they double up."""
    domains = {"n0": "d0", "n1": "d0", "n2": "d1", "n3": "d1"}
    view = RichView({n: 1 for n in domains}, domains=domains)
    sched = FunkyScheduler(Policy.PRE_MG)
    for i in range(3):
        sched.submit(SchedTask(tid=f"r{i}", group="svc", submit_time=i))
    actions = sched.schedule_once(view)
    assert len(actions) == 3
    placed_domains = [domains[a.node] for a in actions]
    # first two replicas take distinct domains; the third must collide
    assert set(placed_domains[:2]) == {"d0", "d1"}
    assert sorted(placed_domains) == ["d0", "d0", "d1"] or \
        sorted(placed_domains) == ["d0", "d1", "d1"]


def test_anti_affinity_dominates_free_slices():
    """A conflict-free domain with one free slice beats a same-domain node
    with many free slices — anti-affinity is lexicographic, not a weight."""
    domains = {"n0": "d0", "n1": "d0", "n2": "d1"}
    view = RichView({"n0": 1, "n1": 3, "n2": 1}, domains=domains)
    view.used["n0"] = 1                      # base replica runs here
    base = SchedTask(tid="base", group="svc", state=TaskState.RUNNING,
                     node_id="n0")
    probe = SchedTask(tid="probe", group="svc")
    got = PlacementPolicy().select_node(probe, view, {}, running=[base])
    assert got == "n2"


def test_group_aware_victim_protects_last_replica():
    """Preemption never takes a service's last running replica while an
    equal-priority alternative exists — but will when it must."""
    pol = PlacementPolicy()
    svc = SchedTask(tid="svc-0", priority=0, group="svc",
                    state=TaskState.RUNNING, node_id="n0")
    batch = SchedTask(tid="batch", priority=0,
                      state=TaskState.RUNNING, node_id="n1")
    high = SchedTask(tid="high", priority=5)
    assert pol.find_victim(high, [svc, batch], set()).tid == "batch"
    # two replicas: the group survives losing one, so replicas are fair game
    svc2 = SchedTask(tid="svc-1", priority=0, group="svc",
                     state=TaskState.RUNNING, node_id="n2")
    assert pol.find_victim(high, [svc, svc2, batch], set()).tid == "svc-0"
    # no alternative: the last replica is still evicted (capacity wins)
    assert pol.find_victim(high, [svc], set()).tid == "svc-0"


def test_migrate_from_flag_overrides_home_resume():
    """A straggler evicted *for migration* must not bounce back onto the
    degraded node just because its own freed slice made it look free — it
    lands elsewhere when anywhere else has room, and only falls back to
    the flagged node when it is the sole option."""
    pol = PlacementPolicy()
    view = RichView({"n0": 1, "n1": 1})
    t = SchedTask(tid="t", state=TaskState.EVICTED, node_id="n0",
                  meta={"migrate_from": "n0"})
    assert pol.select_node(t, view, {}) == "n1"
    view.used["n1"] = 1                      # nowhere else: home it is
    assert pol.select_node(t, view, {}) == "n0"
    view.used["n1"] = 0
    # PRE_EV cannot migrate contexts, so the flag is ignored
    assert pol.select_node(t, view, {}, allow_migrate=False) == "n0"
    # the scheduler consumes the flag on placement: a later eviction of
    # the same task resumes on its (new) home node as usual
    sched = FunkyScheduler(Policy.PRE_MG)
    sched.submit(t)
    actions = sched.schedule_once(view)
    assert [(a.kind, a.node) for a in actions] == [("migrate", "n1")]
    assert "migrate_from" not in t.meta


def test_service_group_gather():
    a = SchedTask(tid="a", group="g1", node_id="n0")
    b = SchedTask(tid="b", group="g1", node_id="n1")
    c = SchedTask(tid="c")
    groups = ServiceGroup.gather([a, b, c])
    assert set(groups) == {"g1"}
    assert groups["g1"].domains(lambda n: n) == {"n0": 1, "n1": 1}


# ---------------------------------------------------------------------------
# scale-out path: Orchestrator.place_replica (acceptance criteria)
# ---------------------------------------------------------------------------
class FakeAgent:
    def __init__(self, slices=1, domain=None, warm=()):
        self.failed = False
        self.failure_domain = domain
        self._slices = slices
        self._warm = tuple(warm)

    def num_slices(self):
        return self._slices

    def warm_programs(self):
        return self._warm


def _orch_with_running_base(agents, image_programs):
    orch = Orchestrator(agents)
    cid = orch.submit("svc")
    orch._image_programs["svc"] = tuple(image_programs)
    st = orch._sched_tasks[cid]
    st.state = TaskState.RUNNING
    st.node_id = "n0"
    orch.scheduler.wait_queue.remove(st)
    orch.scheduler.run_queue.append(st)
    return orch, cid


def test_scale_out_prefers_warm_node_at_equal_free_slices():
    progs = ("prefill_8", "decode_step")
    orch, cid = _orch_with_running_base(
        {"n0": FakeAgent(domain="d0"),
         "n1": FakeAgent(domain="d1", warm=progs),
         "n2": FakeAgent(domain="d1")},           # cold, same domain as n1
        progs)
    assert orch.place_replica(cid) == "n1"
    # group bookkeeping: base and future replicas share the group id
    assert orch.deployments[cid].group == cid
    assert orch._sched_tasks[cid].group == cid


def test_scale_out_spreads_replicas_across_domains():
    orch, cid = _orch_with_running_base(
        {"n0": FakeAgent(domain="d0"),
         "n1": FakeAgent(slices=3, domain="d0"),  # roomy but same domain
         "n2": FakeAgent(domain="d1")},
        ())
    assert orch.place_replica(cid) == "n2"


def test_scale_out_returns_none_when_full():
    orch, cid = _orch_with_running_base({"n0": FakeAgent(domain="d0")}, ())
    assert orch.place_replica(cid) is None


# ---------------------------------------------------------------------------
# the simulator runs the same placement engine
# ---------------------------------------------------------------------------
def _trace_job(jid, t, **kw):
    from repro_torch.core.traces import TraceJob
    return TraceJob(jid=jid, submit_time=t, duration=30.0, priority=0,
                    memory_bytes=1 << 20, fail_frac=None, **kw)


def test_simulator_warm_cache_skips_reconfiguration():
    """A node that already compiled a job's programs is warm: the second
    deploy skips ``reconfig_s``, so submit-to-finish latency drops — the
    overhead the placement layer's warm-cache affinity is chasing."""
    from repro_torch.core.simulator import SimParams, Simulator

    cold = Simulator([_trace_job("a", 0.0, programs=("p1",)),
                      _trace_job("b", 100.0, programs=("p2",))],
                     num_nodes=1).run()
    warm = Simulator([_trace_job("a", 0.0, programs=("p1",)),
                      _trace_job("b", 100.0, programs=("p1",))],
                     num_nodes=1).run()
    reconfig = SimParams().reconfig_s
    assert warm["mean_latency_s"] == pytest.approx(
        cold["mean_latency_s"] - reconfig / 2)


def test_simulator_spreads_group_across_synthetic_domains():
    from repro_torch.core.simulator import Simulator

    jobs = [_trace_job(f"r{i}", 0.0, group="svc") for i in range(2)]
    sim = Simulator(jobs, num_nodes=4, failure_domains=2)
    rep = sim.run()
    assert rep["completed"] == 2
    doms = {sim.cluster.domains[sim.tasks[f"r{i}"].node_id]
            for i in range(2)}
    assert doms == {"dom0", "dom1"}


# ---------------------------------------------------------------------------
# metrics-driven migration
# ---------------------------------------------------------------------------
def test_median_even_count():
    """The old probe took the upper element for even counts."""
    assert _median([1.0, 2.0, 3.0, 4.0]) == 2.5
    assert _median([1.0, 2.0, 3.0]) == 2.0
    assert math.isnan(_median([]))


def test_migration_controller_flags_straggler_from_registry():
    t = [0.0]
    reg = MetricsRegistry(clock=lambda: t[0])
    ctl = MigrationController(reg)
    running = {"c0": "n0", "c1": "n0", "c2": "n1", "c3": "n1"}
    for cid in running:
        ctl.observe(cid, 0)
    t[0] = 2.0
    for cid, step in {"c0": 20, "c1": 20, "c2": 20, "c3": 2}.items():
        ctl.observe(cid, step)
    decisions = ctl.decide(running)
    assert [d.cid for d in decisions] == ["c3"]
    assert decisions[0].rate == pytest.approx(1.0)
    assert decisions[0].median == pytest.approx(10.0)
    # the signal lives in the shared registry, not a private probe
    assert len(reg.series(M_TASK_PROGRESS, cid="c3")) == 2
    assert reg.gauge(M_NODE_PROGRESS_RATE, node="n0").value == \
        pytest.approx(10.0)
    assert reg.gauge(M_NODE_PROGRESS_RATE, node="n1").value == \
        pytest.approx(5.5)
    # after a migration the task's history resets: not instantly re-flagged
    ctl.reset("c3")
    assert ctl.decide(running) == []
    # a node whose tasks all left gets its rate gauge zeroed (no stale
    # placement bonus), and forgotten tasks drop their series entirely
    for cid in ("c2", "c3"):
        running.pop(cid)
        ctl.forget(cid)
    ctl.decide(running)
    assert reg.gauge(M_NODE_PROGRESS_RATE, node="n1").value == 0.0
    assert len(reg.series(M_TASK_PROGRESS, cid="c3")) == 0


def test_migration_controller_even_median_not_overtriggered():
    """Rates [4, 6, 10, 12]: proper median 8 -> threshold 4 -> no
    straggler.  The old upper-element median (10 -> threshold 5) would have
    migrated a healthy task."""
    t = [0.0]
    reg = MetricsRegistry(clock=lambda: t[0])
    ctl = MigrationController(reg)
    running = {c: "n0" for c in ("c0", "c1", "c2", "c3")}
    for cid in running:
        ctl.observe(cid, 0)
    t[0] = 1.0
    for cid, step in {"c0": 4, "c1": 6, "c2": 10, "c3": 12}.items():
        ctl.observe(cid, step)
    assert ctl.decide(running) == []


def test_migration_controller_needs_peers_and_window():
    t = [0.0]
    reg = MetricsRegistry(clock=lambda: t[0])
    ctl = MigrationController(reg)
    running = {"c0": "n0", "c1": "n1"}
    for cid in running:
        ctl.observe(cid, 0)
    t[0] = 2.0
    ctl.observe("c0", 20)
    ctl.observe("c1", 1)
    assert ctl.decide(running) == []          # only 2 peers (< min_peers)
    t[0] = 2.1
    running["c2"] = "n2"
    ctl.observe("c2", 0)
    assert ctl.decide(running) == []          # c2's window too short


# ---------------------------------------------------------------------------
# hypothesis state machine: scheduler + placement invariants
# ---------------------------------------------------------------------------
if HAS_HYPOTHESIS:
    DOMAINS = {"node0": "dom0", "node1": "dom1", "node2": "dom0",
               "node3": "dom1"}

    class PlacementMachine(RuleBasedStateMachine):
        """Random submit/schedule/finish interleavings under PRE_MG.

        Invariants checked after every scheduling pass:
        * no node is ever oversubscribed (replaying the pass's actions in
          order never exceeds capacity);
        * no task is lost or duplicated across deploy/evict/resume/migrate
          (every submitted task sits in exactly one of wait/run/done);
        * in eviction-free passes, a grouped deploy never lands in an
          occupied failure domain while a conflict-free node with a free
          slice existed (anti-affinity honored whenever feasible).
        """

        def __init__(self):
            super().__init__()
            self.view = RichView({n: 2 for n in DOMAINS}, domains=DOMAINS)
            self.sched = FunkyScheduler(Policy.PRE_MG)
            self.tasks = {}
            self.done = set()
            self.count = 0

        @rule(prio=st.integers(0, 3),
              group=st.sampled_from([None, "svcA", "svcB"]))
        def submit(self, prio, group):
            tid = f"t{self.count}"
            t = SchedTask(tid=tid, priority=prio, submit_time=self.count,
                          group=group)
            self.count += 1
            self.tasks[tid] = t
            self.sched.submit(t)

        @rule(idx=st.integers(0, 7))
        def finish(self, idx):
            if not self.sched.run_queue:
                return
            t = self.sched.run_queue[idx % len(self.sched.run_queue)]
            self.sched.task_done(t.tid)
            self.view.used[t.node_id] -= 1
            t.state = TaskState.DONE
            self.done.add(t.tid)

        @rule()
        def tick(self):
            pre_groups = {}
            for t in self.sched.run_queue:
                if t.group and t.node_id:
                    pre_groups.setdefault(t.group, []).append(
                        DOMAINS[t.node_id])
            free = {n: self.view.free_slices(n) for n in self.view.nodes()}
            actions = self.sched.schedule_once(self.view)
            evicted_in_pass = any(a.kind == "evict" for a in actions)
            for a in actions:
                if a.kind == "evict":
                    free[a.node] += 1
                    self.view.used[a.node] -= 1
                    continue
                if a.kind == "deploy" and not evicted_in_pass:
                    grp = self.tasks[a.tid].group
                    if grp:
                        occupied = set(pre_groups.get(grp, []))
                        feasible = any(
                            free[n] > 0 and DOMAINS[n] not in occupied
                            for n in self.view.nodes())
                        if feasible:
                            assert DOMAINS[a.node] not in occupied, (
                                f"{a.tid} ({grp}) stacked into "
                                f"{DOMAINS[a.node]} with a conflict-free "
                                f"free node available")
                free[a.node] -= 1
                assert free[a.node] >= 0, f"{a.node} oversubscribed"
                self.view.used[a.node] += 1
                grp = self.tasks[a.tid].group
                if grp:
                    pre_groups.setdefault(grp, []).append(DOMAINS[a.node])

        @invariant()
        def capacity_and_conservation(self):
            for n in self.view.nodes():
                assert 0 <= self.view.used[n] <= self.view.capacity[n]
            in_wait = {t.tid for t in self.sched.wait_queue}
            in_run = {t.tid for t in self.sched.run_queue}
            assert not (in_wait & in_run)
            assert not (in_wait & self.done)
            assert not (in_run & self.done)
            assert in_wait | in_run | self.done == set(self.tasks)
            # run-queue occupancy matches the view's accounting
            assert len(in_run) == sum(self.view.used.values())

    PlacementMachine.TestCase.settings = settings(
        max_examples=40, stateful_step_count=30, deadline=None)
    TestPlacementMachine = PlacementMachine.TestCase
else:
    def test_placement_state_machine():
        pytest.importorskip("hypothesis")


# ---------------------------------------------------------------------------
# parity with the reference package: equal select_node / find_victim
# ---------------------------------------------------------------------------
def _placement_case(mod_sched, mod_place, mod_metrics, seed):
    """One seeded enriched view, registry, running set and probe task,
    built from one package's classes; returns its ``select_node`` choices
    (default and no-migrate) and its ``find_victim``."""
    import numpy as np

    rng = np.random.Generator(np.random.Philox(seed))
    nodes = [f"n{i}" for i in range(int(rng.integers(2, 6)))]
    cap = {n: int(rng.integers(1, 4)) for n in nodes}
    view = RichView(cap, domains={n: f"d{i % 2}"
                                  for i, n in enumerate(nodes)},
                    warm={n: {f"p{j}" for j in range(4)
                              if rng.uniform() < 0.4} for n in nodes})
    reg = mod_metrics.MetricsRegistry(clock=lambda: 0.0)
    for n in nodes:
        view.used[n] = int(rng.integers(0, cap[n] + 1))
        reg.gauge("node_utilization", node=n).set(view.used[n] / cap[n])
        reg.gauge("node_progress_rate", node=n).set(
            float(rng.uniform(0, 10)))
        reg.gauge("node_kv_free_pages", node=n).set(
            float(rng.integers(0, 64)))
    running = []
    for i in range(int(rng.integers(0, 6))):
        running.append(mod_sched.SchedTask(
            tid=f"r{i}", priority=int(rng.integers(0, 4)),
            group=("svc", None)[int(rng.integers(0, 2))],
            state=mod_sched.TaskState.RUNNING,
            node_id=nodes[int(rng.integers(0, len(nodes)))]))
    role = (None, "prefill", "decode")[int(rng.integers(0, 3))]
    meta = {"programs": tuple(f"p{j}" for j in range(4)
                              if rng.uniform() < 0.5)}
    if role:
        meta["role"] = role
    task = mod_sched.SchedTask(tid="probe", priority=int(rng.integers(0, 5)),
                               group=("svc", None)[int(rng.integers(0, 2))],
                               meta=meta)
    if rng.uniform() < 0.3:
        task.state = mod_sched.TaskState.EVICTED
        task.node_id = nodes[int(rng.integers(0, len(nodes)))]
        if rng.uniform() < 0.5:
            task.meta["migrate_from"] = task.node_id
    reserved = {n: int(rng.integers(0, 2)) for n in nodes
                if rng.uniform() < 0.3}
    pol = mod_place.PlacementPolicy(registry=reg)
    victim = pol.find_victim(task, running, set())
    return (pol.select_node(task, view, reserved, running=running),
            pol.select_node(task, view, reserved, running=running,
                            allow_migrate=False),
            victim.tid if victim is not None else None)


def test_select_node_equals_the_reference():
    import repro.core.placement as jplace
    import repro.core.scheduler as jsched
    import repro.scaling.metrics as jmetrics
    import repro_torch.core.placement as tplace
    import repro_torch.core.scheduler as tsched
    import repro_torch.scaling.metrics as tmetrics

    choices = set()
    for seed in range(200):
        got = _placement_case(tsched, tplace, tmetrics, seed)
        want = _placement_case(jsched, jplace, jmetrics, seed)
        assert got == want, seed
        choices.add(got[0])
    assert None in choices and len(choices) >= 4
