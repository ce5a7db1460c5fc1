"""The port's scheduler (``repro_torch.core.scheduler``): every case of
``tests/test_scheduler.py``, then exact parity with the reference's
``FunkyScheduler`` on seeded task streams.

Property-based tests of Algorithm 1 (paper §3.5, Table 5 policies)."""

import itertools

import pytest

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAS_HYPOTHESIS = True
except ImportError:      # property tests skip; the rest of the module runs
    HAS_HYPOTHESIS = False

torch = pytest.importorskip("torch")

from repro_torch.core.scheduler import (Action, FunkyScheduler,  # noqa: E402
                                        Policy, SchedTask, TaskState)


class FakeView:
    def __init__(self, capacity):
        self.capacity = dict(capacity)
        self.used = {n: 0 for n in capacity}

    def nodes(self):
        return list(self.capacity)

    def free_slices(self, node):
        return self.capacity[node] - self.used[node]

    def running_tasks(self, node):
        return []

    def apply(self, sched, actions):
        for a in actions:
            if a.kind in ("deploy", "resume", "migrate"):
                self.used[a.node] += 1
            elif a.kind == "evict":
                self.used[a.node] -= 1


def _drive(policy, n_nodes, slices, tasks):
    view = FakeView({f"node{i}": slices for i in range(n_nodes)})
    sched = FunkyScheduler(policy)
    log = []
    for t in tasks:
        sched.submit(t)
    for _ in range(len(tasks) * 3 + 3):
        actions = sched.schedule_once(view)
        if not actions:
            break
        view.apply(sched, actions)
        log.extend(actions)
        # capacity invariant after every pass
        for n in view.nodes():
            assert 0 <= view.used[n] <= view.capacity[n]
    return sched, view, log


if HAS_HYPOTHESIS:
    @settings(max_examples=60, deadline=None)
    @given(
        policy=st.sampled_from(list(Policy)),
        n_nodes=st.integers(1, 4),
        slices=st.integers(1, 2),
        prios=st.lists(st.integers(0, 3), min_size=1, max_size=10),
    )
    def test_capacity_and_queue_conservation(policy, n_nodes, slices, prios):
        tasks = [SchedTask(tid=f"t{i}", priority=p, submit_time=i)
                 for i, p in enumerate(prios)]
        sched, view, log = _drive(policy, n_nodes, slices, tasks)
        # each task is in exactly one queue
        in_wait = {t.tid for t in sched.wait_queue}
        in_run = {t.tid for t in sched.run_queue}
        assert not (in_wait & in_run)
        assert len(in_run) <= n_nodes * slices
        # non-preemptive policies never evict
        if policy in (Policy.FCFS, Policy.NO_PRE):
            assert not [a for a in log if a.kind == "evict"]
        # only PRE_MG migrates
        if policy is not Policy.PRE_MG:
            assert not [a for a in log if a.kind == "migrate"]

    @settings(max_examples=40, deadline=None)
    @given(prios=st.lists(st.integers(0, 3), min_size=2, max_size=8))
    def test_preemption_always_favors_higher_priority(prios):
        """PRE_EV: an evicted task's priority is strictly lower than a task
        that was scheduled in the same pass."""
        tasks = [SchedTask(tid=f"t{i}", priority=p, submit_time=i)
                 for i, p in enumerate(prios)]
        view = FakeView({"node0": 1})
        sched = FunkyScheduler(Policy.PRE_EV)
        for t in tasks:
            sched.submit(t)
            actions = sched.schedule_once(view)
            view.apply(sched, actions)
            evicted = [a for a in actions if a.kind == "evict"]
            placed = [a for a in actions if a.kind in ("deploy", "resume")]
            for e in evicted:
                ep = next(x.priority for x in tasks if x.tid == e.tid)
                assert any(
                    next(x.priority for x in tasks if x.tid == p.tid) > ep
                    for p in placed)
else:
    def test_capacity_and_queue_conservation():
        pytest.importorskip("hypothesis")

    def test_preemption_always_favors_higher_priority():
        pytest.importorskip("hypothesis")


def test_fcfs_is_head_of_line_blocking():
    tasks = [SchedTask(tid="low", priority=0, submit_time=0),
             SchedTask(tid="high", priority=9, submit_time=1)]
    view = FakeView({"node0": 1})
    sched = FunkyScheduler(Policy.FCFS)
    for t in tasks:
        sched.submit(t)
    actions = sched.schedule_once(view)
    assert [a.tid for a in actions] == ["low"]


def test_no_pre_reorders_by_priority():
    tasks = [SchedTask(tid="low", priority=0, submit_time=0),
             SchedTask(tid="high", priority=9, submit_time=1)]
    view = FakeView({"node0": 1})
    sched = FunkyScheduler(Policy.NO_PRE)
    for t in tasks:
        sched.submit(t)
    actions = sched.schedule_once(view)
    assert actions[0].tid == "high"


def test_pre_ev_resumes_on_context_node_only():
    sched = FunkyScheduler(Policy.PRE_EV)
    view = FakeView({"node0": 1, "node1": 1})
    evicted = SchedTask(tid="e", priority=1, submit_time=0,
                        state=TaskState.EVICTED, node_id="node0")
    view.used["node0"] = 1          # home is busy
    sched.submit(evicted)
    actions = sched.schedule_once(view)
    # node1 is free but PRE_EV cannot migrate a context
    assert not [a for a in actions if a.tid == "e"]


def test_pre_mg_migrates_when_home_busy():
    sched = FunkyScheduler(Policy.PRE_MG)
    view = FakeView({"node0": 1, "node1": 1})
    evicted = SchedTask(tid="e", priority=1, submit_time=0,
                        state=TaskState.EVICTED, node_id="node0")
    view.used["node0"] = 1
    sched.submit(evicted)
    actions = sched.schedule_once(view)
    mig = [a for a in actions if a.kind == "migrate"]
    assert mig and mig[0].node == "node1" and mig[0].src_node == "node0"


# ---------------------------------------------------------------------------
# parity with the reference package: equal Action lists on seeded streams
# ---------------------------------------------------------------------------
def _stream(seed, n=24):
    """A seeded task stream: (tid, priority, submit_time, group, evicted
    home node or None, finish-after-passes)."""
    import numpy as np

    rng = np.random.Generator(np.random.Philox(seed))
    out = []
    for i in range(n):
        home = (f"node{int(rng.integers(0, 3))}"
                if rng.uniform() < 0.2 else None)
        out.append((f"t{i:02d}", int(rng.integers(0, 4)),
                    float(rng.uniform(0, 10)),
                    (None, "svcA", "svcB")[int(rng.integers(0, 3))],
                    home, int(rng.integers(1, 4))))
    return out


def _run_stream(mod_sched, stream, policy):
    """Submit the stream in waves of four, run a pass after each wave,
    finish tasks after their pass count; returns every pass's actions."""
    view = FakeView({"node0": 2, "node1": 1, "node2": 2})
    sched = mod_sched.FunkyScheduler(mod_sched.Policy(policy.value))
    tasks, age, log = {}, {}, []
    for w in range(0, len(stream) + 8, 4):
        for tid, prio, t, group, home, life in stream[w:w + 4]:
            st = mod_sched.SchedTask(tid=tid, priority=prio, submit_time=t,
                                     group=group)
            if home is not None:
                st.state = mod_sched.TaskState.EVICTED
                st.node_id = home
            tasks[tid] = (st, life)
            sched.submit(st)
        actions = sched.schedule_once(view)
        view.apply(sched, actions)
        log.append([(a.kind, a.tid, a.node, a.src_node) for a in actions])
        for st in list(sched.run_queue):
            age[st.tid] = age.get(st.tid, 0) + 1
            if age[st.tid] >= tasks[st.tid][1]:
                sched.task_done(st.tid)
                view.used[st.node_id] -= 1
    return log


@pytest.mark.parametrize("policy", list(Policy))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_action_lists_equal_the_reference(policy, seed):
    import repro.core.scheduler as jsched
    import repro_torch.core.scheduler as tsched

    stream = _stream(seed)
    got = _run_stream(tsched, stream, policy)
    want = _run_stream(jsched, stream, policy)
    assert sum(map(len, got)) > 0
    assert got == want
