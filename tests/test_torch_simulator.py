"""The port's trace generator and simulator: every case of
``tests/test_simulator.py``, then exact parity of ``generate_trace``,
``Simulator.run`` and ``ServingSimulator.run`` with the reference's.

Trace-driven simulator (paper §5.6): trends must reproduce Figs 11-13."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.scheduler import Policy  # noqa: E402
from repro_torch.core.simulator import SimParams, Simulator  # noqa: E402
from repro_torch.core.traces import generate_trace  # noqa: E402


def test_trace_generation_deterministic():
    a = generate_trace(n_jobs=50, seed=4)
    b = generate_trace(n_jobs=50, seed=4)
    c = generate_trace(n_jobs=50, seed=5)
    assert [j.duration for j in a] == [j.duration for j in b]
    assert [j.duration for j in a] != [j.duration for j in c]
    assert all(30.0 <= j.duration <= 3 * 3600 for j in a)
    assert all(j.memory_bytes <= 8 << 30 for j in a)


def test_fig11_throughput_scales_with_slices_and_acceleration():
    jobs = generate_trace(n_jobs=200, horizon_s=2 * 3600, seed=1)
    thr = {}
    for n in (2, 8, 32):
        r = Simulator(jobs, num_nodes=n, policy=Policy.NO_PRE,
                      params=SimParams(acceleration_rate=1.0)).run()
        assert r["completed"] == 200
        thr[n] = r["throughput_per_min"]
    assert thr[8] > thr[2]
    lat = {}
    for rate in (0.0, 1.0):
        r = Simulator(jobs, num_nodes=8, policy=Policy.NO_PRE,
                      params=SimParams(acceleration_rate=rate)).run()
        lat[rate] = r["mean_latency_s"]
    assert lat[1.0] < lat[0.0]          # acceleration helps (paper: 1.6x)


def test_fig13_preemption_helps_high_priority():
    jobs = generate_trace(n_jobs=150, horizon_s=3600, seed=2)
    res = {}
    for pol in (Policy.NO_PRE, Policy.PRE_EV, Policy.PRE_MG):
        r = Simulator(jobs, num_nodes=6, policy=pol).run()
        assert r["completed"] == 150
        res[pol] = r
    hi = max(res[Policy.NO_PRE]["latency_by_priority"])
    assert res[Policy.PRE_EV]["latency_by_priority"][hi] <= \
        res[Policy.NO_PRE]["latency_by_priority"][hi] * 1.02
    assert res[Policy.PRE_EV]["evictions"] > 0
    assert res[Policy.PRE_MG]["migrations"] > 0


def test_fig12_checkpointing_recovers_failures():
    jobs = generate_trace(n_jobs=120, horizon_s=2 * 3600, seed=3,
                          with_failures=True)
    execs = {}
    for ck in (None, 60.0):
        r = Simulator(jobs, num_nodes=16, policy=Policy.NO_PRE,
                      params=SimParams(checkpoint_interval_s=ck)).run()
        assert r["completed"] == 120
        execs[ck] = r["mean_exec_s"]
    assert execs[60.0] < execs[None]    # snapshots recover lost work


def test_fig12_checkpoint_overhead_without_failures():
    jobs = generate_trace(n_jobs=80, horizon_s=3600, seed=6,
                          with_failures=False)
    base = Simulator(jobs, num_nodes=16, policy=Policy.NO_PRE,
                     params=SimParams()).run()
    freq = Simulator(jobs, num_nodes=16, policy=Policy.NO_PRE,
                     params=SimParams(checkpoint_interval_s=15.0)).run()
    assert freq["mean_exec_s"] >= base["mean_exec_s"]   # pure overhead


def test_simulation_conserves_jobs():
    jobs = generate_trace(n_jobs=77, horizon_s=1800, seed=9,
                          with_failures=True)
    r = Simulator(jobs, num_nodes=4, policy=Policy.PRE_MG,
                  params=SimParams(checkpoint_interval_s=120.0)).run()
    assert r["completed"] == 77


# ---------------------------------------------------------------------------
# parity with the reference package: same seeds, same outputs, exactly
# ---------------------------------------------------------------------------
def _jobs_tuple(jobs):
    return [(j.jid, j.submit_time, j.duration, j.priority, j.memory_bytes,
             j.fail_frac, j.group, j.programs) for j in jobs]


@pytest.mark.parametrize("seed,failures", [(4, False), (3, True)])
def test_generate_trace_equals_the_reference(seed, failures):
    from repro.core.traces import generate_trace as jgenerate_trace

    kw = dict(n_jobs=120, horizon_s=7200.0, seed=seed,
              with_failures=failures)
    assert _jobs_tuple(generate_trace(**kw)) == \
        _jobs_tuple(jgenerate_trace(**kw))


@pytest.mark.parametrize("policy", list(Policy))
def test_simulator_run_equals_the_reference(policy):
    """Each policy over one seeded trace with failures, periodic
    checkpoints, service groups, programs and synthetic failure domains:
    both packages' ``Simulator.run`` report the same numbers, and every
    job ends on the same node."""
    import dataclasses

    from repro.core.scheduler import Policy as JPolicy
    from repro.core.simulator import SimParams as JSimParams
    from repro.core.simulator import Simulator as JSimulator
    from repro.core.traces import generate_trace as jgenerate_trace

    def enrich(jobs):
        return [dataclasses.replace(
            j, group=f"svc{i % 3}" if i % 4 == 0 else None,
            programs=(f"p{i % 5}",) if i % 2 else ())
            for i, j in enumerate(jobs)]

    kw = dict(n_jobs=90, horizon_s=3600.0, seed=12, with_failures=True)
    ours = Simulator(enrich(generate_trace(**kw)), num_nodes=5,
                     slices_per_node=2, policy=policy,
                     params=SimParams(checkpoint_interval_s=300.0),
                     failure_domains=2)
    theirs = JSimulator(enrich(jgenerate_trace(**kw)), num_nodes=5,
                        slices_per_node=2, policy=JPolicy(policy.value),
                        params=JSimParams(checkpoint_interval_s=300.0),
                        failure_domains=2)
    got, want = ours.run(), theirs.run()
    assert got["completed"] == 90
    assert got == want
    assert {t: s.node_id for t, s in ours.tasks.items()} == \
        {t: s.node_id for t, s in theirs.tasks.items()}
    assert ours.metrics.snapshot()["counters"] == \
        theirs.metrics.snapshot()["counters"]


def test_sim_params_defaults_are_the_reference_constants():
    """The simulator's costs stay the reference's modelling constants."""
    import dataclasses

    from repro.core.simulator import ServingParams as JServingParams
    from repro.core.simulator import SimParams as JSimParams
    from repro_torch.core.simulator import ServingParams

    assert dataclasses.asdict(SimParams()) == \
        dataclasses.asdict(JSimParams())
    assert dataclasses.asdict(ServingParams()) == \
        dataclasses.asdict(JServingParams())


def test_serving_simulator_trace_raises_not_ported():
    from repro_torch.core.simulator import ServingSimulator

    with pytest.raises(NotImplementedError, match="not ported yet"):
        ServingSimulator([], trace=True)
