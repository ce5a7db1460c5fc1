"""The port's workload-scaling service: every case of
``tests/test_autoscaler.py``, then exact parity of ``open_loop`` and of
the autoscaled ``ServingSimulator`` with the reference's.

Workload-scaling service: policies, hysteresis/cooldown, bounds, the
reconcile contract against a (fake) orchestrator, and the simulator-in-the-
loop smoke run (Fig 14 machinery)."""

import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.simulator import (ServingParams,  # noqa: E402
                                        ServingSimulator)
from repro_torch.scaling import (Autoscaler, LatencySLOPolicy,  # noqa: E402
                                 MetricsRegistry, QueueLengthPolicy,
                                 ScalingSignals, TargetUtilizationPolicy,
                                 burst_rate, open_loop,
                                 signals_from_registry)


def sig(replicas=1, util=0.0, queue=0.0, p95=math.nan):
    return ScalingSignals(replicas=replicas, utilization=util,
                          queue_depth=queue, p95_latency_s=p95)


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------
def test_target_utilization_proportional():
    p = TargetUtilizationPolicy(target=0.6)
    assert p.desired_replicas(sig(replicas=4, util=0.9)) == 6
    assert p.desired_replicas(sig(replicas=4, util=0.3)) == 2
    # idle with empty queue collapses to 1
    assert p.desired_replicas(sig(replicas=4, util=0.0)) == 1


def test_queue_length_policy():
    p = QueueLengthPolicy(target_per_replica=2.0)
    # 9 outstanding / 3-per-replica budget -> 3 replicas
    assert p.desired_replicas(sig(replicas=2, util=1.0, queue=7.0)) == 3
    assert p.desired_replicas(sig(replicas=4, util=0.0, queue=0.0)) == 1


def test_latency_slo_scale_up_on_spike():
    p = LatencySLOPolicy(slo_p95_s=0.5, growth=1.5)
    s = sig(replicas=2, util=1.0, queue=10.0, p95=2.0)
    assert p.desired_replicas(s) == 3            # ceil(2 * 1.5)
    # no latency signal yet -> hold
    assert p.desired_replicas(sig(replicas=2, util=0.9, queue=1.0)) == 2


def test_latency_slo_scale_down_needs_headroom_and_idle():
    p = LatencySLOPolicy(slo_p95_s=1.0, headroom=0.5, idle_utilization=0.5)
    assert p.desired_replicas(sig(replicas=4, util=0.2, p95=0.1)) == 3
    # tail fine but still busy -> hold
    assert p.desired_replicas(sig(replicas=4, util=0.9, p95=0.1)) == 4
    # queued work -> hold even when idle-ish
    assert p.desired_replicas(sig(replicas=4, util=0.2, queue=3.0,
                                  p95=0.1)) == 4


# ---------------------------------------------------------------------------
# reconciler
# ---------------------------------------------------------------------------
def test_scale_up_on_load_spike():
    asc = Autoscaler(LatencySLOPolicy(slo_p95_s=0.5), max_replicas=8)
    got = asc.reconcile(sig(replicas=2, util=1.0, queue=5.0, p95=3.0),
                        now=0.0)
    assert got is not None and got > 2


def test_scale_down_only_after_cooldown():
    asc = Autoscaler(LatencySLOPolicy(slo_p95_s=1.0),
                     scale_down_cooldown_s=30.0)
    idle = sig(replicas=4, util=0.1, p95=0.05)
    assert asc.reconcile(idle, now=0.0) == 3         # first down: free
    assert asc.reconcile(idle, now=10.0) is None     # inside cooldown
    assert asc.reconcile(idle, now=31.0) == 3        # cooldown elapsed
    reasons = [d.reason for d in asc.decisions]
    assert "down-cooldown" in reasons


def test_scale_up_rearms_shrink_guard():
    """After a burst-driven scale-up, the first shrink must wait out the
    down-cooldown (anti-flap), instead of firing immediately."""
    asc = Autoscaler(LatencySLOPolicy(slo_p95_s=0.5),
                     scale_down_cooldown_s=30.0, max_replicas=8)
    assert asc.reconcile(sig(replicas=2, util=1.0, queue=9.0, p95=2.0),
                         now=0.0) == 3             # burst: scale up
    idle = sig(replicas=3, util=0.1, p95=0.05)
    assert asc.reconcile(idle, now=5.0) is None    # guard re-armed by up
    assert asc.reconcile(idle, now=31.0) == 2      # cooldown elapsed


def test_scale_up_cooldown():
    asc = Autoscaler(LatencySLOPolicy(slo_p95_s=0.5),
                     scale_up_cooldown_s=10.0, max_replicas=16)
    hot = sig(replicas=2, util=1.0, queue=9.0, p95=2.0)
    assert asc.reconcile(hot, now=0.0) == 3
    assert asc.reconcile(sig(replicas=3, util=1.0, queue=9.0, p95=2.0),
                         now=1.0) is None            # up-cooldown
    assert asc.reconcile(sig(replicas=3, util=1.0, queue=9.0, p95=2.0),
                         now=11.0) == 5


def test_bounds_never_exceeded():
    asc = Autoscaler(LatencySLOPolicy(slo_p95_s=0.1), min_replicas=2,
                     max_replicas=5, scale_down_cooldown_s=0.0)
    replicas = 2
    for i in range(20):              # persistent SLO breach
        got = asc.reconcile(sig(replicas=replicas, util=1.0, queue=50.0,
                                p95=9.0), now=float(i))
        if got is not None:
            replicas = got
        assert 2 <= replicas <= 5
    assert replicas == 5
    # persistent idle never goes below min
    for i in range(20, 40):
        got = asc.reconcile(sig(replicas=replicas, util=0.0, p95=0.0),
                            now=float(i))
        if got is not None:
            replicas = got
        assert replicas >= 2


def test_tolerance_dead_band():
    asc = Autoscaler(TargetUtilizationPolicy(target=0.5), tolerance=0.3,
                     max_replicas=32)
    # desired 12 vs current 10: |2|/10 <= 0.3 -> hold
    assert asc.reconcile(sig(replicas=10, util=0.6), now=0.0) is None
    # desired 20 vs current 10: outside the band -> act
    assert asc.reconcile(sig(replicas=10, util=1.0), now=1.0) == 20


# ---------------------------------------------------------------------------
# reconcile contract against a (fake) live orchestrator
# ---------------------------------------------------------------------------
class _FakeDep:
    def __init__(self):
        self.status = "running"


class _FakeOrch:
    """Duck-typed Orchestrator surface used by OrchestratorScaler."""

    def __init__(self, free_nodes=4):
        self.metrics = MetricsRegistry()
        self.deployments = {"svc-base": _FakeDep()}
        self._free = free_nodes
        self._n = 0
        self.removed = []

    def place_replica(self, cid):
        return f"node{self._free}" if self._free > 0 else None

    def scale_horizontal(self, cid, node):
        assert self._free > 0
        self._free -= 1
        self._n += 1
        new_cid = f"{cid}-r{self._n}"
        self.deployments[new_cid] = _FakeDep()
        return new_cid

    def scale_in(self, cid, drain_s=0.0):
        self.deployments[cid].status = "removed"
        self._free += 1
        self.removed.append(cid)


def test_orchestrator_scaler_scale_out_and_in():
    from repro_torch.scaling.autoscaler import OrchestratorScaler

    orch = _FakeOrch(free_nodes=3)
    scaler = OrchestratorScaler(orch, "svc-base", service="svc")
    assert scaler.current_replicas() == 1
    scaler.scale_to(3)
    assert scaler.current_replicas() == 3
    scaler.scale_to(5)                   # only one free slot left
    assert scaler.current_replicas() == 4
    scaler.scale_to(1)                   # base is never removed
    assert scaler.current_replicas() == 1
    assert len(orch.removed) == 3
    assert orch.metrics.gauge("replicas", service="svc").value == 1


# ---------------------------------------------------------------------------
# simulator in the loop (Fig 14 smoke)
# ---------------------------------------------------------------------------
def test_serving_simulator_autoscaler_smoke():
    reqs = open_loop(burst_rate(3.0, 6.0, 30.0, 30.0), 90.0, seed=7,
                     mean_service_s=0.25)
    params = ServingParams(slo_latency_s=1.0, control_interval_s=1.0)

    fixed = ServingSimulator(reqs, initial_replicas=2, params=params).run()

    asc = Autoscaler(LatencySLOPolicy(slo_p95_s=1.0), min_replicas=1,
                     max_replicas=10, scale_down_cooldown_s=5.0)
    elastic = ServingSimulator(
        reqs, autoscaler=asc, initial_replicas=2, params=params).run()

    assert fixed["completed"] == elastic["completed"] == len(reqs)
    assert elastic["slo_attainment"] > fixed["slo_attainment"]
    assert elastic["max_replicas"] <= 10
    # scaled back down after the burst
    assert elastic["mean_replicas"] < 10
    assert any(d.applied for d in asc.decisions)


def test_serving_simulator_emits_canonical_schema():
    reqs = open_loop(burst_rate(2.0, 4.0, 10.0, 10.0), 30.0, seed=3,
                     mean_service_s=0.2)
    asc = Autoscaler(TargetUtilizationPolicy(0.6), max_replicas=6)
    sim = ServingSimulator(reqs, autoscaler=asc, initial_replicas=1)
    sim.run()
    snap = sim.metrics.snapshot()
    assert snap["ts"] == sim.now                       # virtual clock
    assert snap["counters"]["requests_total{service=svc}"] == len(reqs)
    assert "queue_depth{service=svc}" in snap["gauges"]
    assert "utilization{service=svc}" in snap["gauges"]
    assert "request_latency_seconds{service=svc}" in snap["histograms"]
    assert "replicas_ts{service=svc}" in snap["series"]
    # the signal reader the orchestrator uses works against the sim registry
    s = signals_from_registry(sim.metrics, "svc")
    assert s.replicas >= 1


def test_closed_loop_gen_tokens_and_conservation():
    """Closed-loop think-time mode: ragged generation lengths ride along
    (engine-served runs), and the simulator completes exactly the requests
    the generator issued — the defining closed-loop property."""
    from repro_torch.scaling import ClosedLoopGen

    gen = ClosedLoopGen(n_clients=6, think_time_s=0.2, mean_service_s=0.1,
                        horizon_s=20.0, seed=3, tokens_range=(4, 9))
    init = gen.initial()
    assert len(init) == 6
    assert all(4 <= r.n_tokens < 9 for r in init)
    rep = ServingSimulator(init, closed_gen=gen,
                           initial_replicas=2).run()
    assert rep["completed"] == gen.issued > 6


# ---------------------------------------------------------------------------
# cache-memory occupancy: KV pool model + pressure signal/policy
# ---------------------------------------------------------------------------
def test_kv_pressure_policy_composes():
    from repro_torch.scaling.autoscaler import KVPressurePolicy

    p = KVPressurePolicy(inner=QueueLengthPolicy(target_per_replica=2.0),
                         high_watermark=0.8)
    calm = sig(replicas=2)
    calm.kv_pressure = 0.5
    assert p.desired_replicas(calm) == p.inner.desired_replicas(calm)
    hot = sig(replicas=2)
    hot.kv_pressure = 0.95                 # pool nearly full, queue empty
    assert p.desired_replicas(hot) == 3


def test_serving_simulator_kv_pool_model():
    """A tight pool shows up as the canonical kv signal, blocks admission
    on memory, and OOM-preempts growing requests — which the autoscaler
    relieves by adding replicas (capacity = replicas x pool_pages)."""
    from repro_torch.core.simulator import KVModelParams
    from repro_torch.scaling.autoscaler import (KVPressurePolicy,
                                          signals_from_registry)

    reqs = open_loop(burst_rate(3.0, 5.0, 3.0, 8.0), 20.0, seed=5,
                     mean_service_s=0.4, tokens_range=(8, 33))
    kv = KVModelParams(pool_pages=5, page_tokens=8, prompt_tokens=16,
                       default_tokens=16)
    fixed = ServingSimulator(reqs, initial_replicas=2, kv_model=kv)
    fixed_rep = fixed.run()
    assert fixed_rep["completed"] == len(reqs)         # preempts, finishes
    assert fixed_rep["kv_peak_occupancy"] > 0.9        # pool genuinely hot
    assert fixed_rep["kv_preemptions"] > 0
    snap = fixed.metrics.snapshot()
    assert "kv_pages_in_use_ratio{service=svc}" in snap["gauges"]
    s = signals_from_registry(fixed.metrics, "svc")
    assert 0.0 <= s.kv_pressure <= 1.0

    asc = Autoscaler(KVPressurePolicy(QueueLengthPolicy(2.0),
                                      high_watermark=0.8),
                     max_replicas=8, scale_down_cooldown_s=5.0)
    elastic = ServingSimulator(reqs, autoscaler=asc, initial_replicas=2,
                               kv_model=kv).run()
    assert elastic["completed"] == len(reqs)
    assert elastic["max_replicas"] > 2                 # pressure scaled out
    assert elastic["kv_preemptions"] <= fixed_rep["kv_preemptions"]


# ---------------------------------------------------------------------------
# speculative decode in the service model
# ---------------------------------------------------------------------------
def test_engine_service_model_speculation_speedup():
    """Speculation divides the per-token time by the expected committed
    tokens per iteration, E = sum a^i: 1 at a=0 (plain), k+1 at a=1."""
    from repro_torch.core.simulator import (engine_service_model,
                                      spec_tokens_per_iteration)
    from repro_torch.scaling.loadgen import Request

    assert spec_tokens_per_iteration(2, 0.0) == 1.0
    assert spec_tokens_per_iteration(2, 1.0) == 3.0
    assert spec_tokens_per_iteration(3, 0.5) == pytest.approx(1.875)

    req = Request(rid="r", arrival_t=0.0, service_s=1.0, n_tokens=9)
    plain = engine_service_model(0.1, 0.02)
    spec_off = engine_service_model(0.1, 0.02, spec_k=0,
                                    spec_accept_rate=0.9)
    forced = engine_service_model(0.1, 0.02, spec_k=2, spec_accept_rate=1.0)
    assert plain(req) == spec_off(req) == pytest.approx(0.1 + 8 * 0.02)
    assert forced(req) == pytest.approx(0.1 + 8 * 0.02 / 3.0)
    # acceptance clamps to [0, 1]
    wild = engine_service_model(0.1, 0.02, spec_k=2, spec_accept_rate=7.0)
    assert wild(req) == forced(req)


def test_serving_simulator_publishes_spec_accept_gauge():
    from repro_torch.core.simulator import engine_service_model
    from repro_torch.scaling.autoscaler import M_SPEC_ACCEPT_RATE

    reqs = open_loop(burst_rate(2.0, 3.0, 5.0, 5.0), 15.0, seed=9,
                     mean_service_s=0.2, tokens_range=(4, 9))
    spec = ServingSimulator(
        reqs, initial_replicas=2,
        service_time_fn=engine_service_model(0.05, 0.02, spec_k=2,
                                             spec_accept_rate=0.7),
        spec_accept_rate=0.7)
    rep = spec.run()
    assert rep["completed"] == len(reqs)
    snap = spec.metrics.snapshot()
    assert snap["gauges"][f"{M_SPEC_ACCEPT_RATE}{{service=svc}}"] == 0.7
    # faster service at equal traffic: speculation strictly helps the tail
    plain = ServingSimulator(
        reqs, initial_replicas=2,
        service_time_fn=engine_service_model(0.05, 0.02)).run()
    assert rep["p95_latency_s"] <= plain["p95_latency_s"]


# ---------------------------------------------------------------------------
# parity with the reference package: same seeds, same outputs, exactly
# ---------------------------------------------------------------------------
def _requests_tuple(reqs):
    return [(r.rid, r.arrival_t, r.service_s, r.client, r.n_tokens)
            for r in reqs]


@pytest.mark.parametrize("seed,tokens_range", [(7, None), (41, (8, 65))])
def test_open_loop_arrivals_equal_the_reference(seed, tokens_range):
    from repro.scaling import burst_rate as jburst_rate
    from repro.scaling import diurnal_rate as jdiurnal_rate
    from repro.scaling import open_loop as jopen_loop
    from repro_torch.scaling import diurnal_rate

    for ours, theirs in (
            (burst_rate(0.63, 4.0, 10.0, 10.0),
             jburst_rate(0.63, 4.0, 10.0, 10.0)),
            (diurnal_rate(1.0, 5.0, 60.0), jdiurnal_rate(1.0, 5.0, 60.0))):
        got = open_loop(ours, 30.0, seed=seed, mean_service_s=0.4,
                        tokens_range=tokens_range)
        want = jopen_loop(theirs, 30.0, seed=seed, mean_service_s=0.4,
                          tokens_range=tokens_range)
        assert got and _requests_tuple(got) == _requests_tuple(want)


def test_closed_loop_gen_equals_the_reference():
    from repro.scaling import ClosedLoopGen as JClosedLoopGen
    from repro_torch.scaling import ClosedLoopGen

    kw = dict(n_clients=5, think_time_s=0.3, mean_service_s=0.1,
              horizon_s=10.0, seed=11, tokens_range=(4, 9))
    ours, theirs = ClosedLoopGen(**kw), JClosedLoopGen(**kw)
    a, b = ours.initial(), theirs.initial()
    assert _requests_tuple(a) == _requests_tuple(b)
    for i, (ra, rb) in enumerate(zip(a, b)):
        na = ours.on_complete(ra, 1.0 + i)
        nb = theirs.on_complete(rb, 1.0 + i)
        assert _requests_tuple([na]) == _requests_tuple([nb])


def _policies(mod):
    return {
        "latency-slo": lambda: mod.LatencySLOPolicy(slo_p95_s=1.0,
                                                    growth=2.0),
        "queue-len": lambda: mod.QueueLengthPolicy(2.0),
        "target-util": lambda: mod.TargetUtilizationPolicy(0.6),
        "kv-pressure": lambda: mod.KVPressurePolicy(
            mod.QueueLengthPolicy(2.0), high_watermark=0.8),
    }


@pytest.mark.parametrize("policy", ["latency-slo", "queue-len",
                                    "target-util", "kv-pressure"])
def test_autoscaled_serving_simulator_equals_the_reference(policy):
    """The same trace, policy and service model through both packages'
    ``ServingSimulator``: equal reports, equal autoscaler decisions."""
    import repro.scaling.autoscaler as jauto
    import repro_torch.scaling.autoscaler as tauto
    from repro.core.simulator import KVModelParams as JKV
    from repro.core.simulator import ServingParams as JParams
    from repro.core.simulator import ServingSimulator as JSim
    from repro.core.simulator import engine_service_model as jmodel
    from repro.scaling import burst_rate as jburst_rate
    from repro.scaling import open_loop as jopen_loop
    from repro_torch.core.simulator import KVModelParams, \
        engine_service_model

    def run(mod, sim_cls, params_cls, kv_cls, model, ol, br):
        reqs = ol(br(2.0, 4.0, 10.0, 10.0), 40.0, seed=5,
                  mean_service_s=0.3, tokens_range=(8, 33))
        asc = mod.Autoscaler(_policies(mod)[policy](), max_replicas=6,
                             scale_down_cooldown_s=3.0)
        kv = (kv_cls(pool_pages=6, page_tokens=8, prompt_tokens=16)
              if policy == "kv-pressure" else None)
        sim = sim_cls(reqs, autoscaler=asc, initial_replicas=1,
                      params=params_cls(slo_latency_s=1.0),
                      service_time_fn=model(0.1, 0.02), kv_model=kv)
        rep = sim.run()
        return rep, [(d.t, d.current, d.desired, d.applied, d.reason)
                     for d in asc.decisions]

    got = run(tauto, ServingSimulator, ServingParams, KVModelParams,
              engine_service_model, open_loop, burst_rate)
    want = run(jauto, JSim, JParams, JKV, jmodel, jopen_loop, jburst_rate)
    assert got[0]["completed"] > 0
    assert got == want
