"""The port's span tracer (``repro_torch.obs``) against the reference's
``tests/test_obs.py``, case for case: virtual-clock determinism, bounded
retention (ring + keep-slowest + probabilistic sampling), Chrome-trace
export round trip, and the live instrumentation — a router -> engine ->
monitor request forms one connected span tree, monitor phase attribution
sums to no more than the handler's wall time, and the engine's host/device
split is published.  Plus ``tests/test_chaos.py``'s recovery-trace link
case and ``tests/test_straggler.py``'s migration-trace link through the
orchestrator's ``cluster`` trace, and parity with the reference package: the simulator under
``trace=True`` exports the reference's Chrome trace event for event, and
the same tracer calls give the same export.

The engine cases serve yi-9b-smoke in float32 (registered for this module
as ``tests/test_torch_engine.py`` does) on ``device="cpu"``.
"""

import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jcfg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.core import FunkyCL, Monitor, SliceAllocator  # noqa: E402
from repro_torch.core.simulator import ServingSimulator  # noqa: E402
from repro_torch.obs import (Tracer, chrome_trace_events,  # noqa: E402
                             export_chrome_trace, validate_chrome_trace)
from repro_torch.scaling import burst_rate, open_loop  # noqa: E402
from repro_torch.scaling.metrics import MetricsRegistry  # noqa: E402
from repro_torch.scaling.serving import RequestRouter  # noqa: E402
from repro_torch.serve.engine import (M_DEVICE_US, M_HOST_US,  # noqa: E402
                                      M_QUEUE_WAIT_US,
                                      ContinuousBatchingEngine, ServeRequest)

ARCH = "yi-9b-f32-smoke"
PROMPT_LEN = 8
PAGE = 4


@pytest.fixture(scope="module", autouse=True)
def f32_arch():
    mp = pytest.MonkeyPatch()
    for mod in (jcfg, tcfg):
        base = mod.ARCHS["yi-9b"]
        mp.setitem(mod.ARCHS, "yi-9b-f32", dataclasses.replace(
            base, name="yi-9b-f32", dtype="float32"))
    yield
    mp.undo()


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _engine(name, tracer=None, slots=2, max_new=8, **kw):
    reg = MetricsRegistry()
    mon = Monitor(name, SliceAllocator("n0", 1, device="cpu"),
                  telemetry=reg, tracer=tracer)
    eng = ContinuousBatchingEngine(ARCH, FunkyCL(mon), slots=slots,
                                   prompt_len=PROMPT_LEN,
                                   max_new_tokens=max_new, registry=reg,
                                   page_size=PAGE, **kw)
    eng.setup()
    return mon, eng, reg


# ---------------------------------------------------------------------------
# Tracer core under a virtual clock
# ---------------------------------------------------------------------------
def test_span_tree_virtual_clock_deterministic():
    clk = FakeClock()
    tracer = Tracer(clock=clk)
    tr = tracer.start_trace("request", trace_id="r0", service="svc")
    assert tr.root.start_t == 0.0 and tr.root.parent_id == 0

    clk.now = 1.0
    queue = tr.span("router.queue")
    clk.now = 3.0
    queue.end()
    admit = tr.span("engine.admit", engine="eng0")
    clk.now = 3.5
    ex = admit.child("monitor.execute", program="decode")
    clk.now = 4.0
    ex.end()
    admit.end()
    clk.now = 6.0
    tr.finish(tokens=4)

    assert queue.start_t == 1.0 and queue.end_t == 3.0
    assert queue.duration == 2.0
    assert ex.start_t == 3.5 and ex.duration == 0.5
    assert tr.duration == 6.0 and tr.finished

    spans = tr.spans()
    assert spans[0] is tr.root
    by_id = {s.span_id: s for s in spans}
    assert by_id[queue.parent_id] is tr.root
    assert by_id[admit.parent_id] is tr.root
    assert by_id[ex.parent_id] is admit
    clk2 = FakeClock()
    t2 = Tracer(clock=clk2).start_trace("request", trace_id="r0")
    s2 = t2.span("router.queue")
    assert (s2.span_id, s2.parent_id) == (queue.span_id, queue.parent_id)


def test_parent_defaults_to_root_and_context_manager():
    clk = FakeClock()
    tr = Tracer(clock=clk).start_trace("t")
    with tr.span("a") as sp:
        clk.now = 2.0
    assert sp.end_t == 2.0
    assert sp.end(t=99.0).end_t == 2.0          # end() is idempotent
    assert sp.parent_id == tr.root.span_id


def test_trace_span_ring_never_evicts_root():
    clk = FakeClock()
    tracer = Tracer(clock=clk, max_spans_per_trace=4)
    tr = tracer.start_trace("hot", trace_id="h")
    for i in range(10):
        tr.span(f"s{i}").end()
    spans = tr.spans()
    assert spans[0] is tr.root
    assert len(spans) == 1 + 4
    assert [s.name for s in spans[1:]] == ["s6", "s7", "s8", "s9"]
    assert tr.dropped_spans == 6


def test_ring_capacity_and_keep_slowest():
    clk = FakeClock()
    tracer = Tracer(clock=clk, capacity=4, sample_rate=1.0, keep_slowest=2)
    durs = [1.0, 9.0, 2.0, 7.0, 3.0, 0.5, 0.25, 0.125]
    for i, d in enumerate(durs):
        clk.now = 10.0 * i
        tr = tracer.start_trace("t", trace_id=f"t{i}")
        clk.now = 10.0 * i + d
        tr.finish()
    ids = {t.trace_id for t in tracer.traces()}
    assert {"t4", "t5", "t6", "t7"} <= ids
    assert {"t1", "t3"} <= ids
    assert "t0" not in ids and "t2" not in ids


def test_probabilistic_sampling_bounds_and_determinism():
    def run(seed):
        tracer = Tracer(clock=FakeClock(), capacity=1000, sample_rate=0.25,
                        keep_slowest=0, seed=seed)
        for i in range(400):
            tracer.start_trace("t", trace_id=f"t{i}").finish()
        return [t.trace_id for t in tracer.traces()]

    a, b = run(7), run(7)
    assert a == b
    assert 40 <= len(a) <= 160
    t0 = Tracer(clock=FakeClock(), sample_rate=0.0, keep_slowest=0)
    for i in range(10):
        t0.start_trace("t").finish()
    assert t0.traces() == [] and t0.finished == 10
    clk = FakeClock()
    t1 = Tracer(clock=clk, sample_rate=0.0, keep_slowest=1)
    tr = t1.start_trace("slow")
    clk.now = 5.0
    tr.finish()
    assert [t.trace_id for t in t1.traces()] == [tr.trace_id]


def test_live_traces_visible_until_finished():
    tracer = Tracer(clock=FakeClock())
    tr = tracer.start_trace("inflight", trace_id="x")
    assert tracer.find("x") is tr
    assert tracer.traces(include_live=False) == []
    tr.finish()
    assert tracer.find("x") is tr


# ---------------------------------------------------------------------------
# Chrome-trace export
# ---------------------------------------------------------------------------
def test_chrome_export_round_trip(tmp_path):
    clk = FakeClock()
    tracer = Tracer(clock=clk)
    tr = tracer.start_trace("request", trace_id="r9", service="svc")
    clk.now = 0.25
    sp = tr.span("engine.admit", engine="e0")
    clk.now = 0.75
    sp.end()
    unfinished = tr.span("engine.decode")
    clk.now = 1.0
    tr.finish(tokens=3)

    path = tmp_path / "trace.json"
    export_chrome_trace(tracer, str(path))
    doc = json.loads(path.read_text())
    assert validate_chrome_trace(doc) == {"traces": 1, "spans": 3}
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    assert {"process_name", "thread_name"} <= {e["name"] for e in meta}
    xs = {e["name"]: e for e in evs if e["ph"] == "X"}
    assert set(xs) == {"request", "engine.admit", "engine.decode"}
    adm = xs["engine.admit"]
    assert adm["ts"] == pytest.approx(0.25e6)
    assert adm["dur"] == pytest.approx(0.5e6)
    assert adm["args"]["engine"] == "e0"
    assert adm["args"]["parent_id"] == xs["request"]["args"]["span_id"]
    assert adm["pid"] == xs["request"]["pid"]
    assert adm["tid"] != xs["request"]["tid"]
    assert unfinished.end_t is None
    assert xs["engine.decode"]["args"]["unfinished"] is True
    assert xs["engine.decode"]["dur"] == pytest.approx(0.25e6)


def test_validate_rejects_orphans_and_bad_ph():
    doc = chrome_trace_events([])
    doc["traceEvents"].append({"name": "x", "ph": "B", "pid": 1, "tid": 1})
    with pytest.raises(ValueError, match="unexpected ph"):
        validate_chrome_trace(doc)
    orphan = {"traceEvents": [
        {"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 1,
         "args": {"span_id": 2, "parent_id": 1, "trace_id": "t"}}]}
    with pytest.raises(ValueError, match="orphaned|root"):
        validate_chrome_trace(orphan)


def _tracer_script(mod):
    """One fixed sequence of tracer calls under a virtual clock (links,
    children, annotations, an unfinished span, a live trace)."""
    clk = FakeClock()
    tracer = mod.Tracer(clock=clk, capacity=3, keep_slowest=1,
                        sample_rate=0.5, seed=3)
    prev = None
    for i in range(6):
        clk.now = float(i)
        tr = tracer.start_trace("request", trace_id=f"r{i}", service="svc")
        sp = tr.span("router.queue", n=i)
        clk.now += 0.25
        sp.annotate(engine="e0").end()
        adm = tr.span("engine.admit", bucket=8)
        adm.child("monitor.execute", program="prefill_8").end(
            clk.now + 0.125)
        clk.now += 0.5 + 0.1 * i
        adm.end()
        if prev is not None:
            tr.link(prev, relation="recovers")
        if i < 5:
            tr.finish(tokens=i)
        prev = tr
    tr.span("engine.decode")                    # left open on a live trace
    clk.now += 1.0
    return tracer.chrome_trace()


def test_chrome_trace_equals_the_reference_for_the_same_calls():
    import repro.obs as jobs
    import repro_torch.obs as tobs

    assert _tracer_script(tobs) == _tracer_script(jobs)


# ---------------------------------------------------------------------------
# Simulator (virtual clock) publishes into the same abstraction
# ---------------------------------------------------------------------------
def test_simulator_traces_deterministic_virtual_time():
    reqs = open_loop(burst_rate(3.0, 2.0, 3.0, 3.0), 10.0, seed=5,
                     mean_service_s=0.2)

    def run():
        sim = ServingSimulator(list(reqs), initial_replicas=2, trace=True)
        sim.run()
        return sim.tracer

    tr1, tr2 = run(), run()
    done1 = [t for t in tr1.traces() if t.finished]
    assert done1, "simulator produced no finished request traces"
    t = done1[0]
    names = [s.name for s in t.spans()]
    assert "router.queue" in names and "sim.service" in names
    assert "latency_s" in t.root.labels
    d1 = [x.to_dict() for x in tr1.traces() if x.finished]
    d2 = [x.to_dict() for x in tr2.traces() if x.finished]
    assert d1 == d2
    validate_chrome_trace(tr1.chrome_trace())


def test_simulator_chrome_trace_equals_the_reference():
    """One seed, the same trace: the port's simulator under ``trace=True``
    exports the reference simulator's Chrome trace event for event."""
    from repro.core.simulator import ServingSimulator as JServingSimulator
    from repro.scaling import burst_rate as jburst_rate
    from repro.scaling import open_loop as jopen_loop

    def run(sim_cls, ol, br):
        reqs = ol(br(3.0, 2.0, 3.0, 3.0), 10.0, seed=11,
                  mean_service_s=0.2)
        sim = sim_cls(list(reqs), initial_replicas=2, trace=True)
        sim.run()
        return sim.tracer.chrome_trace()

    port = run(ServingSimulator, open_loop, burst_rate)
    ref = run(JServingSimulator, jopen_loop, jburst_rate)
    assert len(port["traceEvents"]) > 100
    assert port == ref


# ---------------------------------------------------------------------------
# Live plane: router -> engine -> monitor, one connected tree per request
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def traced_run(tmp_path_factory, f32_arch):
    tracer = Tracer(capacity=512, sample_rate=1.0)
    mon, eng, reg = _engine("obs-test", tracer=tracer)
    router = RequestRouter("svc", registry=reg, kv_aware=False,
                           tracer=tracer)
    rng = np.random.Generator(np.random.Philox(0))
    for i, n in enumerate([2, 5, 3]):
        router.submit(ServeRequest(
            rid=f"r{i}", prompt=rng.integers(0, 100, PROMPT_LEN),
            max_new_tokens=n))
    while router.outstanding() or not eng.idle:
        eng.pump(router)
    mon.vfpga_exit()
    path = tmp_path_factory.mktemp("obs") / "live.json"
    export_chrome_trace(tracer, str(path))
    return tracer, eng, reg, json.loads(path.read_text())


def test_request_trace_is_one_connected_tree(traced_run):
    tracer, eng, _, _ = traced_run
    assert sorted(eng.completed) == ["r0", "r1", "r2"]
    for rid in ("r0", "r1", "r2"):
        tr = tracer.find(rid)
        assert tr is not None and tr.finished
        spans = tr.spans()
        ids = {s.span_id for s in spans}
        for s in spans:
            assert s.parent_id == 0 or s.parent_id in ids, \
                f"{rid}: span {s.name} orphaned"
        names = {s.name for s in spans}
        assert {"router.queue", "engine.queue", "engine.admit",
                "engine.decode", "monitor.execute",
                "execute.device"} <= names
        for s in spans:
            assert s.end_t is not None
            assert s.end_t >= s.start_t
            assert s.end_t <= tr.root.end_t + 1e-9
        assert tr.root.labels["tokens"] == len(eng.completed[rid].tokens)


def test_exported_live_trace_validates(traced_run):
    _, _, _, doc = traced_run
    stats = validate_chrome_trace(doc)
    assert stats["traces"] >= 3
    execs = [e for e in doc["traceEvents"]
             if e.get("ph") == "X" and e["name"] == "execute.device"]
    assert execs and any(e["dur"] > 0 for e in execs)


def test_iteration_traces_cover_decode_steps(traced_run):
    tracer, eng, _, _ = traced_run
    its = [t for t in tracer.traces()
           if t.name == "engine.step" and t.finished]
    assert its, "no per-iteration engine.step traces"
    assert all(t.trace_id.startswith(eng.engine_id) for t in its)
    decoded = sum(t.root.labels.get("decoded", 0) for t in its)
    admitted = sum(t.root.labels.get("admitted", 0) for t in its)
    total = sum(len(rec.tokens) for rec in eng.completed.values())
    assert decoded + admitted == total


def test_phase_attribution_bounded_by_wall_time(traced_run):
    tracer, _, _, _ = traced_run
    for tr in tracer.traces():
        for mon_span in tr.find_spans("monitor.execute"):
            kids = [s for s in tr.spans()
                    if s.parent_id == mon_span.span_id]
            assert kids, "monitor.execute has no phase children"
            for k in kids:
                assert k.duration >= 0.0
            assert sum(k.duration for k in kids) \
                <= mon_span.duration + 1e-6


def test_host_device_split_published(traced_run):
    _, eng, reg, _ = traced_run
    split = eng.host_device_split()
    total = sum(len(rec.tokens) for rec in eng.completed.values())
    assert split["tokens"] == total
    assert split["execs"] > 0
    assert split["device_us_per_token"] > 0.0
    assert split["host_us_per_token"] >= 0.0
    text = reg.to_prometheus_text()
    assert M_HOST_US in text and M_DEVICE_US in text
    assert (f'{M_DEVICE_US}{{engine="{eng.engine_id}",service="svc"}}'
            in text)


def test_queue_wait_gauge_denominator_counts_only_executes(traced_run):
    """The queue-wait gauge averages per-EXECUTE queue time: its
    denominator is the EXECUTE tally, not every completion of the step."""
    _, eng, reg, _ = traced_run
    split = eng.host_device_split()
    assert eng._attr_execs == split["execs"] == sum(
        eng.program_execs.values())
    assert split["queue_wait_us_mean"] == pytest.approx(
        eng._attr_queue_wait_s / split["execs"] * 1e6)
    val = reg.gauge(M_QUEUE_WAIT_US, service="svc",
                    engine=eng.engine_id).value
    assert val == pytest.approx(split["queue_wait_us_mean"])


def test_engine_crash_dumps_flight_record(monkeypatch):
    """An unexpected step() exception leaves the event ring on disk before
    the error reaches the caller."""
    mon, eng, reg = _engine("obs-crash", slots=1, max_new=4)
    reg.record_event("engine_admit", rid="x", slot=0)

    def boom():
        raise RuntimeError("boom")

    monkeypatch.setattr(eng, "_step_inner", boom)
    with pytest.raises(RuntimeError, match="boom"):
        eng.step()
    path = os.path.join(tempfile.gettempdir(),
                        f"funky_flight_{eng.engine_id}.json")
    with open(path) as f:
        doc = json.load(f)
    os.unlink(path)
    assert "RuntimeError" in doc["context"]["error"]
    assert doc["context"]["engine"] == eng.engine_id
    assert any(e["kind"] == "engine_admit" for e in doc["events"])
    mon.vfpga_exit()


def test_untraced_engine_still_attributes_phases():
    """No tracer anywhere: the split still comes from Completion.phases."""
    mon, eng, _ = _engine("obs-plain", max_new=6)
    assert eng.tracer is None
    rng = np.random.Generator(np.random.Philox(1))
    eng.submit(ServeRequest(rid="p0", prompt=rng.integers(0, 100, PROMPT_LEN),
                            max_new_tokens=4))
    eng.run_until_drained()
    mon.vfpga_exit()
    split = eng.host_device_split()
    assert split["tokens"] == 4
    assert split["device_us_per_token"] > 0.0


def test_traced_engine_serves_the_untraced_tokens(traced_run):
    """Tracing changes no token: the traced run's transcript equals an
    untraced engine's on the same requests."""
    _, eng, _, _ = traced_run
    mon, plain, _ = _engine("obs-untraced")
    rng = np.random.Generator(np.random.Philox(0))
    for i, n in enumerate([2, 5, 3]):
        plain.submit(ServeRequest(
            rid=f"r{i}", prompt=rng.integers(0, 100, PROMPT_LEN),
            max_new_tokens=n))
    plain.run_until_drained()
    mon.vfpga_exit()
    assert {r: list(c.tokens) for r, c in plain.completed.items()} == \
        {r: list(c.tokens) for r, c in eng.completed.items()}


# ---------------------------------------------------------------------------
# tests/test_chaos.py: the recovery-trace link
# ---------------------------------------------------------------------------
def test_replay_links_recovery_traces():
    """A replayed request's new trace carries a span link back to its
    crashed predecessor (same trace_id = rid), and the Chrome export puts
    the link on the root event."""
    tracer = Tracer()
    router = RequestRouter("link-svc", tracer=tracer)
    rng = np.random.Generator(np.random.Philox(0))
    reqs = [ServeRequest(rid=f"r{i}", prompt=rng.integers(0, 100, 8),
                         max_new_tokens=4) for i in range(2)]
    for r in reqs:
        router.submit(r)
    popped = router.pop(2, engine_id="eng-a")
    for r in popped:
        r.committed = [1, 2]               # as if two tokens decoded
    n = router.fail_engine("eng-a")
    assert n == 2 and router.in_flight == 0
    assert router.pending_count() == 2
    assert router.replayed == {"r0": [1, 2], "r1": [1, 2]}
    for r in popped:
        assert r.trace is not None
        assert r.trace.links[0]["trace_id"] == r.rid
        assert r.trace.links[0]["relation"] == "recovers"
        r.trace.finish()
    doc = tracer.chrome_trace()
    validate_chrome_trace(doc)
    roots = [ev for ev in doc["traceEvents"]
             if ev.get("ph") == "X" and ev["args"].get("parent_id") == 0
             and "links" in ev["args"]]
    assert len(roots) == 2


# ---------------------------------------------------------------------------
# The orchestrator's cluster trace (tests/test_straggler.py's link case)
# ---------------------------------------------------------------------------
def test_migrate_trace_links_pre_and_post():
    """A migrated task's pre- and post-migration traces are linked with
    relation "migrates", the control actions are spans of the ``cluster``
    trace, and the link survives the Chrome export ``trace_dump_torch``
    reads."""
    import sys
    import time

    from repro_torch.core import TaskImage, make_cluster
    from repro_torch.core.scheduler import Policy, TaskState

    tracer = Tracer(capacity=256, sample_rate=1.0)
    img = TaskImage(name="j", kind="train", arch="yi-9b-smoke", seq_len=16,
                    global_batch=4, total_steps=150, chunks=1)
    cl = make_cluster(num_nodes=2, slices_per_node=1, images={"j": img},
                      policy=Policy.PRE_MG, tracer=tracer, device="cpu")
    orch = cl.orchestrator
    orch.start(tick_interval=0.02)
    try:
        cid = orch.submit("j")
        st = orch._sched_tasks[cid]

        def wait(cond, timeout=120):
            deadline = time.time() + timeout
            while time.time() < deadline and not cond():
                time.sleep(0.01)
            return cond()

        assert wait(lambda: st.state == TaskState.RUNNING
                    and st.node_id is not None)
        node = st.node_id
        # check_stragglers' eviction half (its decision needs three
        # measurable peers and a rate window; the link plumbing through
        # _execute is what is under test)
        orch.agents[node].evict(cid)
        pre = orch.tracer.event_span("orch.migrate_out", cid=cid, node=node)
        pre.finish()
        with orch._lock:
            orch.scheduler.task_done(cid)
            st.state = TaskState.EVICTED
            st.meta["migrate_from"] = node
            orch.scheduler.submit(st)
        orch._pending_migrate_links[cid] = pre
        assert wait(lambda: st.state == TaskState.RUNNING)
        assert wait(lambda: not orch._pending_migrate_links)
        post = [t for t in tracer.traces() if t.name == "orch.migrate_in"]
        assert post, "no post-migration trace emitted"
        assert post[0].links[0]["relation"] == "migrates"
        assert post[0].links[0]["trace_id"] == pre.trace_id
        names = {s.name for s in tracer.find("cluster").spans()}
        assert {"orch.deploy"} <= names
        assert names & {"orch.resume", "orch.migrate"}
        sys.path.insert(0, "tools")
        try:
            from trace_dump_torch import links_of, spans_by_trace
        finally:
            sys.path.pop(0)
        doc = tracer.chrome_trace()
        validate_chrome_trace(doc)
        roots = [ev for evs in spans_by_trace(doc).values() for ev in evs
                 if links_of(ev)]
        assert any(lk.get("relation") == "migrates"
                   for ev in roots for lk in links_of(ev))
        assert orch.wait_all(timeout=600)
    finally:
        orch.stop()
        cl.stop()
