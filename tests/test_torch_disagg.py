"""Prefill/decode disaggregation on the port, on the CPU: every case of
``tests/test_disagg.py`` but the deferred prefix-hit admission (which
``test_torch_prefix_cache.py`` carries), plus parity with the reference.

The ported cases run yi-9b-smoke (bf16, the port's seed-0 weights) with
pages of 4 and hold the disaggregated pair (a ``prefill`` replica and a
``decode`` replica joined by one ``TransferQueue`` behind one
``RequestRouter``) to the aggregated ``mixed`` engine, token for token:
live handoff, fallback on a saturated decode side, a TTFT target that
refuses every offer, evict/resume of both replicas, OOM preemption on
the receiver, torn and delayed transfers, the Prometheus counters, the
router's roles, bucketed routing and lease transfer, placement's role
scores, ``RoleMixPolicy``, ``disaggregated_service_model``, role and EOS
validation, both on-device EOS cases and EOS across evict/resume.

Parity: yi-9b-smoke in float32 (``yi-9b-f32-smoke``, registered in both
packages' ``ARCHS`` for this module) on the reference engine's weights.
The port's pair must give the reference pair's transcripts (which equal
the reference's aggregated engine's), equal handoff, fallback and byte
counters and the same sequence of router pops.  ``RoleMixPolicy``,
``disaggregated_service_model`` and placement's role scores are held to
the reference's on seeded inputs.  Port-only cases: export under the
prefill replica's async pipeline, staging widths that differ between
replicas, a handoff that keeps no device tensor and no reference cycle,
``TaskImage.role``.  One ``gpu`` case runs the pair on the card.
"""

import dataclasses
import gc
import weakref

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jcfg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro.core import FunkyCL as JFunkyCL  # noqa: E402
from repro.core import Monitor as JMonitor  # noqa: E402
from repro.core import SliceAllocator as JSliceAllocator  # noqa: E402
from repro.scaling.metrics import MetricsRegistry as JRegistry  # noqa: E402
from repro.scaling.serving import RequestRouter as JRouter  # noqa: E402
from repro.serve.disagg import TransferQueue as JTransferQueue  # noqa: E402
from repro.serve.engine import \
    ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve.engine import ServeRequest as JServeRequest  # noqa: E402
from repro_torch.chaos import FaultPlan, FaultSpec  # noqa: E402
from repro_torch.core import FunkyCL, Monitor, SliceAllocator  # noqa: E402
from repro_torch.scaling.metrics import MetricsRegistry  # noqa: E402
from repro_torch.scaling.serving import RequestRouter  # noqa: E402
from repro_torch.serve.disagg import (M_HANDOFF,  # noqa: E402
                                      M_HANDOFF_FALLBACK, M_TRANSFER_BYTES,
                                      TransferQueue)
from repro_torch.serve.engine import (ContinuousBatchingEngine,  # noqa: E402
                                      ServeRequest)
from repro_torch.testing import params_from_jax  # noqa: E402

ARCH = "yi-9b-smoke"
F32 = "yi-9b-f32-smoke"
PROMPT_LEN = 8
PAGE = 4
SPEC = [3, 6, 4, 5]
COUNTERS = (M_HANDOFF, M_HANDOFF_FALLBACK, M_TRANSFER_BYTES)


def make_engine(reg, engine_id, slots=2, max_new=8, arch=ARCH, params=None,
                device="cpu", **kw):
    mon = Monitor(engine_id, SliceAllocator("n0", 1, device=device),
                  telemetry=reg)
    eng = ContinuousBatchingEngine(arch, FunkyCL(mon), slots=slots,
                                   prompt_len=PROMPT_LEN,
                                   max_new_tokens=max_new, registry=reg,
                                   page_size=PAGE, engine_id=engine_id, **kw)
    eng.setup()
    if params is not None:
        eng.cl.write_buffer("params", params).wait()
    return mon, eng


def make_requests(spec, seed=0, cls=ServeRequest):
    rng = np.random.Generator(np.random.Philox(seed))
    return [cls(rid=f"r{i}", prompt=rng.integers(0, 100, PROMPT_LEN),
                max_new_tokens=n)
            for i, n in enumerate(spec)]


_AGG: dict = {}


def aggregated_ref(spec, seed, device="cpu"):
    """The aggregated engine's transcript (cached per workload)."""
    key = (tuple(spec), seed, device)
    if key not in _AGG:
        mon, eng = make_engine(MetricsRegistry(), "agg", device=device)
        for r in make_requests(spec, seed=seed):
            eng.submit(r)
        eng.run_until_drained()
        _AGG[key] = {rid: list(rec.tokens)
                     for rid, rec in eng.completed.items()}
        mon.vfpga_exit()
    return _AGG[key]


def _record_pops(router):
    """Wrap ``router.pop`` to log every non-empty pop as (engine, rids)."""
    pops, pop = [], router.pop

    def logged(n, engine_id=None):
        out = pop(n, engine_id=engine_id)
        if out:
            pops.append((engine_id, [r.rid for r in out]))
        return out
    router.pop = logged
    return pops


def run_disagg(spec, seed, *, decode_kw=None, prefill_kw=None,
               ttft_target_s=None, chaos=None, step_hook=None,
               max_pumps=600, make=make_engine, registry=MetricsRegistry,
               router_cls=RequestRouter, queue_cls=TransferQueue,
               request_cls=ServeRequest, **engine_kw):
    """Drive a prefill + decode replica pair over a workload through a
    RequestRouter and TransferQueue; returns (transcripts, queue,
    registry, router, router pops)."""
    reg = registry()
    router = router_cls("svc", registry=reg, kv_aware=False)
    pops = _record_pops(router)
    monP, engP = make(reg, "pf", role="prefill", **engine_kw,
                      **(prefill_kw or {}))
    monD, engD = make(reg, "dec", role="decode", fuse_steps=2,
                      async_depth=1, **engine_kw, **(decode_kw or {}))
    tq = queue_cls(router=router, registry=reg, service="svc",
                   ttft_target_s=ttft_target_s, chaos=chaos)
    engP.attach_transfer(tq)
    engD.attach_transfer(tq)
    for r in make_requests(spec, seed=seed, cls=request_cls):
        router.submit(r)
    try:
        for i in range(max_pumps):
            if step_hook is not None:
                step_hook(engP, monP, engD, monD, i)
            engP.pump(router)
            engD.pump(router)
            if (not router.outstanding() and engP.idle and engD.idle
                    and len(tq) == 0):
                break
        else:
            raise AssertionError(
                f"disagg pair did not drain: outstanding="
                f"{router.outstanding()} queue={len(tq)}")
        got = {rid: list(rec.tokens)
               for rid, rec in router.completed.items()}
        return got, tq, reg, router, pops
    finally:
        monP.vfpga_exit()
        monD.vfpga_exit()


def _counter(reg, name):
    return reg.snapshot()["counters"][f"{name}{{service=svc}}"]


def _events(reg):
    return [e[1] for e in reg.flight_record()["events"]]


# ---------------------------------------------------------------------------
# Live KV handoff: bit-exactness and fallback
# ---------------------------------------------------------------------------
def test_handoff_bit_exact_vs_aggregated():
    """Every request prefills on one replica and decodes on the other;
    the token streams equal the aggregated single-engine run."""
    ref = aggregated_ref(SPEC, seed=3)
    got, tq, reg, _, _ = run_disagg(SPEC, seed=3)
    assert got == ref
    handoffs = _counter(reg, M_HANDOFF)
    assert handoffs >= 1          # slot-aware admission may refuse some
    assert _counter(reg, M_TRANSFER_BYTES) > 0
    # every handoff happened mid-decode: the importer continued the lane
    events = _events(reg)
    assert events.count("engine_handoff_out") == handoffs
    assert events.count("engine_handoff_in") == handoffs


def test_fallback_when_decode_side_saturated():
    """A decode pool with room for about one lane forces refusals: refused
    lanes decode to completion on the prefill replica (aggregated
    fallback) and the streams stay bit-exact."""
    ref = aggregated_ref(SPEC, seed=3)
    got, tq, reg, _, _ = run_disagg(SPEC, seed=3,
                                    decode_kw={"pool_pages": 5,
                                               "reserve_pages": 1})
    assert got == ref
    assert _counter(reg, M_HANDOFF_FALLBACK) > 0


def test_ttft_target_refuses_slow_transfers():
    """With a TTFT target below the predicted queue wait the queue refuses
    every offer: pure aggregated fallback, zero handoffs."""
    ref = aggregated_ref(SPEC, seed=3)

    def poison(engP, monP, engD, monD, i):
        # pretend installs are ruinously slow (predicted wait >> target)
        engP.transfer._ewma_install_s = 10.0

    got, tq, reg, _, _ = run_disagg(SPEC, seed=3, ttft_target_s=1e-9,
                                    step_hook=poison)
    assert got == ref
    assert _counter(reg, M_HANDOFF) == 0
    assert _counter(reg, M_HANDOFF_FALLBACK) > 0


def test_handoff_with_evict_resume_both_sides():
    """Monitor-level evict/resume on both replicas amid handoff traffic:
    lanes in transit and installed lanes continue bit-exactly (imported
    pages are reported dirty, so the decode replica's evict saves them)."""
    ref = aggregated_ref(SPEC, seed=3)

    def hook(engP, monP, engD, monD, i):
        if i % 3:
            return
        for eng, mon in ((engP, monP), (engD, monD)):
            if eng.active_count:
                mon.evict()
                mon.resume()

    got, tq, reg, _, _ = run_disagg(SPEC, seed=3, step_hook=hook)
    assert got == ref
    assert _counter(reg, M_HANDOFF) > 0


def test_handoff_then_oom_preempt_on_receiver():
    """The decode replica's pool admits transfers but cannot decode every
    lane to its limit: imported lanes are OOM-preempted and recompute
    locally (a full prefill on the decode replica), the streams stay
    bit-exact, and TTFT is observed exactly once per request."""
    spec = [8, 8, 8, 8]
    ref = aggregated_ref(spec, seed=9)
    got, tq, reg, _, _ = run_disagg(spec, seed=9,
                                    decode_kw={"pool_pages": 7,
                                               "reserve_pages": 1})
    assert got == ref
    snap = reg.snapshot()
    assert snap["counters"][
        "engine_oom_preemptions_total{service=svc}"] > 0
    # TTFT is observed once per request across admit + handoff + recompute
    assert (snap["histograms"]["request_ttft_seconds{service=svc}"]["count"]
            == len(spec))


# ---------------------------------------------------------------------------
# Torn transfers: chaos site kv.transfer + router lease replay
# ---------------------------------------------------------------------------
def test_torn_transfer_replays_without_loss_or_duplication():
    """A transfer torn between dequeue and install loses the lane (the
    source already released it); the request replays through its router
    lease and the recompute reproduces the committed prefix."""
    ref = aggregated_ref(SPEC, seed=3)
    plan = FaultPlan([FaultSpec(site="kv.transfer", kind="torn", at=2)])
    got, tq, reg, router, _ = run_disagg(SPEC, seed=3, chaos=plan)
    assert tq.torn == 1
    assert got == ref                          # nothing lost
    assert len(router.completed) == len(SPEC)  # nothing duplicated
    assert router.duplicates == 0
    events = _events(reg)
    assert "kv_transfer_torn" in events
    assert "router_replay" in events
    # the replay's recompute reproduced the pre-tear tokens as a prefix
    assert "replay_mismatch" not in events
    assert router.replay_mismatches == 0


def test_transfer_delay_fault_is_benign():
    """kind=delay at the transfer site only stretches the install."""
    ref = aggregated_ref(SPEC, seed=3)
    plan = FaultPlan([FaultSpec(site="kv.transfer", kind="delay",
                                delay_s=0.002, at=1)])
    got, tq, _, _, _ = run_disagg(SPEC, seed=3, chaos=plan)
    assert got == ref and tq.torn == 0
    assert len(plan.fired) == 1


def test_transfer_counters_export_in_prometheus_text():
    """The disaggregation counters appear in the Prometheus exposition
    (even before traffic) with finite values."""
    reg = MetricsRegistry()
    TransferQueue(registry=reg, service="svc")
    text = reg.to_prometheus_text()
    for name in COUNTERS:
        line = next(ln for ln in text.splitlines()
                    if ln.startswith(name))
        assert np.isfinite(float(line.rsplit(" ", 1)[1]))


# ---------------------------------------------------------------------------
# Role-aware routing / leases
# ---------------------------------------------------------------------------
def test_router_never_feeds_decode_replicas():
    router = RequestRouter("svc", kv_aware=False)
    router.register_engine_role("dec", "decode", (PROMPT_LEN,))
    router.register_engine_role("pf", "prefill", (PROMPT_LEN,))
    for r in make_requests([2, 2], seed=1):
        router.submit(r)
    assert router.pop(2, engine_id="dec") == []
    assert [r.rid for r in router.pop(2, engine_id="pf")] == ["r0", "r1"]


def test_bucketed_prompt_routing_between_prefills():
    """Two prefill replicas with buckets (4, 8): a short prompt maps to the
    first replica, a long one to the second, and deferral is a head start,
    never starvation."""
    router = RequestRouter("svc", kv_aware=False)
    router.register_engine_role("pfA", "prefill", (4, 8))
    router.register_engine_role("pfB", "prefill", (4, 8))
    rng = np.random.Generator(np.random.Philox(2))
    router.submit(ServeRequest(rid="short", prompt=rng.integers(0, 100, 3),
                               max_new_tokens=2))
    router.submit(ServeRequest(rid="long", prompt=rng.integers(0, 100, 8),
                               max_new_tokens=2))
    # head is `short` (bucket idx 0 -> pfA): pfB is held back once
    assert router.pop(1, engine_id="pfB") == []
    assert [r.rid for r in router.pop(1, engine_id="pfA")] == ["short"]
    # head is `long` (bucket idx 1 -> pfB)
    assert router.pop(1, engine_id="pfA") == []
    assert [r.rid for r in router.pop(1, engine_id="pfB")] == ["long"]


def test_transfer_lease_moves_crash_replay_ownership():
    """After a handoff the lease points at the decode replica: its crash
    replays the request; the old owner's crash no longer does."""
    router = RequestRouter("svc", kv_aware=False)
    for r in make_requests([2], seed=4):
        router.submit(r)
    (req,) = router.pop(1, engine_id="pf")
    req.committed = [7]
    router.transfer_lease(req.rid, "dec")
    assert router.fail_engine("pf") == 0     # no longer the owner
    assert router.fail_engine("dec") == 1
    assert router.replayed[req.rid] == [7]


def test_fail_engine_drops_the_role():
    """A crashed replica's role goes with it: a later replica of the same
    id registers afresh."""
    router = RequestRouter("svc", kv_aware=False)
    router.register_engine_role("dec", "decode", (PROMPT_LEN,))
    router.fail_engine("dec")
    router.submit(make_requests([2], seed=1)[0])
    assert [r.rid for r in router.pop(1, engine_id="dec")] == ["r0"]


# ---------------------------------------------------------------------------
# Role-aware placement and per-role autoscaling
# ---------------------------------------------------------------------------
class _View:
    def __init__(self, capacity):
        self.capacity = dict(capacity)

    def nodes(self):
        return list(self.capacity)

    def free_slices(self, node):
        return self.capacity[node]

    def running_tasks(self, node):
        return []


def test_placement_scores_roles():
    """Decode tasks steer toward the node advertising the most free KV
    pages (at equal capacity); prefill tasks get a free-compute bonus on
    top of the capacity term."""
    from repro_torch.core.placement import M_NODE_KV_FREE, PlacementPolicy
    from repro_torch.core.scheduler import SchedTask

    reg = MetricsRegistry()
    # name tie-break alone would pick "b"; the KV gauge flips it to "a"
    reg.gauge(M_NODE_KV_FREE, node="a").set(64)
    reg.gauge(M_NODE_KV_FREE, node="b").set(4)
    pol = PlacementPolicy(registry=reg)
    view = _View({"a": 2, "b": 2})
    dec = SchedTask(tid="dec", meta={"role": "decode"})
    plain = SchedTask(tid="t", meta={})
    assert pol.select_node(plain, view, {}) == "b"
    assert pol.select_node(dec, view, {}) == "a"
    # prefill: the free-compute bonus scales with free slices
    pf = SchedTask(tid="pf", meta={"role": "prefill"})
    w = pol.weights
    assert (pol.score(pf, "a", view, 3) - pol.score(plain, "a", view, 3)
            == pytest.approx(w.role_compute * 3))


def test_role_mix_policy_scales_and_fits_budget():
    from repro_torch.scaling.autoscaler import RoleMixPolicy, ScalingSignals

    pol = RoleMixPolicy(slice_budget=8, vfpga_num=2)
    idle = pol.desired_mix(ScalingSignals(replicas=2))
    assert (idle.prefill, idle.decode) == (1, 1)
    assert idle.total_slices <= 8

    # queue depth grows the prefill side
    queued = pol.desired_mix(ScalingSignals(replicas=2, queue_depth=6.0))
    assert queued.prefill > idle.prefill
    assert queued.total_slices <= 8

    # KV pressure grows the decode side
    hot = pol.desired_mix(ScalingSignals(replicas=2, kv_pressure=0.95))
    assert hot.decode > idle.decode
    assert hot.total_slices <= 8

    # scarce slices: vertical size is shed before replicas, floors hold
    tight = RoleMixPolicy(slice_budget=3, vfpga_num=2)
    mix = tight.desired_mix(ScalingSignals(replicas=2, queue_depth=8.0,
                                           kv_pressure=0.95))
    assert mix.total_slices <= 3
    assert mix.prefill >= 1 and mix.decode >= 1
    assert min(mix.prefill_vfpga, mix.decode_vfpga) == 1


def test_disaggregated_service_model_bounds():
    from repro_torch.core.simulator import (disaggregated_service_model,
                                            engine_service_model)
    from repro_torch.scaling.loadgen import Request

    req = Request(rid="r", arrival_t=0.0, service_s=0.0, n_tokens=8)
    agg = engine_service_model(0.05, 0.002)
    # full fallback degrades exactly to the aggregated model, never worse
    full_fb = disaggregated_service_model(0.05, 0.002, fallback_rate=1.0)
    assert full_fb(req) == pytest.approx(agg(req))
    # a clean handoff holds the decode pool for transfer + tail only
    clean = disaggregated_service_model(0.05, 0.002, transfer_s=0.001)
    assert clean(req) < agg(req)


# ---------------------------------------------------------------------------
# Engine role/eos validation
# ---------------------------------------------------------------------------
def test_role_and_eos_config_validation():
    from repro_torch.serve.engine import SpecConfig

    reg = MetricsRegistry()
    mon = Monitor("cfg", SliceAllocator("n0", 1, device="cpu"),
                  telemetry=reg)
    cl = FunkyCL(mon)
    mk = lambda **kw: ContinuousBatchingEngine(  # noqa: E731
        ARCH, cl, slots=2, prompt_len=PROMPT_LEN, max_new_tokens=4,
        registry=reg, page_size=PAGE, **kw)
    with pytest.raises(ValueError):
        mk(role="verifier")
    with pytest.raises(ValueError):
        mk(role="prefill", paged=False)
    with pytest.raises(ValueError):
        mk(role="decode", spec=SpecConfig(k=2))
    with pytest.raises(ValueError):
        mk(eos_id=5, spec=SpecConfig(k=2))
    with pytest.raises(ValueError):
        mk(role="mixed").attach_transfer(TransferQueue())
    for role in ("prefill", "decode"):
        assert mk(role=role).role == role
    mon.vfpga_exit()


# ---------------------------------------------------------------------------
# On-device EOS
# ---------------------------------------------------------------------------
def _eos_token(spec, seed):
    """A token the reference streams emit mid-sequence, so EOS truncates at
    least one request."""
    ref = aggregated_ref(spec, seed)
    for toks in ref.values():
        if len(toks) > 2:
            return ref, int(toks[1])
    raise AssertionError("no stream long enough to pick an EOS token")


def _truncate_at(ref, eos):
    out = {}
    for rid, toks in ref.items():
        cut = toks.index(eos) + 1 if eos in toks else len(toks)
        out[rid] = toks[:cut]
    return out


@pytest.mark.parametrize("fused_kw", [
    {"fuse_steps": 4, "async_depth": 1},    # on-device freeze mid-span
    {"fuse_steps": 1, "async_depth": 2},    # host-side EOS, async commits
])
def test_on_device_eos_bit_exact_vs_host_side(fused_kw):
    """A lane emitting eos_id freezes inside decode_multi (or is cut at the
    async commit): tokens match the synchronous host-side EOS engine
    exactly, the stop token included."""
    ref, eos = _eos_token(SPEC, seed=3)
    want = _truncate_at(ref, eos)
    assert any(len(v) < len(ref[k]) for k, v in want.items())

    for tag, kw in (("sync", {}), ("pipelined", fused_kw)):
        mon, eng = make_engine(MetricsRegistry(), f"eos-{tag}", eos_id=eos,
                               **kw)
        for r in make_requests(SPEC, seed=3):
            eng.submit(r)
        eng.run_until_drained()
        got = {rid: list(rec.tokens) for rid, rec in eng.completed.items()}
        mon.vfpga_exit()
        assert got == want, f"eos mismatch on {tag} engine"


def test_eos_mid_span_with_evict_resume():
    """An EOS freeze inside a fused span survives monitor evict/resume."""
    from repro_torch.serve.equivalence import (evict_resume_every,
                                               run_transcript)

    ref, eos = _eos_token(SPEC, seed=3)
    want = _truncate_at(ref, eos)

    def factory():
        return make_engine(MetricsRegistry(), "eos-ev", eos_id=eos,
                           fuse_steps=4, async_depth=1)

    got, _ = run_transcript(factory,
                            lambda: make_requests(SPEC, seed=3),
                            step_hook=evict_resume_every(3))
    assert got == want


# ---------------------------------------------------------------------------
# The port's own cases
# ---------------------------------------------------------------------------
def test_export_under_the_prefill_replicas_async_pipeline():
    """A pipelined prefill replica (2 steps fused, one EXECUTE ahead) keeps
    a decode EXECUTE in flight for each lane at its step boundaries, so no
    lane qualifies there.  Once its pipeline is drained, its lanes export,
    their slots refill under the pipeline, and the streams equal the
    aggregated engine's."""
    ref = aggregated_ref(SPEC, seed=3)
    seen = []

    def hook(engP, monP, engD, monD, i):
        busy = [st for st in engP._active.values() if st.inflight]
        assert not set(map(id, busy)) & set(map(id,
                                                engP.exportable_lanes()))
        if i == 2:
            engP._drain_pipeline()
            seen.append(len(engP.exportable_lanes()))
            engP.transfer.pump_source(engP)

    got, tq, reg, _, _ = run_disagg(SPEC, seed=3, step_hook=hook,
                                    prefill_kw={"fuse_steps": 2,
                                                "async_depth": 1})
    assert got == ref
    assert seen[0] > 0
    assert _counter(reg, M_HANDOFF) > 0


@pytest.mark.parametrize("decode_max_new", [12, 6])
def test_staging_width_differs_between_replicas(decode_max_new):
    """The replicas' tables differ in width (the decode replica's cap is
    larger or smaller): the staged pages are padded or trimmed to the
    importer's width, and the padding never reaches a real page."""
    spec = [3, 5, 4, 5] if decode_max_new < 8 else SPEC
    ref = aggregated_ref(spec, seed=3)
    got, tq, reg, _, _ = run_disagg(spec, seed=3,
                                    decode_kw={"max_new": decode_max_new})
    assert got == ref
    assert _counter(reg, M_HANDOFF) > 0


def test_handoff_holds_cpu_tensors_and_no_cycle():
    """A handoff in transit holds CPU tensors only, and a dropped decode
    replica is freed at once (no reference cycle through its queue)."""
    reg = MetricsRegistry()
    router = RequestRouter("svc", registry=reg, kv_aware=False)
    monP, engP = make_engine(reg, "pf", role="prefill")
    monD, engD = make_engine(reg, "dec", role="decode")
    tq = TransferQueue(router=router, registry=reg, service="svc")
    engP.attach_transfer(tq)
    engD.attach_transfer(tq)
    for r in make_requests(SPEC, seed=3):
        router.submit(r)
    engP.pump(router)                        # admit + step + export
    assert len(tq) > 0
    from repro_torch.tree import tree_leaves

    for h in tq._q:
        leaves = tree_leaves(h.pages)
        assert leaves and all(isinstance(x, torch.Tensor)
                              and x.device.type == "cpu" for x in leaves)
        assert all(x.shape[0] == engP.max_blocks for x in leaves)
    assert tq.stats()["decode_engines"] == ["dec"]
    monD.vfpga_exit()
    ref = weakref.ref(engD)
    gc.disable()
    try:
        del engD, monD
        assert ref() is None
        assert tq.decode_engines == []
    finally:
        gc.enable()
        monP.vfpga_exit()


@pytest.mark.parametrize("lanes", [2, 14, 17, 65])
def test_paged_decode_lane_keeps_its_bits_at_any_batch(lanes):
    """``lm_decode_paged`` runs its row-wise products at ``DECODE_ROWS``
    rows (past that many lanes, in blocks of it): lane 0 decodes to the
    same logits and pages alone and among ``lanes`` lanes, and alone it
    writes its own pages only (attention and the cache writes run over
    the lanes, never the padding rows)."""
    from repro_torch.models import build_model
    from repro_torch.serve.kvcache import (init_caches_from_specs,
                                           pool_specs_from_lane_cache)
    from repro_torch.tree import tree_leaves, tree_map

    cfg = tcfg.get_arch(ARCH)
    bundle = build_model(cfg, cache_margin=0)
    params = bundle.init(0, device="cpu")
    mb = 4
    NP = 65 * mb
    pool0 = init_caches_from_specs(pool_specs_from_lane_cache(
        bundle.cache_specs(1, PROMPT_LEN), NP, PAGE, PROMPT_LEN), "cpu")
    rng = np.random.default_rng(5)
    toks = torch.as_tensor(rng.integers(0, 100, (65, 3)), dtype=torch.int32)
    bt = torch.as_tensor(rng.permutation(NP).reshape(65, mb),
                         dtype=torch.int32)
    runs = {}
    for B in (1, lanes):
        pool = tree_map(torch.clone, pool0)
        out = []
        for i in range(3):
            logits, pool = bundle.decode_paged_fn(
                params, toks[:B, i], torch.full((B,), i, dtype=torch.int32),
                pool, bt[:B])
            out.append(logits[0])
        runs[B] = (torch.stack(out), pool)
    assert torch.equal(runs[lanes][0], runs[1][0])
    # lane 0's pages hold the same bytes; alone, lane 0 wrote its own pages
    # and nothing else, the sink (page NP) included
    pages = bt[0].long()
    for a, b in zip(tree_leaves(runs[lanes][1]), tree_leaves(runs[1][1])):
        assert torch.equal(a[pages], b[pages])
    rest = torch.ones(NP + 1, dtype=torch.bool)
    rest[pages] = False
    for a, b in zip(tree_leaves(runs[1][1]), tree_leaves(pool0)):
        assert torch.equal(a[rest], b[rest])


def test_task_image_role_reaches_the_engine():
    from repro_torch.core import FunkyRuntime, TaskImage

    im = TaskImage(name="disagg-img", kind="engine-serve", arch=ARCH,
                   prompt_len=PROMPT_LEN, global_batch=2, max_new_tokens=4,
                   page_size=PAGE, role="decode")
    assert TaskImage(name="x", kind="engine-serve").role == "mixed"
    rt = FunkyRuntime("n0", SliceAllocator("n0", 1, device="cpu"))
    rec = rt.create("e", im)
    from repro_torch.core.guest import FunkyCL as CL

    mon = rec.monitor
    rec.task.setup(CL(mon), rec.guest_state, restore=False)
    assert rec.task.engine.role == "decode"
    assert "xfer_install" in rec.task.engine.program_ids()
    mon.vfpga_exit()


# ---------------------------------------------------------------------------
# Parity with the reference on shared f32 weights
# ---------------------------------------------------------------------------
def _jmake(reg, engine_id, slots=2, max_new=8, **kw):
    mon = JMonitor(engine_id, JSliceAllocator("n0", 1), telemetry=reg)
    eng = JEngine(F32, JFunkyCL(mon), slots=slots, prompt_len=PROMPT_LEN,
                  max_new_tokens=max_new, registry=reg, page_size=PAGE,
                  engine_id=engine_id, **kw)
    eng.setup()
    return mon, eng


@pytest.fixture(scope="module")
def ref():
    """The f32 arch in both packages; the reference's aggregated engine
    (its weights and transcript) and its disaggregated pair (transcript,
    counters, router pops)."""
    mp = pytest.MonkeyPatch()
    for mod in (jcfg, tcfg):
        base = mod.ARCHS["yi-9b"]
        mp.setitem(mod.ARCHS, "yi-9b-f32", dataclasses.replace(
            base, name="yi-9b-f32", dtype="float32"))
    mon, eng = _jmake(JRegistry(), "agg")
    params = params_from_jax(jax.tree.map(np.asarray,
                                          eng.cl.read_buffer("params")))
    for r in make_requests(SPEC, seed=3, cls=JServeRequest):
        eng.submit(r)
    eng.run_until_drained()
    agg = {rid: list(rec.tokens) for rid, rec in eng.completed.items()}
    mon.vfpga_exit()
    got, tq, reg, router, pops = run_disagg(
        SPEC, 3, make=_jmake, registry=JRegistry, router_cls=JRouter,
        queue_cls=JTransferQueue, request_cls=JServeRequest)
    snap = reg.snapshot()["counters"]
    yield {"params": params, "aggregated": agg, "pair": got, "pops": pops,
           "counters": {n: snap[f"{n}{{service=svc}}"] for n in COUNTERS},
           "torn": tq.torn}
    mp.undo()


def test_pair_matches_the_reference_pair(ref):
    """Transcripts, handoff counters and router pops of the port's pair
    equal the reference pair's on the same weights; both equal the
    reference's aggregated engine."""
    assert ref["pair"] == ref["aggregated"]

    def make(reg, engine_id, **kw):
        return make_engine(reg, engine_id, arch=F32, params=ref["params"],
                           **kw)

    got, tq, reg, router, pops = run_disagg(SPEC, 3, make=make)
    assert got == ref["pair"]
    assert {n: _counter(reg, n) for n in COUNTERS} == ref["counters"]
    assert ref["counters"][M_HANDOFF] > 0
    assert pops == ref["pops"]
    assert router.duplicates == 0 and tq.torn == ref["torn"] == 0


def test_role_mix_policy_matches_the_reference():
    from repro.scaling.autoscaler import RoleMixPolicy as JPolicy
    from repro.scaling.autoscaler import ScalingSignals as JSignals
    from repro_torch.scaling.autoscaler import RoleMixPolicy, ScalingSignals

    rng = np.random.default_rng(11)
    for _ in range(200):
        budget, vnum = int(rng.integers(2, 12)), int(rng.integers(1, 4))
        sig = dict(replicas=int(rng.integers(1, 6)),
                   queue_depth=float(rng.choice([0.0, rng.random() * 20])),
                   kv_pressure=float(rng.choice([0.0, rng.random()])),
                   utilization=float(rng.random()))
        a = RoleMixPolicy(slice_budget=budget, vfpga_num=vnum).desired_mix(
            ScalingSignals(**sig))
        b = JPolicy(slice_budget=budget, vfpga_num=vnum).desired_mix(
            JSignals(**sig))
        assert dataclasses.asdict(a) == dataclasses.asdict(b), sig


def test_disaggregated_service_model_matches_the_reference():
    from repro.core.simulator import \
        disaggregated_service_model as jmodel  # noqa: N813
    from repro.scaling.loadgen import Request as JRequest
    from repro_torch.core.simulator import disaggregated_service_model
    from repro_torch.scaling.loadgen import Request

    rng = np.random.default_rng(12)
    for _ in range(100):
        kw = dict(transfer_s=float(rng.random() * 0.01),
                  fallback_rate=float(rng.random() * 1.4 - 0.2))
        ttft, tbt = float(rng.random()), float(rng.random() * 0.01)
        n = int(rng.integers(1, 64))
        a = disaggregated_service_model(ttft, tbt, **kw)(
            Request(rid="r", arrival_t=0.0, service_s=0.0, n_tokens=n))
        b = jmodel(ttft, tbt, **kw)(
            JRequest(rid="r", arrival_t=0.0, service_s=0.0, n_tokens=n))
        assert a == b


def test_placement_role_scores_match_the_reference():
    from repro.core.placement import PlacementPolicy as JPolicy
    from repro.core.scheduler import SchedTask as JTask
    from repro_torch.core.placement import M_NODE_KV_FREE, PlacementPolicy
    from repro_torch.core.scheduler import SchedTask

    rng = np.random.default_rng(13)
    nodes = ["a", "b", "c", "d"]
    for _ in range(40):
        regs = (MetricsRegistry(), JRegistry())
        for n in nodes:
            v = float(rng.integers(0, 128))
            for reg in regs:
                reg.gauge(M_NODE_KV_FREE, node=n).set(v)
        view = _View({n: int(rng.integers(0, 4)) for n in nodes})
        ours, theirs = PlacementPolicy(registry=regs[0]), JPolicy(
            registry=regs[1])
        for role in ("prefill", "decode", None):
            meta = {"role": role} if role else {}
            t, jt = SchedTask(tid="t", meta=meta), JTask(tid="t", meta=meta)
            for n in nodes:
                f = view.free_slices(n)
                assert ours.score(t, n, view, f) == pytest.approx(
                    theirs.score(jt, n, view, f), rel=1e-12, abs=1e-12)
            assert (ours.select_node(t, view, {})
                    == theirs.select_node(jt, view, {}))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_pair_on_card_gives_the_mixed_engine_tokens():
    """The pair at yi-9b-smoke (bf16) on the card: the mixed engine's
    tokens, with K2 once a layer per admission and K1 paged once a layer
    per decode step over both replicas, each at its replica's lane count
    (K1 paged runs over the lanes, never the rows that pad the decode's
    products to ``DECODE_ROWS``), and no dense K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_paged)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    want = aggregated_ref(SPEC, seed=3, device="cuda")
    engines = []

    def make(reg, engine_id, **kw):
        mon, eng = make_engine(reg, engine_id, device="cuda", **kw)
        engines.append(eng)
        return mon, eng

    for w in (decode_attention, decode_attention_paged, flash_attention):
        w.launches = 0
    decode_attention_paged.launches_by_shape.clear()
    got, tq, reg, _, _ = run_disagg(SPEC, seed=3, make=make)
    assert got == want
    assert _counter(reg, M_HANDOFF) > 0
    L = tcfg.get_arch(ARCH).num_layers
    steps = sum(e.program_execs.get("decode_step", 0)
                + e.fuse_steps * e.program_execs.get("decode_multi", 0)
                for e in engines)
    admits = sum(n for e in engines for p, n in e.program_execs.items()
                 if p.startswith("prefill_admit"))
    assert flash_attention.launches == L * admits
    assert decode_attention_paged.launches == L * steps
    by_shape = decode_attention_paged.launches_by_shape
    assert {B for B, _ in by_shape} == {
        e.slots for e in engines if e.program_execs.get("decode_step", 0)
        or e.program_execs.get("decode_multi", 0)}
    assert sum(by_shape.values()) == L * steps
    assert decode_attention.launches == 0
