"""The port's paged continuous-batching engine against the reference's.

yi-9b-smoke in float32 (an f32 variant of yi-9b registered in both
packages' ``ARCHS`` for this module), ``PAGE`` 4, on ``device="cpu"``, so
the paged decode runs its plain version (gather + ``sdpa_naive``) and the
prefill K2's.  Both engines serve on the same weights: the reference
engine's ``params`` buffer, read after its ``setup()``, is written into
the port engine's through the port engine's own TRANSFER.

Token transcripts must be identical; a divergence is reported with the
port's logit margin at the diverging token (a near tie is a finding, not
a pass).  Covered: the reference's workloads of ``tests/test_engine.py``
(a); evict/resume mid-batch with page-granular saves (b); OOM preemption
plus compaction (c); fused and pipelined decode against single-step,
across evict/resume, OOM and compaction, and the stop token on the host
and on the device (d); bucket routing and
memory-gated admission (e); the failure contract of a dropped pipeline
(f); ``RequestRouter`` -> ``EngineServeTask`` -> ``FunkyRuntime`` (g).
"""

import dataclasses
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jcfg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro.core import FunkyCL as JFunkyCL  # noqa: E402
from repro.core import Monitor as JMonitor  # noqa: E402
from repro.core import SliceAllocator as JSliceAllocator  # noqa: E402
from repro.serve.engine import \
    ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve.engine import ServeRequest as JServeRequest  # noqa: E402
from repro_torch.chaos import FaultPlan, FaultSpec  # noqa: E402
from repro_torch.core import (EngineServeTask, FunkyCL,  # noqa: E402
                              FunkyRuntime, Monitor, SliceAllocator,
                              TaskImage, TaskStatus)
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention_paged)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.scaling.metrics import MetricsRegistry  # noqa: E402
from repro_torch.scaling.serving import (RequestRouter,  # noqa: E402
                                         reset_router)
from repro_torch.serve.engine import (ContinuousBatchingEngine,  # noqa: E402
                                      ServeRequest)
from repro_torch.serve.equivalence import (evict_resume_every,  # noqa: E402
                                           run_transcript)
from repro_torch.testing import params_from_jax  # noqa: E402

ARCH = "yi-9b-f32-smoke"
PROMPT_LEN = 8
PAGE = 4

# workload -> (engine options, request maker): tests/test_engine.py's
WORKLOADS = {
    "spec": (dict(slots=2, max_new=8), ([3, 6, 4, 5], 3)),
    "ragged": (dict(slots=2, max_new=8), ([6, 8, 4, 7, 5, 8], 2)),
    "buckets": (dict(slots=2, max_new=6, prompt_buckets=(4, 8)), None),
}


def make_requests(workload, cls=ServeRequest):
    if workload == "eos":
        workload = "spec"
    if workload == "buckets":
        rng = np.random.Generator(np.random.Philox(9))
        return [cls(rid="short", prompt=rng.integers(0, 100, 3),
                    max_new_tokens=5),
                cls(rid="long", prompt=rng.integers(0, 100, 8),
                    max_new_tokens=4),
                cls(rid="over", prompt=rng.integers(0, 100, 8),
                    max_new_tokens=99)]
    spec, seed = WORKLOADS[workload][1]
    rng = np.random.Generator(np.random.Philox(seed))
    return [cls(rid=f"r{i}", prompt=rng.integers(0, 100, PROMPT_LEN),
                max_new_tokens=n) for i, n in enumerate(spec)]


def _engine_kw(workload):
    kw = dict(WORKLOADS["spec" if workload == "eos" else workload][0])
    return dict(slots=kw.pop("slots"), max_new_tokens=kw.pop("max_new"),
                **kw)


@pytest.fixture(scope="module")
def ref():
    """The f32 arch in both packages, the reference engine's weights and
    its transcript of every workload."""
    mp = pytest.MonkeyPatch()
    for mod in (jcfg, tcfg):
        base = mod.ARCHS["yi-9b"]
        mp.setitem(mod.ARCHS, "yi-9b-f32", dataclasses.replace(
            base, name="yi-9b-f32", dtype="float32"))
    out = {"params": None, "tokens": {}}
    for wl in list(WORKLOADS) + ["eos"]:
        kw = {}
        if wl == "eos":
            # a stop token that the spec workload emits mid-request
            out["eos_id"] = kw["eos_id"] = out["tokens"]["spec"]["r1"][1]
        mon = JMonitor("ref", JSliceAllocator("n0", 1))
        eng = JEngine(ARCH, JFunkyCL(mon), prompt_len=PROMPT_LEN,
                      page_size=PAGE, **_engine_kw(wl), **kw)
        eng.setup()
        if out["params"] is None:
            out["params"] = params_from_jax(jax.tree.map(
                np.asarray, eng.cl.read_buffer("params")))
        for r in make_requests(wl, JServeRequest):
            eng.submit(r)
        eng.run_until_drained()
        out["tokens"][wl] = {rid: list(rec.tokens)
                             for rid, rec in eng.completed.items()}
        mon.vfpga_exit()
    yield out
    mp.undo()


def port_factory(ref, workload, chaos=None, **kw):
    """() -> (monitor, engine) with the reference's weights written in."""
    def make():
        mon = Monitor("port", SliceAllocator("n0", 1, device="cpu"),
                      telemetry=MetricsRegistry(), chaos=chaos)
        eng = ContinuousBatchingEngine(ARCH, FunkyCL(mon),
                                       prompt_len=PROMPT_LEN, page_size=PAGE,
                                       **{**_engine_kw(workload), **kw})
        eng.setup()
        eng.cl.write_buffer("params", ref["params"]).wait()
        return mon, eng
    return make


def _margin(ref, workload, rid, tokens):
    """The port model's top-2 logits after the request's (padded) prompt
    and ``tokens``: how near a tie the diverging token was."""
    req = next(r for r in make_requests(workload) if r.rid == rid)
    bucket = 4 if workload == "buckets" and len(req.prompt) <= 4 else 8
    prompt = np.zeros(bucket, np.int32)
    prompt[:min(bucket, len(req.prompt))] = req.prompt[:bucket]
    seq = torch.tensor(np.concatenate([prompt, tokens]).astype(np.int32))
    bundle = build_model(tcfg.get_arch(ARCH), decode_impl="naive")
    logits, _ = bundle.prefill_fn(ref["params"], {"tokens": seq[None]})
    top = logits[0].topk(2)
    return top.values.tolist(), top.indices.tolist()


def assert_same_tokens(ref, workload, got):
    want = ref["tokens"][workload]
    assert set(got) == set(want)
    for rid in sorted(want):
        a, b = got[rid], want[rid]
        if a == b:
            continue
        div = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]),
                   min(len(a), len(b)))
        vals, idx = _margin(ref, workload, rid, a[:div])
        pytest.fail(f"{workload}: rid {rid} diverges at token {div}: port "
                    f"{a[div:div + 3]} reference {b[div:div + 3]}; port "
                    f"top-2 logits {vals} at tokens {idx} (margin "
                    f"{vals[0] - vals[1]:.3g})")


# ---------------------------------------------------------------------------
# (a) the reference's workloads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_transcripts_match_the_reference(ref, workload):
    got, eng = run_transcript(port_factory(ref, workload),
                              lambda: make_requests(workload))
    assert_same_tokens(ref, workload, got)
    assert eng.pool.used_count() == 0          # all freed at retirement
    split = eng.host_device_split()
    assert split["tokens"] == sum(len(t) for t in got.values())
    assert eng.program_execs["decode_step"] > 0


# ---------------------------------------------------------------------------
# (b) evict/resume mid-batch, page-granular saves
# ---------------------------------------------------------------------------

def test_evict_resume_mid_batch_saves_only_dirty_pages(ref):
    mon, eng = port_factory(ref, "spec")()
    for r in make_requests("spec"):
        eng.submit(r)
    for _ in range(2):
        eng.step()
    assert eng.active_count > 0
    stats = mon.evict()
    # the first evict has no host copy of the pool yet: every page
    assert stats["paged_saved_pages"] == stats["paged_total_pages"] > 0
    mon.resume()
    eng.step()
    assert eng.active_count > 0
    stats2 = mon.evict()
    assert 0 < stats2["paged_saved_pages"] < stats2["paged_total_pages"]
    mon.resume()
    eng.run_until_drained()
    got = {rid: rec.tokens for rid, rec in eng.completed.items()}
    mon.vfpga_exit()
    assert_same_tokens(ref, "spec", got)


def test_evict_resume_every_two_iterations(ref):
    got, _ = run_transcript(port_factory(ref, "spec"),
                            lambda: make_requests("spec"),
                            step_hook=evict_resume_every(2))
    assert_same_tokens(ref, "spec", got)


# ---------------------------------------------------------------------------
# (c) OOM preemption and compaction
# ---------------------------------------------------------------------------

def test_oom_preemption_compaction_and_resume(ref):
    mon, eng = port_factory(ref, "spec", pool_pages=6)()
    for r in make_requests("spec"):
        eng.submit(r)
    for _ in range(3):
        eng.step()
    eng.compact()
    eng.pool.check_invariants()
    mon.evict()
    mon.resume()
    eng.run_until_drained()
    got = {rid: rec.tokens for rid, rec in eng.completed.items()}
    assert eng.preemptions > 0             # the pool genuinely ran dry
    eng.pool.check_invariants()
    mon.vfpga_exit()
    assert_same_tokens(ref, "spec", got)


def test_churn_with_aggressive_auto_compaction(ref):
    """A first wave fragments the pool; the second wave's tokens are the
    reference's while the engine auto-compacts under it."""
    def hook(eng, mon, i):
        if i == 1:
            for r in make_requests("spec"):
                r.rid = "b-" + r.rid
                eng.submit(r)

    got, eng = run_transcript(
        port_factory(ref, "ragged", auto_compact_frag=0.2,
                     auto_compact_min_pages=1),
        lambda: make_requests("ragged"), step_hook=hook)
    assert eng.auto_compactions > 0
    assert_same_tokens(ref, "ragged",
                       {k: v for k, v in got.items() if k[:2] != "b-"})
    assert_same_tokens(ref, "spec",
                       {k[2:]: v for k, v in got.items() if k[:2] == "b-"})


# ---------------------------------------------------------------------------
# (d) fused and pipelined decode equal single-step
# ---------------------------------------------------------------------------

def _compact_every(eng, mon, i):
    eng.compact()


FUSED = {
    "fused4_async1": (dict(fuse_steps=4, async_depth=1), None),
    "fused4_evict_resume": (dict(fuse_steps=4, async_depth=1),
                            evict_resume_every(3)),
    "fused4_oom": (dict(fuse_steps=4, async_depth=1, pool_pages=6), None),
    "async2_unfused": (dict(fuse_steps=1, async_depth=2), None),
    "fused4_compact_every_step": (dict(fuse_steps=4, async_depth=1),
                                  _compact_every),
}


@pytest.mark.parametrize("case", sorted(FUSED))
def test_fused_decode_equals_single_step(ref, case):
    kw, hook = FUSED[case]
    got, eng = run_transcript(port_factory(ref, "ragged", **kw),
                              lambda: make_requests("ragged"),
                              step_hook=hook)
    assert_same_tokens(ref, "ragged", got)
    eng.pool.check_invariants()
    assert eng.bt_delta_execs > 0
    if case == "fused4_oom":
        assert eng.preemptions > 0, "pool was not tight enough to preempt"
    if kw["fuse_steps"] > 1:
        assert eng.program_execs.get("decode_multi", 0) > 0


@pytest.mark.parametrize("fuse,depth", [(1, 0), (4, 1)])
def test_on_device_stop_token(ref, fuse, depth):
    """eos_id stops a lane at the stop token: single-step on the host,
    fused on the device (the lane freezes mid-span)."""
    got, eng = run_transcript(
        port_factory(ref, "eos", eos_id=ref["eos_id"], fuse_steps=fuse,
                     async_depth=depth), lambda: make_requests("eos"))
    assert_same_tokens(ref, "eos", got)
    assert got["r1"][-1] == ref["eos_id"] and len(got["r1"]) == 2
    eng.pool.check_invariants()


# ---------------------------------------------------------------------------
# (e) bucket routing and memory-gated admission
# ---------------------------------------------------------------------------

def test_prompt_buckets_route_admissions(ref):
    mon, eng = port_factory(ref, "buckets")()
    assert [eng._pick_bucket(n) for n in (3, 4, 5, 99)] == [4, 4, 8, 8]
    assert {"prefill_admit_4", "prefill_admit_8"} <= set(eng.program_ids())
    for r in make_requests("buckets"):
        eng.submit(r)
    eng.run_until_drained()
    assert [len(eng.completed[r].tokens) for r in ("short", "long", "over")
            ] == [5, 4, 6]          # the over-cap ask is clamped to 6
    assert eng.program_execs["prefill_admit_4"] == 1
    assert eng.program_execs["prefill_admit_8"] == 2
    mon.vfpga_exit()


def test_memory_based_admission_and_watermark(ref):
    mon, eng = port_factory(ref, "spec", pool_pages=4, reserve_pages=1)()
    for r in make_requests("spec")[:2]:
        eng.submit(r)
    out = eng.step()
    # a prompt needs 2 pages; after one admission 2 free - 2 < 1 reserve
    assert out["admitted"] == 1 and out["pending"] == 1
    eng.run_until_drained()
    assert len(eng.completed) == 2
    mon.vfpga_exit()


def test_unported_features_raise():
    reg = MetricsRegistry()
    mon = Monitor("bad", SliceAllocator("n0", 1, device="cpu"),
                  telemetry=reg)
    mk = lambda **kw: ContinuousBatchingEngine(  # noqa: E731
        "yi-9b-smoke", FunkyCL(mon), slots=2, prompt_len=PROMPT_LEN,
        max_new_tokens=4, page_size=PAGE, **kw)
    for kw in (dict(spec=object()), dict(prefix_cache=True),
               dict(role="prefill"), dict(paged=False),
               dict(tracer=object())):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            mk(**kw)
    eng = mk()
    with pytest.raises(NotImplementedError, match="not ported yet"):
        eng.attach_transfer(None)
    eng._legacy_admit = True
    with pytest.raises(NotImplementedError, match="not ported yet"):
        eng.setup()
    with pytest.raises(ValueError):
        mk(fuse_steps=0)
    with pytest.raises(ValueError):       # SSM states have no pages
        ContinuousBatchingEngine("mamba2-1.3b-smoke", FunkyCL(mon), slots=2,
                                 prompt_len=PROMPT_LEN, page_size=PAGE
                                 ).setup()


# ---------------------------------------------------------------------------
# (f) the failure contract: one raise per failure, then an exact replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("program,at", [("decode_multi", 3),
                                        ("prefill_admit", 2)])
def test_failed_execute_raises_once_and_replays(ref, program, at):
    plan = FaultPlan([FaultSpec(site="monitor.execute", kind="crash",
                                match=program, at=at)])
    mon, eng = port_factory(ref, "ragged", chaos=plan, fuse_steps=4,
                            async_depth=1)()
    for r in make_requests("ragged"):
        eng.submit(r)
    raised = 0
    for _ in range(500):
        if eng.idle:
            break
        try:
            eng.step()
        except RuntimeError as e:
            assert "injected crash" in str(e)
            raised += 1
    assert raised == 1 and len(plan.fired) == 1
    got = {rid: rec.tokens for rid, rec in eng.completed.items()}
    eng.pool.check_invariants()
    mon.vfpga_exit()
    assert_same_tokens(ref, "ragged", got)


# ---------------------------------------------------------------------------
# (g) RequestRouter -> EngineServeTask -> FunkyRuntime
# ---------------------------------------------------------------------------

def test_router_pump_and_requeue(ref):
    router = RequestRouter("svc")
    for r in make_requests("spec"):
        router.submit(r)
    popped = router.pop(2)
    assert [r.rid for r in popped] == ["r0", "r1"]
    assert router.in_flight == 2 and router.outstanding() == 4
    router.requeue(popped)
    assert router.in_flight == 0
    assert [r.rid for r in router.pop(4)] == ["r0", "r1", "r2", "r3"]
    mon, eng = port_factory(ref, "spec")()
    router2 = RequestRouter("svc", registry=eng.registry)
    for r in make_requests("spec"):
        router2.submit(r)
    while router2.outstanding() > 0 and eng.pump(router2):
        pass
    mon.vfpga_exit()
    assert router2.in_flight == 0
    assert_same_tokens(ref, "spec", {rid: rec.tokens for rid, rec
                                     in router2.completed.items()})


def test_kv_aware_routing_prefers_max_free_pages():
    from repro_torch.scaling.autoscaler import M_KV_FREE_PAGES

    reg = MetricsRegistry()
    router = RequestRouter("svc", registry=reg)
    reg.gauge(M_KV_FREE_PAGES, service="svc", engine="eA").set(10)
    reg.gauge(M_KV_FREE_PAGES, service="svc", engine="eB").set(2)
    for r in make_requests("spec"):
        router.submit(r)
    assert router.pop(2, engine_id="eB") == []          # deferred once
    assert [r.rid for r in router.pop(2, engine_id="eA")] == ["r0", "r1"]
    assert [r.rid for r in router.pop(1, engine_id="eB")] == ["r2"]


@pytest.mark.parametrize("fuse,evict", [(1, False), (4, True)])
def test_engine_serve_task_through_the_runtime(ref, fuse, evict):
    name = f"svc-g{fuse}"
    im = TaskImage(name=name, kind="engine-serve", arch=ARCH,
                   prompt_len=PROMPT_LEN, global_batch=2, max_new_tokens=8,
                   page_size=PAGE, total_steps=10 ** 9, seed=0,
                   fuse_steps=fuse, async_depth=1 if fuse > 1 else 0)
    router = reset_router(name)
    rt = FunkyRuntime("n0", SliceAllocator("n0", 1, device="cpu"))
    rec = rt.create("e", im)
    assert isinstance(rec.task, EngineServeTask)
    rt.start("e")
    deadline = time.time() + 60
    while rec.status is TaskStatus.CREATED and time.time() < deadline:
        time.sleep(0.005)
    assert rec.status is TaskStatus.RUNNING, rec.error
    # the reference's weights, through the engine's own TRANSFER, before
    # any request reaches the router
    FunkyCL(rec.monitor).write_buffer("params", ref["params"]).wait()
    for r in make_requests("spec"):
        router.submit(r)
    if evict:
        while not router.completed and time.time() < deadline:
            time.sleep(0.002)
        stats = rt.evict("e")
        assert stats["paged_total_pages"] > 0
        rt.resume("e")
    router.close()
    assert rt.wait("e", timeout=120) is TaskStatus.DONE, rec.error
    assert rec.guest_state.user["completed"] == 4
    assert router.in_flight == 0
    assert_same_tokens(ref, "spec", {rid: c.tokens for rid, c
                                     in router.completed.items()})
    assert decode_attention_paged.launches == 0     # plain version on CPU
    rt.delete("e")
