"""Speculative decode and reserved mode of the port's engine against the
reference's ``tests/test_spec_decode.py``, case for case: committed tokens
equal plain greedy decode's across acceptance regimes (forced-accept
self-draft, forced-reject antigreedy draft, a different-seed draft),
rollback frees exactly the orphaned lookahead tail, evict/resume with a
lane mid-lookahead, OOM preemption during lookahead, prompt buckets, the
acceptance gauges and dynamic k.

Parity with the reference package on the JAX engine's weights (target and
draft, f32): the port's transcripts and ``spec_stats`` in spec mode
(forced accept, forced reject, a random draft, dynamic k's sequence of
k) and its transcripts in reserved mode equal the JAX engine's.  Also the
pieces under them: K1's dense entry with per-lane positions (the draft
and reserved lanes) and the per-lane cache helpers, on the CPU against
the JAX package's one-lane ``decode_ref`` vmapped over the lanes; on the
card (``gpu``) the kernel against its plain
version at the verify window and at the draft-lane shape, and a smoke
spec engine in f32 giving the CPU's tokens.

The engines serve yi-9b-smoke in float32 (registered for this module) on
``device="cpu"``.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jcfg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.core import FunkyCL, Monitor, SliceAllocator  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention, decode_attention_paged)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_paged_ref, decode_attention_ref)
from repro_torch.scaling.autoscaler import M_SPEC_ACCEPT_RATE  # noqa: E402
from repro_torch.scaling.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serve.engine import (M_SPEC_K,  # noqa: E402
                                      ContinuousBatchingEngine, ServeRequest,
                                      SpecConfig)
from repro_torch.serve.equivalence import (  # noqa: E402
    assert_transcripts_equal, check_equivalence, evict_resume_every,
    run_transcript)
from repro_torch.serve.kvcache import (install_lane_cache,  # noqa: E402
                                       lane_cache_specs)

ARCH = "yi-9b-f32-smoke"
PROMPT_LEN = 8
PAGE = 4
SPEC = [3, 6, 4, 5]            # ragged per-request generation lengths
INVALID = 2 ** 30


@pytest.fixture(scope="module", autouse=True)
def f32_arch():
    mp = pytest.MonkeyPatch()
    for mod in (jcfg, tcfg):
        base = mod.ARCHS["yi-9b"]
        mp.setitem(mod.ARCHS, "yi-9b-f32", dataclasses.replace(
            base, name="yi-9b-f32", dtype="float32"))
    yield
    mp.undo()


def factory(spec=None, slots=2, max_new=8, weights=None, device="cpu",
            **kw):
    """() -> (monitor, engine); ``weights`` ({buffer: tree}) are written
    into the engine after its setup."""
    def make():
        reg = MetricsRegistry()
        mon = Monitor("spec-test", SliceAllocator("n0", 1, device=device),
                      telemetry=reg)
        eng = ContinuousBatchingEngine(
            ARCH, FunkyCL(mon), slots=slots, prompt_len=PROMPT_LEN,
            max_new_tokens=max_new, registry=reg, page_size=PAGE,
            spec=spec, **kw)
        eng.setup()
        for buf, tree in (weights or {}).items():
            eng.cl.write_buffer(buf, tree).wait()
        return mon, eng
    return make


def requests(spec_list=SPEC, seed=3, prompt_len=PROMPT_LEN,
             cls=ServeRequest):
    def make():
        rng = np.random.Generator(np.random.Philox(seed))
        return [cls(rid=f"r{i}", prompt=rng.integers(0, 100, prompt_len),
                    max_new_tokens=n)
                for i, n in enumerate(spec_list)]
    return make


@pytest.fixture(scope="module")
def plain_ref():
    """The non-speculative paged greedy transcript of SPEC."""
    ref, _ = run_transcript(factory(), requests())
    return ref


def test_forced_accept_bit_exact_and_multitoken(plain_ref):
    got, eng = run_transcript(factory(SpecConfig(k=2)), requests())
    assert_transcripts_equal(got, plain_ref, context="forced-accept")
    stats = eng.spec_stats()
    assert stats["accept_rate"] == 1.0
    assert stats["tokens_per_lane_iteration"] > 1
    assert stats["committed_tokens"] == sum(SPEC) - len(SPEC)


def test_forced_reject_bit_exact(plain_ref):
    got, eng = run_transcript(
        factory(SpecConfig(k=2, draft_mode="antigreedy")), requests())
    assert_transcripts_equal(got, plain_ref, context="forced-reject")
    stats = eng.spec_stats()
    assert stats["accept_rate"] == 0.0
    assert stats["tokens_per_lane_iteration"] == 1.0


def test_mixed_draft_bit_exact(plain_ref):
    got, eng = run_transcript(
        factory(SpecConfig(k=2, draft_seed=99)), requests())
    assert_transcripts_equal(got, plain_ref, context="mixed")
    assert 0.0 <= eng.spec_stats()["accept_rate"] <= 1.0


def test_spec_vs_dense_reserved_baseline():
    check_equivalence(factory(SpecConfig(k=2)), factory(paged=False),
                      requests(), context="spec-vs-dense")


def test_rollback_frees_exactly_orphaned_tail():
    def hook(eng, mon, i):
        eng.pool.check_invariants()
        for st in eng._active.values():
            assert len(st.blocks) == -(-st.pos // PAGE)
    got, eng = run_transcript(
        factory(SpecConfig(k=3, draft_mode="antigreedy")), requests(),
        step_hook=hook)
    assert eng.pool.used_count() == 0
    rollbacks = [e for e in eng.registry.flight_record()["events"]
                 if e[1] == "engine_spec_rollback"]
    assert rollbacks and all(e[2]["freed"] > 0 for e in rollbacks)


def test_evict_resume_mid_lookahead_bit_exact(plain_ref):
    got, _ = run_transcript(
        factory(SpecConfig(k=2, draft_mode="antigreedy")), requests(),
        step_hook=evict_resume_every(1))
    assert_transcripts_equal(got, plain_ref, context="evict-mid-lookahead")
    got, eng = run_transcript(factory(SpecConfig(k=3)), requests(),
                              step_hook=evict_resume_every(2))
    assert_transcripts_equal(got, plain_ref, context="evict-k3")
    assert eng.spec_stats()["accept_rate"] == 1.0


def test_oom_preemption_during_lookahead_recomputes_bit_exact(plain_ref):
    got, eng = run_transcript(
        factory(SpecConfig(k=2), pool_pages=6, reserve_pages=1), requests())
    assert_transcripts_equal(got, plain_ref, context="oom-lookahead")
    assert eng.preemptions > 0
    eng.pool.check_invariants()


def test_spec_with_prompt_buckets(plain_ref):
    got, eng = run_transcript(
        factory(SpecConfig(k=2), prompt_buckets=(4, PROMPT_LEN)),
        requests())
    assert_transcripts_equal(got, plain_ref, context="buckets")
    assert eng.spec_stats()["accept_rate"] == 1.0


def test_accept_rate_gauge_published_and_tombstoned_on_kill():
    _, eng = run_transcript(factory(SpecConfig(k=2)), requests())
    vals = eng.registry.labeled_gauge_values(M_SPEC_ACCEPT_RATE,
                                             service="svc")
    per_engine = {lbl["engine"]: v for lbl, v in vals if "engine" in lbl}
    assert per_engine == {"engine0": 1.0}
    eng.evacuate()                         # kill path
    vals = eng.registry.labeled_gauge_values(M_SPEC_ACCEPT_RATE,
                                             service="svc")
    assert all(math.isnan(v) for lbl, v in vals if "engine" in lbl)


def test_dynamic_k_shrinks_on_rejection(plain_ref):
    got, eng = run_transcript(
        factory(SpecConfig(k=2, draft_mode="antigreedy", dynamic_k=True,
                           adapt_window=4)),
        requests())
    assert_transcripts_equal(got, plain_ref, context="dynamic-shrink")
    assert eng.spec_k_now == 1
    adapts = [e for e in eng.registry.flight_record()["events"]
              if e[1] == "engine_spec_k_adapt"]
    assert adapts and adapts[-1][2]["k_to"] == 1
    vals = {lbl["engine"]: v for lbl, v in
            eng.registry.labeled_gauge_values(M_SPEC_K, service="svc")
            if "engine" in lbl}
    assert vals == {"engine0": 1.0}


def test_dynamic_k_regrows_on_sustained_acceptance():
    def shrunk_factory():
        mon, eng = factory(SpecConfig(k=2, dynamic_k=True,
                                      adapt_window=4))()
        eng.spec_k_now = 1          # as if a bad phase shrank the lookahead
        return mon, eng

    reqs = requests(spec_list=[8, 8, 7, 8])
    eng, _ = check_equivalence(shrunk_factory, factory(), reqs,
                               context="dynamic-regrow")
    assert eng.spec_k_now == 2
    assert eng.spec_stats()["k_now"] == 2


def test_spec_requires_paged_mode():
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatchingEngine(
            ARCH, FunkyCL(Monitor("x", SliceAllocator("n0", 1,
                                                      device="cpu"))),
            paged=False, spec=SpecConfig(k=2))


def test_harness_reports_first_divergence():
    ref = {"r0": [1, 2, 3]}
    with pytest.raises(AssertionError, match="rid=r0 at token 1"):
        assert_transcripts_equal({"r0": [1, 9, 3]}, ref)
    with pytest.raises(AssertionError, match="request sets differ"):
        assert_transcripts_equal({}, ref)


def test_spec_rides_delta_block_table(plain_ref):
    got, eng = run_transcript(factory(spec=SpecConfig(k=2, draft_seed=99)),
                              requests())
    assert_transcripts_equal(got, plain_ref, context="spec + delta bt")
    assert eng.bt_delta_execs > 0
    assert eng.bt_full_writes == 0


def test_spec_refuses_fused_pipeline():
    with pytest.raises(ValueError):
        factory(spec=SpecConfig(k=2), fuse_steps=4)()
    with pytest.raises(ValueError):
        factory(spec=SpecConfig(k=2), async_depth=1)()


# ---------------------------------------------------------------------------
# Parity with the JAX engine on shared f32 weights
# ---------------------------------------------------------------------------
def _jax_run(spec_list=SPEC, **kw):
    """The JAX engine's transcript, spec stats, spec_k adaptations, and
    weights (target, and the draft's for a speculative engine)."""
    import jax

    from repro.core import FunkyCL as JFunkyCL
    from repro.core import Monitor as JMonitor
    from repro.core import SliceAllocator as JSliceAllocator
    from repro.serve.engine import ContinuousBatchingEngine as JEngine
    from repro.serve.engine import ServeRequest as JServeRequest
    from repro.serve.engine import SpecConfig as JSpecConfig
    from repro_torch.testing import params_from_jax

    spec = kw.pop("spec", None)
    if spec is not None:
        spec = JSpecConfig(**dataclasses.asdict(spec))
    mon = JMonitor("spec-ref", JSliceAllocator("n0", 1))
    eng = JEngine(ARCH, JFunkyCL(mon), slots=2, prompt_len=PROMPT_LEN,
                  max_new_tokens=8, page_size=PAGE, spec=spec, **kw)
    eng.setup()
    weights = {b: params_from_jax(jax.tree.map(np.asarray,
                                               eng.cl.read_buffer(b)))
               for b in (("params", "draft_params") if spec is not None
                         else ("params",))}
    for r in requests(spec_list, cls=JServeRequest)():
        eng.submit(r)
    eng.run_until_drained()
    mon.vfpga_exit()
    return ({rid: list(c.tokens) for rid, c in eng.completed.items()},
            eng.spec_stats(), _adapts(eng), weights)


def _adapts(eng):
    return [(e[2]["k_from"], e[2]["k_to"])
            for e in eng.registry.flight_record()["events"]
            if e[1] == "engine_spec_k_adapt"]


@pytest.mark.parametrize("case", ["forced_accept", "forced_reject",
                                  "random_draft", "dynamic_k"])
def test_spec_engine_equals_the_jax_engine(case):
    spec, spec_list = {
        "forced_accept": (SpecConfig(k=3), SPEC),
        "forced_reject": (SpecConfig(k=2, draft_mode="antigreedy"), SPEC),
        "random_draft": (SpecConfig(k=2, draft_seed=99), SPEC),
        "dynamic_k": (SpecConfig(k=3, draft_seed=99, dynamic_k=True,
                                 adapt_window=3), [8, 8, 7, 8]),
    }[case]
    want, want_stats, want_adapts, weights = _jax_run(spec_list, spec=spec)
    got, eng = run_transcript(factory(spec, weights=weights),
                              requests(spec_list))
    assert_transcripts_equal(got, want, context=f"port vs JAX ({case})")
    assert eng.spec_stats() == want_stats
    assert _adapts(eng) == want_adapts
    if case == "dynamic_k":
        assert want_adapts, "dynamic k never adapted"


def test_staged_admission_gives_the_one_execute_tokens(plain_ref):
    """The staged admission (``_legacy_admit``: prompt write, prefill,
    admit, first-token read) serves the single-EXECUTE admission's
    tokens."""
    def staged():
        reg = MetricsRegistry()
        mon = Monitor("staged", SliceAllocator("n0", 1, device="cpu"),
                      telemetry=reg)
        eng = ContinuousBatchingEngine(
            ARCH, FunkyCL(mon), slots=2, prompt_len=PROMPT_LEN,
            max_new_tokens=8, registry=reg, page_size=PAGE)
        eng._legacy_admit = True
        eng.setup()
        return mon, eng

    got, eng = run_transcript(staged, requests())
    assert_transcripts_equal(got, plain_ref, context="staged admission")
    assert eng.program_execs[f"admit_{PROMPT_LEN}"] == len(SPEC)
    assert f"prefill_admit_{PROMPT_LEN}" not in eng.program_execs


def test_reserved_engine_equals_the_jax_engine():
    want, _, _, weights = _jax_run(paged=False)
    got, eng = run_transcript(factory(paged=False, weights=weights),
                              requests())
    assert_transcripts_equal(got, want, context="port vs JAX (reserved)")
    assert eng.program_execs["decode_step"] > 0


# ---------------------------------------------------------------------------
# The pieces: K1 dense with per-lane positions, the per-lane caches
# ---------------------------------------------------------------------------
def _lanes_case(B, cap, Hq, Hkv, hd, pos, dtype="float32", seed=0):
    """Per-lane rings: lane b wrote positions 0..pos[b] (slot = position),
    its other slots hold a stale position > pos[b] or INVALID."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.standard_normal((B, 1, Hq, hd),
                                             dtype=np.float32)).to(dt)
    k, v = (torch.from_numpy(rng.standard_normal(
        (B, cap, Hkv, hd), dtype=np.float32)).to(dt) for _ in range(2))
    kv_pos = np.full((B, cap), INVALID, np.int32)
    for b, p in enumerate(pos):
        kv_pos[b, :p + 1] = np.arange(p + 1)
        kv_pos[b, p + 1:p + 3] = p + 7          # rejected lookahead writes
    return (q, k, v, torch.from_numpy(kv_pos),
            torch.tensor(pos, dtype=torch.int32))


def test_per_lane_plain_version_matches_jax_vmapped_decode():
    """The port's per-lane form (kv_pos (B, cap), pos (B,)) against the
    JAX package's one-lane oracle ``decode_ref`` vmapped over the lanes,
    on the same f32 inputs (tolerance 1e-5)."""
    import jax
    import jax.numpy as jnp

    from repro.kernels.decode_attention.ref import decode_ref

    q, k, v, kvp, pos = _lanes_case(3, 24, 8, 2, 16, [5, 20, 11])
    out = decode_attention(q, k, v, pos, kvp)
    one = lambda q, k, v, p, kp: decode_ref(  # noqa: E731
        q[None], k[None], v[None], p, kp)[0]
    ref = jax.vmap(one)(*(jnp.asarray(t.numpy()) for t in (q, k, v, pos,
                                                            kvp)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_lane_caches_install_a_shorter_bucket():
    from repro_torch.models import build_model

    cfg = tcfg.get_arch(ARCH)
    bundle = build_model(cfg, cache_margin=5)
    specs = lane_cache_specs(bundle.cache_specs(1, 8 + 5), 3)
    k_spec = specs[0][0]["k"]
    assert tuple(k_spec.shape) == (cfg.num_layers, 3, 13,
                                   cfg.num_kv_heads, cfg.head_dim_)
    assert tuple(specs[0][0]["kv_pos"].shape) == (cfg.num_layers, 3, 13)
    from repro_torch.serve.kvcache import init_caches_from_specs

    caches = init_caches_from_specs(specs, "cpu")
    params = bundle.init(0, device="cpu")
    _, pf = bundle.prefill_fn(params, {"tokens": torch.arange(4)[None]})
    install_lane_cache(caches, pf, 1)
    got = caches[0][0]
    assert torch.equal(got["kv_pos"][:, 1, :4],
                       torch.arange(4, dtype=torch.int32).expand(
                           cfg.num_layers, 4))
    assert (got["kv_pos"][:, 1, 4:] == INVALID).all()
    assert (got["kv_pos"][:, 0] == INVALID).all()
    assert torch.equal(got["k"][:, 1, :4], pf[0][0]["k"][:, 0, :4])
    assert (got["k"][:, 1, 4:] == 0).all()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_lane_dense_kernel_matches_plain_on_card(cuda, dtype):
    """The draft lanes' shape: 8 lanes of yi-9b's heads at ragged
    positions in rings of 163 slots, rejected writes past each position."""
    q, k, v, kvp, pos = (t.to(cuda) for t in _lanes_case(
        8, 163, 32, 4, 128, [128, 150, 131, 140, 159, 129, 133, 147],
        dtype))
    before = decode_attention.launches
    out = decode_attention(q, k, v, pos, kvp)
    assert decode_attention.launches == before + 1
    ref = decode_attention_ref(q, k, v, pos, kvp)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=1e-4 if dtype == "float32" else 2e-2)
    assert torch.equal(out, decode_attention(q, k, v, pos, kvp))


@pytest.mark.gpu
def test_verify_window_paged_kernel_matches_plain_on_card(cuda):
    """Verify's k+1 = 4 steps over 8 lanes whose window crosses a page
    boundary (pages of 16), each step one more written slot."""
    rng = np.random.default_rng(1)
    B, ps, mb, NP, Hq, Hkv, hd = 8, 16, 11, 96, 32, 4, 128
    pos0 = np.array([14, 30, 45, 13, 62, 77, 94, 126]) % (mb * ps - 4)
    k, v = (torch.from_numpy(rng.standard_normal(
        (NP, ps, Hkv, hd), dtype=np.float32)).to(cuda) for _ in range(2))
    kvp = torch.full((NP, ps), INVALID, dtype=torch.int32, device=cuda)
    bt = torch.full((B, mb), -1, dtype=torch.int32)
    perm = rng.permutation(NP)
    for b in range(B):
        n = (pos0[b] + 3) // ps + 1
        bt[b, :n] = torch.from_numpy(perm[b * mb:b * mb + n].astype(
            np.int32))
        for lp in range(n):
            p = lp * ps + np.arange(ps)
            kvp[int(bt[b, lp]), :] = torch.from_numpy(
                np.where(p < pos0[b], p, INVALID).astype(np.int32))
    bt = bt.to(cuda)
    for i in range(4):
        pos = torch.from_numpy((pos0 + i).astype(np.int32)).to(cuda)
        for b in range(B):
            p = int(pos[b])
            kvp[int(bt[b, p // ps]), p % ps] = p
        q = torch.from_numpy(rng.standard_normal(
            (B, 1, Hq, hd), dtype=np.float32)).to(cuda)
        b1 = decode_attention_paged.launches_b1
        out = decode_attention_paged(q, k, v, kvp, bt, pos)
        assert decode_attention_paged.launches_b1 == b1   # 8 lanes
        ref = decode_attention_paged_ref(q, k, v, kvp, bt, pos)
        torch.testing.assert_close(out, ref, rtol=2e-2, atol=1e-4)
        assert torch.equal(out, decode_attention_paged(q, k, v, kvp, bt,
                                                       pos))


@pytest.mark.gpu
def test_spec_engine_on_card_gives_the_cpu_tokens(cuda, plain_ref):
    """A smoke spec engine (self-draft, k 2) in f32 on the card: the CPU
    engine's tokens, with the weights drawn on the CPU."""
    mon, eng = factory(SpecConfig(k=2))()
    weights = {b: eng.cl.read_buffer(b) for b in ("params", "draft_params")}
    mon.vfpga_exit()
    got, eng = run_transcript(
        factory(SpecConfig(k=2), device="cuda", weights=weights),
        requests())
    assert_transcripts_equal(got, plain_ref, context="spec on the card")
    assert eng.spec_stats()["iterations"] > 0
