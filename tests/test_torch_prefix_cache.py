"""The port's cross-request KV prefix cache against the reference's
``tests/test_prefix_cache.py``, case for case: radix-tree units (match /
insert / dedup / LRU eviction / remap over a refcounted ``BlockPool``) and
the engine gates — a prefix-hit request streams the tokens of a cold run
of the same engine, across evict/resume and OOM preemption, with
copy-on-write guarding shared pages from the engine's in-place writes.
Also the router's prefix-warmth routing (``tests/test_engine.py``'s four
cases) and the pipelined deferred hit of ``tests/test_disagg.py``.

Parity with the reference package: one seeded sequence of match, insert,
evict, free and remap gives the same matches, page ids and stats in both
``PrefixCache``s; and on the JAX engine's weights (f32) the port's prefix
engine gives the JAX prefix engine's transcripts and ``prefix_stats``.

The engines serve yi-9b-smoke in float32 (registered for this module) on
``device="cpu"``, where K1's paged entry runs its plain version.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jcfg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.core import FunkyCL, Monitor, SliceAllocator  # noqa: E402
from repro_torch.scaling.autoscaler import M_PREFIX_HIT_RATE  # noqa: E402
from repro_torch.scaling.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serve.engine import (ContinuousBatchingEngine,  # noqa: E402
                                      ServeRequest, SpecConfig)
from repro_torch.serve.equivalence import (  # noqa: E402
    assert_transcripts_equal, evict_resume_every, run_transcript)
from repro_torch.serve.kvcache import BlockPool  # noqa: E402
from repro_torch.serve.prefix_cache import PrefixCache  # noqa: E402

ARCH = "yi-9b-f32-smoke"
PROMPT_LEN = 8
PAGE = 4
BUCKET = PROMPT_LEN


@pytest.fixture(scope="module", autouse=True)
def f32_arch():
    mp = pytest.MonkeyPatch()
    for mod in (jcfg, tcfg):
        base = mod.ARCHS["yi-9b"]
        mp.setitem(mod.ARCHS, "yi-9b-f32", dataclasses.replace(
            base, name="yi-9b-f32", dtype="float32"))
    yield
    mp.undo()


# ---------------------------------------------------------------------------
# Tree units (no model, bare pool)
# ---------------------------------------------------------------------------
def _tree(pages=16, max_nodes=64):
    pool = BlockPool(pages, PAGE)
    return pool, PrefixCache(pool, PAGE, max_nodes=max_nodes)


def _toks(*pages):
    """Page-key shorthand: _toks(1, 2) -> [1]*PAGE + [2]*PAGE."""
    out = []
    for p in pages:
        out.extend([p] * PAGE)
    return out


def test_match_walks_longest_prefix():
    pool, tree = _tree()
    ids = pool.alloc(3)
    tree.insert(BUCKET, _toks(1, 2, 3), ids, next_token=77)
    m = tree.match(BUCKET, _toks(1, 2, 3))
    assert m.pages == ids and m.tokens == 3 * PAGE and m.next_token == 77
    m2 = tree.match(BUCKET, _toks(1, 2))
    assert m2.pages == ids[:2] and m2.next_token == 3
    m3 = tree.match(BUCKET, _toks(1, 9))
    assert m3.pages == ids[:1] and m3.next_token is None
    assert tree.match(BUCKET, _toks(8)).pages == []
    assert tree.match(BUCKET + PAGE, _toks(1)).pages == []   # per-bucket
    tree.check_invariants()


def test_non_page_aligned_tokens_rejected():
    _, tree = _tree()
    with pytest.raises(ValueError):
        tree.match(BUCKET, [1, 2, 3])


def test_insert_pins_pages_and_dedups():
    pool, tree = _tree()
    a = pool.alloc(2)
    assert tree.insert(BUCKET, _toks(1, 2), a) == 2
    assert pool.refcount(a[0]) == 2             # caller's ref + tree's ref
    b = pool.alloc(2)
    assert tree.insert(BUCKET, _toks(1, 2), b) == 0
    assert pool.refcount(b[0]) == 1
    assert tree.match(BUCKET, _toks(1, 2)).pages == a
    assert pool.free(a) == []
    assert pool.refcount(a[0]) == 1
    tree.check_invariants()


def test_evict_lru_respects_refcounts_and_cascades():
    pool, tree = _tree()
    cold = pool.alloc(2)
    tree.insert(BUCKET, _toks(1, 2), cold)
    pool.free(cold)                             # tree-only: evictable
    hot = pool.alloc(1)
    tree.insert(BUCKET, _toks(5), hot)          # lane still holds its ref
    tree.match(BUCKET, _toks(5))
    assert tree.evict_pages(3) == 2
    assert tree.match(BUCKET, _toks(1)).pages == []
    assert pool.refcount(hot[0]) == 2
    assert tree.nodes == 1
    assert tree.reclaimable_pages() == 0
    tree.check_invariants()


def test_match_len_probe_does_not_bump_recency():
    pool, tree = _tree()
    a = pool.alloc(1)
    tree.insert(BUCKET, _toks(1), a)
    b = pool.alloc(1)
    tree.insert(BUCKET, _toks(2), b)
    pool.free(a)
    pool.free(b)
    assert tree.match_len(BUCKET, _toks(1)) == PAGE
    assert tree.match_len(BUCKET, _toks(1, 2)) == PAGE
    tree.evict_pages(1)
    assert tree.match(BUCKET, _toks(1)).pages == []
    assert tree.match(BUCKET, _toks(2)).pages == b


def test_max_nodes_overflow_evicts():
    pool, tree = _tree(pages=16, max_nodes=2)
    for i in range(4):
        ids = pool.alloc(1)
        tree.insert(BUCKET, _toks(10 + i), ids)
        pool.free(ids)
    assert tree.nodes <= 2
    assert tree.stats()["evicted_nodes"] >= 2
    tree.check_invariants()


def test_remap_follows_pool_compaction():
    pool, tree = _tree()
    a = pool.alloc(4)
    tree.insert(BUCKET, _toks(1, 2), [a[1], a[3]])
    pool.free([a[0], a[2]])
    pool.free([a[1], a[3]])
    mapping = pool.compact()
    tree.remap(mapping)
    m = tree.match(BUCKET, _toks(1, 2))
    assert m.pages == [mapping.get(a[1], a[1]), mapping.get(a[3], a[3])]
    tree.check_invariants()
    pool.check_invariants()


def _tree_script(pool_cls, cache_cls, seed=17):
    """A seeded random sequence of lookups, inserts (with lane references
    dropped or kept), evictions, probes, compactions and remaps on one
    pool + tree; returns everything it observed."""
    rng = np.random.Generator(np.random.Philox(seed))
    pool = pool_cls(24, PAGE)
    tree = cache_cls(pool, PAGE, max_nodes=12)
    lanes, out = [], []
    for _ in range(300):
        op = int(rng.integers(0, 6))
        bucket = BUCKET * int(rng.integers(1, 3))
        toks = [int(t) for t in rng.integers(0, 3, bucket)]
        if op == 0:
            m = tree.match(bucket, toks)
            out.append(("match", m.pages, m.tokens, m.next_token))
        elif op == 1:
            n = bucket // PAGE
            ids = pool.alloc(n, urgent=True)
            if ids is None:
                out.append(("full",))
                continue
            nxt = int(rng.integers(0, 50)) if rng.random() < 0.5 else None
            out.append(("insert", tree.insert(bucket, toks, ids, nxt), ids))
            if rng.random() < 0.5:
                pool.free(ids)
            else:
                lanes.append(ids)
        elif op == 2:
            out.append(("evict", tree.evict_pages(int(rng.integers(1, 4)))))
        elif op == 3 and lanes:
            out.append(("free", pool.free(lanes.pop(0))))
        elif op == 4:
            mapping = pool.compact()
            tree.remap(mapping)
            lanes = [[mapping.get(p, p) for p in ids] for ids in lanes]
            out.append(("compact", sorted(mapping.items())))
        else:
            out.append(("probe", tree.match_len(bucket, toks),
                        tree.reclaimable_pages()))
        tree.check_invariants()
        pool.check_invariants()
    out.append(("stats", tree.stats(), tree.nodes, pool.used_count()))
    return out


def test_tree_sequence_equals_the_reference():
    from repro.serve.kvcache import BlockPool as JBlockPool
    from repro.serve.prefix_cache import PrefixCache as JPrefixCache

    port = _tree_script(BlockPool, PrefixCache)
    ref = _tree_script(JBlockPool, JPrefixCache)
    assert port == ref
    kinds = {o[0] for o in port}
    assert {"match", "insert", "evict", "free", "compact", "probe"} <= kinds
    assert port[-1][1]["evicted_pages"] > 0


# ---------------------------------------------------------------------------
# Engine integration: bit-exactness, COW, eviction pressure, gauges
# ---------------------------------------------------------------------------
def _factory(slots=2, max_new=6, pool_pages=None, **kw):
    def make():
        reg = MetricsRegistry()
        mon = Monitor("pfx-test", SliceAllocator("n0", 1, device="cpu"),
                      telemetry=reg)
        eng = ContinuousBatchingEngine(
            ARCH, FunkyCL(mon), slots=slots, prompt_len=PROMPT_LEN,
            max_new_tokens=max_new, registry=reg, page_size=PAGE,
            pool_pages=pool_pages, prefix_cache=True, **kw)
        eng.setup()
        return mon, eng
    return make


def _prompts(n_distinct, seed=3):
    rng = np.random.Generator(np.random.Philox(seed))
    return [rng.integers(0, 100, PROMPT_LEN) for _ in range(n_distinct)]


def _requests(prompts, tokens, cls=ServeRequest):
    def make():
        return [cls(rid=f"r{i}", prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, tokens))]
    return make


@pytest.fixture(scope="module")
def warm_run():
    """Two repeats of one prompt plus a distinct one, on a prefix-cache
    engine with ample pages."""
    p = _prompts(2)
    prompts, tokens = [p[0], p[0], p[1]], [4, 6, 4]
    transcript, eng = run_transcript(_factory(), _requests(prompts, tokens))
    return transcript, eng, prompts, tokens


def test_prefix_hit_bit_exact_vs_cold(warm_run):
    transcript, eng, prompts, _ = warm_run
    assert eng.prefix_stats()["hits"] >= 1
    assert transcript["r1"][:4] == transcript["r0"]
    cold, _ = run_transcript(_factory(), _requests([prompts[0]], [6]))
    assert_transcripts_equal({"r0": cold["r0"]}, {"r0": transcript["r1"]},
                             context="prefix hit vs cold")


def test_prefix_hit_bit_exact_across_evict_resume(warm_run):
    transcript, _, prompts, tokens = warm_run
    perturbed, eng = run_transcript(_factory(),
                                    _requests(prompts, tokens),
                                    step_hook=evict_resume_every(2))
    assert_transcripts_equal(perturbed, transcript,
                             context="prefix + evict/resume")
    assert eng.prefix_stats()["hits"] >= 1


def test_prefix_hit_bit_exact_under_oom_preemption(warm_run):
    transcript, _, prompts, tokens = warm_run
    squeezed, eng = run_transcript(
        _factory(slots=3, pool_pages=6), _requests(prompts, tokens))
    assert eng.preemptions > 0, "pool was not tight enough to preempt"
    assert_transcripts_equal(squeezed, transcript,
                             context="prefix + OOM preemption")
    eng.pool.check_invariants()
    eng.prefix.check_invariants()


def _pinned_tail_run(steps, **kw):
    """r0 alone; after ``steps`` steps another owner pins the lane's tail
    page, so the lane's next write into it must copy it first."""
    p = _prompts(1)
    ref, _ = run_transcript(_factory(), _requests(p, [6]))
    mon, eng = _factory(**kw)()
    try:
        eng.submit(ServeRequest(rid="r0", prompt=p[0], max_new_tokens=6))
        for _ in range(steps):
            eng.step()
        st = next(iter(eng._active.values()))
        tail = st.blocks[-1]
        eng.pool.share([tail])          # simulate another owner pinning it
        while not eng.idle:
            eng.step()
        assert eng.cow_copies >= 1
        assert tail not in st.blocks    # the writer moved to a private copy
        assert eng.pool.refcount(tail) == 1     # our pin still holds
        eng.pool.free([tail])
        assert_transcripts_equal(
            {rid: list(r.tokens) for rid, r in eng.completed.items()},
            ref, context="COW")
        eng.pool.check_invariants()
    finally:
        mon.vfpga_exit()


def test_cow_on_write_to_shared_page():
    """A write into a page another owner references copies it first: the
    writer gets a private page, the shared copy survives, tokens never
    change."""
    _pinned_tail_run(2)


def test_tree_evicted_under_admission_pressure():
    prompts = _prompts(6, seed=9)
    transcript, eng = run_transcript(
        _factory(slots=2, pool_pages=10), _requests(prompts, [3] * 6))
    assert len(transcript) == 6
    assert eng.prefix_stats()["evicted_pages"] > 0
    eng.pool.check_invariants()
    eng.prefix.check_invariants()


def test_hit_rate_gauge_published(warm_run):
    _, eng, _, _ = warm_run
    stats = eng.prefix_stats()
    assert stats["hit_rate"] > 0
    val = eng.registry.gauge(M_PREFIX_HIT_RATE, service="svc",
                             engine=eng.engine_id).value
    assert val == pytest.approx(stats["cached_tokens"]
                                / stats["prompt_tokens"])


def test_retire_donates_generated_pages(warm_run):
    """r0: 8 prompt + 4 generated tokens = 3 complete pages in the tree."""
    _, eng, _, _ = warm_run
    assert eng.prefix.nodes >= 3


def test_prefix_cache_requires_paged_aligned_buckets():
    reg = MetricsRegistry()
    mon = Monitor("pfx-bad", SliceAllocator("n0", 1, device="cpu"),
                  telemetry=reg)
    with pytest.raises(ValueError):
        ContinuousBatchingEngine(ARCH, FunkyCL(mon), slots=2,
                                 prompt_len=PROMPT_LEN, max_new_tokens=4,
                                 registry=reg, paged=False,
                                 prefix_cache=True)
    with pytest.raises(ValueError):
        ContinuousBatchingEngine(ARCH, FunkyCL(mon), slots=2,
                                 prompt_len=6, max_new_tokens=4,
                                 registry=reg, page_size=PAGE,
                                 prefix_cache=True)
    mon.vfpga_exit()


def test_spec_decode_composes_with_prefix_cache():
    p = _prompts(2, seed=13)
    prompts, tokens = [p[0], p[0], p[1]], [4, 4, 4]
    plain, _ = run_transcript(_factory(), _requests(prompts, tokens))
    spec, eng = run_transcript(_factory(spec=SpecConfig(k=2)),
                               _requests(prompts, tokens))
    assert_transcripts_equal(spec, plain, context="spec + prefix")
    assert eng.prefix_stats()["hits"] >= 1


def test_cow_on_shared_page_inside_fused_span():
    """k=3: after admit + one fused span the position sits mid-page, so the
    next span's write window starts inside the already-mapped tail page."""
    _pinned_tail_run(1, fuse_steps=3)


def test_prefix_hits_bit_exact_with_fused_pipeline():
    p = _prompts(2, seed=13)
    prompts, tokens = [p[0], p[0], p[1]], [6, 6, 4]
    plain, _ = run_transcript(_factory(), _requests(prompts, tokens))
    fused, eng = run_transcript(_factory(fuse_steps=4, async_depth=1),
                                _requests(prompts, tokens))
    assert_transcripts_equal(fused, plain, context="prefix + fused")
    assert eng.prefix_stats()["hits"] >= 1
    assert eng.bt_delta_execs > 0


def test_deferred_prefix_hit_admission_bit_exact():
    """``tests/test_disagg.py``'s case: prefix-hit suffix prefills ride
    the async pipeline (first-token read deferred, tree insert parked):
    repeat-prompt waves on a pipelined prefix engine match the
    synchronous one."""
    from repro_torch.serve.equivalence import check_equivalence

    def requests():
        rng = np.random.Generator(np.random.Philox(17))
        prompts = [rng.integers(0, 100, PROMPT_LEN) for _ in range(3)]
        return ([ServeRequest(rid=f"r{i}", prompt=p, max_new_tokens=n)
                 for i, (p, n) in enumerate(zip(prompts, [4, 6, 3]))]
                + [ServeRequest(rid=f"w2-r{i}", prompt=p, max_new_tokens=n)
                   for i, (p, n) in enumerate(zip(prompts, [5, 4, 6]))])

    eng, _ = check_equivalence(
        _factory(fuse_steps=2, async_depth=1), _factory(), requests,
        context="deferred prefix admission")
    assert eng.prefix_hits + eng.prefix_partial_hits > 0


# ---------------------------------------------------------------------------
# The router's prefix-warmth routing (tests/test_engine.py's cases)
# ---------------------------------------------------------------------------
def _routing_setup(free_a, free_b, n_req=3):
    from repro_torch.scaling.autoscaler import M_KV_FREE_PAGES
    from repro_torch.scaling.serving import RequestRouter

    reg = MetricsRegistry()
    router = RequestRouter("svc", registry=reg)
    reg.gauge(M_KV_FREE_PAGES, service="svc", engine="eA").set(free_a)
    reg.gauge(M_KV_FREE_PAGES, service="svc", engine="eB").set(free_b)
    for r in _requests(_prompts(n_req, seed=21), [2] * n_req)():
        router.submit(r)
    return reg, router


def test_prefix_aware_routing_prefers_warmest_replica():
    """The replica whose tree matches the head request wins the pop; a
    cold replica is held back exactly once."""
    _, router = _routing_setup(free_a=10, free_b=10)
    router.register_prefix_probe("eA", lambda p: 0)
    router.register_prefix_probe("eB", lambda p: 8)
    assert router.pop(1, engine_id="eA") == []          # cold: deferred
    assert [r.rid for r in router.pop(1, engine_id="eB")] == ["r0"]
    assert [r.rid for r in router.pop(1, engine_id="eA")] == ["r1"]


def test_prefix_preference_capped_by_free_page_headroom():
    """A warm replica with under half the best replica's free pages loses
    its preference; with the headroom back, warmth wins again."""
    from repro_torch.scaling.autoscaler import M_KV_FREE_PAGES

    _, router = _routing_setup(free_a=10, free_b=4)
    router.register_prefix_probe("eA", lambda p: 0)
    router.register_prefix_probe("eB", lambda p: 8)     # warm but starving
    assert [r.rid for r in router.pop(1, engine_id="eA")] == ["r0"]
    assert router.pop(1, engine_id="eB") == []          # deferred once
    assert [r.rid for r in router.pop(1, engine_id="eB")] == ["r1"]
    router.registry.gauge(M_KV_FREE_PAGES, service="svc",
                          engine="eB").set(6)
    assert router.pop(1, engine_id="eA") == []
    assert [r.rid for r in router.pop(1, engine_id="eB")] == ["r2"]


def test_failed_engine_probe_dropped():
    """A crashed replica's warmth probe stops attracting traffic."""
    _, router = _routing_setup(free_a=10, free_b=10)
    router.register_prefix_probe("eB", lambda p: 8)
    router.fail_engine("eB")
    assert [r.rid for r in router.pop(1, engine_id="eA")] == ["r0"]


def test_engine_pump_registers_prefix_probe():
    """A prefix engine advertises its warmth probe through pump(); the
    served prompt's pages then report warmth."""
    from repro_torch.scaling.serving import RequestRouter

    mon, eng = _factory(max_new=4)()
    router = RequestRouter("svc", registry=eng.registry)
    prompt = _prompts(1, seed=41)[0]
    router.submit(ServeRequest(rid="w0", prompt=prompt, max_new_tokens=2))
    while router.outstanding() or not eng.idle:
        if not eng.pump(router):
            break
    assert eng.engine_id in router._prefix_probes
    assert router._prefix_probes[eng.engine_id](prompt) > 0
    mon.vfpga_exit()


# ---------------------------------------------------------------------------
# Parity with the JAX prefix engine on shared f32 weights
# ---------------------------------------------------------------------------
def _jax_prefix_run(prompts, tokens, **kw):
    """The JAX prefix engine's transcript, stats and weights."""
    import jax

    from repro.core import FunkyCL as JFunkyCL
    from repro.core import Monitor as JMonitor
    from repro.core import SliceAllocator as JSliceAllocator
    from repro.serve.engine import ContinuousBatchingEngine as JEngine
    from repro.serve.engine import ServeRequest as JServeRequest
    from repro_torch.testing import params_from_jax

    mon = JMonitor("pfx-ref", JSliceAllocator("n0", 1))
    eng = JEngine(ARCH, JFunkyCL(mon), slots=2, prompt_len=PROMPT_LEN,
                  max_new_tokens=6, page_size=PAGE, prefix_cache=True, **kw)
    eng.setup()
    params = params_from_jax(jax.tree.map(np.asarray,
                                          eng.cl.read_buffer("params")))
    for r in _requests(prompts, tokens, JServeRequest)():
        eng.submit(r)
    eng.run_until_drained()
    mon.vfpga_exit()
    return ({rid: list(c.tokens) for rid, c in eng.completed.items()},
            eng.prefix_stats(), params)


def test_prefix_engine_equals_the_jax_engine():
    """Cold, partial-hit and full-hit admissions, a tight pool (tree
    eviction, OOM preemption) and retire donation: the same tokens and the
    same prefix stats as the JAX engine on its weights."""
    p = _prompts(3, seed=21)
    q = [p[0].copy(), p[0].copy()]
    q[1][PAGE:] = p[2][PAGE:]                   # shares page 0 only
    prompts = [p[0], p[0], p[1], q[1], p[0], p[1]]
    tokens = [4, 6, 5, 3, 6, 4]
    want, want_stats, params = _jax_prefix_run(prompts, tokens,
                                                pool_pages=10)

    def make():
        mon, eng = _factory(pool_pages=10)()
        eng.cl.write_buffer("params", params).wait()
        return mon, eng

    got, eng = run_transcript(make, _requests(prompts, tokens))
    assert_transcripts_equal(got, want, context="port vs JAX prefix engine")
    assert eng.prefix_stats() == want_stats
    assert want_stats["hits"] >= 1 and want_stats["partial_hits"] >= 1


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
def test_chunk_prefill_paged_kernel_matches_plain_on_card(cuda, dtype):
    """K1's paged entry at one lane, as ``prefill_chunk`` calls it: the
    positions of one page of 16 inside a partly filled page, the lane's
    row one row of the engine's table (shared prefix pages mapped first,
    fresh pages after it unwritten)."""
    from repro_torch.kernels.decode_attention.ops import \
        decode_attention_paged
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_paged_ref

    rng = np.random.default_rng(2)
    dt = getattr(torch, dtype)
    ps, mb, NP, Hq, Hkv, hd = 16, 11, 64, 32, 4, 128
    k, v = (torch.from_numpy(rng.standard_normal(
        (NP + 1, ps, Hkv, hd), dtype=np.float32)).to(dt).to(cuda)
        for _ in range(2))
    kvp = torch.full((NP + 1, ps), 2 ** 30, dtype=torch.int32, device=cuda)
    row = torch.from_numpy(rng.permutation(NP)[:mb].astype(
        np.int32)).to(cuda)
    lp = 3                                       # pages 0-2 are the prefix
    for page in range(lp):
        kvp[int(row[page])] = torch.arange(page * ps, (page + 1) * ps,
                                           dtype=torch.int32)
    bt = row[None].clone()
    bt[0, lp + 1:] = -1
    for i in range(ps):
        p = lp * ps + i
        kvp[int(row[lp]), i] = p
        q = torch.from_numpy(rng.standard_normal(
            (1, 1, Hq, hd), dtype=np.float32)).to(dt).to(cuda)
        pos = torch.tensor([p], dtype=torch.int32, device=cuda)
        before = decode_attention_paged.launches
        b1 = decode_attention_paged.launches_b1
        out = decode_attention_paged(q, k, v, kvp, bt, pos)
        assert decode_attention_paged.launches == before + 1
        assert decode_attention_paged.launches_b1 == b1 + 1
        ref = decode_attention_paged_ref(q, k, v, kvp, bt, pos)
        torch.testing.assert_close(
            out.float(), ref.float(), rtol=2e-2,
            atol=1e-4 if dtype == "float32" else 2e-2)
        assert torch.equal(out, decode_attention_paged(q, k, v, kvp, bt,
                                                       pos))


@pytest.mark.gpu
def test_prefix_engine_on_card_gives_the_cpu_tokens(cuda, warm_run):
    """A smoke prefix engine in f32 on the card (cold, partial and full
    hits): the CPU engine's tokens, with the weights drawn on the CPU."""
    transcript, _, prompts, tokens = warm_run
    mon, eng = _factory()()
    params = eng.cl.read_buffer("params")
    mon.vfpga_exit()

    def make():
        reg = MetricsRegistry()
        mon = Monitor("pfx-card", SliceAllocator("n0", 1, device="cuda"),
                      telemetry=reg)
        eng = ContinuousBatchingEngine(
            ARCH, FunkyCL(mon), slots=2, prompt_len=PROMPT_LEN,
            max_new_tokens=6, registry=reg, page_size=PAGE,
            prefix_cache=True)
        eng.setup()
        eng.cl.write_buffer("params", params).wait()
        return mon, eng

    got, eng = run_transcript(make, _requests(prompts, tokens))
    assert_transcripts_equal(got, transcript, context="prefix on the card")
    assert eng.prefix_stats()["hits"] >= 1
