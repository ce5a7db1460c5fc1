"""MLA (multi-head latent attention) of the PyTorch port against the
reference, and deepseek-v3-671b (3 dense MLA blocks, then MLA + MoE).

* the config equals the reference's (its smoke's MLA ranks too); at full
  width the parameter tree has the reference's keys, shapes and dtypes
  and the same count, 671,026,404,352, and its first 4 of 61 layers (the
  cut the card serves) 15,111,101,440; the plan and the latent cache
  specs equal the reference's;
* ``sdpa`` with ``hd_v != hd``: the ports of
  ``tests/test_attention.py::test_mla_head_dim_mismatch_supported`` and
  ``::test_mla_absorb_equals_decompressed``, and K2's route refusing the
  shape;
* ``mla_prefill`` (output and ring cache) and ``mla_decode``, absorbed and
  decompressed, on the reference's ``init_mla`` weights: within 1e-5 of
  max|ref| in f32, 3e-2 in bf16 (tolerance only); per-lane rings (the
  engine's reserved and draft lanes) against the reference's decode of
  each lane alone;
* ``mla_decode_paged`` against the reference's ``mla_decode`` of each lane
  alone on its own dense cache (what the JAX engine's per-lane gather +
  decode computes), lanes at distinct positions over scattered pages of
  4; an inactive lane and a lane with ``write_ok`` False write to the
  sink page and nowhere else;
* deepseek-v3-671b-smoke in f32 on the reference's own ``init``: prefill
  logits and caches within 1e-4, then 8 greedy tokens equal, absorbed and
  decompressed; ``lm_loss`` and every gradient leaf against ``jax.grad``
  (the decode against the full-sequence forward is in
  ``tests/test_torch_models_smoke.py``);
* on the card (``gpu``): the paged MLA decode in f32 against the CPU.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.model_zoo import analytic_param_count  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import plan_segments  # noqa: E402
from repro_torch.testing import params_from_jax, to_numpy  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_moe import _paths  # noqa: E402
from test_torch_train import _shared, grads_against_reference  # noqa: E402

NAME = "deepseek-v3-671b"
SMOKE = NAME + "-smoke"
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FN_TOL = {"float32": 1e-5, "bfloat16": 3e-2}     # of max|ref|
F32_TOL = 1e-4
PROMPT = 24


def _f(x):
    return np.asarray(x, np.float32)


def _cfgs(dtype):
    return tuple(dataclasses.replace(c, dtype=dtype)
                 for c in (jget_arch(SMOKE), get_arch(SMOKE)))


def _jit(fn, jc, **kw):
    """The reference's ``fn(jc, ...)``, jitted (eager JAX dispatches each op
    on its own, several times slower here)."""
    return jax.jit(partial(fn, jc, **kw))


def _mla_inputs(jc, B, S, seed=0):
    """The reference's ``init_mla`` weights (numpy) and x (B, S, D)."""
    p = jax.tree.map(np.asarray, _jit(jattn.init_mla, jc)(
        jax.random.PRNGKey(seed)))
    x = np.random.default_rng(seed).standard_normal(
        (B, S, jc.d_model)).astype(np.float32)
    return p, x


def _close(ref, got, tol):
    ref = _f(ref)
    return np.abs(ref - _f(to_numpy(got))).max() <= tol * np.abs(ref).max()


# ---------------------------------------------------------------------------
# Config, parameter tree, plan
# ---------------------------------------------------------------------------

def test_configs_equal_reference():
    for n in (NAME, SMOKE):
        assert dataclasses.asdict(get_arch(n)) == \
            dataclasses.asdict(jget_arch(n))
        assert get_arch(n).source == jget_arch(n).source
    m = get_arch(SMOKE).mla
    assert (m.q_lora_rank, m.kv_lora_rank, m.qk_nope_head_dim,
            m.qk_rope_head_dim, m.v_head_dim) == (32, 32, 16, 8, 16)


def test_param_tree_and_counts_equal_reference():
    cfg = get_arch(NAME)
    tparams = build_model(cfg).init(0, device="meta")
    jparams = jax.eval_shape(jbuild(jget_arch(NAME)).init,
                             jax.random.PRNGKey(0))
    assert _paths(tparams) == _paths(jparams)
    mla = tparams["segments"][1]["blocks"][0]["attn"]
    assert tuple(mla["wq_b"].shape) == (58, 1536, 128, 192)
    assert tuple(mla["wkv_a"].shape) == (58, 7168, 576)
    assert tuple(mla["wo"].shape) == (58, 128, 128, 7168)
    assert cfg.param_count() == analytic_param_count(jget_arch(NAME)) == \
        671_026_404_352
    cut = dataclasses.replace(cfg, num_layers=4)
    assert cut.param_count() == analytic_param_count(dataclasses.replace(
        jget_arch(NAME), num_layers=4)) == 15_111_101_440


@pytest.mark.parametrize("name", (NAME, SMOKE))
def test_plan_and_cache_specs_equal_reference(name):
    from repro.models.transformer import plan_segments as jplan

    plan = plan_segments(get_arch(name))
    assert [b.mixer for s in plan for b in s.blocks] == ["mla", "mla"]
    assert [(s.count, [dataclasses.asdict(b) for b in s.blocks])
            for s in plan] == \
        [(s.count, [dataclasses.asdict(b) for b in s.blocks])
         for s in jplan(jget_arch(name))]
    ts = build_model(get_arch(name)).cache_specs(8, 512 + 128)
    js = jbuild(jget_arch(name)).cache_specs(8, 512 + 128)
    assert [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for t in tree_leaves(ts)] == \
        [(tuple(s.shape), str(s.dtype)) for s in jax.tree.leaves(js)]


# ---------------------------------------------------------------------------
# sdpa at hd_v != hd (ports of tests/test_attention.py's MLA cases)
# ---------------------------------------------------------------------------

def test_mla_head_dim_mismatch_supported():
    """v head dim 16 against q/k 24: the naive and blockwise paths agree
    with each other and with the reference's; K2's route refuses it."""
    rng = np.random.default_rng(0)
    q, k = (rng.standard_normal((2, 32, 4, 24)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ref = tattn.sdpa_naive(tq, tk, tv, causal=True)
    out = tattn.sdpa_blockwise(tq, tk, tv, causal=True, chunk=8)
    assert tuple(ref.shape) == (2, 32, 4, 16)
    assert float((out - ref).abs().max()) < 2e-5
    jref = jattn.sdpa_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True)
    assert np.abs(_f(jref) - to_numpy(ref)).max() < 2e-5
    with pytest.raises(ValueError, match="hd_v"):
        tattn.sdpa(tq, tk, tv, impl="kernel", causal=True, q_pos=None,
                   kv_pos=None)


def test_mla_absorb_equals_decompressed():
    cfg = get_arch(SMOKE)
    p = params_from_jax(_mla_inputs(jget_arch(SMOKE), 1, 1, seed=2)[0])
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    _, cache = tattn.mla_prefill(cfg, p, x)
    xt = x[:, -1:, :]
    pos = torch.tensor(15, dtype=torch.int32)
    out_a, _ = tattn.mla_decode(cfg, p, xt, pos,
                                {k: v.clone() for k, v in cache.items()},
                                absorb=True)
    out_n, _ = tattn.mla_decode(cfg, p, xt, pos, cache, absorb=False)
    d = float((out_a.float() - out_n.float()).abs().max())
    assert d < 0.05, d


# ---------------------------------------------------------------------------
# The MLA functions against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_and_decode_match_reference(dtype):
    """Prefill of 16 tokens into a ring of 20, then two decode steps in
    each form, both sides on their own caches."""
    jc, tc = _cfgs(dtype)
    p, x = _mla_inputs(jc, 2, 18, seed=4)
    tp = params_from_jax(p)
    assert tp["wq_b"].dtype == TDT[dtype]
    jx, tx = jnp.asarray(x, jc.dtype), torch.from_numpy(x).to(TDT[dtype])
    tol = FN_TOL[dtype]
    jo, jcache = _jit(jattn.mla_prefill, jc, margin=4)(p, jx[:, :16])
    to, tcache = tattn.mla_prefill(tc, tp, tx[:, :16], margin=4)
    assert _close(jo, to, tol)
    assert set(tcache) == {"ckv", "k_pe", "kv_pos"}
    for name in ("ckv", "k_pe"):
        assert tuple(tcache[name].shape) == tuple(jcache[name].shape)
        assert _close(jcache[name], tcache[name], tol)
    np.testing.assert_array_equal(np.asarray(jcache["kv_pos"]),
                                  tcache["kv_pos"].numpy())
    for absorb in (True, False):
        jc_, tc_ = jcache, {k: v.clone() for k, v in tcache.items()}
        jdec = _jit(jattn.mla_decode, jc, absorb=absorb)
        for i in (16, 17):
            jd, jc_ = jdec(p, jx[:, i:i + 1], jnp.int32(i), jc_)
            td, tc_ = tattn.mla_decode(tc, tp, tx[:, i:i + 1],
                                       torch.tensor(i, dtype=torch.int32),
                                       tc_, absorb=absorb)
            assert td.dtype == TDT[dtype]
            assert _close(jd, td, tol), (absorb, i)
            for name in ("ckv", "k_pe"):
                assert _close(jc_[name], tc_[name], tol)
            np.testing.assert_array_equal(np.asarray(jc_["kv_pos"]),
                                          tc_["kv_pos"].numpy())


def _paged_setup(tc, rng, B, ps, mb, NP, pos):
    """A pool of ``NP`` pages of ``ps`` (plus the sink) holding B lanes'
    latent caches over scattered pages: lane b's first ``pos[b] // ps +
    1`` logical pages mapped (slots past pos[b] on its last page INVALID),
    each lane's dense view (cap = mb * ps) beside it."""
    r, rope = tc.mla.kv_lora_rank, tc.mla.qk_rope_head_dim
    cap = mb * ps
    dense = {"ckv": rng.standard_normal((B, cap, r)).astype(np.float32),
             "k_pe": rng.standard_normal((B, cap, rope)).astype(np.float32),
             "kv_pos": np.full((B, cap), 2 ** 30, np.int32)}
    pool = {"ckv": np.zeros((NP + 1, ps, r), np.float32),
            "k_pe": np.zeros((NP + 1, ps, rope), np.float32),
            "kv_pos": np.full((NP + 1, ps), 2 ** 30, np.int32)}
    bt = np.full((B, mb), -1, np.int32)
    free = list(rng.permutation(NP))
    for b in range(B):
        if pos[b] < 0:
            continue
        dense["kv_pos"][b, :pos[b]] = np.arange(pos[b])
        for lp in range(pos[b] // ps + 1):
            pg = free.pop()
            bt[b, lp] = pg
            sl = slice(lp * ps, (lp + 1) * ps)
            for name in pool:
                pool[name][pg] = dense[name][b, sl]
    return dense, pool, bt


def test_mla_decode_paged_matches_per_lane_decode():
    """Four lanes at positions 9, 22, 5 and 14 over pages of 4 (lane 2
    inactive, lane 3 with ``write_ok`` False), absorbed and decompressed:
    each active lane's output and its new page slot against the
    reference's ``mla_decode`` of that lane alone on its dense cache, f32
    within 1e-5; the inactive and the refused lanes write only the sink."""
    jc, tc = _cfgs("float32")
    rng = np.random.default_rng(7)
    p, _ = _mla_inputs(jc, 1, 1, seed=5)
    tp = params_from_jax(p)
    B, ps, mb, NP = 4, 4, 8, 40
    pos = np.array([9, 22, 5, 14], np.int32)
    x = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
    dense, pool_np, bt = _paged_setup(tc, rng, B, ps, mb, NP,
                                      [9, 22, -1, 14])
    write_ok = torch.tensor([True, True, True, False])
    for absorb in (True, False):
        jdec = _jit(jattn.mla_decode, jc, absorb=absorb)
        pool = {k: torch.from_numpy(v.copy()) for k, v in pool_np.items()}
        out = tattn.mla_decode_paged(
            tc, tp, torch.from_numpy(x), torch.from_numpy(pos), pool,
            torch.from_numpy(bt), write_ok=write_ok, absorb=absorb)
        assert tuple(out.shape) == (B, 1, tc.d_model)
        assert torch.isfinite(out).all()
        for b in (0, 1):
            cache = {"ckv": jnp.asarray(dense["ckv"][b:b + 1]),
                     "k_pe": jnp.asarray(dense["k_pe"][b:b + 1]),
                     "kv_pos": jnp.asarray(dense["kv_pos"][b])}
            jo, jn = jdec(p, jnp.asarray(x[b:b + 1]), jnp.int32(pos[b]),
                          cache)
            assert _close(jo, out[b:b + 1], 1e-5), (absorb, b)
            pg, off = bt[b, pos[b] // ps], pos[b] % ps
            for name in ("ckv", "k_pe"):
                assert _close(np.asarray(jn[name])[0, pos[b]],
                              pool[name][pg, off], 1e-5)
            assert int(pool["kv_pos"][pg, off]) == pos[b]
        # lanes 2 and 3 wrote the sink only: every real page is unchanged
        # but the two active lanes' written slots
        for name in pool:
            got = pool[name][:NP].numpy().copy()
            want = pool_np[name][:NP].copy()
            for b in (0, 1):
                pg, off = bt[b, pos[b] // ps], pos[b] % ps
                got[pg, off] = want[pg, off] = 0
            np.testing.assert_array_equal(got, want)
        assert set(pool["kv_pos"][NP].tolist()) <= {5, 14, 2 ** 30}
        assert 14 in pool["kv_pos"][NP].tolist()


def test_mla_decode_per_lane_rings_match_reference():
    """Per-lane rings (the engine's reserved and draft lanes: ``kv_pos``
    (B, cap), pos (B,)): each lane writes its own slot and attends over its
    own positions, as the reference's ``mla_decode`` of that lane alone,
    f32 within 1e-5, absorbed and decompressed."""
    jc, tc = _cfgs("float32")
    rng = np.random.default_rng(9)
    p, _ = _mla_inputs(jc, 1, 1, seed=8)
    tp = params_from_jax(p)
    B, cap = 3, 12
    pos = np.array([4, 11, 15], np.int32)       # lane 2 wraps its ring
    x = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
    dense, _, _ = _paged_setup(tc, rng, B, 4, 3, 12, [4, 11, 11])
    dense["kv_pos"][2] = np.arange(cap)
    for absorb in (True, False):
        jdec = _jit(jattn.mla_decode, jc, absorb=absorb)
        cache = {k: torch.from_numpy(v.copy()) for k, v in dense.items()}
        out, cache = tattn.mla_decode(tc, tp, torch.from_numpy(x),
                                      torch.from_numpy(pos), cache,
                                      absorb=absorb)
        for b in range(B):
            jo, jn = jdec(p, jnp.asarray(x[b:b + 1]), jnp.int32(pos[b]),
                          {"ckv": jnp.asarray(dense["ckv"][b:b + 1]),
                           "k_pe": jnp.asarray(dense["k_pe"][b:b + 1]),
                           "kv_pos": jnp.asarray(dense["kv_pos"][b])})
            assert _close(jo, out[b:b + 1], 1e-5), (absorb, b)
            for name in ("ckv", "k_pe"):
                assert _close(jn[name][0], cache[name][b], 1e-5)
            np.testing.assert_array_equal(np.asarray(jn["kv_pos"]),
                                          cache["kv_pos"][b].numpy())


# ---------------------------------------------------------------------------
# Whole-model parity on shared weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("absorb", [True, False])
def test_f32_prefill_and_greedy_decode_match_reference(absorb):
    jb, jp, tb, tp = _shared(SMOKE)
    if not absorb:
        jb = jbuild(jb.cfg, mla_absorb=False)
        tb = build_model(tb.cfg, mla_absorb=False)
    toks = np.random.default_rng(1).integers(0, 512, (2, PROMPT)).astype(
        np.int32)
    jl, jc = jb.prefill_fn(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tb.prefill_fn(tp, {"tokens": torch.from_numpy(toks)})
    assert np.max(np.abs(_f(jl) - to_numpy(tl))) < F32_TOL
    for a, b in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        assert tuple(a.shape) == tuple(b.shape)
        assert np.max(np.abs(_f(a) - to_numpy(b).astype(np.float32))) \
            < F32_TOL
    jdec = jax.jit(jb.decode_fn)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = tl.argmax(-1).to(torch.int32)
    for i in range(8):
        np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
        jl, jc = jdec(jp, jtok, jnp.int32(PROMPT + i), jc)
        tl, tc = tb.decode_fn(tp, ttok, PROMPT + i, tc, inplace=True)
        assert np.max(np.abs(_f(jl) - to_numpy(tl))) < F32_TOL
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = tl.argmax(-1).to(torch.int32)
    np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())


def test_lm_loss_and_grads_match_reference():
    """Training runs ``mla_fwd`` with the naive ``sdpa``, as the
    reference's: loss within 1e-5 relative and every gradient leaf (the
    eight MLA leaves of each block among them) within 1e-4 of max|g|."""
    grads_against_reference(SMOKE, "cpu")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("absorb", [True, False])
def test_mla_decode_paged_on_card_matches_cpu(cuda, absorb):
    """f32 on the card within 1e-5 of max|out| on the CPU, the pool's
    writes equal."""
    _, tc = _cfgs("float32")
    rng = np.random.default_rng(11)
    p = params_from_jax(_mla_inputs(jget_arch(SMOKE), 1, 1, seed=6)[0])
    p = {k: v.float() for k, v in p.items()}
    B, ps, mb, NP = 4, 4, 8, 40
    pos = torch.tensor([9, 22, 5, 14], dtype=torch.int32)
    x = torch.from_numpy(rng.standard_normal(
        (B, 1, tc.d_model)).astype(np.float32))
    _, pool_np, bt = _paged_setup(tc, rng, B, ps, mb, NP, [9, 22, 5, 14])
    pool = {k: torch.from_numpy(v) for k, v in pool_np.items()}
    gpool = {k: v.to(cuda) for k, v in pool.items()}
    out = tattn.mla_decode_paged(tc, p, x, pos, pool, torch.from_numpy(bt),
                                 absorb=absorb)
    gout = tattn.mla_decode_paged(
        tc, {k: v.to(cuda) for k, v in p.items()}, x.to(cuda),
        pos.to(cuda), gpool, torch.from_numpy(bt).to(cuda), absorb=absorb)
    assert float((gout.cpu() - out).abs().max()) <= \
        1e-5 * float(out.abs().max())
    for k in pool:
        torch.testing.assert_close(gpool[k].cpu(), pool[k], rtol=1e-5,
                                   atol=1e-5)
