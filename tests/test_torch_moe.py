"""The MoE family of the PyTorch port against the reference: ``moe_fwd``
with local capacity dispatch, shared experts and the aux loss, and
deepseek-moe-16b (1 dense block, then attention + MoE blocks).

* the config equals the reference's; at full width the parameter tree has
  the reference's keys, shapes and dtypes (the f32 ``router``) and the
  same count, 16,375,728,128;
* ``moe_fwd`` on shared weights against the reference's (trivial mesh, as
  its ``build_model`` makes it): out within 1e-5 (f32) and 2e-2 (bf16) of
  max|out| (a few bf16 ulps: the reference adds a token's k gated rows
  into a bf16 sum one by one, the port sums them in f32 and rounds once),
  aux within 1e-5 absolute; with every pair kept and with a router column
  scaled so that most tokens pick one expert and pairs drop;
* the paged decode's routing (``live``): the lanes' bits at 16 and 32
  padded rows equal the unpadded call's, at a smoke variant where a
  capacity computed from 32 padded rows exceeds 8, and every lane's output
  equals the reference's ``moe_fwd`` of that lane alone (the reference
  engine's vmap) within 1e-5, where routing the rows together at the
  reference's capacity drops pairs;
* whole-model f32 parity on the reference's own ``init``: prefill logits
  and caches within 1e-4, then 8 greedy tokens equal (decode against the
  full-sequence forward at ``capacity_factor=8.0``, the reference's own
  check, is in ``tests/test_torch_models_smoke.py``);
* ``lm_loss`` within 1e-5 relative and every gradient leaf within 1e-4 of
  max|g| against ``jax.grad``, with a nonzero aux loss equal to the
  reference's within 1e-5 relative;
* on the card (``gpu``): K2, K1's dense and K1's paged entry at
  deepseek-moe-16b's attention shape (16 of 16 heads, hd 128), and
  ``moe_fwd`` on the card against the CPU.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model_zoo import _trivial_mesh  # noqa: E402
from repro.models.model_zoo import analytic_param_count  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.layers import mlp_fwd  # noqa: E402
from repro_torch.models.transformer import plan_segments  # noqa: E402
from repro_torch.testing import params_from_jax, to_numpy  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_train import (_batch, _shared,  # noqa: E402
                              grads_against_reference, value_and_grad)

NAME = "deepseek-moe-16b"
SMOKE = NAME + "-smoke"
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
OUT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}    # of max|out|
AUX_TOL = 1e-5
F32_TOL = 1e-4
PROMPT = 24


def _f(x):
    return np.asarray(x, np.float32)


def _paths(tree, prefix=()):
    """(key path, shape, dtype) of every leaf, dict keys sorted."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        return [p for i, t in enumerate(tree) for p in _paths(t,
                                                              prefix + (i,))]
    return [(prefix, tuple(tree.shape),
             str(tree.dtype).removeprefix("torch."))]


def _cfgs(dtype, **moe):
    """(reference, port) smoke configs in ``dtype``, MoE fields ``moe``."""
    return tuple(dataclasses.replace(
        c, dtype=dtype, moe=dataclasses.replace(c.moe, **moe))
        for c in (jget_arch(SMOKE), get_arch(SMOKE)))


# ---------------------------------------------------------------------------
# Config, parameter tree, plan
# ---------------------------------------------------------------------------

def test_configs_equal_reference():
    for n in (NAME, SMOKE):
        assert dataclasses.asdict(get_arch(n)) == \
            dataclasses.asdict(jget_arch(n))
        assert get_arch(n).source == jget_arch(n).source


def test_param_tree_and_counts_equal_reference():
    cfg = get_arch(NAME)
    tparams = build_model(cfg).init(0, device="meta")
    jparams = jax.eval_shape(jbuild(jget_arch(NAME)).init,
                             jax.random.PRNGKey(0))
    assert _paths(tparams) == _paths(jparams)
    moe = tparams["segments"][1]["blocks"][0]["moe"]
    assert tuple(moe["router"].shape) == (27, 2048, 64)
    assert moe["router"].dtype == torch.float32
    assert tuple(moe["w_down"].shape) == (27, 64, 1408, 2048)
    assert tuple(moe["shared"]["w_gate"].shape) == (27, 2048, 2816)
    assert cfg.param_count() == analytic_param_count(jget_arch(NAME)) == \
        16_375_728_128


@pytest.mark.parametrize("name", (NAME, SMOKE))
def test_plan_and_cache_specs_equal_reference(name):
    from repro.models.transformer import plan_segments as jplan

    assert [(s.count, [dataclasses.asdict(b) for b in s.blocks])
            for s in plan_segments(get_arch(name))] == \
        [(s.count, [dataclasses.asdict(b) for b in s.blocks])
         for s in jplan(jget_arch(name))]
    ts = build_model(get_arch(name)).cache_specs(8, 512 + 128)
    js = jbuild(jget_arch(name)).cache_specs(8, 512 + 128)
    assert [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for t in tree_leaves(ts)] == \
        [(tuple(s.shape), str(s.dtype)) for s in jax.tree.leaves(js)]


# ---------------------------------------------------------------------------
# moe_fwd against the reference
# ---------------------------------------------------------------------------

def _moe_inputs(jc, B, S, seed=0, skew=None):
    """The reference's ``init_moe`` weights (numpy) and an input (B, S, D);
    ``skew`` scales router column 0 so most tokens pick expert 0."""
    p = jax.tree.map(np.asarray, jmoe.init_moe(jc, jax.random.PRNGKey(seed)))
    x = np.random.default_rng(seed).standard_normal(
        (B, S, jc.d_model)).astype(np.float32)
    if skew is not None:
        p["router"] = p["router"].copy()
        p["router"][:, 0] = np.abs(p["router"][:, 0]) * skew
        x = np.abs(x)
    return p, x


def _dropped(cfg, p, x2d, capacity):
    """Pairs past their expert's capacity when ``x2d``'s rows route
    together."""
    probs = torch.softmax(x2d.float() @ p["router"], -1)
    counts = torch.bincount(torch.topk(probs, cfg.moe.top_k, -1)[1].reshape(
        -1), minlength=cfg.moe.num_experts)
    return int(torch.clamp(counts - capacity, min=0).sum())


def _jmoe(jc, p, x, per_lane=False):
    """The reference's ``moe_fwd`` on numpy weights, x cast to jc's dtype;
    ``per_lane`` vmaps it over the rows of x (B, 1, D), each row a call of
    its own, as the reference engine decodes its lanes."""
    fn = partial(jmoe.moe_fwd, jc, mesh=_trivial_mesh(), dp_axes=("data",))
    if per_lane:
        fn = jax.vmap(lambda p, xi: jmoe.moe_fwd(
            jc, p, xi[None], mesh=_trivial_mesh(), dp_axes=("data",))[0][0],
            in_axes=(None, 0))
    return jax.jit(fn)(jax.tree.map(jnp.asarray, p),
                       jnp.asarray(x, jc.dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["kept", "dropped"])
def test_moe_fwd_matches_reference(dtype, case):
    """"kept" at capacity factor 4 (48 slots an expert for 96 pairs),
    "dropped" at the config's 1.25 with most tokens on expert 0."""
    jc, tc = _cfgs(dtype, capacity_factor=4.0 if case == "kept" else 1.25)
    B, S = 2, 24
    p, x = _moe_inputs(jc, B, S, skew=None if case == "kept" else 30.0)
    tp = params_from_jax(p)
    assert tp["router"].dtype == torch.float32
    assert tp["w_up"].dtype == tp["shared"]["w_up"].dtype == TDT[dtype]
    cap = tmoe._capacity(B * S, tc.moe.top_k, tc.moe.num_experts,
                         tc.moe.capacity_factor)
    xt = torch.from_numpy(x).to(TDT[dtype])
    n_drop = _dropped(tc, tp, xt.reshape(B * S, -1), cap)
    assert (n_drop > 0) == (case == "dropped"), n_drop
    jout, jaux = _jmoe(jc, p, x)
    tout, taux = tmoe.moe_fwd(tc, tp, xt)
    assert tout.dtype == TDT[dtype] and taux.dtype == torch.float32
    assert np.abs(_f(jout) - to_numpy(tout)).max() \
        < OUT_TOL[dtype] * np.abs(_f(jout)).max()
    assert abs(float(jaux) - float(taux)) < AUX_TOL
    assert tmoe.moe_fwd(tc, tp, xt, aux=False)[1] is None


def test_substituted_top_k_is_followed(monkeypatch):
    """``_top_k`` is the router's only choice: a substitute that returns
    the router's own top-k gives the same bits, and any other choice is
    followed, with the router's probabilities of those experts as gates
    (how a comparison of two paths on the card holds their routing
    equal).  Capacity factor 4: no pair drops."""
    jc, tc = _cfgs("float32", capacity_factor=4.0)
    p, x = _moe_inputs(jc, 2, 12, seed=5)
    tp, xt = params_from_jax(p), torch.from_numpy(x)
    x2d = xt.reshape(24, -1)
    out, aux = tmoe.moe_fwd(tc, tp, xt)
    own = tmoe._top_k
    monkeypatch.setattr(tmoe, "_top_k", lambda probs, k: own(probs, k))
    got, got_aux = tmoe.moe_fwd(tc, tp, xt)
    assert torch.equal(got, out) and torch.equal(got_aux, aux)

    def shifted(probs, k):
        e = (own(probs, k)[1] + 1) % tc.moe.num_experts
        return probs.gather(-1, e), e

    monkeypatch.setattr(tmoe, "_top_k", shifted)
    moved = tmoe.moe_fwd(tc, tp, xt, aux=False)[0]
    probs = torch.softmax(x2d @ tp["router"], -1)
    other = shifted(probs, tc.moe.top_k)[1]
    g = probs.gather(-1, other)
    g = g / g.sum(-1, keepdim=True)
    want = mlp_fwd(tc, tp["shared"], x2d)
    for j in range(tc.moe.top_k):
        e = other[:, j]
        h = torch.einsum("td,tdf->tf", x2d, tp["w_gate"][e])
        u = torch.einsum("td,tdf->tf", x2d, tp["w_up"][e])
        want = want + g[:, j:j + 1] * torch.einsum(
            "tf,tfd->td", torch.nn.functional.silu(h) * u, tp["w_down"][e])
    assert (moved.reshape(24, -1) - want).abs().max() < 1e-5


def test_paged_routing_ignores_padding_and_keeps_every_lane():
    """12 lanes, most picking expert 0: the reference engine decodes each
    lane alone (capacity 8, never binding); ``live=12`` keeps every pair at
    any padding, while the rows routed together at the reference's
    capacity (8 of 12 rows, 10 of 32 padded rows) drop pairs."""
    jc, tc = _cfgs("float32")
    k, E, cf = tc.moe.top_k, tc.moe.num_experts, tc.moe.capacity_factor
    assert tmoe._capacity(32, k, E, cf) > 8
    n = 12
    p, x = _moe_inputs(jc, 32, 1, seed=3, skew=30.0)
    tp = params_from_jax(p)
    xt = torch.from_numpy(x)
    want = tmoe.moe_fwd(tc, tp, xt[:n], live=n)[0]
    for rows in (16, 32):
        got = tmoe.moe_fwd(tc, tp, xt[:rows], live=n)[0][:n]
        assert torch.equal(got, want), rows
    lanes = np.asarray(_jmoe(jc, p, x[:n], per_lane=True))
    assert np.abs(lanes - to_numpy(want)).max() < OUT_TOL["float32"]
    for rows in (n, 32):
        cap = tmoe._capacity(rows, k, E, cf)
        assert _dropped(tc, tp, xt[:rows, 0], cap) > 0
        together = tmoe.moe_fwd(tc, tp, xt[:rows])[0][:n]
        assert np.abs(lanes - to_numpy(together)).max() > 1e-3
    with pytest.raises(ValueError):
        tmoe.moe_fwd(tc, tp, xt[:4], live=5)


# ---------------------------------------------------------------------------
# Whole-model parity on shared weights
# ---------------------------------------------------------------------------

def test_f32_prefill_and_greedy_decode_match_reference():
    jb, jp, tb, tp = _shared(SMOKE)
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


def test_lm_loss_aux_and_grads_match_reference():
    grads_against_reference(SMOKE, "cpu")
    jb, jp, tb, tp = _shared(SMOKE)
    batch = _batch()
    with jax.default_matmul_precision("highest"):
        jtotal, jm = jb.loss_fn(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    total, m = tb.loss_fn(tp, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert float(m["aux_loss"]) > 0.1
    for a, b in ((jtotal, total), (jm["loss"], m["loss"]),
                 (jm["aux_loss"], m["aux_loss"])):
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(a))
    w = get_arch(SMOKE).moe.router_aux_weight
    assert float(total) == pytest.approx(float(m["loss"])
                                         + w * float(m["aux_loss"]))
    g, loss, _ = value_and_grad(tb)(tp, batch)
    router_g = g["segments"][1]["blocks"][0]["moe"]["router"]
    assert float(router_g.abs().max()) > 0


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
def test_attention_kernels_at_deepseek_shape_on_card(cuda, dtype):
    """K2, K1's dense and K1's paged entry at 16 of 16 heads, hd 128
    (group 1), narrowed to 200 positions: each count rises on a CUDA
    tensor, each matches its plain version, two calls give the same
    bits."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_paged)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_paged_ref, decode_attention_ref)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    B, S, H, hd = 2, 200, 16, 128
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, hd)).astype(
        np.float32)).to(TDT[dtype]).to(cuda) for _ in range(3))

    def check(wrapper, fn, ref, *args):
        before = wrapper.launches
        out = fn(*args)
        assert wrapper.launches == before + 1
        torch.testing.assert_close(out.float(), ref(*args).float(),
                                   rtol=2e-2, atol=tol)
        assert torch.equal(out, fn(*args))

    check(flash_attention, lambda *a: flash_attention(*a, causal=True),
          lambda *a: flash_attention_ref(*a, causal=True), q, k, v)
    pos = S - 1
    kv_pos = torch.arange(S, dtype=torch.int32, device=cuda)
    qd = q[:, :1].contiguous()
    check(decode_attention, decode_attention, decode_attention_ref,
          qd, k, v, pos, kv_pos)
    ps, mb = 16, -(-S // 16)
    NP = B * mb + 3
    perm = torch.from_numpy(rng.permutation(NP)[:B * mb].astype(
        np.int32)).view(B, mb)
    kp = torch.zeros((NP, ps, H, hd), dtype=k.dtype, device=cuda)
    vp = torch.zeros_like(kp)
    kvp = torch.zeros((NP, ps), dtype=torch.int32, device=cuda)
    pad = mb * ps - S
    for b in range(B):
        rows = perm[b].long().to(cuda)
        kp[rows] = torch.nn.functional.pad(k[b], (0, 0, 0, 0, 0, pad)).view(
            mb, ps, H, hd)
        vp[rows] = torch.nn.functional.pad(v[b], (0, 0, 0, 0, 0, pad)).view(
            mb, ps, H, hd)
        kvp[rows] = torch.arange(mb * ps, dtype=torch.int32,
                                 device=cuda).view(mb, ps)
    posv = torch.tensor([S - 1, S - 30], dtype=torch.int32, device=cuda)
    check(decode_attention_paged, decode_attention_paged,
          decode_attention_paged_ref, qd, kp, vp, kvp, perm.to(cuda), posv)


@pytest.mark.gpu
def test_moe_fwd_on_card_matches_cpu(cuda):
    """f32 on the card within 1e-5 of the CPU (no TF32 in the router);
    bf16 gives the same bits twice (no atomics in the combine); with TF32
    enabled the router refuses to run."""
    _, tc = _cfgs("float32")
    p = build_model(tc).init(0, device="cpu")["segments"][1]["blocks"][0][
        "moe"]
    p = {k: (v[0] if isinstance(v, torch.Tensor)
             else {n: t[0] for n, t in v.items()}) for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 32, tc.d_model)).astype(np.float32))
    out, aux = tmoe.moe_fwd(tc, p, x)
    pc = {k: (v.to(cuda) if isinstance(v, torch.Tensor)
              else {n: t.to(cuda) for n, t in v.items()})
          for k, v in p.items()}
    gout, gaux = tmoe.moe_fwd(tc, pc, x.to(cuda))
    assert (gout.cpu() - out).abs().max() < 1e-5
    assert abs(float(gaux) - float(aux)) < 1e-5
    tb = dataclasses.replace(tc, dtype="bfloat16")
    pb = {k: v if k == "router" else
          (v.bfloat16() if isinstance(v, torch.Tensor)
           else {n: t.bfloat16() for n, t in v.items()})
          for k, v in pc.items()}
    xb = x.to(cuda).bfloat16()
    assert torch.equal(tmoe.moe_fwd(tb, pb, xb)[0],
                       tmoe.moe_fwd(tb, pb, xb)[0])
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            tmoe.moe_fwd(tc, pc, x.to(cuda))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
