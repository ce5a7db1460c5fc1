"""Layers and GQA attention of the PyTorch port against the reference
(``repro.models.layers`` / ``repro.models.attention``) on the same numpy
inputs: norms, RoPE, the gated MLP, the sdpa cores, prefill's ring cache
and decode's ring writes, including a wrap past the cache capacity.

Tolerances: f32 2e-5 absolute (1e-5 relative for the projections), bf16
2e-2 absolute on O(1) values.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.testing import params_from_jax, to_numpy  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jget_arch("yi-9b-smoke"), dtype=dtype),
            dataclasses.replace(get_arch("yi-9b-smoke"), dtype=dtype))


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else to_numpy(x).astype(np.float32)


def _gqa_params(jcfg, tcfg, seed=0):
    jp = jattn.init_gqa(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_jax(tcfg, jax.tree.map(np.asarray, jp))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_matches_reference(dtype):
    jcfg, tcfg = _cfgs(dtype)
    (x, s) = _normal(1, (2, 5, 64), (64,))
    jout = jlayers.norm_fwd(jcfg, {"scale": jnp.asarray(s).astype(dtype)},
                            jnp.asarray(x).astype(dtype))
    tdt = tlayers.cdtype(tcfg)
    tout = tlayers.norm_fwd(tcfg, {"scale": torch.from_numpy(s).to(tdt)},
                            torch.from_numpy(x).to(tdt))
    assert tout.dtype == tdt
    assert np.max(np.abs(_np(jout) - _np(tout))) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta,pct", [(10_000.0, 1.0), (1_000_000.0, 0.25)])
def test_rope_matches_reference(dtype, theta, pct):
    (x,) = _normal(2, (2, 9, 4, 16))
    pos = np.arange(100, 109, dtype=np.int32)
    jout = jlayers.rope_fwd(jnp.asarray(x).astype(dtype), jnp.asarray(pos),
                            theta, pct)
    tout = tlayers.rope_fwd(torch.from_numpy(x).to(getattr(torch, dtype)),
                            torch.from_numpy(pos), theta, pct)
    assert np.max(np.abs(_np(jout) - _np(tout))) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_reference(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp = jlayers.init_mlp(jcfg, jax.random.PRNGKey(3), 64, 128)
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    (x,) = _normal(4, (2, 3, 64))
    jout = jlayers.mlp_fwd(jcfg, jp, jnp.asarray(x).astype(dtype))
    tout = tlayers.mlp_fwd(tcfg, tp,
                           torch.from_numpy(x).to(tlayers.cdtype(tcfg)))
    assert np.max(np.abs(_np(jout) - _np(tout))) < 5 * TOL[dtype]


def test_embed_and_head_match_reference():
    jcfg, tcfg = _cfgs()
    jp = jlayers.init_embed(jcfg, jax.random.PRNGKey(5))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    toks = np.array([[1, 7, 511], [0, 3, 3]], np.int32)
    jh = jlayers.embed_fwd(jcfg, jp, jnp.asarray(toks))
    th = tlayers.embed_fwd(tcfg, tp, torch.from_numpy(toks))
    np.testing.assert_array_equal(_np(jh), _np(th))
    jl = jlayers.lm_head_fwd(jcfg, jp, jh)
    tl = tlayers.lm_head_fwd(tcfg, tp, th)
    assert np.max(np.abs(_np(jl) - _np(tl))) < TOL["float32"]


def test_init_scales_follow_the_reference():
    """Same initialisers and scales (different random numbers): per-leaf
    standard deviations agree with the reference's to a few percent."""
    tcfg = get_arch("yi-9b-smoke")
    tp = tattn.init_gqa(tcfg, torch.device("cpu"),
                        torch.Generator().manual_seed(0))
    jp = jattn.init_gqa(jget_arch("yi-9b-smoke"), jax.random.PRNGKey(0))
    for name in ("wq", "wk", "wv", "wo"):
        js = float(np.std(np.asarray(jp[name], np.float32)))
        ts = float(tp[name].float().std())
        assert tp[name].shape == jp[name].shape
        assert abs(ts / js - 1) < 0.1, (name, ts, js)


# ---------------------------------------------------------------------------
# sdpa cores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["naive", "blockwise"])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 12, 0.0), (False, 0, 0.0), (True, 0, 3.0)])
def test_sdpa_matches_reference(impl, causal, window, softcap):
    q, k, v = _normal(7, (2, 32, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16))
    kw = dict(causal=causal, window=window, softcap=softcap)
    jfn = getattr(jattn, f"sdpa_{impl}")
    tfn = getattr(tattn, f"sdpa_{impl}")
    if impl == "blockwise":
        kw["chunk"] = 8
    jout = jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    tout = tfn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
               **kw)
    assert np.max(np.abs(_np(jout) - _np(tout))) < TOL["float32"]


def test_sdpa_dispatch_kernel_impl_on_cpu_equals_naive():
    q, k, v = (torch.from_numpy(x) for x in _normal(
        8, (1, 16, 4, 16), (1, 16, 2, 16), (1, 16, 2, 16)))
    pos = torch.arange(16)
    a = tattn.sdpa(q, k, v, impl="kernel", causal=True, window=0,
                   q_pos=pos, kv_pos=pos, chunk=8, softcap=0.0)
    b = tattn.sdpa(q, k, v, impl="naive", causal=True, window=0,
                   q_pos=pos, kv_pos=pos, chunk=8, softcap=0.0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tattn.sdpa(q, k, v, impl="pallas")


# ---------------------------------------------------------------------------
# prefill ring cache and decode ring writes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,margin", [(16, 8), (16, 0), (24, 128)])
def test_prefill_ring_cache_matches_reference(S, margin):
    jcfg, tcfg = _cfgs()
    jp, tp = _gqa_params(jcfg, tcfg)
    (x,) = _normal(9, (2, S, 64))
    jout, jc = jattn.gqa_prefill(jcfg, jp, jnp.asarray(x), margin=margin,
                                 impl="naive")
    tout, tc = tattn.gqa_prefill(tcfg, tp, torch.from_numpy(x),
                                 margin=margin, impl="kernel")
    assert np.max(np.abs(_np(jout) - _np(tout))) < TOL["float32"]
    np.testing.assert_array_equal(np.asarray(jc["kv_pos"]),
                                  tc["kv_pos"].numpy())
    assert tc["kv_pos"].dtype == torch.int32
    for name in ("k", "v"):
        assert np.max(np.abs(_np(jc[name]) - _np(tc[name]))) < TOL["float32"]


def test_decode_ring_writes_match_reference_past_a_wrap():
    """Prefill 12 tokens into a cap-16 ring, then decode 14 steps: the
    writes wrap past cap, evicting oldest-first, with kv_pos equal to the
    reference's at every step."""
    jcfg, tcfg = _cfgs()
    jp, tp = _gqa_params(jcfg, tcfg, seed=1)
    S, margin = 12, 4
    (x, xs) = _normal(10, (2, S, 64), (14, 2, 1, 64))
    _, jc = jattn.gqa_prefill(jcfg, jp, jnp.asarray(x), margin=margin,
                              impl="naive")
    _, tc = tattn.gqa_prefill(tcfg, tp, torch.from_numpy(x), margin=margin)
    for i in range(14):
        pos = S + i
        jout, jc = jattn.gqa_decode(jcfg, jp, jnp.asarray(xs[i]),
                                    jnp.int32(pos), jc)
        tout, tc = tattn.gqa_decode(tcfg, tp, torch.from_numpy(xs[i]),
                                    torch.tensor(pos, dtype=torch.int32), tc)
        np.testing.assert_array_equal(np.asarray(jc["kv_pos"]),
                                      tc["kv_pos"].numpy())
        assert np.max(np.abs(_np(jout) - _np(tout))) < TOL["float32"]
        assert np.max(np.abs(_np(jc["k"]) - _np(tc["k"]))) < TOL["float32"]
    # the ring wrapped: every slot is written, the oldest kept is pos 10
    assert int(tc["kv_pos"].min()) == S + 14 - 16


def test_decode_writes_the_cache_in_place():
    jcfg, tcfg = _cfgs()
    _, tp = _gqa_params(jcfg, tcfg)
    (x, xn) = _normal(11, (1, 8, 64), (1, 1, 64))
    _, cache = tattn.gqa_prefill(tcfg, tp, torch.from_numpy(x), margin=4)
    k_before = cache["k"].clone()
    _, out = tattn.gqa_decode(tcfg, tp, torch.from_numpy(xn),
                              torch.tensor(8, dtype=torch.int32), cache)
    assert out["k"] is cache["k"]
    assert int(cache["kv_pos"][8]) == 8
    assert not torch.equal(cache["k"][:, 8], k_before[:, 8])
    torch.testing.assert_close(cache["k"][:, :8], k_before[:, :8])


def test_cache_spec_matches_reference():
    jcfg, tcfg = _cfgs("bfloat16")
    js = jattn.gqa_cache_spec(jcfg, 3, 40)
    ts = tattn.gqa_cache_spec(tcfg, 3, 40)
    for name in ("k", "v", "kv_pos"):
        assert tuple(ts[name].shape) == tuple(js[name].shape)
        assert ts[name].device.type == "meta"
    init = tattn.gqa_cache_init(tcfg, 3, 40, torch.device("cpu"))
    assert (init["kv_pos"] == 2 ** 30).all()
