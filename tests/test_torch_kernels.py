"""K1/K2 in the PyTorch port: the plain versions against the reference's
Pallas kernels (interpret mode, as tests/test_kernels.py runs them) and
against the reference's sdpa cores; the wrappers' device rules.

The CUDA kernels themselves run only on a card: the ``gpu`` cases hold them
against the plain versions there and skip on a host without one.
Tolerances: f32 2e-5, bf16 2e-2 (max abs), as tests/test_kernels.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.kernel import decode_attention_fwd  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_fwd  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _j(x, dtype):
    return jnp.asarray(x).astype(JDT[dtype])


def _t(x, dtype):
    return torch.from_numpy(x).to(TDT[dtype])


def _diff(jout, tout) -> float:
    return float(np.max(np.abs(np.asarray(jout, np.float32)
                               - tout.float().numpy())))


def _ring_kv_pos(cap, pos, hole=None):
    kv = np.full((cap,), 2 ** 30, np.int32)
    for p in range(max(0, pos - cap + 1), pos + 1):
        kv[p % cap] = p
    if hole is not None:
        kv[hole] = 2 ** 30
    return kv


# ---------------------------------------------------------------------------
# K2: flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,window", [
    (2, 128, 4, 2, 64, True, 0),
    (1, 128, 8, 8, 128, True, 0),
    (2, 128, 4, 1, 64, True, 32),
    (1, 64, 4, 2, 32, False, 0),
    (1, 128, 4, 4, 80, True, 0),       # stablelm-3b: hd 80, MHA (G 1)
    (1, 128, 12, 1, 128, True, 0),     # starcoder2-15b: G 12
    # cross attention, S = (Sq, Skv): non-causal, Sq != Skv; at
    # seamless-m4t-large-v2's heads (16/16 of 64) too
    (2, (64, 128), 4, 2, 32, False, 0),
    (1, (64, 192), 16, 16, 64, False, 0),
])
def test_flash_plain_matches_pallas(B, S, Hq, Hkv, hd, causal, window, dtype):
    if isinstance(S, tuple):
        (Sq, Skv), seed = S, B * 7 + sum(S)
    else:
        Sq = Skv = S
        seed = B * 7 + S
    q, k, v = _normal(seed, (B, Sq, Hq, hd), (B, Skv, Hkv, hd),
                      (B, Skv, Hkv, hd))
    jout = flash_attention_fwd(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                               causal=causal, window=window, bq=64, bk=64,
                               interpret=True)
    tout = flash_attention_ref(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                               causal=causal, window=window)
    assert tout.dtype == TDT[dtype]
    assert _diff(jout, tout) < TOL[dtype]


@pytest.mark.parametrize("impl", ["naive", "blockwise"])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0), (0, 5.0)])
def test_flash_plain_matches_reference_sdpa(impl, window, softcap):
    q, k, v = _normal(3, (2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32))
    jfn = jattn.sdpa_naive if impl == "naive" else jattn.sdpa_blockwise
    kw = {"chunk": 16} if impl == "blockwise" else {}
    jout = jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
               window=window, softcap=softcap, **kw)
    tout = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True,
                               window=window, softcap=softcap)
    assert _diff(jout, tout) < TOL["float32"]


def test_flash_wrapper_on_cpu_runs_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _normal(
        5, (1, 40, 4, 16), (1, 40, 2, 16), (1, 40, 2, 16)))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, window=8)
    assert flash_attention.launches == before
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, window=8),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K1: decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,cap,Hq,Hkv,hd,pos,window", [
    (2, 256, 8, 2, 64, 200, 0),
    (1, 256, 4, 4, 128, 255, 0),
    (2, 512, 8, 1, 64, 400, 128),
    (2, 256, 4, 4, 80, 200, 0),        # stablelm-3b: hd 80, MHA (G 1)
    (1, 256, 12, 1, 128, 255, 0),      # starcoder2-15b: G 12
])
def test_decode_plain_matches_pallas(B, cap, Hq, Hkv, hd, pos, window,
                                     dtype):
    q, k, v = _normal(cap + pos, (B, 1, Hq, hd), (B, cap, Hkv, hd),
                      (B, cap, Hkv, hd))
    kv_pos = np.arange(cap, dtype=np.int32)
    kv_pos[cap // 3] = 2 ** 30
    jout = decode_attention_fwd(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                                pos, jnp.asarray(kv_pos), window=window,
                                bk=128, interpret=True)
    tout = decode_attention_ref(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                pos, torch.from_numpy(kv_pos), window=window)
    assert tout.dtype == TDT[dtype]
    assert _diff(jout, tout) < TOL[dtype]


@pytest.mark.parametrize("pos,window,softcap", [
    (40, 0, 0.0),        # unwritten slots (sentinel 2**30) after pos
    (150, 0, 0.0),       # ring wrapped past cap
    (150, 50, 0.0),      # wrapped + sliding window
    (90, 0, 7.5),        # softcap
])
def test_decode_plain_matches_reference_ring(pos, window, softcap):
    cap = 72
    q, k, v = _normal(pos, (2, 1, 8, 16), (2, cap, 2, 16), (2, cap, 2, 16))
    kv_pos = _ring_kv_pos(cap, pos)
    jout = jattn.sdpa_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, window=window,
                            q_pos=jnp.asarray([pos], jnp.int32),
                            kv_pos=jnp.asarray(kv_pos), softcap=softcap)
    tout = decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor([pos], dtype=torch.int32), torch.from_numpy(kv_pos),
        window=window, softcap=softcap)
    assert _diff(jout, tout) < TOL["float32"]


def test_decode_wrapper_on_cpu_runs_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _normal(
        6, (2, 1, 4, 16), (2, 24, 2, 16), (2, 24, 2, 16)))
    kv_pos = torch.from_numpy(_ring_kv_pos(24, 30))
    before = decode_attention.launches
    out = decode_attention(q, k, v, 30, kv_pos)
    assert decode_attention.launches == before
    torch.testing.assert_close(
        out, decode_attention_ref(q, k, v, 30, kv_pos), rtol=0, atol=0)


def test_wrappers_refuse_devices_without_a_kernel():
    meta = torch.device("meta")
    q = torch.empty((1, 8, 4, 16), device=meta)
    k = torch.empty((1, 8, 2, 16), device=meta)
    with pytest.raises(ValueError):
        flash_attention(q, k, k)
    with pytest.raises(ValueError):       # mixed devices never fall back
        flash_attention(q, torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16))
    with pytest.raises(ValueError):
        decode_attention(q[:, :1], k, k, 3,
                         torch.zeros(8, dtype=torch.int32, device=meta))


def test_wrappers_accept_head_dim_256():
    """recurrentgemma-9b's attention: hd 256, 16 q heads over one kv head.
    K2's wrapper refused hd 256 before the kernel gained it; K1 had it."""
    from repro_torch.kernels.decode_attention.ops import \
        check_shapes as da_check
    from repro_torch.kernels.flash_attention.ops import \
        check_shapes as fa_check

    q = torch.empty((2, 8, 16, 256))
    k = torch.empty((2, 8, 1, 256))
    fa_check(q, k, k)
    da_check(q[:, :1], k, k)
    with pytest.raises(ValueError):
        fa_check(torch.empty((2, 8, 16, 512)), torch.empty((2, 8, 1, 512)),
                 torch.empty((2, 8, 1, 512)))
    with pytest.raises(ValueError):           # group 32 > 16
        da_check(torch.empty((2, 1, 32, 256)), k, k)


def test_flash_wrapper_takes_sq_ne_skv_of_one_batch():
    """Cross attention: K2 takes Sq != Skv, never a k/v batch other than
    q's."""
    from repro_torch.kernels.flash_attention.ops import \
        check_shapes as fa_check

    q = torch.empty((8, 256, 16, 64))
    fa_check(q, torch.empty((8, 1024, 16, 64)), torch.empty((8, 1024, 16,
                                                             64)))
    with pytest.raises(ValueError, match="does not match"):
        kv = torch.empty((4, 1024, 16, 64))
        fa_check(q, kv, kv)


# ---------------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window,softcap,causal", [
    (100, 0, 0.0, True), (128, 32, 0.0, True), (64, 0, 5.0, True),
    (40, 0, 0.0, False)])
def test_flash_kernel_matches_plain_on_card(cuda, dtype, S, window, softcap,
                                            causal):
    q, k, v = (_t(x, dtype).to(cuda) for x in _normal(
        S, (2, S, 8, 64), (2, S, 2, 64), (2, S, 2, 64)))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window,
                          softcap=softcap)
    ref = flash_attention_ref(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv", [(56, 200), (200, 1000), (256, 64)])
def test_flash_kernel_at_sq_ne_skv_matches_plain_on_card(cuda, dtype, Sq,
                                                         Skv):
    """Cross attention (non-causal, Sq != Skv) at seamless-m4t-large-v2's
    heads; the launch is tallied under its shape."""
    q, k, v = (_t(x, dtype).to(cuda) for x in _normal(
        Sq + Skv, (2, Sq, 16, 64), (2, Skv, 16, 64), (2, Skv, 16, 64)))
    key = (2, Sq, Skv, 16, 16, 64, False)
    before = flash_attention.launches_by_shape.get(key, 0)
    out = flash_attention(q, k, v, causal=False)
    ref = flash_attention_ref(q, k, v, causal=False)
    assert flash_attention.launches_by_shape[key] == before + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=TOL[dtype])
    if dtype == "bfloat16":     # small outputs: also in L2 against f32
        r32 = flash_attention_ref(q.float(), k.float(), v.float(),
                                  causal=False)
        assert ((out.float() - r32).norm() / r32.norm()).item() < 5e-3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap,pos,window", [(72, 40, 0), (72, 150, 0),
                                            (640, 700, 256)])
def test_decode_kernel_matches_plain_on_card(cuda, dtype, cap, pos, window):
    q, k, v = (_t(x, dtype).to(cuda) for x in _normal(
        pos, (2, 1, 8, 128), (2, cap, 1, 128), (2, cap, 1, 128)))
    kv_pos = torch.from_numpy(_ring_kv_pos(cap, pos)).to(cuda)
    before = decode_attention.launches
    out = decode_attention(q, k, v, pos, kv_pos, window=window)
    ref = decode_attention_ref(q, k, v, pos, kv_pos, window=window)
    assert decode_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_at_head_dim_256_match_plain_on_card(cuda, dtype):
    """recurrentgemma-9b's shapes, scaled down: hd 256, group 16, window."""
    q, k, v = (_t(x, dtype).to(cuda) for x in _normal(
        11, (1, 200, 16, 256), (1, 200, 1, 256), (1, 200, 1, 256)))
    out = flash_attention(q, k, v, causal=True, window=64)
    ref = flash_attention_ref(q, k, v, causal=True, window=64)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=TOL[dtype])
    kv_pos = torch.from_numpy(_ring_kv_pos(128, 300)).to(cuda)
    qd = q[:, :1].contiguous()
    kd, vd = k[:, :128].contiguous(), v[:, :128].contiguous()
    out = decode_attention(qd, kd, vd, 300, kv_pos, window=100)
    ref = decode_attention_ref(qd, kd, vd, 300, kv_pos, window=100)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=TOL[dtype])


# K1 split across a cluster: (B, cap, Hq, Hkv, hd, pos, window)
K1_SPLIT_EDGES = {
    "unwritten_splits": (2, 2048, 16, 1, 256, 20, 0),
    "window_cuts_splits": (2, 2048, 16, 1, 256, 2600, 300),
    "wrapped_ring": (2, 640, 32, 4, 128, 700, 0),
    "ragged_cap": (2, 200, 8, 8, 64, 199, 0),
    "one_lane": (1, 2048, 16, 1, 256, 2600, 2048),
    "g1_hd16": (3, 136, 4, 4, 16, 100, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(K1_SPLIT_EDGES))
def test_decode_kernel_split_edges_on_card(cuda, dtype, case):
    B, cap, Hq, Hkv, hd, pos, window = K1_SPLIT_EDGES[case]
    q, k, v = (_t(x, dtype).to(cuda) for x in _normal(
        cap + pos, (B, 1, Hq, hd), (B, cap, Hkv, hd), (B, cap, Hkv, hd)))
    kv_pos = torch.from_numpy(_ring_kv_pos(cap, pos)).to(cuda)
    out = decode_attention(q, k, v, pos, kv_pos, window=window)
    ref = decode_attention_ref(q, k, v, pos, kv_pos, window=window)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=TOL[dtype])
    assert torch.equal(out, decode_attention(q, k, v, pos, kv_pos,
                                             window=window))


# stablelm-3b's and starcoder2-15b's shapes, narrowed:
# (B, S, Hq, Hkv, hd, window); the decode cases read a cache of S slots
NEW_SHAPES = {
    "hd80_g1": (2, 200, 8, 8, 80, 0),
    "hd80_g1_window": (2, 300, 4, 4, 80, 64),
    "hd128_g12": (2, 200, 24, 2, 128, 0),
    "hd80_g12": (1, 150, 12, 1, 80, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(NEW_SHAPES))
def test_kernels_at_head_dim_80_and_group_12_on_card(cuda, dtype, case):
    """K2, K1's dense and K1's paged entry at hd 80 (rows padded to 128 in
    shared memory, scale 80^-0.5) and at group 12: each wrapper launches
    its kernel on a CUDA tensor (its count rises; no plain fallback) and
    matches its plain version; two calls give the same bits."""
    from repro_torch.kernels.decode_attention.ops import \
        decode_attention_paged
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_paged_ref

    B, S, Hq, Hkv, hd, window = NEW_SHAPES[case]
    q, k, v = (_t(x, dtype).to(cuda) for x in _normal(
        S + hd + Hq, (B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, window=window)
    assert flash_attention.launches == before + 1
    ref = flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=TOL[dtype])
    assert torch.equal(out, flash_attention(q, k, v, causal=True,
                                            window=window))

    pos = S + 40                        # a wrapped ring of S slots
    kv_pos = torch.from_numpy(_ring_kv_pos(S, pos)).to(cuda)
    qd = q[:, :1].contiguous()
    before = decode_attention.launches
    out = decode_attention(qd, k, v, pos, kv_pos, window=window)
    assert decode_attention.launches == before + 1
    ref = decode_attention_ref(qd, k, v, pos, kv_pos, window=window)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=TOL[dtype])
    assert torch.equal(out, decode_attention(qd, k, v, pos, kv_pos,
                                             window=window))

    # the paged entry: the cache cut into pages of 16, scattered through a
    # pool, lane b at position S - 1 - 7 b (its last page part-filled)
    ps, mb = 16, -(-S // 16)
    NP = B * mb + 3
    perm = torch.from_numpy(np.random.default_rng(S).permutation(NP)[:B * mb]
                            .astype(np.int32)).view(B, mb)
    kp = torch.zeros((NP, ps, Hkv, hd), dtype=k.dtype, device=cuda)
    vp, kvp = torch.zeros_like(kp), torch.zeros((NP, ps), dtype=torch.int32)
    posv = torch.tensor([S - 1 - 7 * b for b in range(B)], dtype=torch.int32)
    pad = mb * ps - S
    for b in range(B):
        rows = perm[b].long()
        kp[rows] = torch.nn.functional.pad(k[b], (0, 0, 0, 0, 0, pad)).view(
            mb, ps, Hkv, hd)
        vp[rows] = torch.nn.functional.pad(v[b], (0, 0, 0, 0, 0, pad)).view(
            mb, ps, Hkv, hd)
        kvp[rows] = torch.arange(mb * ps, dtype=torch.int32).view(mb, ps)
    kvp, bt, posv = kvp.to(cuda), perm.to(cuda), posv.to(cuda)
    before = decode_attention_paged.launches
    out = decode_attention_paged(qd, kp, vp, kvp, bt, posv, window=window)
    assert decode_attention_paged.launches == before + 1
    ref = decode_attention_paged_ref(qd, kp, vp, kvp, bt, posv,
                                     window=window)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=TOL[dtype])
    assert torch.equal(out, decode_attention_paged(qd, kp, vp, kvp, bt, posv,
                                                   window=window))


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 64, 80, 128, 256])
@pytest.mark.parametrize("S,window", [(1, 0), (127, 0), (129, 0), (200, 0),
                                      (200, 64), (256, 128)])
def test_flash_kernel_tile_edges_on_card(cuda, hd, S, window):
    """Sq one row, one short of and one past a 64/128-row tile; windows that
    end on a 64-key tile boundary; every head dim route (hd 16 mma.sync,
    64/80/128 one consumer warpgroup, 80 with a zero-filled second
    sub-tile, 256 two).  Two calls give the same bits."""
    q, k, v = (_t(x, "bfloat16").to(cuda) for x in _normal(
        S + hd, (2, S, 16, hd), (2, S, 2, hd), (2, S, 2, hd)))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, window=window)
    ref = flash_attention_ref(q, k, v, causal=True, window=window)
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=TOL["bfloat16"])
    assert torch.equal(out, flash_attention(q, k, v, causal=True,
                                            window=window))
