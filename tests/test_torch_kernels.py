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
])
def test_flash_plain_matches_pallas(B, S, Hq, Hkv, hd, causal, window, dtype):
    q, k, v = _normal(B * 7 + S, (B, S, Hq, hd), (B, S, Hkv, hd),
                      (B, S, Hkv, hd))
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
