"""K4, the RG-LRU block and the new layers of the PyTorch port against the
reference.

* plain K4 (``rglru_scan_ref``) against the reference's Pallas kernel
  ``rglru_scan_fwd`` in interpret mode (1e-4 absolute, as
  tests/test_kernels.py), and at a ragged S and W against the reference's
  ``rglru_scan_ref``;
* ``_gates``, ``rglru_ref``, ``rec_block_prefill`` / ``rec_block_step``
  against the reference on shared weights in f32 (2e-5 absolute), with
  decode writing ``h`` and the conv window into the given cache;
* ``causal_conv1d`` (left zero padding kept when S < K-1) and its step, the
  geglu and gelu MLPs, and ``gelu`` as JAX's tanh approximation;
* the wrapper's device rules, and on a card (``gpu``) K4 against its
  plain version.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.kernels.rglru_scan.kernel import rglru_scan_fwd  # noqa: E402
from repro.kernels.rglru_scan.ref import (  # noqa: E402
    rglru_scan_ref as jscan_ref)
from repro.models import layers as jlayers  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as rg_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.testing import params_from_jax, to_numpy  # noqa: E402

SCAN_TOL = 1e-4         # tests/test_kernels.py
F32_TOL = 2e-5


def _gates_np(seed, B, S, W):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, W))))) * 0.98
    b = rng.standard_normal((B, S, W)) * 0.1
    return a.astype(np.float32), b.astype(np.float32)


def _abs(ref, out) -> float:
    return float(np.max(np.abs(np.asarray(ref, np.float32)
                               - np.asarray(out, np.float32))))


# ---------------------------------------------------------------------------
# K4: plain version against the Pallas kernel and the reference's oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,W,bs", [(1, 64, 128, 32), (3, 256, 256, 64),
                                      (2, 128, 128, 64)])
def test_rglru_plain_matches_pallas(B, S, W, bs):
    a, b = _gates_np(S + W, B, S, W)
    jh, jhf = rglru_scan_fwd(jnp.asarray(a), jnp.asarray(b), bs=bs, bw=128,
                             interpret=True)
    th, thf = rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert th.dtype == torch.float32 and thf.shape == (B, W)
    assert _abs(jh, th) < SCAN_TOL and _abs(jhf, thf) < SCAN_TOL


@pytest.mark.parametrize("S,W", [(77, 300), (1, 5), (129, 33)])
def test_rglru_plain_ragged_matches_reference(S, W):
    a, b = _gates_np(S * W, 2, S, W)
    jh, jhf = jscan_ref(jnp.asarray(a), jnp.asarray(b))
    th, thf = rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert _abs(jh, th) < SCAN_TOL and _abs(jhf, thf) < SCAN_TOL
    # and against the recurrence written out
    h = np.zeros((2, W), np.float64)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
    assert _abs(h, thf) < SCAN_TOL


# ---------------------------------------------------------------------------
# Layers the hybrid family adds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 3, 9])     # K - 1 = 3
def test_causal_conv_and_step_match_reference(S):
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    jy, jst = jlayers.causal_conv1d(jnp.asarray(x), jnp.asarray(w))
    ty, tst = tlayers.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w))
    assert _abs(jy, ty) < F32_TOL and _abs(jst, tst) < F32_TOL
    assert tst.shape == (2, 3, 6)
    for i in range(4):
        xt = rng.standard_normal((2, 6)).astype(np.float32)
        jy, jst = jlayers.causal_conv1d_step(jnp.asarray(xt), jnp.asarray(w),
                                             jst)
        ty = tlayers.causal_conv1d_step(torch.from_numpy(xt),
                                        torch.from_numpy(w), tst)
        assert _abs(jy, ty) < F32_TOL and _abs(jst, tst) < F32_TOL


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    ours = tlayers.gelu(torch.from_numpy(x))
    assert _abs(jax.nn.gelu(jnp.asarray(x)), ours) < 1e-6
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert _abs(exact, ours) > 1e-4      # the trap: PyTorch's default differs


@pytest.mark.parametrize("kind", ["geglu", "gelu"])
def test_gelu_mlps_match_reference(kind):
    jcfg = dataclasses.replace(jget_arch("recurrentgemma-9b-smoke"),
                               dtype="float32", mlp_kind=kind)
    tcfg = dataclasses.replace(get_arch("recurrentgemma-9b-smoke"),
                               dtype="float32", mlp_kind=kind)
    jp = jlayers.init_mlp(jcfg, jax.random.PRNGKey(1), 64, 128)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    assert sorted(tp) == sorted(jp)
    x = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(
        np.float32)
    jout = jlayers.mlp_fwd(jcfg, jp, jnp.asarray(x))
    tout = tlayers.mlp_fwd(tcfg, tp, torch.from_numpy(x))
    assert _abs(jout, tout) < F32_TOL


# ---------------------------------------------------------------------------
# RG-LRU block on shared weights
# ---------------------------------------------------------------------------

def _cfgs(dtype="float32"):
    name = "recurrentgemma-9b-smoke"
    return (dataclasses.replace(jget_arch(name), dtype=dtype),
            dataclasses.replace(get_arch(name), dtype=dtype))


def _rec_params(seed=0):
    jcfg, tcfg = _cfgs()
    jp = jrg.init_rec_block(jcfg, jax.random.PRNGKey(seed))
    # non-zero biases, so the test sees them
    rng = np.random.default_rng(seed)
    jp = dict(jp, b_a=jnp.asarray(rng.standard_normal(64), jnp.float32),
              b_x=jnp.asarray(rng.standard_normal(64), jnp.float32))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def test_gates_and_rglru_ref_match_reference():
    jcfg, tcfg, jp, tp = _rec_params(1)
    u = np.random.default_rng(1).standard_normal((2, 30, 64)).astype(
        np.float32)
    ja, jb = jrg._gates(jp, jnp.asarray(u))
    ta, tb = trg._gates(tp, torch.from_numpy(u))
    assert _abs(ja, ta) < F32_TOL and _abs(jb, tb) < F32_TOL
    jy, jh = jrg.rglru_ref(jp, jnp.asarray(u))
    ty, th = trg.rglru_ref(tp, torch.from_numpy(u))
    assert _abs(jy, ty) < F32_TOL and _abs(jh, th) < F32_TOL


@pytest.mark.parametrize("impl", ["kernel", "naive"])
@pytest.mark.parametrize("S", [24, 2])
def test_rec_block_prefill_and_step_match_reference(impl, S):
    jcfg, tcfg, jp, tp = _rec_params(S)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    jout, jc = jrg.rec_block_prefill(jcfg, jp, jnp.asarray(x))
    tout, tc = trg.rec_block_prefill(tcfg, tp, torch.from_numpy(x),
                                     impl=impl)
    assert _abs(jout, tout) < F32_TOL
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(to_numpy(tc))):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _abs(a, b) < F32_TOL
    h, conv = tc["h"], tc["conv_state"]
    for i in range(3):
        xt = rng.standard_normal((2, 1, 64)).astype(np.float32)
        jout, jc = jrg.rec_block_step(jcfg, jp, jnp.asarray(xt), jc)
        tout, tc2 = trg.rec_block_step(tcfg, tp, torch.from_numpy(xt), tc)
        assert _abs(jout, tout) < F32_TOL
        assert tc2["h"] is h and tc2["conv_state"] is conv
        assert _abs(jc["h"], h) < F32_TOL
        assert _abs(jc["conv_state"], conv) < F32_TOL


def test_rec_block_params_and_cache_dtypes():
    tcfg = get_arch("recurrentgemma-9b-smoke")
    p = trg.init_rec_block(tcfg, torch.device("cpu"),
                           torch.Generator().manual_seed(0), count=2)
    jp = jax.eval_shape(lambda k: jrg.init_rec_block(
        jget_arch("recurrentgemma-9b-smoke"), k), jax.random.PRNGKey(0))
    for k, s in jp.items():
        assert tuple(p[k].shape) == (2,) + tuple(s.shape), k
        assert str(p[k].dtype).removeprefix("torch.") == str(s.dtype), k
    spec = trg.rec_cache_spec(tcfg, 3)
    assert spec["h"].dtype == torch.float32
    assert spec["conv_state"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def test_rglru_wrapper_on_cpu_runs_the_plain_version():
    a, b = (torch.from_numpy(x) for x in _gates_np(4, 2, 40, 24))
    before = rg_ops.rglru_scan.launches
    h, hf = rg_ops.rglru_scan(a, b)
    assert rg_ops.rglru_scan.launches == before
    rh, rhf = rglru_scan_ref(a, b)
    torch.testing.assert_close(h, rh, rtol=0, atol=0)
    torch.testing.assert_close(hf, rhf, rtol=0, atol=0)


def test_rglru_wrapper_refuses_devices_without_a_kernel():
    meta = torch.device("meta")
    a = torch.empty((1, 8, 16), device=meta)
    with pytest.raises(ValueError):
        rg_ops.rglru_scan(a, a)
    with pytest.raises(ValueError):       # mixed devices never fall back
        rg_ops.rglru_scan(a, torch.zeros(1, 8, 16))


# ---------------------------------------------------------------------------
# On the card: K4 against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,W", [(2, 256, 512), (3, 77, 300), (1, 1, 5)])
def test_rglru_kernel_matches_plain_on_card(cuda, B, S, W):
    a, b = (torch.from_numpy(x).to(cuda) for x in _gates_np(S, B, S, W))
    before = rg_ops.rglru_scan.launches
    h, hf = rg_ops.rglru_scan(a, b)
    rh, rhf = rglru_scan_ref(a, b)
    assert rg_ops.rglru_scan.launches == before + 1
    assert _abs(rh.cpu(), h.cpu()) < SCAN_TOL
    assert _abs(rhf.cpu(), hf.cpu()) < SCAN_TOL
