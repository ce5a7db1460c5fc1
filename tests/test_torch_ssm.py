"""K3 and the Mamba2 block of the PyTorch port against the reference.

* plain K3 (``ssd_chunked``) against the reference's Pallas kernel
  ``ssd_scan_fwd`` in interpret mode, at tests/test_kernels.py's shapes
  and tolerances (y relative 1e-4, state absolute 1e-3);
* a ragged S (no chunk multiple) against the Pallas kernel on a zero-padded
  copy and against the reference's ``ssd_chunked``; chunk invariance;
* ``ssm_block_prefill`` / ``ssm_block_step`` and ``ssd_step`` against the
  reference on shared weights in f32 (2e-5 absolute on O(1) values), with
  decode writing the state and conv windows into the given cache;
* the wrapper's device rules, and on a card (``gpu``) K3 against its
  plain version.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.kernels.ssd_scan.kernel import ssd_scan_fwd  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.testing import params_from_jax, to_numpy  # noqa: E402

Y_REL_TOL = 1e-4        # tests/test_kernels.py: y relative to max |y|
STATE_TOL = 1e-3        # tests/test_kernels.py: state absolute
F32_TOL = 2e-5


def _inputs(seed, B, S, H, P, N):
    """x, dt (> 0), A (< 0), B, C as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.2)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _rel(ref, out) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(ref - np.asarray(out, np.float32)))
                 / (np.max(np.abs(ref)) + 1e-9))


def _abs(ref, out) -> float:
    return float(np.max(np.abs(np.asarray(ref, np.float32)
                               - np.asarray(out, np.float32))))


# ---------------------------------------------------------------------------
# K3: plain version against the Pallas kernel and the reference's oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,P,N,cs", [
    (2, 128, 4, 32, 64, 32),
    (1, 128, 8, 64, 128, 64),
    (2, 64, 2, 16, 32, 64),
])
def test_ssd_plain_matches_pallas(B, S, H, P, N, cs):
    ins = _inputs(S * H, B, S, H, P, N)
    jy, jst = ssd_scan_fwd(*map(jnp.asarray, ins), chunk=cs, interpret=True)
    ty, tst = ssd_chunked(*_t(*ins), chunk=cs)
    assert ty.dtype == torch.float32 and tst.shape == (B, H, P, N)
    assert _rel(jy, ty) < Y_REL_TOL
    assert _abs(jst, tst) < STATE_TOL


@pytest.mark.parametrize("S,cs", [(100, 32), (77, 64), (40, 256)])
def test_ssd_plain_ragged_matches_padded_pallas_and_reference(S, cs):
    B, H, P, N = 2, 4, 16, 32
    ins = _inputs(S, B, S, H, P, N)
    ty, tst = ssd_chunked(*_t(*ins), chunk=cs)
    # the reference's oracle pads with zeros itself
    ry, rst = jssm.ssd_chunked(*map(jnp.asarray, ins), chunk=cs)
    assert _rel(ry, ty) < Y_REL_TOL and _abs(rst, tst) < STATE_TOL
    # the Pallas kernel needs S % chunk == 0: pad by hand (dt = 0 rows)
    c = min(cs, S)
    pad = (-S) % c
    x, dt, A, Bm, Cm = ins
    padded = [np.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0))),
              np.pad(dt, ((0, 0), (0, pad), (0, 0))), A,
              np.pad(Bm, ((0, 0), (0, pad), (0, 0))),
              np.pad(Cm, ((0, 0), (0, pad), (0, 0)))]
    jy, jst = ssd_scan_fwd(*map(jnp.asarray, padded), chunk=c,
                           interpret=True)
    assert _rel(np.asarray(jy)[:, :S], ty) < Y_REL_TOL
    assert _abs(jst, tst) < STATE_TOL


def test_ssd_plain_chunk_invariance():
    ins = _t(*_inputs(77, 1, 120, 2, 16, 32))
    y1, s1 = ssd_chunked(*ins, chunk=16)
    for cs in (32, 50, 128):
        y2, s2 = ssd_chunked(*ins, chunk=cs)
        assert _abs(y1, y2) < 1e-3 and _abs(s1, s2) < 1e-3


def test_ssd_plain_never_makes_nan_from_large_decays():
    """exp(cs_i - cs_j) for i < j overflows; the plain version masks the
    exponent, not the product."""
    x, dt, A, Bm, Cm = _inputs(5, 1, 64, 2, 16, 16)
    dt = dt * 200.0                      # cs spans ~-1e4 within a chunk
    y, st = ssd_chunked(*_t(x, dt, A, Bm, Cm), chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()


def test_ssd_step_matches_reference_and_writes_the_state():
    rng = np.random.default_rng(3)
    B, H, P, N = 2, 4, 8, 16
    x = rng.standard_normal((B, H, P)).astype(np.float32)
    dt = np.abs(rng.standard_normal((B, H))).astype(np.float32)
    A = -np.abs(rng.standard_normal(H)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, N)).astype(np.float32)
              for _ in range(2))
    st = rng.standard_normal((B, H, P, N)).astype(np.float32)
    jy, jst = jssm.ssd_step(*map(jnp.asarray, (x, dt, A, Bm, Cm, st)))
    tst = torch.from_numpy(st.copy())
    ty = tssm.ssd_step(*_t(x, dt, A, Bm, Cm), tst)
    assert _abs(jy, ty) < F32_TOL
    assert _abs(jst, tst) < F32_TOL      # written in place


# ---------------------------------------------------------------------------
# Mamba2 block on shared weights
# ---------------------------------------------------------------------------

def _cfgs(dtype="float32"):
    return (dataclasses.replace(jget_arch("mamba2-1.3b-smoke"), dtype=dtype),
            dataclasses.replace(get_arch("mamba2-1.3b-smoke"), dtype=dtype))


@pytest.mark.parametrize("impl", ["kernel", "naive"])
@pytest.mark.parametrize("S", [40, 2])      # 2 < d_conv - 1: padded window
def test_ssm_block_prefill_and_step_match_reference(impl, S):
    jcfg, tcfg = _cfgs()
    jp = jssm.init_ssm_block(jcfg, jax.random.PRNGKey(S))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    jout, jc = jssm.ssm_block_prefill(jcfg, jp, jnp.asarray(x))
    tout, tc = tssm.ssm_block_prefill(tcfg, tp, torch.from_numpy(x),
                                      impl=impl)
    assert _abs(jout, tout) < F32_TOL
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(to_numpy(tc))):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _abs(a, b) < F32_TOL
    state, conv_x = tc["ssm_state"], tc["conv"]["x"]
    for i in range(3):
        xt = rng.standard_normal((2, 1, 64)).astype(np.float32)
        jout, jc = jssm.ssm_block_step(jcfg, jp, jnp.asarray(xt), jc)
        tout, tc2 = tssm.ssm_block_step(tcfg, tp, torch.from_numpy(xt), tc)
        assert _abs(jout, tout) < F32_TOL
        # the step writes into the cache it was given
        assert tc2["ssm_state"] is state and tc2["conv"]["x"] is conv_x
        assert _abs(jc["ssm_state"], state) < F32_TOL
        assert _abs(jc["conv"]["x"], conv_x) < F32_TOL


def test_ssm_block_params_and_cache_dtypes():
    """In a bf16 config the A_log/dt_bias/D_skip leaves and the SSM state
    are float32, as in the reference."""
    tcfg = get_arch("mamba2-1.3b-smoke")
    p = tssm.init_ssm_block(tcfg, torch.device("cpu"),
                            torch.Generator().manual_seed(0), count=2)
    jp = jax.eval_shape(lambda k: jssm.init_ssm_block(
        jget_arch("mamba2-1.3b-smoke"), k), jax.random.PRNGKey(0))
    for k, s in jp.items():
        assert tuple(p[k].shape) == (2,) + tuple(s.shape), k
        assert str(p[k].dtype).removeprefix("torch.") == str(s.dtype), k
    spec = tssm.ssm_cache_spec(tcfg, 3)
    assert spec["ssm_state"].dtype == torch.float32
    assert spec["conv"]["x"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def test_ssd_wrapper_on_cpu_runs_the_plain_version():
    ins = _t(*_inputs(9, 1, 50, 2, 16, 16))
    before = ssd_ops.ssd_scan.launches
    y, st = ssd_ops.ssd_scan(*ins, chunk=32)
    assert ssd_ops.ssd_scan.launches == before
    ry, rst = ssd_chunked(*ins, chunk=32)
    torch.testing.assert_close(y, ry, rtol=0, atol=0)
    torch.testing.assert_close(st, rst, rtol=0, atol=0)


def test_ssd_wrapper_limits():
    meta = torch.device("meta")
    x, dt, A, Bm, Cm = (torch.empty(s, device=meta) for s in (
        (1, 8, 2, 16), (1, 8, 2), (2,), (1, 8, 16), (1, 8, 16)))
    with pytest.raises(ValueError):       # no kernel for meta tensors
        ssd_ops.ssd_scan(x, dt, A, Bm, Cm)
    ssd_ops.check_shapes(x, dt, A, Bm, Cm, 256)       # served limits
    big = torch.empty((1, 8, 2, 128), device=meta)
    with pytest.raises(ValueError):
        ssd_ops.check_shapes(big, dt, A, Bm, Cm, 256)
    with pytest.raises(ValueError):
        ssd_ops.check_shapes(x, dt, A, Bm, Cm, 512)
    with pytest.raises(ValueError):
        ssd_ops.check_shapes(x, dt[:, :4], A, Bm, Cm, 256)


# ---------------------------------------------------------------------------
# On the card: K3 against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,cs", [
    (2, 128, 4, 32, 64, 32), (1, 300, 8, 64, 128, 256),
    (2, 100, 2, 16, 16, 64),
    # the bf16 mma route's edges: ragged S, a chunk that is not a multiple
    # of its 64-row block, and the smoke shape
    (2, 1000, 4, 64, 128, 256), (2, 1000, 4, 64, 128, 100),
    (2, 40, 8, 16, 16, 32)])
def test_ssd_kernel_matches_plain_on_card(cuda, dtype, B, S, H, P, N, cs):
    """One launch per call, on the route ``route`` picks; two calls give
    the same bits."""
    x, dt, A, Bm, Cm = (t.to(cuda) for t in _t(*_inputs(S, B, S, H, P, N)))
    dty = getattr(torch, dtype)
    x, Bm, Cm = x.to(dty), Bm.to(dty), Cm.to(dty)
    assert ssd_ops.route(dty, P, N) == (
        "mma" if dtype == "bfloat16" else "cuda_core")
    before = ssd_ops.ssd_scan.launches
    y, st = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=cs)
    ry, rst = ssd_chunked(x, dt, A, Bm, Cm, chunk=cs)
    assert ssd_ops.ssd_scan.launches == before + 1
    y2, st2 = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=cs)
    assert ssd_ops.ssd_scan.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(st, st2)
    tol = Y_REL_TOL if dtype == "float32" else 2e-2
    assert _rel(ry.float().cpu(), y.float().cpu()) < tol
    assert _rel(rst.cpu(), st.cpu()) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,N,cs", [
    (2, 300, 4, 20, 36, 64), (1, 200, 2, 64, 36, 100),
    (2, 100, 4, 20, 128, 256)])
def test_ssd_kernel_bf16_off_grain_on_card(cuda, B, S, H, P, N, cs):
    """bf16 with P or N off the mma route's 16-grain takes the CUDA-core
    kernel: held against the plain version like the other routes, one
    launch per call, the same bits twice."""
    x, dt, A, Bm, Cm = (t.to(cuda) for t in _t(*_inputs(S, B, S, H, P, N)))
    x, Bm, Cm = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    assert ssd_ops.route(torch.bfloat16, P, N) == "cuda_core"
    before = ssd_ops.ssd_scan.launches
    y, st = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=cs)
    y2, st2 = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=cs)
    assert ssd_ops.ssd_scan.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(st, st2)
    ry, rst = ssd_chunked(x, dt, A, Bm, Cm, chunk=cs)
    assert _rel(ry.float().cpu(), y.float().cpu()) < 2e-2
    assert _rel(rst.cpu(), st.cpu()) < 1e-3
