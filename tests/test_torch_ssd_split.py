"""K3's bf16 route on the CPU: its arithmetic, and the wrapper's choice of
route.

``ssd_chunked_split_ref`` mirrors ``csrc/ssd_scan.cu: ssd_scan_mma_kernel``
in plain PyTorch: row blocks of 64, x, B and C as exact bf16 operands, and
the f32 operand of each product (the state, the gated scores, the weighted
x) split into hi = bf16(v) and lo = bf16(v - hi).  On inputs that are bf16
values it is held, with y kept in f32, against the reference's Pallas
``ssd_scan_fwd`` in interpret mode and against the plain ``ssd_chunked``:
y within 1e-4 of max |y|, the state within 1e-4 absolute (the split
carries each f32 operand to about 2**-16).  Then ``route`` for the served
shapes and dtypes, and the wrapper's constants against the CUDA source.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.kernel import ssd_scan_fwd  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ROW_BLOCK, ssd_chunked, ssd_chunked_split_ref)
from repro_torch.models.ssm import ssm_dims  # noqa: E402

Y_TOL = 1e-4        # of max |y|
STATE_TOL = 1e-4    # absolute


def _inputs(seed, B, S, H, P, N, dt_scale=1.0):
    """x, dt (> 0), A (< 0), B, C as float32 numpy arrays; x, B and C are
    bf16 values (the route's exact operands)."""
    rng = np.random.default_rng(seed)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(
            torch.bfloat16).float().numpy()

    x = bf16(rng.standard_normal((B, S, H, P)))
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, H)))) * dt_scale) \
        .astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.2)).astype(np.float32)
    Bm = bf16(rng.standard_normal((B, S, N)) * 0.3)
    Cm = bf16(rng.standard_normal((B, S, N)) * 0.3)
    return x, dt, A, Bm, Cm


def _pallas(ins, cs):
    """The Pallas kernel needs S % chunk == 0: pad with dt = 0 rows."""
    x, dt, A, Bm, Cm = ins
    S = x.shape[1]
    c = min(cs, S)
    pad = (-S) % c
    rows = ((0, 0), (0, pad))
    jy, jst = ssd_scan_fwd(
        jnp.asarray(np.pad(x, rows + ((0, 0), (0, 0)))),
        jnp.asarray(np.pad(dt, rows + ((0, 0),))), jnp.asarray(A),
        jnp.asarray(np.pad(Bm, rows + ((0, 0),))),
        jnp.asarray(np.pad(Cm, rows + ((0, 0),))), chunk=c, interpret=True)
    return np.asarray(jy)[:, :S], np.asarray(jst)


def _y_err(ref, out):
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(ref - np.asarray(out, np.float32)))
                 / np.max(np.abs(ref)))


def _abs(ref, out):
    return float(np.max(np.abs(np.asarray(ref, np.float32)
                               - np.asarray(out, np.float32))))


# ---------------------------------------------------------------------------
# the route's arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,P,N,cs", [
    (2, 300, 2, 64, 128, 256),     # the served widths, ragged last chunk
    (2, 250, 4, 16, 16, 100),      # chunk not a multiple of the row block
    (2, 40, 8, 16, 16, 32),        # the smoke shape
    (1, 200, 2, 64, 16, 100),
    (1, 130, 2, 16, 128, 256),     # one short chunk of three row blocks
    (2, 96, 2, 32, 64, 32),
])
def test_split_mirror_matches_pallas_and_plain(B, S, H, P, N, cs):
    ins = _inputs(S + P + N, B, S, H, P, N)
    my, mst = ssd_chunked_split_ref(*map(torch.from_numpy, ins), chunk=cs)
    assert my.dtype == torch.float32 and mst.shape == (B, H, P, N)
    jy, jst = _pallas(ins, cs)
    assert _y_err(jy, my) < Y_TOL and _abs(jst, mst) < STATE_TOL
    ty, tst = ssd_chunked(*map(torch.from_numpy, ins), chunk=cs)
    assert _y_err(ty, my) < Y_TOL and _abs(tst, mst) < STATE_TOL


@pytest.mark.parametrize("cs", [32, 100, 256])
def test_split_mirror_never_makes_nan_from_large_decays(cs):
    """dt 200 times larger: cs spans about -1e4 within a chunk, so exp of
    cs_i - cs_j for i < j would overflow.  The route masks the exponent.
    The state is then dt x B, about 100, so it is held relative to its
    largest entry, as y is."""
    ins = _inputs(5, 1, 300, 2, 16, 16, dt_scale=200.0)
    y, st = ssd_chunked_split_ref(*map(torch.from_numpy, ins), chunk=cs)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    ty, tst = ssd_chunked(*map(torch.from_numpy, ins), chunk=cs)
    assert _y_err(ty, y) < Y_TOL and _y_err(tst, st) < STATE_TOL


def test_split_mirror_of_bf16_tensors_matches_f32_copies():
    """Called on bf16 tensors the mirror takes them as they are and still
    returns f32: the same numbers as on their f32 copies."""
    ins = _inputs(11, 1, 70, 2, 16, 32)
    x, dt, A, Bm, Cm = map(torch.from_numpy, ins)
    y32, s32 = ssd_chunked_split_ref(x, dt, A, Bm, Cm, chunk=64)
    y16, s16 = ssd_chunked_split_ref(x.bfloat16(), dt, A, Bm.bfloat16(),
                                     Cm.bfloat16(), chunk=64)
    assert y16.dtype == torch.float32
    torch.testing.assert_close(y16, y32, rtol=0, atol=0)
    torch.testing.assert_close(s16, s32, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the wrapper's route and constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-1.3b", "mamba2-1.3b-smoke"])
def test_route_of_the_served_shapes(arch):
    _, _, N, P = ssm_dims(get_arch(arch))
    assert ops.route(torch.bfloat16, P, N) == "mma"
    assert ops.route(torch.float32, P, N) == "cuda_core"


@pytest.mark.parametrize("dtype,P,N,want", [
    (torch.bfloat16, 64, 128, "mma"), (torch.bfloat16, 16, 16, "mma"),
    (torch.bfloat16, 32, 64, "mma"), (torch.bfloat16, 20, 16, "cuda_core"),
    (torch.bfloat16, 64, 36, "cuda_core"), (torch.float32, 16, 16,
                                            "cuda_core")])
def test_route_by_dtype_and_shape(dtype, P, N, want):
    assert ops.route(dtype, P, N) == want


def test_wrapper_constants_match_the_cuda_source():
    src = (Path(ops.__file__).parents[1] / "csrc" / "ssd_scan.cu") \
        .read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert (ops.MAX_CHUNK, ops.MAX_P, ops.MAX_N, ROW_BLOCK) == (
        const("CMAX"), const("PMAX"), const("NMAX"), const("BR"))
    enum = re.search(r"enum Route : int \{ ROUTE_CUDA_CORE = (\d+), "
                     r"ROUTE_MMA = (\d+) \};", src)
    assert ops.ROUTES == {"cuda_core": int(enum[1]), "mma": int(enum[2])}
    # the entry point refuses the mma route off its 16-granule
    assert f"P % {ops.MMA_TILE} || N % {ops.MMA_TILE}" in src
    assert "__global__ void __launch_bounds__(MT, 2)\nssd_scan_mma_kernel" \
        in src
