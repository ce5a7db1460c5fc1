"""Wrapper of K3, the Mamba2 SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

On CUDA tensors it launches the kernel or raises; on CPU tensors it runs
the plain version ``ssd_chunked``.  ``ssd_scan.launches`` counts kernel
launches (not plain-version calls).  ``route`` picks the kernel by dtype
and shape; the choice is passed to the C entry point, which refuses a
route it cannot take (there is no fallback).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (I, P, check_operands, on_cpu,
                                        raise_on_error, stream_of)
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

MAX_CHUNK = 256     # csrc/ssd_scan.cu: CMAX
MAX_P = 64          # PMAX
MAX_N = 128         # NMAX
MMA_TILE = 16       # the mma route's P and N granule (m16n8k16)
ROUTES = {"cuda_core": 0, "mma": 1}   # csrc/ssd_scan.cu: Route
_ARGTYPES = (P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P)


def route(dtype: torch.dtype, P: int, N: int) -> str:
    """The kernel a call on the card takes: "mma" (ssd_scan_mma_kernel,
    tensor cores with split-bf16 operands) for bf16 with P and N multiples
    of 16; "cuda_core" (ssd_scan_kernel, f32 on the CUDA cores) for f32 and
    for bf16 at other shapes."""
    if dtype == torch.bfloat16 and P % MMA_TILE == 0 and N % MMA_TILE == 0:
        return "mma"
    return "cuda_core"


def check_shapes(x, dt, A, Bm, Cm, chunk: int) -> None:
    """Raises on what the kernel does not take."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3 \
            or Bm.shape != Cm.shape:
        raise ValueError(f"ssd_scan: bad ranks x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} A {tuple(A.shape)} B "
                         f"{tuple(Bm.shape)} C {tuple(Cm.shape)}")
    Bsz, S, H, Pd = x.shape
    N = Bm.shape[-1]
    if dt.shape != (Bsz, S, H) or A.shape != (H,) \
            or Bm.shape[:2] != (Bsz, S):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} does not match dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)} or B/C "
                         f"{tuple(Bm.shape)}")
    if Pd > MAX_P or N > MAX_N or Pd % 4 or N % 4:
        raise ValueError(f"ssd_scan: head dim {Pd} (<= {MAX_P}) and state "
                         f"{N} (<= {MAX_N}) must be multiples of 4")
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} not in 1..{MAX_CHUNK}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256):
    """x: (B, S, H, P) bf16/f32; dt: (B, S, H) f32; A: (H,) f32; Bm/Cm:
    (B, S, N) in x's dtype.  Returns (y: (B, S, H, P) in x's dtype,
    final state: (B, H, P, N) f32).  Any S: the ragged last chunk is
    masked in the kernel."""
    if on_cpu(x, dt, A, Bm, Cm):
        return ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
    chunk = min(chunk, x.shape[1])
    check_shapes(x, dt, A, Bm, Cm, chunk)
    code = check_operands("ssd_scan", {"x": x, "B": Bm, "C": Cm}, x.dtype)
    check_operands("ssd_scan", {"dt": dt, "A": A}, torch.float32)
    Bsz, S, H, Pd = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((Bsz, H, Pd, N), dtype=torch.float32,
                        device=x.device)
    fn = build.load("ssd_scan", "ssd_scan_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), state.data_ptr(), code,
                ROUTES[route(x.dtype, Pd, N)], Bsz, S, H, Pd, N, chunk,
                stream_of(x))
    raise_on_error("ssd_scan", rc)
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
