"""Wrapper of K4, the RG-LRU linear-recurrence kernel
(``csrc/rglru_scan.cu``).

On CUDA tensors it launches the kernel or raises; on CPU tensors it runs
the plain version ``rglru_scan_ref``.  ``rglru_scan.launches`` counts
kernel launches (not plain-version calls).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (I, P, check_operands, on_cpu,
                                        raise_on_error, stream_of)
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

_ARGTYPES = (P, P, P, P, I, I, I, P)


def rglru_scan(a: torch.Tensor, b: torch.Tensor):
    """a, b: (B, S, W) f32.  Returns (h: (B, S, W), h_final: (B, W)), f32,
    for h_t = a_t h_{t-1} + b_t from h_{-1} = 0.  Any S and W."""
    if on_cpu(a, b):
        return rglru_scan_ref(a, b)
    if a.dim() != 3 or a.shape != b.shape or 0 in a.shape:
        raise ValueError(f"rglru_scan: bad shapes a {tuple(a.shape)} b "
                         f"{tuple(b.shape)}")
    check_operands("rglru_scan", {"a": a, "b": b}, torch.float32)
    Bsz, S, W = a.shape
    h = torch.empty_like(a)
    h_final = torch.empty((Bsz, W), dtype=torch.float32, device=a.device)
    fn = build.load("rglru_scan", "rglru_scan_fwd", _ARGTYPES)
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), h_final.data_ptr(),
                Bsz, S, W, stream_of(a))
    raise_on_error("rglru_scan", rc)
    rglru_scan.launches += 1
    return h, h_final


rglru_scan.launches = 0
