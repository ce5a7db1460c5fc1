"""Wrapper of K2, the flash-attention forward kernel
(``csrc/flash_attention.cu``).

On CUDA tensors it launches the kernel or raises; on CPU tensors it runs
the plain version ``flash_attention_ref``.  ``flash_attention.launches``
counts kernel launches (not plain-version calls).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (F, I, P, check_operands, on_cpu,
                                        raise_on_error, stream_of)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128)
_ARGTYPES = (P, P, P, P, I, I, I, I, I, I, I, I, I, F, P)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k/v: (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd).
    Positions are contiguous from 0 for both q and kv."""
    if on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, hd_k = k.shape
    if k.shape[0] != B or hd_k != hd or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    code = check_operands("flash_attention", {"q": q, "k": k, "v": v},
                          q.dtype)
    out = torch.empty_like(q)
    fn = build.load("flash_attention", "flash_attention_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                code, B, Sq, Skv, Hq, Hkv, hd, int(causal), int(window),
                float(softcap), stream_of(q))
    raise_on_error("flash_attention", rc)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
