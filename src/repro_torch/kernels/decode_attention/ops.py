"""Wrapper of K1, the decode-attention kernel (``csrc/decode_attention.cu``).

On CUDA tensors it launches the kernel or raises; on CPU tensors it runs
the plain version ``decode_attention_ref``.  ``decode_attention.launches``
counts kernel launches (not plain-version calls).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (F, I, P, check_operands, on_cpu,
                                        raise_on_error, stream_of)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 16      # csrc/decode_attention.cu: GMAX
_ARGTYPES = (P, P, P, P, P, P, I, I, I, I, I, I, I, F, P)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos, kv_pos: torch.Tensor, *, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """q: (B, 1, Hq, hd); k/v: (B, cap, Hkv, hd); kv_pos: (cap,) int32
    absolute slot positions (2**30 = unwritten); pos: int or one-element
    int tensor, the query's position.  Returns (B, 1, Hq, hd)."""
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor([int(pos)], dtype=torch.int32, device=q.device)
    if on_cpu(q, k, v, kv_pos, pos):
        return decode_attention_ref(q, k, v, pos, kv_pos, window=window,
                                    softcap=softcap)
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    B, _, Hq, hd = q.shape
    _, cap, Hkv, hd_k = k.shape
    if k.shape[0] != B or hd_k != hd or Hq % Hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)}")
    if hd not in HEAD_DIMS or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: head dim {hd} (allowed "
                         f"{HEAD_DIMS}) or group {Hq // Hkv} (max "
                         f"{MAX_GROUP}) not supported")
    if kv_pos.shape != (cap,) or kv_pos.dtype != torch.int32 \
            or not kv_pos.is_contiguous():
        raise ValueError(f"decode_attention: kv_pos must be contiguous "
                         f"int32 of shape ({cap},)")
    pos = pos.reshape(-1)
    if pos.numel() != 1 or pos.dtype != torch.int32:
        raise ValueError("decode_attention: pos must be one int32 value")
    code = check_operands("decode_attention", {"q": q, "k": k, "v": v},
                          q.dtype)
    out = torch.empty_like(q)
    fn = build.load("decode_attention", "decode_attention_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(),
                pos.data_ptr(), out.data_ptr(), code, B, cap, Hq, Hkv, hd,
                int(window), float(softcap), stream_of(q))
    raise_on_error("decode_attention", rc)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
