"""Plain PyTorch version of K1 (the decode-attention kernel)."""

from __future__ import annotations

import torch

from repro_torch.models.attention import sdpa_naive


def decode_attention_ref(q, k, v, pos, kv_pos, *, window: int = 0,
                         softcap: float = 0.0):
    """q: (B,1,Hq,hd) over cache (B,cap,Hkv,hd) with absolute ``kv_pos``;
    ``gqa_decode``'s ``sdpa_naive`` call with ``q_pos=[pos]``."""
    q_pos = torch.as_tensor(pos, dtype=torch.int32,
                            device=q.device).reshape(1)
    return sdpa_naive(q, k, v, causal=True, window=window, q_pos=q_pos,
                      kv_pos=kv_pos, softcap=softcap)
