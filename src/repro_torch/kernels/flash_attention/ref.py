"""Plain PyTorch version of K2 (the flash-attention kernel)."""

from __future__ import annotations

import torch

from repro_torch.models.attention import sdpa_naive


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """``sdpa_naive`` over positions contiguous from 0."""
    Sq, Skv = q.shape[1], k.shape[1]
    return sdpa_naive(q, k, v, causal=causal, window=window,
                      q_pos=torch.arange(Sq, device=q.device),
                      kv_pos=torch.arange(Skv, device=q.device),
                      softcap=softcap)
