"""Plain PyTorch versions of K1 (the decode-attention kernel).

``decode_attention_ref`` is the plain version the wrapper runs on the CPU
and the kernel is held against.  ``decode_attention_split_ref`` mirrors the
kernel's split-and-merge arithmetic step by step (per-CTA slot ranges,
wholly masked blocks skipped, online softmax per block, the merge over the
cluster in rank order); only tests use it, never the main path.
"""

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


def decode_attention_split_ref(q, k, v, pos, kv_pos, *, chunk: int,
                               cluster: int, block: int = 64,
                               window: int = 0, softcap: float = 0.0):
    """The kernel's arithmetic in f32: CTA r of ``cluster`` walks slots
    [r * chunk, (r + 1) * chunk) in blocks of ``block``, skipping blocks
    with no kept slot, and keeps (m, l, acc); p is rounded to q's dtype
    before p.v, as the bf16 kernel does.  The partials merge with weights
    exp(m_r - max m), 0 for an empty range (m = -inf)."""
    B, _, Hq, hd = q.shape
    cap, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    f32, inf = torch.float32, float("inf")
    pos = int(torch.as_tensor(pos).reshape(-1)[0])
    keep = kv_pos <= pos
    if window:
        keep &= pos - kv_pos < window
    qg = q.reshape(B, Hkv, G, hd).to(f32)
    parts = []
    for r in range(cluster):
        m = torch.full((B, Hkv, G), -inf, dtype=f32)
        l = torch.zeros((B, Hkv, G), dtype=f32)
        acc = torch.zeros((B, Hkv, G, hd), dtype=f32)
        for j0 in range(r * chunk, min(cap, (r + 1) * chunk), block):
            j1 = min(cap, (r + 1) * chunk, j0 + block)
            kb = keep[j0:j1]
            if not bool(kb.any()):       # never loaded
                continue
            s = torch.einsum("bkgh,bnkh->bkgn", qg,
                             k[:, j0:j1].to(f32)) * hd ** -0.5
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            s = s.masked_fill(~kb, -inf)
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(m_new == -inf, 0.0, m_new)
            alpha = torch.exp(m - m_safe)
            p = torch.exp(s - m_safe[..., None])
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bkgn,bnkh->bkgh", p.to(q.dtype).to(f32),
                              v[:, j0:j1].to(f32))
            acc = acc * alpha[..., None] + pv
            m = m_new
        parts.append((m, l, acc))
    M = torch.stack([p[0] for p in parts]).amax(0)
    M = torch.where(M == -inf, 0.0, M)
    L = torch.zeros_like(M)
    O = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:             # rank order
        w = torch.where(m == -inf, 0.0, torch.exp(m - M))
        L = L + w * l
        O = O + w[..., None] * acc
    out = torch.where(L[..., None] > 0, O / L.clamp_min(1e-30)[..., None],
                      0.0)
    return out.reshape(B, 1, Hq, hd).to(q.dtype)
