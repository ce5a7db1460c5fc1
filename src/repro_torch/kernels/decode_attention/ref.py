"""Plain PyTorch versions of K1 (the decode-attention kernel).

``decode_attention_ref`` is the plain version the wrapper runs on the CPU
and the kernel is held against.  ``decode_attention_split_ref`` mirrors the
kernel's split-and-merge arithmetic step by step (per-CTA slot ranges,
wholly masked blocks skipped, online softmax per block, the merge over the
cluster in rank order); only tests use it, never the main path.

``decode_attention_paged_ref`` is the plain version of the paged entry:
each lane's pages gathered through its block-table row (``gather_pages``,
the primitive under ``serve/kvcache.py:gather_lane_cache``), then
``sdpa_naive``.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import _INVALID_POS, sdpa_naive


def decode_attention_ref(q, k, v, pos, kv_pos, *, window: int = 0,
                         softcap: float = 0.0):
    """q: (B,1,Hq,hd) over cache (B,cap,Hkv,hd) with absolute ``kv_pos``;
    ``gqa_decode``'s ``sdpa_naive`` call with ``q_pos=[pos]``."""
    q_pos = torch.as_tensor(pos, dtype=torch.int32,
                            device=q.device).reshape(1)
    return sdpa_naive(q, k, v, causal=True, window=window, q_pos=q_pos,
                      kv_pos=kv_pos, softcap=softcap)


def gather_pages(leaf, block_row, *, slot_axis: int, page_size: int,
                 positions: bool = False):
    """The pages of ``leaf`` (page axis 0, a page's slots on ``slot_axis``)
    that ``block_row`` ``(max_blocks,)`` names, end to end along the slot
    axis: ``(*lead, max_blocks * ps, *rest)``.  Unmapped pages (id < 0) are
    clamped for the gather; in a ``positions`` leaf (kv_pos) their slots
    read INVALID, so attention masks them whatever the clamped page
    holds."""
    cap = block_row.shape[0] * page_size
    row = block_row.to(torch.int64)
    pages = leaf.index_select(0, row.clamp(0, leaf.shape[0] - 1))
    flat = pages.movedim(0, slot_axis - 1)        # (*lead, mb, ps, *rest)
    flat = flat.reshape(flat.shape[:slot_axis - 1] + (cap,)
                        + flat.shape[slot_axis + 1:])
    if positions:
        valid = (row >= 0).repeat_interleave(page_size)
        flat = torch.where(valid, flat, torch.full_like(flat, _INVALID_POS))
    return flat


def gather_lane(k_pool, v_pool, kv_pos_pool, block_row):
    """One lane's dense cache of one layer from pools ``(NP, ps, Hkv, hd)``
    / ``(NP, ps)`` through its row: k/v ``(1, cap, Hkv, hd)``, kv_pos
    ``(cap,)``, cap = max_blocks * ps."""
    ps = k_pool.shape[1]
    k, v = (gather_pages(t, block_row, slot_axis=1, page_size=ps)[None]
            for t in (k_pool, v_pool))
    return k, v, gather_pages(kv_pos_pool, block_row, slot_axis=1,
                              page_size=ps, positions=True)


def decode_attention_paged_ref(q, k_pool, v_pool, kv_pos_pool, block_table,
                               pos, *, window: int = 0,
                               softcap: float = 0.0):
    """q: (B,1,Hq,hd); pools (NP, ps, Hkv, hd) / (NP, ps); block_table
    (B, max_blocks); pos (B,).  Each lane's cache is gathered through its
    row (``gather_lane``, unmapped pages INVALID) and attended by
    ``sdpa_naive``.  A lane that keeps no slot (inactive: block_table[b, 0]
    < 0) gets zeros, the kernel's defined output; nothing reads it."""
    outs = []
    for b in range(q.shape[0]):
        k, v, kv_pos = gather_lane(k_pool, v_pool, kv_pos_pool,
                                   block_table[b])
        qp = pos[b:b + 1].to(torch.int32)
        keep = kv_pos <= qp
        if window:
            keep &= qp - kv_pos < window
        o = sdpa_naive(q[b:b + 1], k, v, causal=True, window=window,
                       q_pos=qp, kv_pos=kv_pos, softcap=softcap)
        outs.append(torch.where(keep.any(), o, torch.zeros_like(o)))
    return torch.cat(outs)


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
