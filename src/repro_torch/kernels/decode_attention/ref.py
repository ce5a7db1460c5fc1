"""Plain PyTorch versions of K1 (the decode-attention kernel).

``decode_attention_ref`` is the plain version the wrapper runs on the CPU
and the kernel is held against.  ``decode_attention_split_ref`` mirrors the
kernel's split-and-merge arithmetic step by step (per-CTA slot ranges,
wholly masked blocks skipped, online softmax per block, the merge over the
cluster in rank order); only tests use it, never the main path.

``decode_attention_paged_ref`` is the plain version of the paged entry:
each lane's pages gathered through its block-table row (``gather_pages``,
the primitive under ``serve/kvcache.py:gather_lane_cache``), then
``sdpa_naive``.  ``decode_attention_paged_split_ref`` mirrors the bf16
paged kernel's split (pages per CTA, tiles per warp) and merge order, for
the tests only.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import _INVALID_POS, sdpa_naive


def decode_attention_ref(q, k, v, pos, kv_pos, *, window: int = 0,
                         softcap: float = 0.0):
    """q: (B,1,Hq,hd) over cache (B,cap,Hkv,hd) with absolute ``kv_pos``;
    ``gqa_decode``'s ``sdpa_naive`` call with ``q_pos=[pos]``.  With
    per-lane positions (``kv_pos`` (B, cap), ``pos`` (B,)) each lane is
    that call at batch 1 on its own row, as the reference vmaps the dense
    decode over its lanes."""
    q_pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    if kv_pos.dim() == 2:
        q_pos = q_pos.reshape(-1)
        return torch.cat([
            sdpa_naive(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=True,
                       window=window, q_pos=q_pos[b:b + 1],
                       kv_pos=kv_pos[b], softcap=softcap)
            for b in range(q.shape[0])])
    return sdpa_naive(q, k, v, causal=True, window=window,
                      q_pos=q_pos.reshape(1), kv_pos=kv_pos,
                      softcap=softcap)


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
    active = (block_table[:, 0] >= 0).tolist()
    for b in range(q.shape[0]):
        if not active[b]:
            outs.append(torch.zeros_like(q[b:b + 1]))
            continue
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


def decode_attention_paged_split_ref(q, k_pool, v_pool, kv_pos_pool,
                                     block_table, pos, *, chunk: int,
                                     cluster: int, window: int = 0,
                                     softcap: float = 0.0, tile: int = 16,
                                     warps: int = 4):
    """The bf16 paged kernel's arithmetic in f32 (``paged_plan``'s
    ``chunk`` and ``cluster``): CTA r of a (lane, kv head) takes the pages
    [r * ppc, (r + 1) * ppc) of the lane's row (ppc = chunk / ps); its warp
    w the ``tile``-slot tiles w, w + ``warps``, ... of them, a tile read
    when any of its pages is mapped.  Each warp keeps its own (m, l, acc)
    over its tiles (online softmax per tile, masked by kv_pos, p rounded to
    q's dtype before p.v); the warps merge in warp order into the CTA's
    partial, the CTAs in rank order, each with weight exp(m - max m), 0 for
    m = -inf.  A lane with block_table[b, 0] < 0 reads nothing: zeros."""
    B, _, Hq, hd = q.shape
    ps, Hkv = k_pool.shape[1], k_pool.shape[2]
    G, mb = Hq // Hkv, block_table.shape[1]
    ppc = chunk // ps
    f32, inf = torch.float32, float("inf")

    def merge(parts):                   # [(m, l, acc)] in order
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        Ms = torch.where(M == -inf, 0.0, M)
        L, O = torch.zeros_like(M), torch.zeros_like(parts[0][2])
        for m, l, acc in parts:
            w = torch.where(m == -inf, 0.0, torch.exp(m - Ms))
            L = L + w * l
            O = O + w[..., None] * acc
        return M, L, O

    outs = []
    for b in range(B):
        row = block_table[b]
        k, v, kv_pos = gather_lane(k_pool, v_pool, kv_pos_pool, row)
        k, v = k[0].to(f32), v[0].to(f32)          # (cap, Hkv, hd)
        p = int(pos[b])
        keep = kv_pos <= p
        if window:
            keep &= p - kv_pos < window
        qg = q[b, 0].reshape(Hkv, G, hd).to(f32)
        ctas = []
        for r in range(cluster):
            lp0 = r * ppc
            nslot = max(0, min(mb - lp0, ppc)) * ps
            ntiles = -(-nslot // tile) if int(row[0]) >= 0 else 0
            parts = []
            for w in range(warps):
                m = torch.full((Hkv, G), -inf, dtype=f32)
                l = torch.zeros((Hkv, G), dtype=f32)
                acc = torch.zeros((Hkv, G, hd), dtype=f32)
                for c in range(w, ntiles, warps):
                    j0 = lp0 * ps + c * tile
                    j1 = lp0 * ps + min(nslot, (c + 1) * tile)
                    if not bool((row[j0 // ps:(j1 - 1) // ps + 1] >= 0)
                                .any()):        # never loaded
                        continue
                    s = torch.einsum("kgh,nkh->kgn", qg, k[j0:j1]) \
                        * hd ** -0.5
                    if softcap:
                        s = softcap * torch.tanh(s / softcap)
                    s = s.masked_fill(~keep[j0:j1], -inf)
                    m_new = torch.maximum(m, s.amax(-1))
                    m_safe = torch.where(m_new == -inf, 0.0, m_new)
                    alpha = torch.exp(m - m_safe)
                    pr = torch.exp(s - m_safe[..., None])
                    l = l * alpha + pr.sum(-1)
                    acc = acc * alpha[..., None] + torch.einsum(
                        "kgn,nkh->kgh", pr.to(q.dtype).to(f32), v[j0:j1])
                    m = m_new
                parts.append((m, l, acc))
            ctas.append(merge(parts))
        _, L, O = merge(ctas)
        out = torch.where(L[..., None] > 0,
                          O / L.clamp_min(1e-30)[..., None], 0.0)
        outs.append(out.reshape(1, 1, Hq, hd))
    return torch.cat(outs).to(q.dtype)
