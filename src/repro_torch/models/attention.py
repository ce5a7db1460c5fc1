"""Attention: the GQA half of the reference's ``models/attention.py``.

Three scaled-dot-product implementations, as in the reference:

* ``naive``      materializes (Sq, Skv) scores;
* ``blockwise``  online softmax over KV chunks (flash expressed in PyTorch);
* ``kernel``     the hand-written CUDA kernel K2
                 (``repro_torch.kernels.flash_attention``); on a CPU tensor
                 its wrapper runs the plain version instead.

Decode writes the new k/v into the ring cache *in place* (``index_copy_``
at slot ``pos % cap``) where the reference built a new array with
``dynamic_update_slice``; the slot and the ``kv_pos`` bookkeeping are the
same.  Callers that need the old cache intact pass a copy.

``gqa_fwd`` is the training forward: full-sequence causal attention on a
plain version, which autograd differentiates.

``gqa_decode_paged`` is the serving engine's decode over the paged pool
(``serve/kvcache.py``): the whole lane batch at once, each lane at its own
position, where the reference vmaps a gather + dense decode per lane.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import cdtype, normal, rope_fwd

NEG_INF = -1e30
_INVALID_POS = 2**30  # masked-out slot sentinel (kv_pos > q_pos)


# ---------------------------------------------------------------------------
# Scaled dot-product attention cores
# ---------------------------------------------------------------------------

def _mask_bias(q_pos, kv_pos, *, causal: bool, window: int):
    """(…, Sq, Skv) additive bias in f32."""
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    keep = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                      dtype=torch.bool, device=qp.device)
    if causal:
        keep &= kp <= qp
    if window:
        keep &= qp - kp < window
    return torch.where(keep, 0.0, NEG_INF).to(torch.float32)


def sdpa_naive(q, k, v, *, causal=True, window=0, q_pos=None, kv_pos=None,
               softcap: float = 0.0):
    """q: (B,Sq,Hq,hd); k: (B,Skv,Hkv,hd); v: (B,Skv,Hkv,hd_v).
    Returns (B,Sq,Hq,hd_v)."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    hd_v = v.shape[-1]
    G = Hq // Hkv
    if q_pos is None:
        q_pos = torch.arange(Sq, device=q.device)
    if kv_pos is None:
        kv_pos = torch.arange(k.shape[1], device=q.device)
    qg = q.reshape(B, Sq, Hkv, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).to(torch.float32)
    scores = scores * hd ** -0.5
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    scores = scores + _mask_bias(q_pos, kv_pos, causal=causal, window=window)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, Hq, hd_v)


def sdpa_blockwise(q, k, v, *, causal=True, window=0, q_pos=None, kv_pos=None,
                   chunk: int = 1024, softcap: float = 0.0):
    """Online-softmax attention, looping over KV in chunks."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    G = Hq // Hkv
    chunk = min(chunk, Skv)
    if Skv % chunk:
        raise ValueError(f"Skv={Skv} is not a multiple of chunk={chunk}")
    if q_pos is None:
        q_pos = torch.arange(Sq, device=q.device)
    if kv_pos is None:
        kv_pos = torch.arange(Skv, device=q.device)

    qf = q.reshape(B, Sq, Hkv, G, hd)
    f32 = torch.float32
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=f32, device=q.device)
    acc = torch.zeros((B, Sq, Hkv, G, hd_v), dtype=f32, device=q.device)
    for c0 in range(0, Skv, chunk):
        kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        kp = kv_pos[c0:c0 + chunk]
        s = torch.einsum("bqkgh,bckh->bkgqc", qf, kc).to(f32) * hd ** -0.5
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        s = s + _mask_bias(q_pos, kp, causal=causal, window=window)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1)
        pv = torch.einsum("bkgqc,bckh->bqkgh", p.to(q.dtype), vc).to(f32)
        acc = acc * scale.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return out.to(q.dtype).reshape(B, Sq, Hq, hd_v)


def sdpa(q, k, v, *, impl="naive", **kw):
    if impl == "blockwise":
        return sdpa_blockwise(q, k, v, **kw)
    kw.pop("chunk", None)
    if impl == "kernel":
        from repro_torch.kernels.flash_attention import ops as fa_ops

        # the kernel assumes contiguous [0, S) positions, as the reference's
        del kw["q_pos"], kw["kv_pos"]
        return fa_ops.flash_attention(q, k, v, **kw)
    if impl == "naive":
        return sdpa_naive(q, k, v, **kw)
    raise ValueError(f"unknown sdpa impl {impl!r}")


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

def init_gqa(cfg: ModelConfig, device, gen, count: int = 0) -> dict:
    if cfg.qk_norm:
        raise NotImplementedError("qk-norm is not ported yet")
    dt = cdtype(cfg)
    hd = cfg.head_dim_
    D, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    s = D ** -0.5
    return {
        "wq": normal((D, H, hd), s, dt, device, gen, count),
        "wk": normal((D, Hkv, hd), s, dt, device, gen, count),
        "wv": normal((D, Hkv, hd), s, dt, device, gen, count),
        "wo": normal((H, hd, D), (H * hd) ** -0.5, dt, device, gen, count),
    }


def _head_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    D, H, hd = w.shape
    return (x @ w.reshape(D, H * hd)).view(*x.shape[:-1], H, hd)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    H, hd, D = wo.shape
    return out.reshape(*out.shape[:-2], H * hd) @ wo.reshape(H * hd, D)


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 positions: torch.Tensor):
    q = _head_proj(x, p["wq"])
    k = _head_proj(x, p["wk"])
    v = _head_proj(x, p["wv"])
    q = rope_fwd(q, positions, cfg.rope_theta, cfg.rope_pct)
    k = rope_fwd(k, positions, cfg.rope_theta, cfg.rope_pct)
    return q, k, v


def gqa_fwd(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
            window: int | None = None, causal: bool = True,
            impl: str = "naive", positions=None,
            chunk: int = 1024) -> torch.Tensor:
    """Full-sequence attention for training. x: (B, S, D), positions
    ``0..S-1`` unless given.  ``impl`` is a plain version ("naive" or
    "blockwise"), differentiable by autograd; the kernels have no
    backward, so K2 is refused here."""
    if impl not in ("naive", "blockwise"):
        raise ValueError(f"gqa_fwd: impl {impl!r} has no backward "
                         "(training runs the plain versions)")
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions)
    w = cfg.sliding_window if window is None else window
    out = sdpa(q, k, v, impl=impl, causal=causal, window=w,
               q_pos=positions, kv_pos=positions, chunk=chunk,
               softcap=cfg.attn_logit_softcap)
    return _out_proj(out, p["wo"])


def _ring_cache_from_prefill(entries: dict, S: int, cap: int) -> dict:
    """Place prefill entries at ring slots ``pos % cap`` so subsequent decode
    writes (slot = pos % cap) evict oldest-first; unfilled slots get the
    INVALID sentinel."""
    n = min(S, cap)
    some = next(iter(entries.values()))
    pos = torch.arange(S - n, S, dtype=torch.int32, device=some.device)
    idx = (pos % cap).long()
    out = {}
    for name, arr in entries.items():
        buf = torch.zeros((arr.shape[0], cap) + tuple(arr.shape[2:]),
                          dtype=arr.dtype, device=arr.device)
        buf[:, idx] = arr[:, S - n:]
        out[name] = buf
    kv_pos = torch.full((cap,), _INVALID_POS, dtype=torch.int32,
                        device=some.device)
    kv_pos[idx] = pos
    out["kv_pos"] = kv_pos
    return out


def gqa_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                window: int | None = None, impl: str = "kernel",
                chunk: int = 1024, margin: int = 0):
    """Prefill: returns (out, cache); the cache is a ring buffer of capacity
    ``min(S + margin, window or inf)`` with each slot's absolute position in
    ``kv_pos``."""
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions)
    w = cfg.sliding_window if window is None else window
    out = sdpa(q, k, v, impl=impl, causal=True, window=w,
               q_pos=positions, kv_pos=positions, chunk=chunk,
               softcap=cfg.attn_logit_softcap)
    cap = min(S + margin, w) if w else S + margin
    cache = _ring_cache_from_prefill({"k": k, "v": v}, S, cap)
    return _out_proj(out, p["wo"]), cache


def gqa_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
               pos: torch.Tensor, cache: dict, *, window: int | None = None,
               impl: str = "kernel"):
    """One-token decode. x: (B, 1, D); pos: 0-d int32 tensor; cache k/v:
    (B, cap, Hkv, hd).  Writes the new k/v at ring slot ``pos % cap`` of
    ``cache`` in place and attends over cached absolute positions <= pos
    (within the sliding window, if any)."""
    cap = cache["k"].shape[1]
    positions = pos.reshape(1).to(torch.int32)
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
    slot = positions.long() % cap
    k, v, kv_pos = cache["k"], cache["v"], cache["kv_pos"]
    k.index_copy_(1, slot, k_new)
    v.index_copy_(1, slot, v_new)
    kv_pos.index_copy_(0, slot, positions)
    w = cfg.sliding_window if window is None else window
    if impl == "kernel":
        from repro_torch.kernels.decode_attention import ops as da_ops

        out = da_ops.decode_attention(q, k, v, positions, kv_pos, window=w,
                                      softcap=cfg.attn_logit_softcap)
    elif impl == "naive":
        out = sdpa_naive(q, k, v, causal=True, window=w, q_pos=positions,
                         kv_pos=kv_pos, softcap=cfg.attn_logit_softcap)
    else:
        raise ValueError(f"unknown decode impl {impl!r}")
    return _out_proj(out, p["wo"]), cache


def gqa_decode_paged(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     pos: torch.Tensor, pool: dict, block_table: torch.Tensor,
                     *, write_ok: torch.Tensor | None = None,
                     window: int | None = None, impl: str = "kernel"):
    """One-token decode of every lane of the engine's batch over the paged
    pool.  x: (B, 1, D); pos: (B,) int32, each lane's position; pool: one
    layer's views ``k``/``v`` (NP + 1, ps, Hkv, hd) and ``kv_pos``
    (NP + 1, ps), page NP the sink; block_table: (B, max_blocks) int32.

    Lane b writes its new k, v and position in place at
    ``pool[bt[b, lp], pos[b] % ps]``, ``lp = (pos[b] % cap) // ps`` with
    ``cap = max_blocks * ps``; the write goes to the sink instead where
    ``bt[b, 0] < 0`` (inactive lane), ``bt[b, lp] < 0`` (unmapped page) or
    ``write_ok[b]`` is False.  Then every lane attends over its own pages:
    K1's paged entry (``impl="kernel"``) or gather + ``sdpa_naive``
    (``impl="naive"``)."""
    from repro_torch.kernels.decode_attention import ops as da_ops

    B = x.shape[0]
    k_pool, v_pool, kv_pos = pool["k"], pool["v"], pool["kv_pos"]
    sink, ps = k_pool.shape[0] - 1, k_pool.shape[1]
    pos = pos.to(torch.int32)
    q, k_new, v_new = _project_qkv(cfg, p, x, pos.reshape(B, 1))
    lp = ((pos % (block_table.shape[1] * ps)) // ps).long()
    phys = block_table.gather(1, lp[:, None])[:, 0]
    ok = (block_table[:, 0] >= 0) & (phys >= 0)
    if write_ok is not None:
        ok &= write_ok
    phys = torch.where(ok, phys, sink).long()
    off = (pos % ps).long()
    k_pool[phys, off] = k_new[:, 0]
    v_pool[phys, off] = v_new[:, 0]
    kv_pos[phys, off] = pos
    w = cfg.sliding_window if window is None else window
    kw = dict(window=w, softcap=cfg.attn_logit_softcap)
    if impl == "kernel":
        out = da_ops.decode_attention_paged(q, k_pool, v_pool, kv_pos,
                                            block_table, pos, **kw)
    elif impl == "naive":
        out = da_ops.decode_attention_paged_ref(q, k_pool, v_pool, kv_pos,
                                                block_table, pos, **kw)
    else:
        raise ValueError(f"unknown decode impl {impl!r}")
    return _out_proj(out, p["wo"])


def gqa_cache_spec(cfg: ModelConfig, batch: int, max_len: int, *,
                   window: int | None = None, count: int = 0) -> dict:
    """Cache shapes as meta tensors (window-bounded for sliding windows);
    ``count > 0`` adds the stacked layer axis."""
    w = cfg.sliding_window if window is None else window
    cap = min(max_len, w) if w else max_len
    lead = (count,) if count else ()
    shp = lead + (batch, cap, cfg.num_kv_heads, cfg.head_dim_)
    meta = torch.device("meta")
    return {
        "k": torch.empty(shp, dtype=cdtype(cfg), device=meta),
        "v": torch.empty(shp, dtype=cdtype(cfg), device=meta),
        "kv_pos": torch.empty(lead + (cap,), dtype=torch.int32, device=meta),
    }


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int, device, *,
                   window: int | None = None, count: int = 0) -> dict:
    spec = gqa_cache_spec(cfg, batch, max_len, window=window, count=count)
    out = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
           for k, v in spec.items()}
    out["kv_pos"].fill_(_INVALID_POS)
    return out
