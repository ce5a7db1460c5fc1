"""Attention: the reference's ``models/attention.py`` on PyTorch, GQA
(+ qk-norm, sliding window, partial RoPE) and MLA.

Three scaled-dot-product implementations, as in the reference:

* ``naive``      materializes (Sq, Skv) scores;
* ``blockwise``  online softmax over KV chunks (flash expressed in PyTorch);
* ``kernel``     the hand-written CUDA kernel K2
                 (``repro_torch.kernels.flash_attention``); on a CPU tensor
                 its wrapper runs the plain version instead.  K2 takes
                 ``hd_v == hd`` only, as the reference's Pallas kernel
                 does: ``sdpa`` refuses other shapes on this route.

Decode writes the new k/v into the ring cache *in place* (``index_copy_``
at slot ``pos % cap``) where the reference built a new array with
``dynamic_update_slice``; the slot and the ``kv_pos`` bookkeeping are the
same.  Callers that need the old cache intact pass a copy.

``gqa_fwd`` is the training forward: full-sequence causal attention on a
plain version, which autograd differentiates.  ``gqa_encode`` is the
encoder-decoder's non-causal encoder attention, on K2 or a plain version.

``gqa_decode_paged`` is the serving engine's decode over the paged pool
(``serve/kvcache.py``): the whole lane batch at once, each lane at its own
position, where the reference vmaps a gather + dense decode per lane.

MLA (DeepSeek-V3) keeps a compressed cache: ``ckv`` (kv_lora) and
``k_pe`` (rope dims) a token.  Its q/k head dim (nope + rope) differs
from its v head dim, so K2 cannot take it: its prefill runs the plain
``blockwise`` path, the reference's default, and its decode is plain
tensor code, as the reference's is (no Pallas kernel).  Decode has the
reference's two forms: ``absorb=True`` folds the decompression matrices
into the query and output projections and attends in latent space (the
default); ``absorb=False`` decompresses the cache every step (the
algebraic definition, the baseline).  ``mla_decode_paged`` is the
engine's decode over a pool of latent pages.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import is_dtensor
from repro_torch.models.layers import (by_rows, cdtype, normal, rmsnorm_1d,
                                       rope_fwd)

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


def head_spec(q, k):
    """The layout attention runs in on a mesh, for (B, S, H, hd) q, k and
    v: the batch over the mesh axes that shard q's batch, the heads over
    ``"model"`` where it divides both q's and k's heads and does not
    shard the batch; the rest replicated.  Each rank then attends its own
    (lane, head) pairs."""
    from repro_torch.sharding.rules import (P, axes_of, axis_names,
                                            axis_sizes, spec_of)

    mesh = q.device_mesh
    b = spec_of(q, strict=False)[0]
    sizes = axis_sizes(mesh)
    h = None
    if ("model" in axis_names(mesh) and "model" not in axes_of(b)
            and q.shape[2] % sizes["model"] == 0
            and k.shape[2] % sizes["model"] == 0):
        h = "model"
    return P(b, None, h, None)


def _sdpa_sharded(q, k, v, impl, kw):
    """``sdpa`` of DTensors in ``shard_map``: every implementation, K2
    (``"kernel"``) among them, runs on each rank's local (lane, head)
    shards (``head_spec``); a kernel wrapper never sees a DTensor."""
    from repro_torch.launch.mesh import shard_map

    spec = head_spec(q, k)
    return shard_map(lambda q, k, v: sdpa(q, k, v, impl=impl, **kw),
                     q.device_mesh, in_specs=(spec, spec, spec),
                     out_specs=spec)(q, k, v)


def sdpa(q, k, v, *, impl="naive", **kw):
    if is_dtensor(q):
        return _sdpa_sharded(q, k, v, impl, kw)
    if impl == "blockwise":
        return sdpa_blockwise(q, k, v, **kw)
    kw.pop("chunk", None)
    if impl == "kernel":
        if v.shape[-1] != q.shape[-1]:
            raise ValueError(
                f"sdpa: the kernel route (K2) takes hd_v == hd, got hd "
                f"{q.shape[-1]} and hd_v {v.shape[-1]} (MLA): run "
                "'blockwise' or 'naive'")
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
    dt = cdtype(cfg)
    hd = cfg.head_dim_
    D, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    s = D ** -0.5
    p = {
        "wq": normal((D, H, hd), s, dt, device, gen, count),
        "wk": normal((D, Hkv, hd), s, dt, device, gen, count),
        "wv": normal((D, Hkv, hd), s, dt, device, gen, count),
        "wo": normal((H, hd, D), (H * hd) ** -0.5, dt, device, gen, count),
    }
    if cfg.qk_norm:
        shape = ((count,) if count else ()) + (hd,)
        p["q_norm"] = torch.ones(shape, dtype=dt, device=device)
        p["k_norm"] = torch.ones(shape, dtype=dt, device=device)
    return p


def _head_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    D, H, hd = w.shape
    w2 = w.reshape(D, H * hd)
    if is_dtensor(w2):
        w2 = _whole_heads(w2, H, 1)
    y = x @ w2
    if is_dtensor(y):
        y = _whole_heads(y, H, y.dim() - 1)
    return y.view(*x.shape[:-1], H, hd)


def _heads_divisible(y, H: int, dim: int):
    """DTensor ``y`` with its dimension ``dim`` (H * hd, heads major)
    replicated where it is sharded over more ranks than divide H: a split
    into (H, hd) needs whole heads on every rank."""
    from torch.distributed.tensor import Replicate, Shard

    n = 1
    for size, pl in zip(y.device_mesh.shape, y.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            n *= size
    if H % n == 0:
        return y
    pls = [Replicate() if isinstance(pl, Shard) and pl.dim == dim else pl
           for pl in y.placements]
    return y.redistribute(y.device_mesh, pls)


class _WholeHeads(torch.autograd.Function):
    """``_heads_divisible`` of a tensor and of its gradient: DTensor's
    backward of a product picks its own layout for the gradient, which
    the gradient of the (H, hd) -> H * hd reshape before it must split."""

    @staticmethod
    def forward(ctx, t, H, dim):
        ctx.H, ctx.dim = H, dim
        return _heads_divisible(t, H, dim)

    @staticmethod
    def backward(ctx, g):
        return _heads_divisible(g, ctx.H, ctx.dim), None, None


def _whole_heads(t, H: int, dim: int):
    return _WholeHeads.apply(t, H, dim)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    H, hd, D = wo.shape
    o2 = out.reshape(*out.shape[:-2], H * hd)
    w2 = wo.reshape(H * hd, D)
    if is_dtensor(w2):
        o2 = _whole_heads(o2, H, o2.dim() - 1)
        w2 = _whole_heads(w2, H, 0)
    return o2 @ w2


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 positions: torch.Tensor):
    q = _head_proj(x, p["wq"])
    k = _head_proj(x, p["wk"])
    v = _head_proj(x, p["wv"])
    if cfg.qk_norm:         # per head, before RoPE
        q = rmsnorm_1d(q, p["q_norm"])
        k = rmsnorm_1d(k, p["k_norm"])
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
    return _gqa_full(cfg, p, x, window=window, causal=causal, impl=impl,
                     positions=positions, chunk=chunk)


def gqa_encode(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
               impl: str) -> torch.Tensor:
    """Full-sequence non-causal attention, no cache: the encoder's self
    attention (positions ``0..S-1``).  ``impl`` "kernel" puts it on K2;
    "naive" and "blockwise" are the plain versions, as in ``gqa_fwd``
    (autograd differentiates them)."""
    return _gqa_full(cfg, p, x, window=None, causal=False, impl=impl,
                     positions=None, chunk=1024)


def _gqa_full(cfg, p, x, *, window, causal, impl, positions, chunk):
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
    if is_dtensor(some):
        return _ring_cache_sharded(entries, S, cap)
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


def _ring_cache_sharded(entries: dict, S: int, cap: int) -> dict:
    """``_ring_cache_from_prefill`` of DTensor (B, S, H, hd) entries in
    ``shard_map`` (each rank fills its own lanes and heads); ``kv_pos``
    is the same on every rank, replicated."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.mesh import shard_map

    names = sorted(entries)
    k = entries["k"] if "k" in entries else entries[names[0]]
    spec = head_spec(k, k)
    mesh = k.device_mesh

    def body(*local):
        out = _ring_cache_from_prefill(dict(zip(names, local)), S, cap)
        return tuple(out[n] for n in names)

    bufs = shard_map(body, mesh, in_specs=(spec,) * len(names),
                     out_specs=(spec,) * len(names))(
        *(entries[n] for n in names))
    out = dict(zip(names, bufs))
    n = min(S, cap)
    pos = torch.arange(S - n, S, dtype=torch.int32, device=k.to_local().device)
    kv_pos = torch.full((cap,), _INVALID_POS, dtype=torch.int32,
                        device=pos.device)
    kv_pos[(pos % cap).long()] = pos
    out["kv_pos"] = DTensor.from_local(kv_pos, mesh,
                                       [Replicate()] * mesh.ndim,
                                       run_check=False)
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
    (within the sliding window, if any).

    Per-lane lanes (the engine's reserved and draft lanes, each its own
    ring at its own position, as the reference vmaps this decode over
    lanes): ``kv_pos`` (B, cap) and pos (B,); lane b writes slot
    ``pos[b] % cap`` of its row."""
    from repro_torch.kernels.decode_attention import ops as da_ops

    cap = cache["k"].shape[1]
    k, v, kv_pos = cache["k"], cache["v"], cache["kv_pos"]
    if is_dtensor(x):
        return _gqa_decode_sharded(cfg, p, x, pos, cache, window=window,
                                   impl=impl)
    if kv_pos.dim() == 2:
        B = x.shape[0]
        positions = pos.reshape(B).to(torch.int32)
        q, k_new, v_new = _project_qkv(cfg, p, x, positions.reshape(B, 1))
        lanes = torch.arange(B, device=x.device)
        slot = positions.long() % cap
        k[lanes, slot] = k_new[:, 0]
        v[lanes, slot] = v_new[:, 0]
        kv_pos[lanes, slot] = positions
    else:
        positions = pos.reshape(1).to(torch.int32)
        q, k_new, v_new = _project_qkv(cfg, p, x, positions)
        slot = positions.long() % cap
        k.index_copy_(1, slot, k_new)
        v.index_copy_(1, slot, v_new)
        kv_pos.index_copy_(0, slot, positions)
    w = cfg.sliding_window if window is None else window
    kw = dict(window=w, softcap=cfg.attn_logit_softcap)
    if impl == "kernel":
        out = da_ops.decode_attention(q, k, v, positions, kv_pos, **kw)
    elif impl == "naive":
        out = da_ops.decode_attention_ref(q, k, v, positions, kv_pos, **kw)
    else:
        raise ValueError(f"unknown decode impl {impl!r}")
    return _out_proj(out, p["wo"]), cache


def _ring_write_local(mesh, s_axes, c, new, slot):
    """In a ``shard_map`` body: write ``new`` (B, 1, ...) at ring slot
    ``slot`` (a 1-element tensor, global) of this rank's shard ``c`` (B,
    cap_l, ...) of a ring cache, in place, and return the cache this rank
    attends over.  A cache whose slots are sharded over ``s_axes`` takes
    the write on the rank that holds the slot, and the shards are then
    all-gathered along the slots."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import axis_group, axis_index

    if not s_axes:
        c.index_copy_(1, slot, new)
        return c
    cap_l = c.shape[1]
    ls = slot - axis_index(mesh, s_axes) * cap_l
    mine = ((ls >= 0) & (ls < cap_l)).reshape((1,) * c.dim())
    ls = ls.clamp(0, cap_l - 1)
    c.index_copy_(1, ls, torch.where(mine, new, c.index_select(1, ls)))
    group = axis_group(mesh, s_axes)
    parts = [torch.empty_like(c) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, c.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def _gqa_decode_sharded(cfg: ModelConfig, p: dict, x, pos, cache: dict, *,
                        window, impl: str):
    """``gqa_decode`` on a mesh: the projections on DTensors, then the
    ring write and the attention (K1 for ``impl="kernel"``) in
    ``shard_map`` on each rank's shards of the cache, in the cache's own
    layout (``ShardingRules.cache_specs``), so the write lands in place.
    A cache sharded over its slots (kv heads that do not divide
    ``"model"``) takes the write on the rank that holds the slot, and each
    rank then all-gathers the layer's k and v over those ranks before it
    attends."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.launch.mesh import shard_map
    from repro_torch.sharding.rules import P, axes_of, spec_of

    k, v, kv_pos = cache["k"], cache["v"], cache["kv_pos"]
    if kv_pos.dim() != 1:
        raise ValueError("per-lane rings run without a mesh")
    cap = k.shape[1]
    pos = pos.to_local() if is_dtensor(pos) else pos
    positions = pos.reshape(1).to(torch.int32)
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
    c_spec = spec_of(k)
    b, s, h = c_spec[0], c_spec[1], c_spec[2]
    s_axes = axes_of(s)
    mesh = k.device_mesh
    w = cfg.sliding_window if window is None else window
    kw = dict(window=w, softcap=cfg.attn_logit_softcap)
    attend = {"kernel": da_ops.decode_attention,
              "naive": da_ops.decode_attention_ref}.get(impl)
    if attend is None:
        raise ValueError(f"unknown decode impl {impl!r}")

    def body(q, k_new, v_new, k, v, kv_pos):
        pl = positions.to(q.device)
        slot = pl.long() % cap
        kv_pos.index_copy_(0, slot, pl)
        k = _ring_write_local(mesh, s_axes, k, k_new, slot)
        v = _ring_write_local(mesh, s_axes, v, v_new, slot)
        return attend(q, k, v, pl, kv_pos, **kw)

    qs = P(b, None, h, None)
    out = shard_map(body, mesh,
                    in_specs=(qs, qs, qs, c_spec, c_spec, P(None)),
                    out_specs=qs)(q, k_new, v_new, k, v, kv_pos)
    return _out_proj(out, p["wo"]), cache


def gqa_decode_paged(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     pos: torch.Tensor, pool: dict, block_table: torch.Tensor,
                     *, write_ok: torch.Tensor | None = None,
                     window: int | None = None, impl: str = "kernel",
                     rows: int | None = None, live: int | None = None):
    """One-token decode of every lane of the engine's batch over the paged
    pool.  x: (B, 1, D); pos: (B,) int32, each lane's position; pool: one
    layer's views ``k``/``v`` (NP + 1, ps, Hkv, hd) and ``kv_pos``
    (NP + 1, ps), page NP the sink; block_table: (B, max_blocks) int32.
    The projections run ``rows`` rows at a time (``layers.by_rows``).
    With ``live``, only the first ``live`` rows are lanes, the rest idle
    padding: the writes and attention run over the lanes alone and the
    idle rows' attention output is zero.

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
    q, k_new, v_new = by_rows(rows, lambda xr, pr: _project_qkv(
        cfg, p, xr, pr), x, pos.reshape(B, 1))
    n = B if live is None else live
    if n < B:
        q, k_new, v_new = q[:n], k_new[:n], v_new[:n]
        pos, block_table = pos[:n], block_table[:n]
        write_ok = None if write_ok is None else write_ok[:n]
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
    if n < B:
        out = torch.cat([out, out.new_zeros((B - n,) + out.shape[1:])])
    return by_rows(rows, lambda o: _out_proj(o, p["wo"]), out)


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


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V3)
# ---------------------------------------------------------------------------

def init_mla(cfg: ModelConfig, device, gen, count: int = 0) -> dict:
    """The reference's keys, shapes and scales; ``count`` stacks that many
    along a new axis 0."""
    m = cfg.mla
    dt = cdtype(cfg)
    D, H = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    s = D ** -0.5
    lead = (count,) if count else ()
    return {
        "wq_a": normal((D, m.q_lora_rank), s, dt, device, gen, count),
        "q_norm": torch.ones(lead + (m.q_lora_rank,), dtype=dt,
                             device=device),
        "wq_b": normal((m.q_lora_rank, H, qk), m.q_lora_rank ** -0.5, dt,
                       device, gen, count),
        "wkv_a": normal((D, m.kv_lora_rank + m.qk_rope_head_dim), s, dt,
                        device, gen, count),
        "kv_norm": torch.ones(lead + (m.kv_lora_rank,), dtype=dt,
                              device=device),
        "wk_b": normal((m.kv_lora_rank, H, m.qk_nope_head_dim),
                       m.kv_lora_rank ** -0.5, dt, device, gen, count),
        "wv_b": normal((m.kv_lora_rank, H, m.v_head_dim),
                       m.kv_lora_rank ** -0.5, dt, device, gen, count),
        "wo": normal((H, m.v_head_dim, D), (H * m.v_head_dim) ** -0.5, dt,
                     device, gen, count),
    }


def _mla_q(cfg: ModelConfig, p: dict, x: torch.Tensor,
           positions: torch.Tensor):
    """(q_nope, q_pe), each (B, S, H, *); q_pe rotated."""
    m = cfg.mla
    cq = rmsnorm_1d(x @ p["wq_a"], p["q_norm"])
    q = _head_proj(cq, p["wq_b"])
    q_pe = rope_fwd(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q[..., :m.qk_nope_head_dim], q_pe


def _mla_latent(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor):
    """(ckv (B, S, kv_lora), k_pe (B, S, rope)): what the cache keeps, the
    rope part rotated as one shared head."""
    m = cfg.mla
    ckv_full = x @ p["wkv_a"]
    ckv = rmsnorm_1d(ckv_full[..., :m.kv_lora_rank], p["kv_norm"])
    k_pe = rope_fwd(ckv_full[..., m.kv_lora_rank:][:, :, None, :],
                    positions, cfg.rope_theta)[:, :, 0, :]
    return ckv, k_pe


def _mla_full(cfg: ModelConfig, p: dict, x: torch.Tensor,
              positions: torch.Tensor, impl: str, chunk: int):
    """Full-sequence MLA in the decompressed form: (out, ckv, k_pe)."""
    B, S, _ = x.shape
    q_nope, q_pe = _mla_q(cfg, p, x, positions)
    ckv, k_pe = _mla_latent(cfg, p, x, positions)
    k_nope = _head_proj(ckv, p["wk_b"])
    v = _head_proj(ckv, p["wv_b"])
    k_pe_h = k_pe[:, :, None, :].expand(B, S, q_pe.shape[2], q_pe.shape[3])
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe_h], dim=-1)
    # sdpa scales by q.shape[-1] ** -0.5 == (qk_nope + qk_rope) ** -0.5
    out = sdpa(q, k, v, impl=impl, causal=True, window=0, q_pos=positions,
               kv_pos=positions, chunk=chunk)
    return _out_proj(out, p["wo"]), ckv, k_pe


def mla_fwd(cfg: ModelConfig, p: dict, x: torch.Tensor, *, positions=None,
            impl: str = "naive", chunk: int = 1024) -> torch.Tensor:
    """Full-sequence MLA (training and prefill math, decompressed form).
    x: (B, S, D), positions ``0..S-1`` unless given.  ``impl`` is a plain
    version ("naive" or "blockwise"; training differentiates "naive")."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    return _mla_full(cfg, p, x, positions, impl, chunk)[0]


def mla_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                impl: str = "blockwise", chunk: int = 1024,
                margin: int = 0):
    """Prefill: returns (out, cache); the cache is a ring of ``S + margin``
    slots holding ``ckv``, ``k_pe`` and each slot's position ``kv_pos``."""
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    out, ckv, k_pe = _mla_full(cfg, p, x, positions, impl, chunk)
    cache = _ring_cache_from_prefill({"ckv": ckv, "k_pe": k_pe}, S,
                                     S + margin)
    return out, cache


def _mla_attend(cfg: ModelConfig, p: dict, q_nope, q_pe, ckv, k_pe, mask,
                absorb: bool) -> torch.Tensor:
    """One query per lane over latent caches.  q_nope/q_pe: (B, 1, H, *);
    ckv (B, S, kv_lora); k_pe (B, S, rope); mask: additive f32 bias
    broadcast to (B, H, S).  Scores in f32, scaled by
    ``(qk_nope + qk_rope) ** -0.5``; probabilities in the working dtype.
    Returns (B, 1, D)."""
    out = _mla_core(cfg, absorb, q_nope, q_pe, ckv, k_pe, mask, p["wk_b"],
                    p["wv_b"])
    return _out_proj(out, p["wo"])


def _mla_core(cfg: ModelConfig, absorb: bool, q_nope, q_pe, ckv, k_pe, mask,
              wk_b, wv_b) -> torch.Tensor:
    """``_mla_attend`` before the output projection: (B, 1, H, v)."""
    m = cfg.mla
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    if absorb:
        # score = (q_nope Wk_b^T) . ckv + q_pe . k_pe: never decompress
        q_lat = torch.einsum("bqhk,rhk->bqhr", q_nope, wk_b)
        s = (torch.einsum("bqhr,bsr->bhqs", q_lat, ckv)
             + torch.einsum("bqhk,bsk->bhqs", q_pe, k_pe)).float()
        s = s[:, :, 0, :] * scale + mask
        probs = torch.softmax(s, dim=-1).to(q_nope.dtype)     # (B, H, S)
        o_lat = torch.einsum("bhs,bsr->bhr", probs, ckv)
        return torch.einsum("bhr,rhk->bhk", o_lat, wv_b)[:, None]
    k_nope = _head_proj(ckv, wk_b)
    v = _head_proj(ckv, wv_b)
    s = (torch.einsum("bqhk,bshk->bhqs", q_nope, k_nope)
         + torch.einsum("bqhk,bsk->bhqs", q_pe, k_pe)).float()
    s = s[:, :, 0, :] * scale + mask
    probs = torch.softmax(s, dim=-1).to(q_nope.dtype)
    return torch.einsum("bhs,bshk->bhk", probs, v)[:, None]


def _keep_bias(kv_pos: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Additive f32 bias of slots at positions <= ``pos`` (0) and the rest
    (NEG_INF)."""
    return torch.where(kv_pos <= pos, 0.0, NEG_INF).to(torch.float32)


def mla_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
               pos: torch.Tensor, cache: dict, *, absorb: bool = True):
    """One-token MLA decode over the compressed cache.  x: (B, 1, D); pos:
    0-d int32 tensor; cache ``ckv`` (B, cap, kv_lora), ``k_pe`` (B, cap,
    rope), ``kv_pos`` (cap,).  Writes the new latent at ring slot
    ``pos % cap`` in place and attends over slots at positions <= pos:
    in latent space (``absorb=True``) or decompressed.  Per-lane rings
    (the engine's reserved and draft lanes): ``kv_pos`` (B, cap) and pos
    (B,), lane b writing slot ``pos[b] % cap`` of its row."""
    ckv, k_pe, kv_pos = cache["ckv"], cache["k_pe"], cache["kv_pos"]
    cap = ckv.shape[1]
    if is_dtensor(x):
        return _mla_decode_sharded(cfg, p, x, pos, cache, absorb=absorb)
    if kv_pos.dim() == 2:
        B = x.shape[0]
        positions = pos.reshape(B).to(torch.int32)
        q_nope, q_pe = _mla_q(cfg, p, x, positions.reshape(B, 1))
        ckv_new, k_pe_new = _mla_latent(cfg, p, x, positions.reshape(B, 1))
        lanes = torch.arange(B, device=x.device)
        slot = positions.long() % cap
        ckv[lanes, slot] = ckv_new[:, 0]
        k_pe[lanes, slot] = k_pe_new[:, 0]
        kv_pos[lanes, slot] = positions
        mask = _keep_bias(kv_pos, positions[:, None])[:, None, :]
    else:
        positions = pos.reshape(1).to(torch.int32)
        q_nope, q_pe = _mla_q(cfg, p, x, positions)
        ckv_new, k_pe_new = _mla_latent(cfg, p, x, positions)
        slot = positions.long() % cap
        ckv.index_copy_(1, slot, ckv_new)
        k_pe.index_copy_(1, slot, k_pe_new)
        kv_pos.index_copy_(0, slot, positions)
        mask = _keep_bias(kv_pos, positions)[None, None, :]
    out = _mla_attend(cfg, p, q_nope, q_pe, ckv, k_pe, mask, absorb)
    return out, cache


def _mla_decode_sharded(cfg: ModelConfig, p: dict, x, pos, cache: dict, *,
                        absorb: bool):
    """``mla_decode`` on a mesh: the projections on DTensors, then the
    ring write and the latent attention in ``shard_map`` on each rank's
    shards of the cache in the cache's own layout (the write lands in
    place; DTensor's ``index_copy_`` may re-lay its target out and write
    a copy, and its einsum fails on a sharded head axis), the heads over
    ``"model"`` where it divides them."""
    from repro_torch.launch.mesh import shard_map
    from repro_torch.sharding.rules import P, axes_of, spec_of

    ckv, k_pe, kv_pos = cache["ckv"], cache["k_pe"], cache["kv_pos"]
    if kv_pos.dim() != 1:
        raise ValueError("per-lane rings run without a mesh")
    cap = ckv.shape[1]
    pos = pos.to_local() if is_dtensor(pos) else pos
    positions = pos.reshape(1).to(torch.int32)
    q_nope, q_pe = _mla_q(cfg, p, x, positions)
    ckv_new, k_pe_new = _mla_latent(cfg, p, x, positions)
    c_spec = spec_of(ckv)
    b, s_axes = c_spec[0], axes_of(c_spec[1])
    mesh = ckv.device_mesh
    qs = head_spec(q_nope, q_nope)
    qs = P(b, None, qs[2] if qs[2] not in axes_of(b) else None, None)
    w = P(None, qs[2], None)
    n = P(b, None, None)

    def body(q_nope, q_pe, ckv_new, k_pe_new, ckv, k_pe, kv_pos, wk_b, wv_b):
        pl = positions.to(q_nope.device)
        slot = pl.long() % cap
        kv_pos.index_copy_(0, slot, pl)
        ckv = _ring_write_local(mesh, s_axes, ckv, ckv_new, slot)
        k_pe = _ring_write_local(mesh, s_axes, k_pe, k_pe_new, slot)
        mask = _keep_bias(kv_pos, pl)[None, None, :]
        return _mla_core(cfg, absorb, q_nope, q_pe, ckv, k_pe, mask, wk_b,
                         wv_b)

    out = shard_map(body, mesh,
                    in_specs=(qs, qs, n, n, c_spec, c_spec, P(None), w, w),
                    out_specs=qs)(q_nope, q_pe, ckv_new, k_pe_new, ckv, k_pe,
                                  kv_pos, p["wk_b"], p["wv_b"])
    return _out_proj(out, p["wo"]), cache


def mla_decode_paged(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     pos: torch.Tensor, pool: dict,
                     block_table: torch.Tensor, *,
                     write_ok: torch.Tensor | None = None,
                     absorb: bool = True):
    """One-token MLA decode of every lane of the engine's batch over the
    paged latent pool: ``gqa_decode_paged``'s contract.  x: (B, 1, D);
    pos: (B,) int32; pool: one layer's views ``ckv`` (NP + 1, ps,
    kv_lora), ``k_pe`` (NP + 1, ps, rope) and ``kv_pos`` (NP + 1, ps),
    page NP the sink; block_table: (B, max_blocks) int32.

    Lane b writes its new latent and position in place at
    ``pool[bt[b, lp], pos[b] % ps]``, ``lp = (pos[b] % cap) // ps``; the
    write goes to the sink instead for an inactive lane (``bt[b, 0] <
    0``), an unmapped page or ``write_ok[b]`` False.  Then every lane
    attends over its own pages, gathered (unmapped pages read INVALID
    positions), in latent space or decompressed (``absorb``), as the
    reference engine's per-lane ``gather_lane_cache`` + ``mla_decode``
    does.  An inactive lane's output is finite and unused."""
    B = x.shape[0]
    ckv_pool, k_pe_pool, kv_pos = pool["ckv"], pool["k_pe"], pool["kv_pos"]
    sink, ps = ckv_pool.shape[0] - 1, ckv_pool.shape[1]
    pos = pos.to(torch.int32)
    q_nope, q_pe = _mla_q(cfg, p, x, pos.reshape(B, 1))
    ckv_new, k_pe_new = _mla_latent(cfg, p, x, pos.reshape(B, 1))
    max_blocks = block_table.shape[1]
    lp = ((pos % (max_blocks * ps)) // ps).long()
    phys = block_table.gather(1, lp[:, None])[:, 0]
    ok = (block_table[:, 0] >= 0) & (phys >= 0)
    if write_ok is not None:
        ok &= write_ok
    phys = torch.where(ok, phys, sink).long()
    off = (pos % ps).long()
    ckv_pool[phys, off] = ckv_new[:, 0]
    k_pe_pool[phys, off] = k_pe_new[:, 0]
    kv_pos[phys, off] = pos
    bt = block_table.long()
    idx = bt.clamp(0, sink)
    cap = max_blocks * ps
    ckv = ckv_pool[idx].reshape(B, cap, ckv_pool.shape[-1])
    k_pe = k_pe_pool[idx].reshape(B, cap, k_pe_pool.shape[-1])
    lane_pos = torch.where((bt >= 0)[..., None], kv_pos[idx],
                           _INVALID_POS).reshape(B, cap)
    mask = _keep_bias(lane_pos, pos[:, None])[:, None, :]
    return _mla_attend(cfg, p, q_nope, q_pe, ckv, k_pe, mask, absorb)


def mla_cache_spec(cfg: ModelConfig, batch: int, max_len: int, *,
                   count: int = 0) -> dict:
    """Cache shapes as meta tensors; ``count > 0`` adds the stacked layer
    axis."""
    m = cfg.mla
    lead = (count,) if count else ()
    meta = torch.device("meta")
    return {
        "ckv": torch.empty(lead + (batch, max_len, m.kv_lora_rank),
                           dtype=cdtype(cfg), device=meta),
        "k_pe": torch.empty(lead + (batch, max_len, m.qk_rope_head_dim),
                            dtype=cdtype(cfg), device=meta),
        "kv_pos": torch.empty(lead + (max_len,), dtype=torch.int32,
                              device=meta),
    }


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, device, *,
                   count: int = 0) -> dict:
    spec = mla_cache_spec(cfg, batch, max_len, count=count)
    out = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
           for k, v in spec.items()}
    out["kv_pos"].fill_(_INVALID_POS)
    return out
