"""Wrapper of K1, the decode-attention kernel (``csrc/decode_attention.cu``).

On CUDA tensors it launches the kernel or raises; on CPU tensors it runs
the plain version ``decode_attention_ref``.  ``decode_attention.launches``
counts kernel launches (not plain-version calls), and
``decode_attention.launches_by_shape`` tallies them by ``(B, cap, Hq, Hkv,
hd)``, which tells an encoder-decoder's self ring from its cross cache.

The kernel splits each (lane, kv head)'s cache across the CTAs of one
thread-block cluster and merges their partial softmaxes in the same launch;
``split_plan`` chooses the split here, in Python, so the CPU tests reach it.

``decode_attention_paged`` is the serving engine's entry: it reads each
lane's pages in place through its block-table row, with its own plain
version (``decode_attention_paged_ref``) and its own count,
``decode_attention_paged.launches``; ``decode_attention_paged.launches_b1``
counts apart those of its launches that take one lane (B 1, the prefix
cache's ``prefill_chunk``) and ``decode_attention_paged.launches_by_shape``
tallies them all by ``(B, max_blocks)``, which tells replicas of one card
apart (the disaggregated pair's tables are 36 and 37 pages wide).  In bf16 it launches its own kernel
(``decode_paged_kernel``), which splits a lane's table by whole pages;
``paged_plan`` chooses the route and the split from static shapes only.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (F, I, P, check_operands, on_cpu,
                                        raise_on_error, stream_of)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_paged_ref, decode_attention_ref)

HEAD_DIMS = (16, 32, 64, 80, 128, 256)
MAX_GROUP = 16      # csrc/decode_attention.cu: GMAX
MAX_CLUSTER = 16    # csrc/decode_attention.cu: MAX_CLUSTER (non-portable > 8)
CHUNK_GRANULE = 64  # csrc/decode_attention.cu: CHUNK_GRANULE (whole blocks)
MAX_CHUNK = 32768   # csrc/decode_attention.cu: MAX_CHUNK (one keep bit a slot)
BT_STAGE = 1024     # csrc/decode_attention.cu: BT_STAGE (table entries a CTA)
TILE = 16           # csrc/decode_attention.cu: TILE (slots a warp takes at once)
# a table of at most this many tiles (two a warp) takes one CTA and no
# cluster per (lane, kv head): tools/k1p_breakdown.py timed both routes at
# 5 tiles (one CTA faster), 11 and 36 (a cluster faster)
SINGLE_TILES = 8
# a longer table of at most this many tiles takes CTAs of one tile a warp
# (CHUNK_GRANULE slots), a longer one CTAs of two: verify's window (11
# tiles) in 3 CTAs of 4 pages took 5.46 us against 7.01 us in 2 of 8
SHORT_TILES = 12
_ARGTYPES = (P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, I, I, P)
_L = ctypes.c_longlong
_PAGED_ARGTYPES = (P, P, P, P, P, P, P, I, I, I, I, I, I, I, _L, _L, I, F,
                   I, I, P)
_sm_counts: dict = {}


def split_plan(B: int, Hkv: int, cap: int, sm_count: int):
    """(chunk, cluster): CTA r of the cluster of one (lane, kv head) takes
    cache slots [r * chunk, (r + 1) * chunk).  The cluster is as large as
    it takes for the B * Hkv clusters to cover ``sm_count`` SMs, but at
    most ``MAX_CLUSTER`` CTAs and at least ``CHUNK_GRANULE`` slots each;
    every slot lies in exactly one CTA's range."""
    want = -(-sm_count // (B * Hkv))
    cluster = max(1, min(MAX_CLUSTER, want, -(-cap // CHUNK_GRANULE)))
    chunk = -(-cap // cluster)
    chunk = -(-chunk // CHUNK_GRANULE) * CHUNK_GRANULE
    if chunk > MAX_CHUNK:
        raise ValueError(f"decode_attention: cap {cap} needs {chunk} slots "
                         f"per CTA (max {MAX_CHUNK})")
    return chunk, -(-cap // chunk)


def paged_plan(B: int, Hkv: int, max_blocks: int, ps: int,
               dtype: torch.dtype, sm_count: int):
    """(route, chunk, cluster) of the paged entry, from static shapes only
    (never from positions or table contents), so an engine program always
    takes the same route.  CTA r of the cluster of one (lane, kv head)
    takes the table's slots [r * chunk, (r + 1) * chunk).

    bf16 (``decode_paged_kernel``): whole pages, ``chunk = ppc * ps``,
    from the table's width and ``ps`` alone: ``"single"``, a table of at
    most ``SINGLE_TILES`` tiles of ``TILE`` slots takes one CTA and no
    cluster; ``"cluster"``, a longer one takes CTAs of ``CHUNK_GRANULE``
    slots (up to ``SHORT_TILES`` tiles) or ``SINGLE_TILES`` tiles (beyond)
    of whole pages, more only where ``MAX_CLUSTER`` CTAs would not cover the
    table.  A lane's tiles thus fall to the same warps and CTAs and merge
    in the same order whatever the batch, and past the lane's own pages a
    wider table only adds empty CTAs: a lane decodes to the same bits in a
    replica of 2 lanes or of 14, with 36 pages to a row or 37
    (prefill/decode disaggregation moves lanes between such replicas;
    ``B`` is not read, ``Hkv`` and ``sm_count`` size the split of f32
    only).  A CTA stages at most ``BT_STAGE`` table entries.  f32
    (``"slots"``): ``split_plan`` over the table's slots as for one lane,
    so the split, and a lane's bits, do not depend on the batch either
    (split by the batch, a lane's f32 output moved by 1e-7 between 8 and
    14 lanes on the H100: ``tools/batch_invariance.py``)."""
    if dtype != torch.bfloat16:
        chunk, cluster = split_plan(1, Hkv, max_blocks * ps, sm_count)
        if (chunk - 1) // ps + 2 > BT_STAGE:
            raise ValueError(f"decode_attention_paged: {chunk} slots per CTA "
                             f"span more than {BT_STAGE} pages of {ps}")
        return "slots", chunk, cluster
    tiles = -(-max_blocks * ps // TILE)
    if tiles <= SINGLE_TILES:
        return "single", max_blocks * ps, 1
    # whole pages of CHUNK_GRANULE slots (a tile for each of the 4 warps)
    gran = CHUNK_GRANULE // math.gcd(ps, CHUNK_GRANULE)
    per = CHUNK_GRANULE if tiles <= SHORT_TILES else SINGLE_TILES * TILE
    ppc = max(-(-per // ps), -(-max_blocks // MAX_CLUSTER))
    ppc = -(-ppc // gran) * gran
    if ppc > BT_STAGE:
        raise ValueError(f"decode_attention_paged: a table of {max_blocks} "
                         f"pages needs more than {MAX_CLUSTER} CTAs")
    cluster = -(-max_blocks // ppc)
    if cluster == 1:
        return "single", max_blocks * ps, 1
    return "cluster", ppc * ps, cluster


def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raises on q/k/v shapes the kernel does not take."""
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


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos, kv_pos: torch.Tensor, *, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """q: (B, 1, Hq, hd); k/v: (B, cap, Hkv, hd); kv_pos: (cap,) int32
    absolute slot positions (2**30 = unwritten); pos: int or one-element
    int tensor, the query's position.  Returns (B, 1, Hq, hd).

    Per-lane positions: kv_pos (B, cap) and pos (B,), lane b attending
    with its own row and position (lanes of one batch at different
    positions, each its own ring)."""
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor([int(pos)], dtype=torch.int32, device=q.device)
    if on_cpu(q, k, v, kv_pos, pos):
        return decode_attention_ref(q, k, v, pos, kv_pos, window=window,
                                    softcap=softcap)
    check_shapes(q, k, v)
    B, _, Hq, hd = q.shape
    _, cap, Hkv, _ = k.shape
    lanes = kv_pos.dim() == 2
    want = (B, cap) if lanes else (cap,)
    if tuple(kv_pos.shape) != want or kv_pos.dtype != torch.int32 \
            or not kv_pos.is_contiguous():
        raise ValueError(f"decode_attention: kv_pos must be contiguous "
                         f"int32 of shape {want}")
    pos = pos.reshape(-1)
    if pos.numel() != (B if lanes else 1) or pos.dtype != torch.int32 \
            or not pos.is_contiguous():
        raise ValueError(f"decode_attention: pos must be "
                         f"{B if lanes else 1} int32 value(s)")
    code = check_operands("decode_attention", {"q": q, "k": k, "v": v},
                          q.dtype)
    chunk, cluster = split_plan(B, Hkv, cap, sm_count(q.device))
    out = torch.empty_like(q)
    fn = build.load("decode_attention", "decode_attention_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(),
                pos.data_ptr(), out.data_ptr(), code, B, cap, Hq, Hkv, hd,
                int(window), float(softcap), chunk, cluster, int(lanes),
                stream_of(q))
    raise_on_error("decode_attention", rc)
    decode_attention.launches += 1
    by_shape, key = decode_attention.launches_by_shape, (B, cap, Hq, Hkv, hd)
    by_shape[key] = by_shape.get(key, 0) + 1
    return out


decode_attention.launches = 0
decode_attention.launches_by_shape = {}


def _check_page_view(name: str, t: torch.Tensor, inner: tuple,
                     align: int = 16) -> int:
    """Page stride (elements) of one layer's pool view; the page's own
    ``inner`` shape must be contiguous and every page ``align``-byte
    aligned (16 for the k/v rows the kernel copies in 16-byte pieces)."""
    if tuple(t.shape[1:]) != inner:
        raise ValueError(f"decode_attention_paged: {name} has shape "
                         f"{tuple(t.shape)}, expected (NP, *{inner})")
    want, stride = [], 1
    for n in reversed(inner):
        want.insert(0, stride)
        stride *= n
    if list(t.stride()[1:]) != want or t.stride(0) < stride:
        raise ValueError(f"decode_attention_paged: {name} must be "
                         f"contiguous within a page (strides "
                         f"{t.stride()})")
    if t.data_ptr() % align or (t.stride(0) * t.element_size()) % align:
        raise ValueError(f"decode_attention_paged: {name} pages must be "
                         f"{align}-byte aligned")
    return t.stride(0)


def decode_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, kv_pos_pool: torch.Tensor,
                           block_table: torch.Tensor, pos: torch.Tensor, *,
                           window: int = 0,
                           softcap: float = 0.0) -> torch.Tensor:
    """q: (B, 1, Hq, hd); k_pool/v_pool: (NP, ps, Hkv, hd) and kv_pos_pool
    (NP, ps) int32, one layer's views of the stacked pool (pages may lie
    any stride apart); block_table: (B, max_blocks) int32, -1 unmapped;
    pos: (B,) int32, each lane's query position.  Returns (B, 1, Hq, hd):
    lane b attends over the slots of its mapped pages with kv_pos <= pos[b]
    (and within the window); a lane with block_table[b, 0] < 0 gets
    zeros."""
    if on_cpu(q, k_pool, v_pool, kv_pos_pool, block_table, pos):
        return decode_attention_paged_ref(q, k_pool, v_pool, kv_pos_pool,
                                          block_table, pos, window=window,
                                          softcap=softcap)
    if q.dim() != 4 or q.shape[1] != 1 or k_pool.dim() != 4:
        raise ValueError(f"decode_attention_paged: bad shapes q "
                         f"{tuple(q.shape)} k_pool {tuple(k_pool.shape)}")
    B, _, Hq, hd = q.shape
    NP, ps, Hkv, _ = k_pool.shape
    if k_pool.shape[3] != hd or Hq % Hkv or hd not in HEAD_DIMS \
            or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention_paged: q {tuple(q.shape)} and "
                         f"k_pool {tuple(k_pool.shape)}: head dim (allowed "
                         f"{HEAD_DIMS}) or group (max {MAX_GROUP}) not "
                         "supported")
    kv_ps = _check_page_view("k_pool", k_pool, (ps, Hkv, hd))
    if _check_page_view("v_pool", v_pool, (ps, Hkv, hd)) != kv_ps \
            or v_pool.shape[0] != NP:
        raise ValueError("decode_attention_paged: k_pool and v_pool must "
                         "have the same page count and stride")
    if kv_pos_pool.dtype != torch.int32 or kv_pos_pool.shape[0] != NP:
        raise ValueError("decode_attention_paged: kv_pos_pool must be "
                         f"int32 of shape ({NP}, {ps})")
    pos_ps = _check_page_view("kv_pos_pool", kv_pos_pool, (ps,), align=4)
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or block_table.dtype != torch.int32 \
            or not block_table.is_contiguous():
        raise ValueError("decode_attention_paged: block_table must be "
                         f"contiguous int32 of shape ({B}, max_blocks)")
    if pos.shape != (B,) or pos.dtype != torch.int32 \
            or not pos.is_contiguous():
        raise ValueError(f"decode_attention_paged: pos must be contiguous "
                         f"int32 of shape ({B},)")
    code = check_operands("decode_attention_paged", {"q": q}, q.dtype)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != q.dtype:
            raise TypeError(f"decode_attention_paged: {name} has dtype "
                            f"{t.dtype}, expected {q.dtype}")
    max_blocks = block_table.shape[1]
    _, chunk, cluster = paged_plan(B, Hkv, max_blocks, ps, q.dtype,
                                   sm_count(q.device))
    out = torch.empty_like(q)
    fn = build.load("decode_attention", "decode_attention_paged_fwd",
                    _PAGED_ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                kv_pos_pool.data_ptr(), block_table.data_ptr(),
                pos.data_ptr(), out.data_ptr(), code, B, max_blocks, ps, Hq,
                Hkv, hd, kv_ps, pos_ps, int(window), float(softcap), chunk,
                cluster, stream_of(q))
    raise_on_error("decode_attention_paged", rc)
    decode_attention_paged.launches += 1
    if B == 1:
        decode_attention_paged.launches_b1 += 1
    by_shape = decode_attention_paged.launches_by_shape
    by_shape[B, max_blocks] = by_shape.get((B, max_blocks), 0) + 1
    return out


decode_attention_paged.launches = 0
decode_attention_paged.launches_b1 = 0
decode_attention_paged.launches_by_shape = {}
