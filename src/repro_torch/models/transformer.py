"""Decoder-only LM composer, dense family.

As in the reference, an architecture is a list of **segments**, each
``count`` repetitions of a tuple of block specs, with every segment's
parameters and caches stacked along a leading ``count`` axis.  A Python
loop over that axis replaces ``lax.scan``; per-layer parameters and caches
are views into the stacked tensors, so decode's in-place cache writes land
in the stacked cache.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed_fwd, init_embed, init_mlp,
                                       init_norm, lm_head_fwd, mlp_fwd,
                                       norm_fwd)
from repro_torch.tree import tree_map


@dataclass(frozen=True)
class BlockSpec:
    mixer: str            # attn (the only mixer ported so far)
    ffn: str = "mlp"      # mlp
    window: int = 0       # sliding-window for attn mixers (0 = full)
    d_ff: int = 0         # mlp hidden size


@dataclass(frozen=True)
class Segment:
    count: int
    blocks: Tuple[BlockSpec, ...]


def plan_segments(cfg: ModelConfig) -> list[Segment]:
    if cfg.family != "dense" or cfg.moe.enabled:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")
    return [Segment(cfg.num_layers, (BlockSpec(
        "attn", "mlp", window=cfg.sliding_window, d_ff=cfg.d_ff),))]


def _layer(tree, i: int):
    """Views of layer ``i`` of a stacked tree."""
    return tree_map(lambda t: t[i], tree)


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------

def init_block(cfg: ModelConfig, spec: BlockSpec, device, gen,
               count: int) -> dict:
    """Parameters of ``count`` stacked blocks of one spec."""
    return {
        "norm1": init_norm(cfg, cfg.d_model, device, count),
        "attn": attn.init_gqa(cfg, device, gen, count),
        "norm2": init_norm(cfg, cfg.d_model, device, count),
        "mlp": init_mlp(cfg, cfg.d_model, spec.d_ff, device, gen, count),
    }


def block_apply(cfg: ModelConfig, p: dict, spec: BlockSpec, x: torch.Tensor,
                *, mode: str, cache, pos, prefill_impl: str,
                decode_impl: str, prefill_chunk: int, cache_margin: int):
    """mode: prefill | decode. Returns (x, cache)."""
    h = norm_fwd(cfg, p["norm1"], x)
    if mode == "prefill":
        mix, new_cache = attn.gqa_prefill(
            cfg, p["attn"], h, window=spec.window, impl=prefill_impl,
            chunk=prefill_chunk, margin=cache_margin)
    elif mode == "decode":
        mix, new_cache = attn.gqa_decode(
            cfg, p["attn"], h, pos, cache, window=spec.window,
            impl=decode_impl)
    else:
        raise ValueError(f"mode {mode!r} is not ported yet")
    x = x + mix
    x = x + mlp_fwd(cfg, p["mlp"], norm_fwd(cfg, p["norm2"], x))
    return x, new_cache


# ---------------------------------------------------------------------------
# Segments (a loop over the stacked layer axis)
# ---------------------------------------------------------------------------

def init_segment(cfg: ModelConfig, seg: Segment, device, gen) -> dict:
    return {"blocks": tuple(init_block(cfg, spec, device, gen, seg.count)
                            for spec in seg.blocks)}


def segment_apply(cfg: ModelConfig, p_stacked: dict, seg: Segment,
                  x: torch.Tensor, *, mode: str, caches=None, pos=None,
                  **kw):
    if mode == "prefill":
        per_block = [[] for _ in seg.blocks]
        for i in range(seg.count):
            rep_p = _layer(p_stacked, i)
            for b, spec in enumerate(seg.blocks):
                x, c = block_apply(cfg, rep_p["blocks"][b], spec, x,
                                   mode=mode, cache=None, pos=None, **kw)
                per_block[b].append(c)
        stacked = tuple(tree_map(lambda *xs: torch.stack(xs), cs[0], *cs[1:])
                        for cs in per_block)
        return x, stacked
    for i in range(seg.count):
        rep_p, rep_cache = _layer(p_stacked, i), _layer(caches, i)
        for b, spec in enumerate(seg.blocks):
            x, _ = block_apply(cfg, rep_p["blocks"][b], spec, x, mode=mode,
                               cache=rep_cache[b], pos=pos, **kw)
    return x, caches


def segment_cache_specs(cfg: ModelConfig, seg: Segment, batch: int,
                        max_len: int):
    return tuple(attn.gqa_cache_spec(cfg, batch, max_len,
                                     window=spec.window, count=seg.count)
                 for spec in seg.blocks)


# ---------------------------------------------------------------------------
# Full decoder-only LM
# ---------------------------------------------------------------------------

def init_lm(cfg: ModelConfig, seed: int, device="cuda") -> dict:
    """Parameters on ``device`` from a ``torch.Generator`` seeded by
    ``seed`` (``device="meta"`` gives the shapes only)."""
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(int(seed)))
    return {
        "embed": init_embed(cfg, dev, gen),
        "segments": tuple(init_segment(cfg, seg, dev, gen)
                          for seg in plan_segments(cfg)),
        "final_norm": init_norm(cfg, cfg.d_model, dev),
    }


def lm_backbone(cfg: ModelConfig, params: dict, h: torch.Tensor, *,
                mode: str, caches=None, pos=None, **kw):
    """Run all segments over input embeddings h. Returns (h, caches)."""
    caches_out = []
    for i, seg in enumerate(plan_segments(cfg)):
        seg_cache = caches[i] if caches is not None else None
        h, c = segment_apply(cfg, params["segments"][i], seg, h, mode=mode,
                             caches=seg_cache, pos=pos, **kw)
        caches_out.append(c)
    return norm_fwd(cfg, params["final_norm"], h), tuple(caches_out)


def lm_prefill(cfg: ModelConfig, params: dict, batch: dict, *,
               impl: str = "kernel", prefill_chunk: int = 1024,
               cache_margin: int = 0):
    """Returns (last-token logits (B, V), caches)."""
    h = embed_fwd(cfg, params["embed"], batch["tokens"])
    h, caches = lm_backbone(cfg, params, h, mode="prefill",
                            prefill_impl=impl, decode_impl="kernel",
                            prefill_chunk=prefill_chunk,
                            cache_margin=cache_margin)
    logits = lm_head_fwd(cfg, params["embed"], h[:, -1:, :])
    return logits[:, 0, :], caches


def lm_decode(cfg: ModelConfig, params: dict, token: torch.Tensor, pos,
              caches, *, impl: str = "kernel", inplace: bool = False):
    """token: (B,) int; pos: int or 0-d int tensor. Returns (logits,
    caches).  ``inplace=True`` writes the new entries into ``caches``
    itself (the monitor's donated buffers); otherwise a copy is updated."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=token.device)
    if not inplace:
        caches = tree_map(torch.clone, caches)
    h = embed_fwd(cfg, params["embed"], token[:, None])
    h, caches = lm_backbone(cfg, params, h, mode="decode", caches=caches,
                            pos=pos, prefill_impl="kernel", decode_impl=impl,
                            prefill_chunk=0, cache_margin=0)
    logits = lm_head_fwd(cfg, params["embed"], h)
    return logits[:, 0, :], caches


def lm_cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    return tuple(segment_cache_specs(cfg, seg, batch, max_len)
                 for seg in plan_segments(cfg))
