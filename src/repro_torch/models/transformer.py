"""Decoder-only LM composer: the dense, ssm and hybrid families.

As in the reference, an architecture is a list of **segments**, each
``count`` repetitions of a tuple of block specs, with every segment's
parameters and caches stacked along a leading ``count`` axis:

    yi-9b:            [48 x ("attn+mlp",)]
    mamba2:           [48 x ("ssm",)]
    recurrentgemma:   [12 x ("rec+mlp", "rec+mlp", "attn+mlp"),
                       1 x ("rec+mlp", "rec+mlp")]

A Python loop over that axis replaces ``lax.scan``; per-layer parameters
and caches are views into the stacked tensors, so decode's in-place cache
writes (attention ring, SSM state, RG-LRU state, conv windows) land in the
stacked cache.  Training (``mode="train"``, ``lm_loss``) runs the plain
forwards under autograd, each repetition optionally rematerialised in the
backward (``remat="full"``: ``torch.utils.checkpoint``, non-reentrant).
``lm_decode_paged`` is the serving engine's decode over the paged pool
(dense plans), one step for every lane at its own position.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import rglru, ssm
from repro_torch.models.layers import (cross_entropy, embed_fwd, init_embed,
                                       init_mlp, init_norm, lm_head_fwd,
                                       mlp_fwd, norm_fwd)
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


@dataclass(frozen=True)
class BlockSpec:
    mixer: str            # attn | rec | ssm
    ffn: str = "mlp"      # mlp | none
    window: int = 0       # sliding-window for attn mixers (0 = full)
    d_ff: int = 0         # mlp hidden size


@dataclass(frozen=True)
class Segment:
    count: int
    blocks: Tuple[BlockSpec, ...]


def plan_segments(cfg: ModelConfig) -> list[Segment]:
    L = cfg.num_layers
    if cfg.family == "ssm":
        return [Segment(L, (BlockSpec("ssm", "none"),))]
    if cfg.family == "hybrid":
        pat = tuple(
            BlockSpec("rec", "mlp", d_ff=cfg.d_ff) if c == "r"
            else BlockSpec("attn", "mlp", window=cfg.sliding_window,
                           d_ff=cfg.d_ff)
            for c in cfg.rec.block_pattern)
        reps, rem = divmod(L, len(pat))
        segs = [Segment(reps, pat)]
        if rem:
            segs.append(Segment(1, pat[:rem]))
        return segs
    if cfg.family != "dense" or cfg.moe.enabled:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense, ssm, hybrid)")
    return [Segment(L, (BlockSpec(
        "attn", "mlp", window=cfg.sliding_window, d_ff=cfg.d_ff),))]


def _layer(tree, i: int):
    """Views of layer ``i`` of a stacked tree."""
    return tree_map(lambda t: t[i], tree)


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree, one ``unbind`` per leaf (its
    backward stacks the layers' gradients once, where ``n`` indexings
    would each add a full-size zero-padded gradient)."""
    leaves, treedef = tree_flatten(tree)
    cols = [t.unbind(0) for t in leaves]
    return [tree_unflatten(treedef, [c[i] for c in cols]) for i in range(n)]


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------

def init_block(cfg: ModelConfig, spec: BlockSpec, device, gen,
               count: int) -> dict:
    """Parameters of ``count`` stacked blocks of one spec."""
    p = {"norm1": init_norm(cfg, cfg.d_model, device, count)}
    if spec.mixer == "attn":
        p["attn"] = attn.init_gqa(cfg, device, gen, count)
    elif spec.mixer == "rec":
        p["rec"] = rglru.init_rec_block(cfg, device, gen, count)
    elif spec.mixer == "ssm":
        p["ssm"] = ssm.init_ssm_block(cfg, device, gen, count)
    else:
        raise ValueError(f"mixer {spec.mixer!r} is not ported yet")
    if spec.ffn == "mlp":
        p["norm2"] = init_norm(cfg, cfg.d_model, device, count)
        p["mlp"] = init_mlp(cfg, cfg.d_model, spec.d_ff, device, gen, count)
    elif spec.ffn != "none":
        raise ValueError(f"ffn {spec.ffn!r} is not ported yet")
    return p


def block_apply(cfg: ModelConfig, p: dict, spec: BlockSpec, x: torch.Tensor,
                *, mode: str, cache, pos, prefill_impl: str = "kernel",
                decode_impl: str = "kernel", prefill_chunk: int = 1024,
                cache_margin: int = 0):
    """mode: train | prefill | decode. Returns (x, cache); training has no
    cache (None).  ``prefill_impl`` "kernel" puts every mixer's prefill on
    its CUDA kernel (K2, K3, K4); ``decode_impl`` "kernel" puts attention
    decode on K1 (the SSM and RG-LRU steps are plain tensor code).
    Training runs the plain versions only (naive attention, the plain SSD
    and RG-LRU scans): no kernel has a backward."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    h = norm_fwd(cfg, p["norm1"], x)
    new_cache = None
    if spec.mixer == "attn":
        if mode == "train":
            mix = attn.gqa_fwd(cfg, p["attn"], h, window=spec.window)
        elif mode == "prefill":
            mix, new_cache = attn.gqa_prefill(
                cfg, p["attn"], h, window=spec.window, impl=prefill_impl,
                chunk=prefill_chunk, margin=cache_margin)
        else:
            mix, new_cache = attn.gqa_decode(
                cfg, p["attn"], h, pos, cache, window=spec.window,
                impl=decode_impl)
    elif spec.mixer == "rec":
        if mode == "train":
            mix = rglru.rec_block_fwd(cfg, p["rec"], h)
        elif mode == "prefill":
            mix, new_cache = rglru.rec_block_prefill(cfg, p["rec"], h,
                                                     impl=prefill_impl)
        else:
            mix, new_cache = rglru.rec_block_step(cfg, p["rec"], h, cache)
    elif spec.mixer == "ssm":
        if mode == "train":
            mix = ssm.ssm_block_fwd(cfg, p["ssm"], h)
        elif mode == "prefill":
            mix, new_cache = ssm.ssm_block_prefill(cfg, p["ssm"], h,
                                                   impl=prefill_impl)
        else:
            mix, new_cache = ssm.ssm_block_step(cfg, p["ssm"], h, cache)
    else:
        raise ValueError(f"mixer {spec.mixer!r} is not ported yet")
    x = x + mix
    if spec.ffn == "mlp":
        x = x + mlp_fwd(cfg, p["mlp"], norm_fwd(cfg, p["norm2"], x))
    return x, new_cache


def block_cache_spec(cfg: ModelConfig, spec: BlockSpec, batch: int,
                     max_len: int, count: int = 0):
    if spec.mixer == "attn":
        return attn.gqa_cache_spec(cfg, batch, max_len, window=spec.window,
                                   count=count)
    if spec.mixer == "rec":
        return rglru.rec_cache_spec(cfg, batch, count)
    if spec.mixer == "ssm":
        return ssm.ssm_cache_spec(cfg, batch, count)
    raise ValueError(f"mixer {spec.mixer!r} is not ported yet")


# ---------------------------------------------------------------------------
# Segments (a loop over the stacked layer axis)
# ---------------------------------------------------------------------------

def init_segment(cfg: ModelConfig, seg: Segment, device, gen) -> dict:
    return {"blocks": tuple(init_block(cfg, spec, device, gen, seg.count)
                            for spec in seg.blocks)}


def _maybe_remat(fn, remat: str):
    """``remat`` of the reference: "none" keeps every activation for the
    backward, "full" keeps only each repetition's inputs and recomputes
    the rest (non-reentrant ``torch.utils.checkpoint``)."""
    if remat == "none":
        return fn
    if remat == "full":
        from torch.utils.checkpoint import checkpoint

        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if remat == "dots":
        raise NotImplementedError("remat 'dots' is not ported yet")
    raise ValueError(f"unknown remat {remat!r}")


def segment_apply(cfg: ModelConfig, p_stacked: dict, seg: Segment,
                  x: torch.Tensor, *, mode: str, caches=None, pos=None,
                  remat: str = "none", **kw):
    if mode == "train":
        def body(x, rep_p):
            for b, spec in enumerate(seg.blocks):
                x, _ = block_apply(cfg, rep_p["blocks"][b], spec, x,
                                   mode=mode, cache=None, pos=None, **kw)
            return x

        body = _maybe_remat(body, remat)
        for rep_p in _unstack(p_stacked, seg.count):
            x = body(x, rep_p)
        return x, None
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
    return tuple(block_cache_spec(cfg, spec, batch, max_len, seg.count)
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
    """Run all segments over input embeddings h. Returns (h, caches);
    training returns no caches (None)."""
    caches_out = []
    for i, seg in enumerate(plan_segments(cfg)):
        seg_cache = caches[i] if caches is not None else None
        h, c = segment_apply(cfg, params["segments"][i], seg, h, mode=mode,
                             caches=seg_cache, pos=pos, **kw)
        caches_out.append(c)
    h = norm_fwd(cfg, params["final_norm"], h)
    return h, (None if mode == "train" else tuple(caches_out))


def lm_loss(cfg: ModelConfig, params: dict, batch: dict, *,
            remat: str = "none"):
    """batch: tokens (B, S) int, targets (B, S) int, optional loss_mask.
    Returns (loss, {"loss", "aux_loss"}); the ported families have no
    auxiliary loss (zero)."""
    h = embed_fwd(cfg, params["embed"], batch["tokens"])
    h, _ = lm_backbone(cfg, params, h, mode="train", remat=remat)
    logits = lm_head_fwd(cfg, params["embed"], h)
    loss = cross_entropy(logits, batch["targets"], batch.get("loss_mask"))
    return loss, {"loss": loss,
                  "aux_loss": torch.zeros((), dtype=torch.float32,
                                          device=loss.device)}


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


def lm_decode_paged(cfg: ModelConfig, params: dict, token: torch.Tensor,
                    pos: torch.Tensor, pool, block_table: torch.Tensor, *,
                    impl: str = "kernel",
                    write_ok: torch.Tensor | None = None):
    """One decode step of every lane of the serving engine over the paged
    pool (``serve/kvcache.py`` layout: the cache tree with page axis 0 in
    front of each segment's stacked ``count`` axis).  token: (B,) int;
    pos: (B,) int32, each lane's position; block_table: (B, max_blocks)
    int32.  Writes each lane's new k/v into its page in place (see
    ``attention.gqa_decode_paged``) and returns (logits (B, V), pool).
    Attention-only plans only: other mixers have no pages."""
    h = embed_fwd(cfg, params["embed"], token.reshape(-1, 1))
    for si, seg in enumerate(plan_segments(cfg)):
        for i in range(seg.count):
            rep_p = _layer(params["segments"][si], i)
            for b, spec in enumerate(seg.blocks):
                if spec.mixer != "attn":
                    raise ValueError(f"mixer {spec.mixer!r} has no paged "
                                     "decode (its state has no pages)")
                p = rep_p["blocks"][b]
                layer_pool = {k: t[:, i] for k, t in pool[si][b].items()}
                h = h + attn.gqa_decode_paged(
                    cfg, p["attn"], norm_fwd(cfg, p["norm1"], h), pos,
                    layer_pool, block_table, write_ok=write_ok,
                    window=spec.window, impl=impl)
                if spec.ffn == "mlp":
                    h = h + mlp_fwd(cfg, p["mlp"],
                                    norm_fwd(cfg, p["norm2"], h))
    h = norm_fwd(cfg, params["final_norm"], h)
    logits = lm_head_fwd(cfg, params["embed"], h)
    return logits[:, 0, :], pool


def lm_cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    return tuple(segment_cache_specs(cfg, seg, batch, max_len)
                 for seg in plan_segments(cfg))
