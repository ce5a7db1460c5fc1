"""Decoder-only LM composer: the dense, vlm, moe, ssm and hybrid families.

As in the reference, an architecture is a list of **segments**, each
``count`` repetitions of a tuple of block specs, with every segment's
parameters and caches stacked along a leading ``count`` axis:

    yi-9b:            [48 x ("attn+mlp",)]
    qwen3-8b:         [36 x ("attn+mlp",)]     (qk-norm in attn)
    stablelm-3b:      [32 x ("attn+mlp",)]     (LayerNorm, rotary on a
                                                quarter of hd 80)
    starcoder2-15b:   [40 x ("attn+mlp",)]     (LayerNorm, GELU mlp)
    llava-next-mistral-7b: [32 x ("attn+mlp",)]  (vlm: image
                                                embeddings in front)
    deepseek-moe-16b: [1 x ("attn+mlp",), 27 x ("attn+moe",)]
    deepseek-v3:      [3 x ("mla+mlp",), 58 x ("mla+moe",)]
    mamba2:           [48 x ("ssm",)]
    recurrentgemma:   [12 x ("rec+mlp", "rec+mlp", "attn+mlp"),
                       1 x ("rec+mlp", "rec+mlp")]

A Python loop over that axis replaces ``lax.scan``; per-layer parameters
and caches are views into the stacked tensors, so decode's in-place cache
writes (attention ring, SSM state, RG-LRU state, conv windows) land in the
stacked cache.  Training (``mode="train"``, ``lm_loss``) runs the plain
forwards under autograd, each repetition optionally rematerialised in the
backward (``remat="full"``: ``torch.utils.checkpoint``, non-reentrant;
``"dots"``: the same, keeping the weight projections' outputs),
and sums the MoE blocks' aux losses into ``lm_loss``'s total.
``lm_decode_paged`` is the serving engine's decode over the paged pool
(attention and MLA plans), one step for every lane at its own position.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import is_dtensor
from repro_torch.models import attention as attn
from repro_torch.models import rglru, ssm
from repro_torch.models.layers import (by_rows, cross_entropy, embed_fwd,
                                       init_embed, init_mlp, init_norm,
                                       lm_head_fwd, mlp_fwd, norm_fwd,
                                       shard_batch_dim, shard_logits)
from repro_torch.models.moe import init_moe, moe_fwd
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


@dataclass(frozen=True)
class BlockSpec:
    mixer: str            # attn | mla | rec | ssm
    ffn: str = "mlp"      # mlp | moe | none
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
    if cfg.moe.enabled:
        mixer = "mla" if cfg.mla.enabled else "attn"
        segs = []
        nd = cfg.moe.n_dense_layers
        if nd:
            segs.append(Segment(nd, (BlockSpec(
                mixer, "mlp", d_ff=cfg.moe.dense_d_ff),)))
        segs.append(Segment(L - nd, (BlockSpec(mixer, "moe"),)))
        return segs
    if cfg.family == "encdec":
        raise ValueError(f"{cfg.name}: the encoder-decoder is not a "
                         "decoder-only plan; its model is models/encdec.py")
    # dense / vlm
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
    elif spec.mixer == "mla":
        p["attn"] = attn.init_mla(cfg, device, gen, count)
    elif spec.mixer == "rec":
        p["rec"] = rglru.init_rec_block(cfg, device, gen, count)
    elif spec.mixer == "ssm":
        p["ssm"] = ssm.init_ssm_block(cfg, device, gen, count)
    else:
        raise ValueError(f"mixer {spec.mixer!r} is not ported yet")
    if spec.ffn != "none":
        p["norm2"] = init_norm(cfg, cfg.d_model, device, count)
        if spec.ffn == "mlp":
            p["mlp"] = init_mlp(cfg, cfg.d_model, spec.d_ff, device, gen,
                                count)
        elif spec.ffn == "moe":
            p["moe"] = init_moe(cfg, device, gen, count)
        else:
            raise ValueError(f"ffn {spec.ffn!r} is not ported yet")
    return p


def block_apply(cfg: ModelConfig, p: dict, spec: BlockSpec, x: torch.Tensor,
                *, mode: str, cache, pos, prefill_impl: str = "kernel",
                decode_impl: str = "kernel", prefill_chunk: int = 1024,
                cache_margin: int = 0, mla_absorb: bool = True, mesh=None,
                dp_axes: Tuple[str, ...] = ()):
    """mode: train | prefill | decode. Returns (x, aux, cache): ``aux`` is
    an MoE block's aux loss in training, else None; training has no cache
    (None).  ``prefill_impl`` "kernel" puts every mixer's prefill on
    its CUDA kernel (K2, K3, K4); ``decode_impl`` "kernel" puts attention
    decode on K1 (the SSM and RG-LRU steps are plain tensor code).  MLA
    has no kernel (K2 takes hd_v == hd only): its "kernel" prefill is the
    reference's default, ``blockwise``, and its decode is plain tensor
    code in the form ``mla_absorb`` picks.
    Training runs the plain versions only (naive attention, the plain SSD
    and RG-LRU scans): no kernel has a backward.  ``mesh`` (DTensor
    parameters and activations) puts an MoE block on its expert-parallel
    dispatch (``cfg.moe_dispatch``) over ``dp_axes``."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    x = shard_batch_dim(x, mesh, dp_axes)
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
    elif spec.mixer == "mla":
        if mode == "train":
            mix = attn.mla_fwd(cfg, p["attn"], h)
        elif mode == "prefill":
            mix, new_cache = attn.mla_prefill(
                cfg, p["attn"], h,
                impl="blockwise" if prefill_impl == "kernel"
                else prefill_impl,
                chunk=prefill_chunk, margin=cache_margin)
        else:
            mix, new_cache = attn.mla_decode(cfg, p["attn"], h, pos, cache,
                                             absorb=mla_absorb)
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
    aux = None
    if spec.ffn == "mlp":
        x = x + mlp_fwd(cfg, p["mlp"], norm_fwd(cfg, p["norm2"], x))
    elif spec.ffn == "moe":
        out, aux = moe_fwd(cfg, p["moe"], norm_fwd(cfg, p["norm2"], x),
                           aux=mode == "train", mesh=mesh,
                           dp_axes=dp_axes, dispatch=cfg.moe_dispatch)
        x = x + out
    return x, aux, new_cache


def block_cache_spec(cfg: ModelConfig, spec: BlockSpec, batch: int,
                     max_len: int, count: int = 0):
    if spec.mixer == "attn":
        return attn.gqa_cache_spec(cfg, batch, max_len, window=spec.window,
                                   count=count)
    if spec.mixer == "mla":
        return attn.mla_cache_spec(cfg, batch, max_len, count=count)
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


def _add_aux(total, aux):
    """A running sum of MoE aux losses; None until a block has one."""
    if aux is None:
        return total
    return aux if total is None else total + aux


# The reference's ``remat="dots"`` saves the outputs of the
# ``dot_general``s that have no batch dimensions
# (``dots_with_no_batch_dims_saveable``): the weight projections.  The port
# writes every such product as ``x @ w`` (or ``F.linear``) on a 2-D
# weight, which folds x's leading dimensions into one and dispatches
# ``aten.mm`` (``aten.addmm`` with a bias), on the CPU and on the card
# alike.  A product over a batch or expert axis (attention's scores and
# values, an einsum, the MoE experts, the RG-LRU's block-diagonal gates)
# dispatches ``aten.bmm``: it has batch dimensions and is recomputed, as
# everything else is.
_NO_BATCH_DIM_DOTS = frozenset({torch.ops.aten.mm.default,
                                torch.ops.aten.addmm.default})


def dots_policy(ctx, func, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: save the output of
    a matrix product without batch dimensions, recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    if func in _NO_BATCH_DIM_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(dots_policy)


def _maybe_remat(fn, remat: str):
    """``remat`` of the reference: "none" keeps every activation for the
    backward, "full" keeps only each repetition's inputs and recomputes
    the rest (non-reentrant ``torch.utils.checkpoint``), "dots" keeps the
    inputs and the outputs of the products without batch dimensions
    (``dots_policy``) and recomputes the rest."""
    if remat == "none":
        return fn
    from torch.utils.checkpoint import checkpoint

    if remat == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if remat == "dots":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=_dots_context)
    raise ValueError(f"unknown remat {remat!r}")


def segment_apply(cfg: ModelConfig, p_stacked: dict, seg: Segment,
                  x: torch.Tensor, *, mode: str, caches=None, pos=None,
                  remat: str = "none", **kw):
    """Returns (x, aux, caches): ``aux`` the sum of the segment's MoE aux
    losses in training (None without MoE blocks, and outside training);
    training has no caches (None)."""
    if mode == "train":
        def body(x, rep_p):
            aux = None
            for b, spec in enumerate(seg.blocks):
                x, a, _ = block_apply(cfg, rep_p["blocks"][b], spec, x,
                                      mode=mode, cache=None, pos=None, **kw)
                aux = _add_aux(aux, a)
            return x, aux

        body = _maybe_remat(body, remat)
        seg_aux = None
        for rep_p in _unstack(p_stacked, seg.count):
            x, aux = body(x, rep_p)
            seg_aux = _add_aux(seg_aux, aux)
        return x, seg_aux, None
    if mode == "prefill":
        per_block = [[] for _ in seg.blocks]
        for i in range(seg.count):
            rep_p = _layer(p_stacked, i)
            for b, spec in enumerate(seg.blocks):
                x, _, c = block_apply(cfg, rep_p["blocks"][b], spec, x,
                                      mode=mode, cache=None, pos=None, **kw)
                per_block[b].append(c)
        stacked = tuple(tree_map(lambda *xs: torch.stack(xs), cs[0], *cs[1:])
                        for cs in per_block)
        return x, None, stacked
    for i in range(seg.count):
        rep_p, rep_cache = _layer(p_stacked, i), _layer(caches, i)
        for b, spec in enumerate(seg.blocks):
            x, _, _ = block_apply(cfg, rep_p["blocks"][b], spec, x,
                                  mode=mode, cache=rep_cache[b], pos=pos,
                                  **kw)
    return x, None, caches


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
    """Run all segments over input embeddings h. Returns (h, aux, caches):
    ``aux`` the MoE aux loss summed over blocks in training (None without
    MoE blocks, and outside training); training returns no caches
    (None).  On a mesh (``kw`` ``mesh``, ``dp_axes``) h is first laid out
    batch-sharded over ``dp_axes`` (``shard_batch_dim``)."""
    h = shard_batch_dim(h, kw.get("mesh"), kw.get("dp_axes"))
    caches_out, aux = [], None
    for i, seg in enumerate(plan_segments(cfg)):
        seg_cache = caches[i] if caches is not None else None
        h, a, c = segment_apply(cfg, params["segments"][i], seg, h,
                                mode=mode, caches=seg_cache, pos=pos, **kw)
        aux = _add_aux(aux, a)
        caches_out.append(c)
    h = norm_fwd(cfg, params["final_norm"], h)
    return h, aux, (None if mode == "train" else tuple(caches_out))


def _embed_inputs(cfg: ModelConfig, params: dict, batch: dict):
    """The token embeddings, and a vlm's ``img_emb`` (B, N, D) spliced in
    front (cast to the embeddings' dtype).  Returns (h, N spliced)."""
    h = embed_fwd(cfg, params["embed"], batch["tokens"])
    if not (cfg.num_image_tokens and "img_emb" in batch):
        return h, 0
    img = torch.as_tensor(batch["img_emb"], device=h.device).to(h.dtype)
    return torch.cat([img, h], dim=1), cfg.num_image_tokens


def lm_loss(cfg: ModelConfig, params: dict, batch: dict, *,
            remat: str = "none", mesh=None, dp_axes: Tuple[str, ...] = ()):
    """batch: tokens (B, S) int, targets (B, S) int, optional loss_mask,
    optional img_emb (B, N, D) spliced in front (vlm; the loss is over
    the text positions only).  Returns (total, {"loss", "aux_loss"}):
    with MoE blocks total = loss + ``router_aux_weight`` * aux, the aux
    loss summed over the blocks; without, the aux loss is zero and total
    is the loss.  On a mesh the logits stay vocab-sharded into the loss
    (``shard_logits``)."""
    h, n_img = _embed_inputs(cfg, params, batch)
    h, aux, _ = lm_backbone(cfg, params, h, mode="train", remat=remat,
                            mesh=mesh, dp_axes=dp_axes)
    logits = lm_head_fwd(cfg, params["embed"], h[:, n_img:, :])
    logits = shard_logits(logits, mesh, dp_axes)
    loss = cross_entropy(logits, batch["targets"], batch.get("loss_mask"))
    if aux is None:
        return loss, {"loss": loss,
                      "aux_loss": torch.zeros((), dtype=torch.float32,
                                              device=loss.device)}
    return loss + cfg.moe.router_aux_weight * aux, {"loss": loss,
                                                    "aux_loss": aux}


def lm_prefill(cfg: ModelConfig, params: dict, batch: dict, *,
               impl: str = "kernel", prefill_chunk: int = 1024,
               cache_margin: int = 0, mesh=None,
               dp_axes: Tuple[str, ...] = ()):
    """Returns (last-token logits (B, V), caches).  A vlm batch's
    ``img_emb`` takes positions ``0..N-1``, the text follows it."""
    h, _ = _embed_inputs(cfg, params, batch)
    h, _, caches = lm_backbone(cfg, params, h, mode="prefill",
                               prefill_impl=impl, decode_impl="kernel",
                               prefill_chunk=prefill_chunk,
                               cache_margin=cache_margin, mesh=mesh,
                               dp_axes=dp_axes)
    logits = lm_head_fwd(cfg, params["embed"], h[:, -1:, :])
    return logits[:, 0, :], caches


def lm_decode(cfg: ModelConfig, params: dict, token: torch.Tensor, pos,
              caches, *, impl: str = "kernel", inplace: bool = False,
              mla_absorb: bool = True, mesh=None,
              dp_axes: Tuple[str, ...] = ()):
    """token: (B,) int; pos: int or 0-d int tensor. Returns (logits,
    caches).  ``inplace=True`` writes the new entries into ``caches``
    itself (the monitor's donated buffers); otherwise a copy is updated.
    ``mla_absorb`` picks MLA's decode form (latent or decompressed)."""
    pos = _position(pos, token)
    if not inplace:
        caches = tree_map(torch.clone, caches)
    h = embed_fwd(cfg, params["embed"], token[:, None])
    h, _, caches = lm_backbone(cfg, params, h, mode="decode",
                               caches=caches, pos=pos, prefill_impl="kernel",
                               decode_impl=impl, prefill_chunk=0,
                               cache_margin=0, mla_absorb=mla_absorb,
                               mesh=mesh, dp_axes=dp_axes)
    logits = lm_head_fwd(cfg, params["embed"], h)
    return logits[:, 0, :], caches


def _position(pos, token) -> torch.Tensor:
    """A decode step's position as a 0-d int32 tensor on the token's
    device (on a mesh: the replicated position's local copy)."""
    if is_dtensor(pos):
        pos = pos.to_local()
    if is_dtensor(token):
        token = token.to_local()
    return torch.as_tensor(pos, dtype=torch.int32, device=token.device)


# The paged decode runs every row-wise product at this many rows, however
# many lanes its replica decodes: the projections, the MLP, MLA's
# projections and latent attention, MoE's router, experts and shared
# experts, and the head.  Its batch is padded with idle rows (token 0,
# position 0, a block-table row of -1) to a multiple of it, and those
# products run it rows at a time (``layers.by_rows``).  cuBLAS picks a
# GEMM algorithm by the row count, and on the H100 a row's bf16 bits differ
# between row counts (tools/batch_invariance.py): at one row count a lane's
# logits, and so its tokens, do not depend on how many lanes its replica
# decodes, which prefill/decode disaggregation and preemption rely on.  The
# embedding and the norms keep a row's bits at any count, so they run over
# every row at once; K1 paged keeps them too, and runs over the lanes
# alone, the idle rows' attention zero.
DECODE_ROWS = 64


def lm_decode_paged(cfg: ModelConfig, params: dict, token: torch.Tensor,
                    pos: torch.Tensor, pool, block_table: torch.Tensor, *,
                    impl: str = "kernel",
                    write_ok: torch.Tensor | None = None,
                    rows: int = DECODE_ROWS, mla_absorb: bool = True):
    """One decode step of every lane of the serving engine over the paged
    pool (``serve/kvcache.py`` layout: the cache tree with page axis 0 in
    front of each segment's stacked ``count`` axis).  token: (B,) int;
    pos: (B,) int32, each lane's position; block_table: (B, max_blocks)
    int32.  Writes each lane's new k/v (MLA: its latent, in the form
    ``mla_absorb`` picks) into its page in place (see
    ``attention.gqa_decode_paged``, ``attention.mla_decode_paged``) and
    returns (logits (B, V), pool).  Attention and MLA plans only: other
    mixers have no pages.  The batch runs
    padded with idle rows to a multiple of ``rows`` (``DECODE_ROWS``; the
    prefix cache's one-lane ``prefill_chunk`` passes 1).  K1 paged and the
    cache writes run over the B lanes alone, the idle rows' attention
    zero; MLA treats the idle rows as inactive lanes, their writes to the
    sink page.  Every row-wise product runs ``rows`` rows at a time: MLA's
    whole decode (it has no kernel) and each MoE block go block by block,
    the attention's projections and the MLP and head by rows.  MoE blocks
    route each block's lanes as the reference engine's per-lane decode does,
    whatever the padding (``moe_fwd``'s ``live``)."""
    B = token.shape[0]
    pad = -B % rows
    if pad:
        F = torch.nn.functional
        token = F.pad(token.reshape(-1), (0, pad))
        pos = F.pad(pos.to(torch.int32), (0, pad))
        block_table = F.pad(block_table, (0, 0, 0, pad), value=-1)
        if write_ok is not None:
            write_ok = F.pad(write_ok, (0, pad))
    h = embed_fwd(cfg, params["embed"], token.reshape(-1, 1))
    for si, seg in enumerate(plan_segments(cfg)):
        for i in range(seg.count):
            rep_p = _layer(params["segments"][si], i)
            for b, spec in enumerate(seg.blocks):
                p = rep_p["blocks"][b]
                layer_pool = {k: t[:, i] for k, t in pool[si][b].items()}
                hn = norm_fwd(cfg, p["norm1"], h)
                if spec.mixer == "attn":
                    h = h + attn.gqa_decode_paged(
                        cfg, p["attn"], hn, pos, layer_pool, block_table,
                        write_ok=write_ok, window=spec.window, impl=impl,
                        rows=rows, live=B)
                elif spec.mixer == "mla":
                    h = h + by_rows(
                        rows, lambda x, ps, bt, ok: attn.mla_decode_paged(
                            cfg, p["attn"], x, ps, layer_pool, bt,
                            write_ok=ok, absorb=mla_absorb),
                        hn, pos, block_table, write_ok)
                else:
                    raise ValueError(f"mixer {spec.mixer!r} has no paged "
                                     "decode (its state has no pages)")
                if spec.ffn == "mlp":
                    h = h + by_rows(rows, lambda x: mlp_fwd(
                        cfg, p["mlp"], norm_fwd(cfg, p["norm2"], x)), h)
                elif spec.ffn == "moe":
                    h = h + torch.cat([moe_fwd(
                        cfg, p["moe"], norm_fwd(cfg, p["norm2"],
                                                h[i:i + rows]),
                        live=min(rows, B - i), aux=False)[0]
                        for i in range(0, h.shape[0], rows)])
    logits = by_rows(rows, lambda x: lm_head_fwd(
        cfg, params["embed"], norm_fwd(cfg, params["final_norm"], x)), h)
    return logits[:B, 0, :], pool


def lm_cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    return tuple(segment_cache_specs(cfg, seg, batch, max_len)
                 for seg in plan_segments(cfg))
