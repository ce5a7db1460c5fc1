"""Model zoo: one ``build_model`` entry point for every family of the
reference: dense, vlm (dense with the image embeddings spliced in front),
moe with GQA or MLA, ssm, hybrid and the encoder-decoder (``encdec.py``).

``ModelBundle`` packages the functional API the rest of the port uses:

    init(seed, device)                       -> params
    loss_fn(params, batch)                   -> (loss, metrics)
    prefill_fn(params, batch)                -> (logits, caches)
    decode_fn(params, tok, pos, caches, inplace=False) -> (logits, caches)
    decode_paged_fn(params, tok, pos, pool, block_table, write_ok=None,
                    rows=16)                 -> (logits, pool)
    cache_specs(batch, max_len)              -> caches as meta tensors

``input_specs(cfg, shape)`` returns meta-tensor stand-ins for every input
of an (arch x shape) cell, as the reference's does; the launch layer
(``launch/steps.py``) and its meta-device dry run build on it.

``decode_paged_fn`` is the serving engine's decode: every lane at its own
position over the paged KV pool (attention plans: K1's paged entry; MLA
plans: plain tensor code over latent pages).  The encoder-decoder has none
(the reference's engine does not serve it): its ``decode_paged_fn``
raises.  Its ``cache_specs(b, s)`` are ``encdec_cache_specs(cfg, b, s, s)``,
as the reference's.

``mesh`` (a ``DeviceMesh``) and ``dp_axes`` (default: the mesh's
``("pod", "data")`` axes) lay the step over several devices, as the
reference's ``build_model(..., mesh, dp_axes)``: the parameters and
inputs are then DTensors (``launch/steps.py`` lays them out by
``sharding.rules``), the activations batch-sharded over ``dp_axes``, the
logits vocab-sharded into the loss, an MoE block on its expert-parallel
dispatch, and attention on each rank's own lanes and heads.  The paged
decode runs without a mesh.

``mla_absorb`` picks MLA's decode form, as the reference's does: True (the
default) attends in latent space, False decompresses the cache.

``loss_fn`` is training's forward (``lm_loss``): the plain versions only
(naive attention, as in the reference; the SSD and RG-LRU scans in plain
PyTorch), since no kernel has a backward.

Prefill and decode default to the hand-written kernels (``"kernel"``: K2
for attention prefill, K3 for the SSD scan, K4 for the RG-LRU scan, K1 for
attention decode); the plain PyTorch paths (``"naive"``, ``"blockwise"``)
are what they are held against.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec as _ed
from repro_torch.models import transformer as _tf
from repro_torch.models.layers import cdtype
from repro_torch.sharding.rules import dp_axes_of
from repro_torch.tree import tree_leaves


@dataclass
class ModelBundle:
    cfg: ModelConfig
    init: Callable[..., Any]
    prefill_fn: Callable[..., Any]
    decode_fn: Callable[..., Any]
    cache_specs: Callable[[int, int], Any]
    decode_paged_fn: Callable[..., Any]
    loss_fn: Callable[..., Any]
    cache_margin: int = 0


def build_model(cfg: ModelConfig, *, prefill_impl: str = "kernel",
                decode_impl: str = "kernel", prefill_chunk: int = 1024,
                cache_margin: int = 128, remat: str = "none",
                mla_absorb: bool = True, mesh=None,
                dp_axes: tuple[str, ...] | None = None) -> ModelBundle:
    if dp_axes is None:
        dp_axes = () if mesh is None else dp_axes_of(mesh)
    on = dict(mesh=mesh, dp_axes=tuple(dp_axes))
    bundle = _build(cfg, prefill_impl, decode_impl, prefill_chunk,
                    cache_margin, remat, mla_absorb, on)
    if mesh is None:
        return bundle
    return dataclasses.replace(
        bundle, loss_fn=_replicating(bundle.loss_fn),
        prefill_fn=_replicating(bundle.prefill_fn),
        decode_fn=_replicating(bundle.decode_fn))


def _replicating(fn):
    """``fn`` with plain tensors it meets among DTensors taken as
    replicated (positions, masks, constants built inside the model)."""
    def run(*args, **kwargs):
        from repro_torch.launch.mesh import replicating

        with replicating():
            return fn(*args, **kwargs)
    return run


def _build(cfg, prefill_impl, decode_impl, prefill_chunk, cache_margin,
           remat, mla_absorb, on) -> ModelBundle:
    if cfg.family == "encdec":
        return ModelBundle(
            cfg=cfg,
            init=partial(_ed.init_encdec, cfg),
            prefill_fn=partial(_ed.encdec_prefill, cfg, impl=prefill_impl,
                               prefill_chunk=prefill_chunk,
                               cache_margin=cache_margin, **on),
            decode_fn=partial(_ed.encdec_decode, cfg, impl=decode_impl,
                              **on),
            cache_specs=lambda b, s: _ed.encdec_cache_specs(cfg, b, s, s),
            decode_paged_fn=partial(_no_paged_decode, cfg),
            loss_fn=partial(_ed.encdec_loss, cfg, remat=remat, **on),
            cache_margin=cache_margin,
        )
    return ModelBundle(
        cfg=cfg,
        init=partial(_tf.init_lm, cfg),
        prefill_fn=partial(_tf.lm_prefill, cfg, impl=prefill_impl,
                           prefill_chunk=prefill_chunk,
                           cache_margin=cache_margin, **on),
        decode_fn=partial(_tf.lm_decode, cfg, impl=decode_impl,
                          mla_absorb=mla_absorb, **on),
        cache_specs=partial(_tf.lm_cache_specs, cfg),
        decode_paged_fn=partial(_tf.lm_decode_paged, cfg, impl=decode_impl,
                                mla_absorb=mla_absorb),
        loss_fn=partial(_tf.lm_loss, cfg, remat=remat, **on),
        cache_margin=cache_margin,
    )


def _no_paged_decode(cfg: ModelConfig, *args, **kwargs):
    raise NotImplementedError(
        f"{cfg.name}: the encoder-decoder has no paged decode (the "
        "reference's serving engine does not serve it); serve it through "
        "prefill_fn/decode_fn")


# ---------------------------------------------------------------------------
# Input specs (meta tensors) per (arch x shape) cell
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta-tensor stand-ins for every model input of an (arch x shape)
    cell, as the reference's ``input_specs``:

    train   -> {"batch": {...}}
    prefill -> {"batch": {...}}
    decode  -> {"token", "pos", "caches"}
    """
    B, S = shape.global_batch, shape.seq_len
    meta = torch.device("meta")

    def tok(*s):
        return torch.empty(s, dtype=torch.int32, device=meta)

    def emb(*s):
        return torch.empty(s, dtype=cdtype(cfg), device=meta)

    if shape.kind in ("train", "prefill"):
        train = shape.kind == "train"
        if cfg.family == "encdec":
            T = int(S * cfg.tgt_ratio)
            batch = {"src_emb": emb(B, S, cfg.d_model), "tgt_tokens": tok(B, T)}
            if train:
                batch["tgt_targets"] = tok(B, T)
        elif cfg.family == "vlm":
            Stext = S - cfg.num_image_tokens
            batch = {"tokens": tok(B, Stext)}
            if train:
                batch["targets"] = tok(B, Stext)
            batch["img_emb"] = emb(B, cfg.num_image_tokens, cfg.d_model)
        else:
            batch = {"tokens": tok(B, S)}
            if train:
                batch["targets"] = tok(B, S)
        return {"batch": batch}

    # decode: one new token against caches of capacity seq_len
    caches = (_ed.encdec_cache_specs(cfg, B, S, S) if cfg.family == "encdec"
              else _tf.lm_cache_specs(cfg, B, S))
    return {"token": tok(B), "pos": tok(), "caches": caches}


# ---------------------------------------------------------------------------
# Analytic parameter counts (exact: from the parameters on the meta device)
# ---------------------------------------------------------------------------

def analytic_param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of ``cfg``; ``active_only`` counts a token's: an MoE
    layer's routed experts beyond its top-k are left out."""
    params = build_model(cfg).init(0, device="meta")
    total = sum(t.numel() for t in tree_leaves(params))
    if active_only and cfg.moe.enabled:
        n_moe_layers = cfg.num_layers - cfg.moe.n_dense_layers
        inactive = cfg.moe.num_experts - cfg.moe.top_k
        per_expert = 3 * cfg.d_model * cfg.moe.d_ff
        total -= n_moe_layers * inactive * per_expert
    return total


def embedding_param_count(cfg: ModelConfig) -> int:
    """The embedding table's parameters, twice where the head is untied."""
    n = cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        n *= 2
    return n
