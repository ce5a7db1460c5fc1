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

``decode_paged_fn`` is the serving engine's decode: every lane at its own
position over the paged KV pool (attention plans: K1's paged entry; MLA
plans: plain tensor code over latent pages).  The encoder-decoder has none
(the reference's engine does not serve it): its ``decode_paged_fn``
raises.  Its ``cache_specs(b, s)`` are ``encdec_cache_specs(cfg, b, s, s)``,
as the reference's.

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

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as _ed
from repro_torch.models import transformer as _tf
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
                mla_absorb: bool = True) -> ModelBundle:
    if cfg.family == "encdec":
        return ModelBundle(
            cfg=cfg,
            init=partial(_ed.init_encdec, cfg),
            prefill_fn=partial(_ed.encdec_prefill, cfg, impl=prefill_impl,
                               prefill_chunk=prefill_chunk,
                               cache_margin=cache_margin),
            decode_fn=partial(_ed.encdec_decode, cfg, impl=decode_impl),
            cache_specs=lambda b, s: _ed.encdec_cache_specs(cfg, b, s, s),
            decode_paged_fn=partial(_no_paged_decode, cfg),
            loss_fn=partial(_ed.encdec_loss, cfg, remat=remat),
            cache_margin=cache_margin,
        )
    return ModelBundle(
        cfg=cfg,
        init=partial(_tf.init_lm, cfg),
        prefill_fn=partial(_tf.lm_prefill, cfg, impl=prefill_impl,
                           prefill_chunk=prefill_chunk,
                           cache_margin=cache_margin),
        decode_fn=partial(_tf.lm_decode, cfg, impl=decode_impl,
                          mla_absorb=mla_absorb),
        cache_specs=partial(_tf.lm_cache_specs, cfg),
        decode_paged_fn=partial(_tf.lm_decode_paged, cfg, impl=decode_impl,
                                mla_absorb=mla_absorb),
        loss_fn=partial(_tf.lm_loss, cfg, remat=remat),
        cache_margin=cache_margin,
    )


def _no_paged_decode(cfg: ModelConfig, *args, **kwargs):
    raise NotImplementedError(
        f"{cfg.name}: the encoder-decoder has no paged decode (the "
        "reference's serving engine does not serve it); serve it through "
        "prefill_fn/decode_fn")


def analytic_param_count(cfg: ModelConfig) -> int:
    params = build_model(cfg).init(0, device="meta")
    return sum(t.numel() for t in tree_leaves(params))
