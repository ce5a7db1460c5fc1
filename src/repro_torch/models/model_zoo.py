"""Model zoo: one ``build_model`` entry point (dense, ssm and hybrid
families so far).

``ModelBundle`` packages the functional API the rest of the port uses:

    init(seed, device)                       -> params
    loss_fn(params, batch)                   -> (loss, metrics)
    prefill_fn(params, batch)                -> (logits, caches)
    decode_fn(params, tok, pos, caches, inplace=False) -> (logits, caches)
    decode_paged_fn(params, tok, pos, pool, block_table, write_ok=None)
                                             -> (logits, pool)
    cache_specs(batch, max_len)              -> caches as meta tensors

``decode_paged_fn`` is the serving engine's decode: every lane at its own
position over the paged KV pool (dense plans; K1's paged entry).

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
                cache_margin: int = 128,
                remat: str = "none") -> ModelBundle:
    return ModelBundle(
        cfg=cfg,
        init=partial(_tf.init_lm, cfg),
        prefill_fn=partial(_tf.lm_prefill, cfg, impl=prefill_impl,
                           prefill_chunk=prefill_chunk,
                           cache_margin=cache_margin),
        decode_fn=partial(_tf.lm_decode, cfg, impl=decode_impl),
        cache_specs=partial(_tf.lm_cache_specs, cfg),
        decode_paged_fn=partial(_tf.lm_decode_paged, cfg, impl=decode_impl),
        loss_fn=partial(_tf.lm_loss, cfg, remat=remat),
        cache_margin=cache_margin,
    )


def analytic_param_count(cfg: ModelConfig) -> int:
    params = _tf.init_lm(cfg, 0, device="meta")
    return sum(t.numel() for t in tree_leaves(params))
