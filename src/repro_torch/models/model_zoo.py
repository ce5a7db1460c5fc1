"""Model zoo: one ``build_model`` entry point (dense family so far).

``ModelBundle`` packages the functional API the rest of the port uses:

    init(seed, device)                       -> params
    prefill_fn(params, batch)                -> (logits, caches)
    decode_fn(params, tok, pos, caches, inplace=False) -> (logits, caches)
    cache_specs(batch, max_len)              -> caches as meta tensors

Attention defaults to the hand-written kernels (``"kernel"``); the plain
PyTorch paths (``"naive"``, ``"blockwise"``) are what they are held against.
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
    cache_margin: int = 0


def build_model(cfg: ModelConfig, *, prefill_impl: str = "kernel",
                decode_impl: str = "kernel", prefill_chunk: int = 1024,
                cache_margin: int = 128) -> ModelBundle:
    return ModelBundle(
        cfg=cfg,
        init=partial(_tf.init_lm, cfg),
        prefill_fn=partial(_tf.lm_prefill, cfg, impl=prefill_impl,
                           prefill_chunk=prefill_chunk,
                           cache_margin=cache_margin),
        decode_fn=partial(_tf.lm_decode, cfg, impl=decode_impl),
        cache_specs=partial(_tf.lm_cache_specs, cfg),
        cache_margin=cache_margin,
    )


def analytic_param_count(cfg: ModelConfig) -> int:
    params = _tf.init_lm(cfg, 0, device="meta")
    return sum(t.numel() for t in tree_leaves(params))
