"""A plain greedy generate loop over a model bundle.

The model-level oracle the runtime-served path is checked against: prefill,
then one decode per token, no monitor in between."""

from __future__ import annotations

import torch

from repro_torch.models.model_zoo import ModelBundle


@torch.no_grad()
def generate(bundle: ModelBundle, params, prompt_batch: dict,
             num_tokens: int) -> torch.Tensor:
    """Prefill + greedy-decode ``num_tokens`` tokens. Returns (B,
    num_tokens) int32 ids: token i is the argmax after i decode steps.
    The first decode position follows the prompt: ``tgt_tokens`` for the
    encoder-decoder, else ``tokens``, after the ``num_image_tokens`` image
    embeddings for a vlm."""
    logits, caches = bundle.prefill_fn(params, prompt_batch)
    pos = prompt_batch.get("tgt_tokens", prompt_batch.get("tokens")).shape[1]
    if bundle.cfg.family == "vlm":
        pos += bundle.cfg.num_image_tokens
    toks = []
    for i in range(num_tokens):
        tok = logits.argmax(dim=-1).to(torch.int32)
        toks.append(tok)
        logits, caches = bundle.decode_fn(params, tok, pos + i, caches,
                                          inplace=True)
    return torch.stack(toks, dim=1)
