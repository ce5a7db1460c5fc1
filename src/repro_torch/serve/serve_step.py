"""A plain generate loop over a model bundle, greedy or sampled.

The model-level oracle the runtime-served path is checked against: prefill,
then one decode per token, no monitor in between."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.model_zoo import ModelBundle


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 temperature: float = 0.0) -> torch.Tensor:
    """One token id per row of ``logits`` (..., V), int32: the argmax at
    temperature 0, else a draw from ``softmax(logits / temperature)`` with
    ``generator`` (on the device of ``logits``)."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draw = torch.multinomial(flat, 1, generator=generator)
    return draw.reshape(probs.shape[:-1]).to(torch.int32)


@torch.no_grad()
def generate(bundle: ModelBundle, params, prompt_batch: dict,
             num_tokens: int, *, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Prefill + decode ``num_tokens`` tokens. Returns (B, num_tokens)
    int32 ids: token i is drawn from the logits after i decode steps, by
    ``sample_token`` (greedy at temperature 0; above it from ``generator``,
    a generator seeded 0 on the logits' device when None).  The first
    decode position follows the prompt: ``tgt_tokens`` for the
    encoder-decoder, else ``tokens``, after the ``num_image_tokens`` image
    embeddings for a vlm."""
    logits, caches = bundle.prefill_fn(params, prompt_batch)
    pos = prompt_batch.get("tgt_tokens", prompt_batch.get("tokens")).shape[1]
    if bundle.cfg.family == "vlm":
        pos += bundle.cfg.num_image_tokens
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=logits.device).manual_seed(0)
    toks = []
    for i in range(num_tokens):
        tok = sample_token(logits, generator, temperature)
        toks.append(tok)
        logits, caches = bundle.decode_fn(params, tok, pos + i, caches,
                                          inplace=True)
    return torch.stack(toks, dim=1)
