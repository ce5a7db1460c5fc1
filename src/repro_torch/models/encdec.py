"""Encoder-decoder transformer (seamless-m4t backbone): the reference's
``models/encdec.py`` on PyTorch.

The speech/text modality frontend is a stub, as in the reference: the
encoder consumes precomputed frame embeddings ``src_emb`` (B, S_src,
d_model) directly.  The decoder is a causal transformer with cross
attention into the encoder memory.  The parameter tree is the reference's
(``embed``, ``enc_stack``, ``enc_final_norm``, ``dec_stack``,
``dec_final_norm``; each stack's leaves carry a leading layer axis), and
so is the cache tree: ``self``, each decoder layer's self-attention ring
(``k``, ``v``, ``kv_pos``; capacity target prompt + margin), and
``cross_k`` / ``cross_v``, the constant cross-attention k/v of the encoder
memory (L, B, S_src, Hkv, hd).  The cross positions live in no cache leaf:
they are ``0..S_src-1``, and the decode step builds them once for all
layers.

Kernels, as in the decoder-only families: at prefill (``impl="kernel"``)
the encoder's non-causal self attention (``attention.gqa_encode``), the
decoder's causal self attention and its cross attention (non-causal, Sq the
target prompt against Skv the source) all run on K2.  At decode
(``impl="kernel"``) the self attention runs on K1 over the ring, and so does
the cross attention: one query over the constant (B, S_src, Hkv, hd)
cache, ``kv_pos`` = ``0..S_src-1`` and the query at position S_src - 1, which
keeps every slot (the reference runs the same function as a plain
non-causal ``sdpa``).  ``"naive"``/``"blockwise"`` are the plain paths.
Training (``encdec_loss``) runs the plain versions under autograd: no
kernel has a backward.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (cdtype, cross_entropy, embed_fwd,
                                       init_embed, init_mlp, init_norm,
                                       lm_head_fwd, mlp_fwd, norm_fwd,
                                       shard_batch_dim, shard_logits)
from repro_torch.models.transformer import (_layer, _maybe_remat, _position,
                                           _unstack)
from repro_torch.tree import tree_map


# ---------------------------------------------------------------------------
# Cross attention
# ---------------------------------------------------------------------------

def init_cross_attn(cfg: ModelConfig, device, gen, count: int = 0) -> dict:
    return attn.init_gqa(cfg, device, gen, count)


def cross_kv(cfg: ModelConfig, p: dict, memory: torch.Tensor):
    """The encoder memory's k and v, (B, S_src, Hkv, hd) each (no RoPE)."""
    return attn._head_proj(memory, p["wk"]), attn._head_proj(memory, p["wv"])


def cross_positions(k: torch.Tensor):
    """K1's ``kv_pos`` and query position over a cross cache of S_src
    slots: ``0..S_src-1`` and S_src - 1, every slot kept."""
    S = k.shape[1]
    kv_pos = torch.arange(S, dtype=torch.int32, device=k.device)
    return kv_pos, kv_pos[-1:]


def cross_attn_fwd(cfg: ModelConfig, p: dict, x: torch.Tensor, k, v, *,
                   impl: str = "naive", chunk: int = 1024,
                   positions=None) -> torch.Tensor:
    """Non-causal attention of x (B, Sq, D) over the memory's k/v.
    ``positions`` marks a decode step: ``cross_positions(k)``, with which
    ``impl`` "kernel" runs K1 over the cross cache; without it "kernel" is
    K2 (Sq against S_src).  "naive" or "blockwise": the plain versions."""
    q = attn._head_proj(x, p["wq"])
    if positions is not None and impl == "kernel":
        from repro_torch.kernels.decode_attention import ops as da_ops

        kv_pos, pos = positions
        out = da_ops.decode_attention(q, k, v, pos, kv_pos)
    else:
        Sq, Skv = q.shape[1], k.shape[1]
        out = attn.sdpa(q, k, v, impl=impl, causal=False, window=0,
                        q_pos=torch.arange(Sq, device=x.device),
                        kv_pos=torch.arange(Skv, device=x.device),
                        chunk=chunk)
    return attn._out_proj(out, p["wo"])


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _init_enc_layer(cfg: ModelConfig, device, gen, count: int) -> dict:
    return {
        "norm1": init_norm(cfg, cfg.d_model, device, count),
        "attn": attn.init_gqa(cfg, device, gen, count),
        "norm2": init_norm(cfg, cfg.d_model, device, count),
        "mlp": init_mlp(cfg, cfg.d_model, cfg.d_ff, device, gen, count),
    }


def _init_dec_layer(cfg: ModelConfig, device, gen, count: int) -> dict:
    return {
        "norm1": init_norm(cfg, cfg.d_model, device, count),
        "self_attn": attn.init_gqa(cfg, device, gen, count),
        "norm_x": init_norm(cfg, cfg.d_model, device, count),
        "cross_attn": init_cross_attn(cfg, device, gen, count),
        "norm2": init_norm(cfg, cfg.d_model, device, count),
        "mlp": init_mlp(cfg, cfg.d_model, cfg.d_ff, device, gen, count),
    }


def _enc_layer(cfg, p, x, *, impl):
    h = norm_fwd(cfg, p["norm1"], x)
    x = x + attn.gqa_encode(cfg, p["attn"], h, impl=impl)
    h = norm_fwd(cfg, p["norm2"], x)
    return x + mlp_fwd(cfg, p["mlp"], h)


def _dec_layer(cfg, p, x, memory_kv, *, mode, cache, pos, impl, chunk,
               cache_margin=0, cross_pos=None):
    """mode: train | prefill | decode.  Returns (x, cache): the layer's
    ``{"self", "cross_k", "cross_v"}`` at prefill and decode (decode
    writes ``self`` in place), None in training."""
    new_cache = None
    h = norm_fwd(cfg, p["norm1"], x)
    if mode == "train":
        x = x + attn.gqa_fwd(cfg, p["self_attn"], h, impl=impl)
    elif mode == "prefill":
        mix, self_cache = attn.gqa_prefill(cfg, p["self_attn"], h, impl=impl,
                                           chunk=chunk, margin=cache_margin)
        x = x + mix
    else:
        mix, self_cache = attn.gqa_decode(cfg, p["self_attn"], h, pos,
                                          cache["self"], impl=impl)
        x = x + mix
    h = norm_fwd(cfg, p["norm_x"], x)
    ck, cv = memory_kv
    x = x + cross_attn_fwd(cfg, p["cross_attn"], h, ck, cv, impl=impl,
                           chunk=chunk, positions=cross_pos)
    h = norm_fwd(cfg, p["norm2"], x)
    x = x + mlp_fwd(cfg, p["mlp"], h)
    if mode in ("prefill", "decode"):
        new_cache = {"self": self_cache, "cross_k": ck, "cross_v": cv}
    return x, new_cache


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def init_encdec(cfg: ModelConfig, seed: int, device="cuda") -> dict:
    """Parameters on ``device`` from a ``torch.Generator`` seeded by
    ``seed`` (``device="meta"`` gives the shapes only)."""
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(int(seed)))
    return {
        "embed": init_embed(cfg, dev, gen),
        "enc_stack": _init_enc_layer(cfg, dev, gen, cfg.encoder_layers),
        "enc_final_norm": init_norm(cfg, cfg.d_model, dev),
        "dec_stack": _init_dec_layer(cfg, dev, gen, cfg.num_layers),
        "dec_final_norm": init_norm(cfg, cfg.d_model, dev),
    }


def encode(cfg: ModelConfig, params: dict, src_emb, *, impl: str = "naive",
           remat: str = "none") -> torch.Tensor:
    """The encoder over ``src_emb`` (B, S_src, D), cast to the config's
    dtype.  ``impl`` "kernel": K2 (inference only, no backward); the plain
    versions run under autograd, each layer optionally rematerialised."""
    dev = params["enc_final_norm"]["scale"].device
    x = torch.as_tensor(src_emb, device=dev).to(cdtype(cfg))
    body = _maybe_remat(lambda x, p: _enc_layer(cfg, p, x, impl=impl), remat)
    for p in _unstack(params["enc_stack"], cfg.encoder_layers):
        x = body(x, p)
    return norm_fwd(cfg, params["enc_final_norm"], x)


def encdec_loss(cfg: ModelConfig, params: dict, batch: dict, *,
                remat: str = "none", mesh=None, dp_axes=()):
    """batch: src_emb (B, S_src, D), tgt_tokens (B, S_tgt), tgt_targets,
    optional loss_mask.  Plain attention throughout (naive, as the
    reference's training).  Returns (loss, {"loss", "aux_loss"}), the aux
    loss zero.  On a mesh the activations are batch-sharded over
    ``dp_axes`` and the logits stay vocab-sharded (``shard_logits``)."""
    memory = encode(cfg, params, batch["src_emb"], impl="naive", remat=remat)
    memory = shard_batch_dim(memory, mesh, dp_axes)
    x = shard_batch_dim(embed_fwd(cfg, params["embed"], batch["tgt_tokens"]),
                        mesh, dp_axes)

    def body(x, p):
        kv = cross_kv(cfg, p["cross_attn"], memory)
        return _dec_layer(cfg, p, x, kv, mode="train", cache=None, pos=None,
                          impl="naive", chunk=1024)[0]

    body = _maybe_remat(body, remat)
    for p in _unstack(params["dec_stack"], cfg.num_layers):
        x = body(x, p)
    x = norm_fwd(cfg, params["dec_final_norm"], x)
    logits = shard_logits(lm_head_fwd(cfg, params["embed"], x), mesh, dp_axes)
    loss = cross_entropy(logits, batch["tgt_targets"], batch.get("loss_mask"))
    return loss, {"loss": loss,
                  "aux_loss": torch.zeros((), dtype=torch.float32,
                                          device=loss.device)}


def encdec_prefill(cfg: ModelConfig, params: dict, batch: dict, *,
                   impl: str = "kernel", prefill_chunk: int = 1024,
                   cache_margin: int = 0, mesh=None, dp_axes=()):
    """Encode ``src_emb``, prefill the decoder over ``tgt_tokens``.
    Returns (last-token logits (B, V), caches)."""
    memory = shard_batch_dim(encode(cfg, params, batch["src_emb"], impl=impl),
                             mesh, dp_axes)
    x = shard_batch_dim(embed_fwd(cfg, params["embed"], batch["tgt_tokens"]),
                        mesh, dp_axes)
    caches = []
    for i in range(cfg.num_layers):
        p = _layer(params["dec_stack"], i)
        kv = cross_kv(cfg, p["cross_attn"], memory)
        x, c = _dec_layer(cfg, p, x, kv, mode="prefill", cache=None,
                          pos=None, impl=impl, chunk=prefill_chunk,
                          cache_margin=cache_margin)
        caches.append(c)
    caches = tree_map(lambda *xs: torch.stack(xs), caches[0], *caches[1:])
    x = norm_fwd(cfg, params["dec_final_norm"], x)
    logits = lm_head_fwd(cfg, params["embed"], x[:, -1:, :])
    return logits[:, 0, :], caches


def encdec_decode(cfg: ModelConfig, params: dict, token: torch.Tensor, pos,
                  caches, *, impl: str = "kernel", inplace: bool = False,
                  mesh=None, dp_axes=()):
    """token: (B,) int; pos: int or 0-d int tensor, the target position.
    Returns (logits (B, V), caches).  ``inplace=True`` writes the self
    caches' new entries into ``caches`` itself; otherwise into a copy of
    ``self`` (the cross k/v are never written, and are shared)."""
    pos = _position(pos, token)
    if not inplace:
        caches = dict(caches, self=tree_map(torch.clone, caches["self"]))
    cross_pos = cross_positions(caches["cross_k"][0])
    x = shard_batch_dim(embed_fwd(cfg, params["embed"], token[:, None]),
                        mesh, dp_axes)
    for i in range(cfg.num_layers):
        x, _ = _dec_layer(cfg, _layer(params["dec_stack"], i), x,
                          (caches["cross_k"][i], caches["cross_v"][i]),
                          mode="decode", cache=_layer(caches, i), pos=pos,
                          impl=impl, chunk=1024, cross_pos=cross_pos)
    x = norm_fwd(cfg, params["dec_final_norm"], x)
    logits = lm_head_fwd(cfg, params["embed"], x)
    return logits[:, 0, :], caches


def encdec_cache_specs(cfg: ModelConfig, batch: int, self_len: int,
                       src_len: int) -> dict:
    """Stacked decode cache specs as meta tensors: the self ring cache of
    capacity ``self_len`` and the constant cross k/v of ``src_len``."""
    L = cfg.num_layers
    kv_shape = (L, batch, src_len, cfg.num_kv_heads, cfg.head_dim_)
    meta = torch.device("meta")
    return {
        "self": attn.gqa_cache_spec(cfg, batch, self_len, window=0, count=L),
        "cross_k": torch.empty(kv_shape, dtype=cdtype(cfg), device=meta),
        "cross_v": torch.empty(kv_shape, dtype=cdtype(cfg), device=meta),
    }
