"""Common layers: norms, rotary embeddings, the MLPs, embeddings, the
training loss, and the causal depthwise convolution of the SSM and RG-LRU
blocks.

Functional, like the reference: ``init_*`` builds a dict of tensors on an
explicit device from an explicit ``torch.Generator``; ``*_fwd`` applies it.
Norms and RoPE run in float32 and cast back; matmuls run in the config's
compute dtype.  Initialisers and scales match the reference's; the numbers
drawn differ (``torch.Generator`` is not JAX's threefry).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def normal(shape, scale: float, dtype: torch.dtype, device: torch.device,
           gen: Optional[torch.Generator], count: int = 0) -> torch.Tensor:
    """``N(0,1) * scale`` drawn in float32 and cast, like the reference.

    ``count > 0`` stacks ``count`` independent draws along a new axis 0,
    filled one slice at a time so the float32 temporary stays one slice."""
    shape = tuple(shape)
    if count:
        out = torch.empty((count,) + shape, dtype=dtype, device=device)
        if device.type != "meta":
            for i in range(count):
                out[i].copy_(normal(shape, scale, dtype, device, gen))
        return out
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, d: int, device, count: int = 0) -> dict:
    if cfg.norm_kind != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm_kind!r} is not ported yet")
    shape = ((count,) if count else ()) + (d,)
    return {"scale": torch.ones(shape, dtype=cdtype(cfg), device=device)}


def norm_fwd(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(ms + 1e-6) * p["scale"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (split-half layout)
# ---------------------------------------------------------------------------

def rope_fwd(x: torch.Tensor, positions: torch.Tensor, theta: float,
             rope_pct: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) integer tensor."""
    hd = x.shape[-1]
    rot = int(hd * rope_pct)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    freqs = theta ** (-torch.arange(0, rot, 2, dtype=torch.float32,
                                    device=x.device) / rot)
    angles = positions.to(torch.float32)[..., None] * freqs   # (S, rot/2)
    angles = angles[..., None, :]                             # (S, 1, rot/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x_rot.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (PyTorch's own
    default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def init_mlp(cfg: ModelConfig, d_in: int, d_ff: int, device,
             gen: Optional[torch.Generator], count: int = 0) -> dict:
    """silu_glu | geglu (gated, with ``w_gate``) | gelu (plain)."""
    if cfg.mlp_kind not in ("silu_glu", "geglu", "gelu"):
        raise ValueError(f"unknown mlp kind {cfg.mlp_kind!r}")
    dt = cdtype(cfg)
    p = {
        "w_up": normal((d_in, d_ff), d_in ** -0.5, dt, device, gen, count),
        "w_down": normal((d_ff, d_in), d_ff ** -0.5, dt, device, gen, count),
    }
    if cfg.mlp_kind != "gelu":
        p["w_gate"] = normal((d_in, d_ff), d_in ** -0.5, dt, device, gen,
                             count)
    return p


def mlp_fwd(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    up = x @ p["w_up"]
    if cfg.mlp_kind == "silu_glu":
        h = F.silu(x @ p["w_gate"]) * up
    elif cfg.mlp_kind == "geglu":
        h = gelu(x @ p["w_gate"]) * up
    else:
        h = gelu(up)
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------

def init_embed(cfg: ModelConfig, device,
               gen: Optional[torch.Generator]) -> dict:
    dt = cdtype(cfg)
    p = {"embedding": normal((cfg.vocab_size, cfg.d_model), 0.02, dt,
                             device, gen)}
    if not cfg.tie_embeddings:
        p["lm_head"] = normal((cfg.d_model, cfg.vocab_size),
                              cfg.d_model ** -0.5, dt, device, gen)
    return p


def embed_fwd(cfg: ModelConfig, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), p["embedding"])


def lm_head_fwd(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ p["embedding"].T
    return x @ p["lm_head"]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy with f32 accumulation; ``mask`` (0/1 per
    token) averages over the kept tokens only.  The gold logit is a
    ``gather`` of the same f32 value the reference takes as a masked sum
    over the vocab axis (a sum of one value and zeros), without a
    (B, S, V) mask; its backward writes one value per row, so it sums in
    no order."""
    m = logits.detach().amax(dim=-1, keepdim=True)
    shifted = (logits - m).float()
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    gold = shifted.gather(-1, targets.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


# ---------------------------------------------------------------------------
# Causal depthwise conv (SSM / RG-LRU input convolutions)
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor):
    """x: (B, S, C), w: (K, C).  Returns (y, state): state is the last K-1
    inputs, left zero padding included when S < K-1, for decode."""
    k = w.shape[0]
    pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                      device=x.device)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + S] * w[i]
    # a copy: a view would keep the whole padded input alive in the cache
    return y, xp[:, S:].clone()


def causal_conv1d_step(x: torch.Tensor, w: torch.Tensor,
                       state: torch.Tensor) -> torch.Tensor:
    """One-token update. x: (B, C), state: (B, K-1, C).  Returns y and
    shifts the new input into ``state`` in place."""
    xp = torch.cat([state.to(x.dtype), x[:, None, :]], dim=1)    # (B, K, C)
    y = (xp * w.to(x.dtype)).sum(dim=1)
    state.copy_(xp[:, 1:])
    return y
