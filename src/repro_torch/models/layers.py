"""Common layers: norms, rotary embeddings, the gated MLP, embeddings.

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

def init_mlp(cfg: ModelConfig, d_in: int, d_ff: int, device,
             gen: Optional[torch.Generator], count: int = 0) -> dict:
    if cfg.mlp_kind != "silu_glu":
        raise NotImplementedError(f"mlp {cfg.mlp_kind!r} is not ported yet")
    dt = cdtype(cfg)
    return {
        "w_up": normal((d_in, d_ff), d_in ** -0.5, dt, device, gen, count),
        "w_down": normal((d_ff, d_in), d_ff ** -0.5, dt, device, gen, count),
        "w_gate": normal((d_in, d_ff), d_in ** -0.5, dt, device, gen, count),
    }


def mlp_fwd(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    up = x @ p["w_up"]
    h = F.silu(x @ p["w_gate"]) * up
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
