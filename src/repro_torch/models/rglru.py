"""RG-LRU recurrent block (RecurrentGemma / Griffin).

The reference's ``models/rglru.py`` (training, prefill, decode).  Per
channel:

    r_t = sigmoid(u_t W_a + b_a)             # recurrence gate
    i_t = sigmoid(u_t W_x + b_x)             # input gate
    a_t = exp(-c * softplus(Lambda) * r_t)   # c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Gates run in float32 with block-diagonal weights (``_N_BLOCKS`` blocks).
Training (``rec_block_fwd``) runs the plain scan under autograd.
Prefill's recurrence is the hand-written CUDA kernel K4
(``repro_torch.kernels.rglru_scan``) on the kernel path and the plain scan
otherwise; on a CPU tensor K4's wrapper runs the plain version too.
Decode writes the new ``h`` and conv window into the cache tensors it is
given, in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.launch.mesh import is_dtensor
from repro_torch.models.layers import (causal_conv1d, causal_conv1d_step,
                                       cdtype, gelu, normal)

_C = 8.0
_N_BLOCKS = 16


def _block_matmul_sharded(u, w):
    """``_block_matmul`` of DTensors in ``shard_map``: each rank takes
    its own blocks (u's channels laid out as w's blocks).  DTensor's
    einsum cannot merge the block axis back into the channels when the
    block axis is sharded."""
    from repro_torch.launch.mesh import shard_map
    from repro_torch.sharding.rules import P, axes_of, partial_over, spec_of

    blk = spec_of(w)[0]
    b = spec_of(u, strict=False)[0]
    if set(axes_of(b)) & set(axes_of(blk)):
        b = None
    u_spec = P(b, *([None] * (u.dim() - 2)), blk)
    w_spec = P(blk, None, None)
    return shard_map(_block_matmul, w.device_mesh, in_specs=(u_spec, w_spec),
                     out_specs=u_spec,
                     in_grad_specs=(u_spec, partial_over(w_spec, axes_of(b)))
                     )(u, w)


def _block_matmul(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u: (..., W) x block-diagonal w: (nb, W/nb, W/nb) -> (..., W)."""
    if is_dtensor(w):
        return _block_matmul_sharded(u, w)
    nb, bs, _ = w.shape
    un = u.reshape(u.shape[:-1] + (nb, bs))
    return torch.einsum("...nk,nkj->...nj", un, w).reshape(u.shape)


def _gates(p: dict, u: torch.Tensor):
    """(a, b) of the recurrence, float32, shaped like u."""
    uf = u.float()
    r = torch.sigmoid(_block_matmul(uf, p["w_a"].float()) + p["b_a"])
    i = torch.sigmoid(_block_matmul(uf, p["w_x"].float()) + p["b_x"])
    log_a = -_C * F.softplus(p["lambda_p"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * uf)
    return a, b


def rglru_ref(p: dict, u: torch.Tensor):
    """Full-sequence RG-LRU with the plain scan. u: (B, S, W) -> (y in u's
    dtype, h_final float32)."""
    a, b = _gates(p, u)
    h, h_last = rglru_scan_ref(a, b)
    return h.to(u.dtype), h_last


def rglru_step(p: dict, u: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One-token update. u: (B, W); h: (B, W) float32, overwritten with the
    new state.  Returns the output in u's dtype."""
    a, b = _gates(p, u[:, None, :])
    h_new = a[:, 0] * h.float() + b[:, 0]
    h.copy_(h_new)
    return h_new.to(u.dtype)


# ---------------------------------------------------------------------------
# Griffin recurrent block: proj -> conv -> RG-LRU -> gated output
# ---------------------------------------------------------------------------

def init_rec_block(cfg: ModelConfig, device, gen, count: int = 0) -> dict:
    """Parameters in the reference's layout; ``b_a``, ``b_x`` and
    ``lambda_p`` are float32 in every config."""
    W = cfg.rec.lru_width
    D = cfg.d_model
    nb = min(_N_BLOCKS, W)
    bs = W // nb
    dt = cdtype(cfg)
    s = D ** -0.5
    sb = bs ** -0.5
    lead = (count,) if count else ()

    def full(value):
        return torch.full(lead + (W,), value, dtype=torch.float32,
                          device=device)

    return {
        "w_in": normal((D, W), s, dt, device, gen, count),
        "w_gate": normal((D, W), s, dt, device, gen, count),
        "conv_w": normal((cfg.rec.conv_width, W), 0.2, dt, device, gen,
                         count),
        "w_a": normal((nb, bs, bs), sb, dt, device, gen, count),
        "b_a": full(0.0),
        "w_x": normal((nb, bs, bs), sb, dt, device, gen, count),
        "b_x": full(0.0),
        # softplus(lambda_p) ~ 0.97 -> a ~ exp(-7.8 r)
        "lambda_p": full(0.5),
        "w_out": normal((W, D), sb, dt, device, gen, count),
    }


def rec_block_fwd(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """Training forward, x: (B, S, D) -> (B, S, D), on the plain scan
    ``rglru_ref`` (K4 has no backward)."""
    u = x @ p["w_in"]
    u, _ = causal_conv1d(u, p["conv_w"])
    h, _ = rglru_ref(p, u)
    gate = gelu(x @ p["w_gate"])
    return (h * gate) @ p["w_out"]


def rec_block_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                      impl: str = "kernel"):
    """x: (B, S, D) -> (out, cache {h, conv_state}).  ``impl`` "kernel"
    runs K4; any other value the plain scan."""
    u = x @ p["w_in"]
    u, conv_state = causal_conv1d(u, p["conv_w"])
    if impl == "kernel":
        from repro_torch.kernels.rglru_scan import ops as rg_ops

        a, b = _gates(p, u)
        h, h_last = rg_ops.rglru_scan(a, b)
        h = h.to(u.dtype)
    else:
        h, h_last = rglru_ref(p, u)
    gate = gelu(x @ p["w_gate"])
    out = (h * gate) @ p["w_out"]
    return out, {"h": h_last.float(), "conv_state": conv_state}


def rec_block_step(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict):
    """x: (B, 1, D).  Writes the new ``h`` and conv window into ``cache``
    in place; returns (out, cache)."""
    u = x[:, 0, :] @ p["w_in"]
    u = causal_conv1d_step(u, p["conv_w"], cache["conv_state"])
    h = rglru_step(p, u, cache["h"])
    gate = gelu(x[:, 0, :] @ p["w_gate"])
    return ((h * gate) @ p["w_out"])[:, None, :], cache


def rec_cache_spec(cfg: ModelConfig, batch: int, count: int = 0) -> dict:
    """Cache shapes as meta tensors; ``count > 0`` adds the stacked layer
    axis."""
    W = cfg.rec.lru_width
    lead = (count,) if count else ()
    meta = torch.device("meta")
    return {
        "h": torch.empty(lead + (batch, W), dtype=torch.float32,
                         device=meta),
        "conv_state": torch.empty(lead + (batch, cfg.rec.conv_width - 1, W),
                                  dtype=cdtype(cfg), device=meta),
    }
