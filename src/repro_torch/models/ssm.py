"""Mamba2 block: SSD (state-space duality) with the chunked algorithm.

The reference's ``models/ssm.py``: training (``ssm_block_fwd``) and
prefill run the whole sequence through the chunked scan, decode is a
single-token step.  Training runs the plain ``ssd_chunked`` under
autograd.  Prefill's
scan is the hand-written CUDA kernel K3 (``repro_torch.kernels.ssd_scan``)
on the kernel path and the plain ``ssd_chunked`` otherwise; on a CPU tensor
K3's wrapper runs the plain version too.

Decode updates the SSM state and the conv windows *in place* in the cache
tensors it is given (the monitor's donated buffers), where the reference
returns new arrays; callers that need the old cache pass a copy.  The
state stays float32 whatever the compute dtype, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.models.layers import (causal_conv1d, causal_conv1d_step,
                                       cdtype, normal)

def ssm_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    return d_inner, nheads, s.d_state, s.head_dim


def ssd_step(x, dt, A, Bm, Cm, state):
    """Single-token SSD update, writing the new state into ``state``.

    x: (B, H, P), dt: (B, H), Bm/Cm: (B, N), state: (B, H, P, N) float32.
    Returns y: (B, H, P) in x's dtype."""
    f32 = torch.float32
    dtf = dt.to(f32)
    dA = torch.exp(dtf * A.to(f32))                            # (B,H)
    xdt = x.to(f32) * dtf[..., None]                           # (B,H,P)
    new = (state.to(f32) * dA[..., None, None]
           + xdt[..., None] * Bm.to(f32)[:, None, None, :])
    state.copy_(new)
    y = torch.einsum("bhpn,bn->bhp", new, Cm.to(f32))
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def init_ssm_block(cfg: ModelConfig, device, gen, count: int = 0) -> dict:
    """Parameters in the reference's layout; ``dt_bias``, ``A_log`` and
    ``D_skip`` are float32 in every config."""
    di, H, N, Pd = ssm_dims(cfg)
    dt_ = cdtype(cfg)
    D = cfg.d_model
    K = cfg.ssm.d_conv
    s = D ** -0.5
    lead = (count,) if count else ()

    def full(shape, value, dtype):
        return torch.full(lead + shape, value, dtype=dtype, device=device)

    return {
        "w_z": normal((D, di), s, dt_, device, gen, count),
        "w_x": normal((D, di), s, dt_, device, gen, count),
        "w_B": normal((D, N), s, dt_, device, gen, count),
        "w_C": normal((D, N), s, dt_, device, gen, count),
        "w_dt": normal((D, H), s, dt_, device, gen, count),
        "conv_x": normal((K, di), 0.2, dt_, device, gen, count),
        "conv_B": normal((K, N), 0.2, dt_, device, gen, count),
        "conv_C": normal((K, N), 0.2, dt_, device, gen, count),
        "dt_bias": full((H,), 0.0, torch.float32),
        "A_log": full((H,), 0.0, torch.float32),     # A = -exp(A_log) = -1
        "D_skip": full((H,), 1.0, torch.float32),
        "norm_scale": full((di,), 1.0, dt_),
        "out_proj": normal((di, D), di ** -0.5, dt_, device, gen, count),
    }


def _gated_norm(y, z, scale):
    yf = y.float() * F.silu(z.float())
    ms = yf.square().mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(ms + 1e-6) * scale.float()).to(y.dtype)


def _ssm_proj_conv(cfg, p, x, conv_states=None):
    """Projections + causal convs; returns (z, xs, Bm, Cm, dt, conv_states).
    With ``conv_states`` (decode, x: (B, D)) the windows are updated in
    place and returned; without (prefill, x: (B, S, D)) new ones are."""
    z = x @ p["w_z"]
    xs = x @ p["w_x"]
    Bm = x @ p["w_B"]
    Cm = x @ p["w_C"]
    dt_raw = x @ p["w_dt"]
    if conv_states is None:
        xs, cx = causal_conv1d(xs, p["conv_x"])
        Bm, cb = causal_conv1d(Bm, p["conv_B"])
        Cm, cc = causal_conv1d(Cm, p["conv_C"])
        conv_states = {"x": cx, "B": cb, "C": cc}
    else:
        xs = causal_conv1d_step(xs, p["conv_x"], conv_states["x"])
        Bm = causal_conv1d_step(Bm, p["conv_B"], conv_states["B"])
        Cm = causal_conv1d_step(Cm, p["conv_C"], conv_states["C"])
    xs, Bm, Cm = F.silu(xs), F.silu(Bm), F.silu(Cm)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    return z, xs, Bm, Cm, dt, conv_states


def ssm_block_fwd(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """Full-sequence Mamba2 block for training, x: (B, S, D) -> (B, S, D),
    on the plain ``ssd_chunked`` (K3 has no backward)."""
    di, H, N, Pd = ssm_dims(cfg)
    B, S, _ = x.shape
    z, xs, Bm, Cm, dt, _ = _ssm_proj_conv(cfg, p, x)
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B, S, H, Pd)
    y, _ = ssd_chunked(xh, dt, A, Bm, Cm, chunk=cfg.ssm.chunk_size)
    y = y + xh * p["D_skip"][:, None].to(y.dtype)
    y = _gated_norm(y.reshape(B, S, di), z, p["norm_scale"])
    return y @ p["out_proj"]


def ssm_block_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                      impl: str = "kernel"):
    """Prefill: x (B, S, D) -> (out, cache {ssm_state, conv}).  ``impl``
    "kernel" runs K3; any other value the plain ``ssd_chunked``."""
    di, H, N, Pd = ssm_dims(cfg)
    B, S, _ = x.shape
    z, xs, Bm, Cm, dt, conv_states = _ssm_proj_conv(cfg, p, x)
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B, S, H, Pd)
    if impl == "kernel":
        from repro_torch.kernels.ssd_scan import ops as ssd_ops

        y, st = ssd_ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=cfg.ssm.chunk_size)
    else:
        y, st = ssd_chunked(xh, dt, A, Bm, Cm, chunk=cfg.ssm.chunk_size)
    y = y + xh * p["D_skip"][:, None].to(y.dtype)
    y = _gated_norm(y.reshape(B, S, di), z, p["norm_scale"])
    cache = {"ssm_state": st.float(), "conv": conv_states}
    return y @ p["out_proj"], cache


def ssm_block_step(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict):
    """One-token decode. x: (B, 1, D).  Writes the new SSM state and conv
    windows into ``cache`` in place; returns (out, cache)."""
    di, H, N, Pd = ssm_dims(cfg)
    B = x.shape[0]
    z, xs, Bm, Cm, dt, _ = _ssm_proj_conv(cfg, p, x[:, 0, :],
                                          conv_states=cache["conv"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B, H, Pd)
    y = ssd_step(xh, dt, A, Bm, Cm, cache["ssm_state"])
    y = y + xh * p["D_skip"][:, None].to(y.dtype)
    y = _gated_norm(y.reshape(B, di), z, p["norm_scale"])
    return (y @ p["out_proj"])[:, None, :], cache


def ssm_cache_spec(cfg: ModelConfig, batch: int, count: int = 0) -> dict:
    """Cache shapes as meta tensors; ``count > 0`` adds the stacked layer
    axis."""
    di, H, N, Pd = ssm_dims(cfg)
    dt = cdtype(cfg)
    K = cfg.ssm.d_conv
    lead = (count,) if count else ()
    meta = torch.device("meta")

    def spec(shape, dtype):
        return torch.empty(lead + shape, dtype=dtype, device=meta)

    return {
        "ssm_state": spec((batch, H, Pd, N), torch.float32),
        "conv": {"x": spec((batch, K - 1, di), dt),
                 "B": spec((batch, K - 1, N), dt),
                 "C": spec((batch, K - 1, N), dt)},
    }
