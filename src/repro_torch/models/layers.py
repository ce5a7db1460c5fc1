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

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import is_dtensor, mesh_ranks

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# the most elements one float32 draw of ``normal`` holds (4 GiB): a larger
# tensor (deepseek-v3's expert weights, 256 x 7168 x 2048) is drawn in
# blocks along axis 0; every smaller one, in one draw
_DRAW_MAX = 1 << 30


def _fill_normal(out: torch.Tensor, scale: float,
                 gen: Optional[torch.Generator]) -> None:
    """``out`` <- ``N(0,1) * scale`` drawn in float32 and cast on the copy,
    in one draw, or in blocks along axis 0 past ``_DRAW_MAX`` elements."""
    row = out[0].numel() if out.dim() > 1 else 0
    if out.numel() > _DRAW_MAX and 0 < row <= _DRAW_MAX:
        step = _DRAW_MAX // row
        for i in range(0, out.shape[0], step):
            _fill_normal(out[i:i + step], scale, gen)
        return
    x = torch.randn(out.shape, generator=gen, device=out.device,
                    dtype=torch.float32)
    out.copy_(x.mul_(scale))


def normal(shape, scale: float, dtype: torch.dtype, device: torch.device,
           gen: Optional[torch.Generator], count: int = 0) -> torch.Tensor:
    """``N(0,1) * scale`` drawn in float32 and cast, like the reference.

    ``count > 0`` stacks ``count`` independent draws along a new axis 0,
    each drawn into its slice, so the float32 temporary stays one slice
    (or one block of ``_fill_normal``'s)."""
    shape = tuple(shape)
    out = torch.empty(((count,) if count else ()) + shape, dtype=dtype,
                      device=device)
    if device.type != "meta":
        for t in (out.unbind(0) if count else (out,)):
            _fill_normal(t, scale, gen)
    return out


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, d: int, device, count: int = 0) -> dict:
    """RMSNorm (``scale``) or LayerNorm (``scale`` and ``bias``); ``count``
    stacks that many along a new axis 0."""
    if cfg.norm_kind not in ("rmsnorm", "layernorm"):
        raise ValueError(f"unknown norm kind {cfg.norm_kind!r}")
    shape = ((count,) if count else ()) + (d,)
    p = {"scale": torch.ones(shape, dtype=cdtype(cfg), device=device)}
    if cfg.norm_kind == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=cdtype(cfg), device=device)
    return p


def norm_fwd(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_kind == "layernorm":
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + 1e-5)
        out = out * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + 1e-6) * p["scale"].float()
    return out.to(x.dtype)


def rmsnorm_1d(x: torch.Tensor, scale: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis with an explicit scale (qk-norm)."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


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


def by_rows(rows: Optional[int], fn, *xs):
    """``fn(*xs)`` computed ``rows`` leading rows of each of ``xs`` at a
    time, its outputs (a tensor or a tuple of them) concatenated: every
    product in ``fn`` then runs at ``rows`` rows however many ``xs`` hold
    (a multiple of ``rows``).  A ``None`` among ``xs`` passes as it is;
    ``rows`` None, or ``xs`` of at most ``rows`` rows, is one call."""
    n = xs[0].shape[0]
    if rows is None or n <= rows:
        return fn(*xs)
    outs = [fn(*(None if x is None else x[i:i + rows] for x in xs))
            for i in range(0, n, rows)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


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
    if is_dtensor(p["embedding"]):
        return _embed_sharded(tokens, p["embedding"])
    return F.embedding(tokens.long(), p["embedding"])


def _embed_sharded(tokens, table):
    """The lookup of a DTensor table, vocab-parallel in ``shard_map``:
    each rank looks its tokens up in its own vocabulary rows (zero where
    another rank holds the row) and the result is a partial sum over the
    vocab axes, reduced where the next layout needs it.  DTensor's own
    lookup into a vocab-sharded table fails on a batch-sharded index."""
    from repro_torch.launch.mesh import axis_index, shard_map
    from repro_torch.sharding.rules import P, axes_of, partial_over, spec_of

    mesh = table.device_mesh
    v_entry = spec_of(table)[0]
    v_axes = axes_of(v_entry)
    # the tokens are replicated over the vocab axes: every rank of a
    # vocab group looks up the same tokens in its own rows
    t_spec = spec_of(tokens)
    b_axes = tuple(a for a in axes_of(t_spec[0]) if a not in v_axes)
    t_spec = P(b_axes or None, *t_spec[1:])
    tab_spec = P(v_entry, None)

    def body(tok, tab):
        if not v_axes:
            return F.embedding(tok.long(), tab)
        V_l = tab.shape[0]
        t = tok.long() - axis_index(mesh, v_axes) * V_l
        inr = (t >= 0) & (t < V_l)
        return torch.where(inr[..., None],
                           F.embedding(t.clamp(0, V_l - 1), tab), 0.0)

    out_spec = partial_over(P(*t_spec, None), v_axes)
    return shard_map(body, mesh, in_specs=(t_spec, tab_spec),
                     out_specs=out_spec,
                     in_grad_specs=(t_spec, partial_over(tab_spec, b_axes))
                     )(tokens, table)


def lm_head_fwd(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ p["embedding"].T
    return x @ p["lm_head"]


def shard_logits(logits: torch.Tensor, mesh, dp_axes) -> torch.Tensor:
    """Keep (B, S, V) logits vocab-sharded over the model axis (and the
    batch over ``dp_axes`` where it divides), as the reference pins them:
    the loss then reduces shard-locally plus small all-reduces
    (``cross_entropy``), never an all-gather of full-vocab f32 logits.
    Identity without a mesh."""
    if mesh is None or not is_dtensor(logits):
        return logits
    from repro_torch.sharding.rules import P, axis_names, placements

    names = axis_names(mesh)
    if "model" not in names:
        return logits
    dp_axes = tuple(dp_axes or ())
    bdim = (dp_axes if dp_axes and logits.shape[0] % mesh_ranks(mesh, dp_axes)
            == 0 else None)
    tp = ("model" if logits.shape[-1] % mesh_ranks(mesh, "model") == 0
          and "model" not in (bdim or ()) else None)
    spec = P(bdim, *([None] * (logits.dim() - 2)), tp)
    return logits.redistribute(mesh, placements(spec, mesh, logits.shape))


def shard_batch_dim(x: torch.Tensor, mesh, dp_axes) -> torch.Tensor:
    """Lay dim 0 (batch) over the data axes, the rest replicated, where
    they divide it: activations never replicate across data shards.
    Identity without a mesh."""
    if mesh is None or not dp_axes or not is_dtensor(x):
        return x
    if x.shape[0] % mesh_ranks(mesh, dp_axes) != 0:
        return x
    from repro_torch.sharding.rules import P, placements

    spec = P(tuple(dp_axes), *([None] * (x.dim() - 1)))
    return x.redistribute(mesh, placements(spec, mesh, x.shape))


def _cross_entropy_sharded(logits, targets, mask):
    """``cross_entropy`` of DTensor logits, vocab-parallel in
    ``shard_map``: each rank takes its rows' max, sum of exponentials and
    gold logit over its own vocabulary slice, and the model group sums
    them (the gold logit is the one rank's that holds the target).  The
    mean over the rows is a partial sum over the batch axes.  DTensor's
    own ``gather`` over a vocab-sharded dimension fails, and an
    all-gather of the logits is what ``shard_logits`` exists to avoid."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import axis_group, axis_index, psum, shard_map
    from repro_torch.sharding.rules import P, axes_of, partial_over, spec_of

    mesh = logits.device_mesh
    spec = spec_of(logits)
    b_axes, v_axes = axes_of(spec[0]), axes_of(spec[-1])
    nd = logits.dim()
    l_spec = P(spec[0], *([None] * (nd - 2)), spec[-1])
    t_spec = P(spec[0], *([None] * (targets.dim() - 1)))
    n_rows = logits[..., 0].numel()
    n_b = mesh_ranks(mesh, b_axes) if b_axes else 1

    def body(lg, tg, *mk):
        v_group = axis_group(mesh, v_axes) if v_axes else None
        m = lg.detach().amax(dim=-1, keepdim=True)
        if v_group is not None:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=v_group)
        shifted = (lg - m).float()
        sumexp = torch.exp(shifted).sum(dim=-1)
        t = tg.long()[..., None]
        if v_group is None:
            gold = shifted.gather(-1, t)[..., 0]
        else:
            V_l = lg.shape[-1]
            t = t - axis_index(mesh, v_axes) * V_l
            inr = (t >= 0) & (t < V_l)
            gold = torch.where(inr, shifted.gather(-1, t.clamp(0, V_l - 1)),
                               0.0)[..., 0]
            sumexp, gold = psum(sumexp, v_group), psum(gold, v_group)
        nll = torch.log(sumexp) - gold
        if mk:
            w = mk[0].float()
            den = w.sum()
            if n_b > 1:
                den = den.detach().clone()
                dist.all_reduce(den, group=axis_group(mesh, b_axes))
            return (nll * w).sum() / torch.clamp(den, min=1.0)
        return nll.mean() if n_b == 1 else nll.sum() / n_rows

    args = (logits, targets) + ((mask,) if mask is not None else ())
    return shard_map(body, mesh,
                     in_specs=(l_spec, t_spec, t_spec)[:len(args)],
                     out_specs=partial_over(P(), b_axes))(*args)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy with f32 accumulation; ``mask`` (0/1 per
    token) averages over the kept tokens only.  The gold logit is a
    ``gather`` of the same f32 value the reference takes as a masked sum
    over the vocab axis (a sum of one value and zeros), without a
    (B, S, V) mask; its backward writes one value per row, so it sums in
    no order.  DTensor logits (a mesh) take the vocab-parallel form."""
    if is_dtensor(logits):
        return _cross_entropy_sharded(logits, targets, mask)
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
