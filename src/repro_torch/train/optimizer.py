"""AdamW and its schedule, written by hand (no ``torch.optim``), so each
step can be held against the reference's ``repro.train.optimizer``.

Moments support the reference's three storage formats (``moment_dtype``):

* ``float32``  — exact Adam;
* ``bfloat16`` — halves moment memory; the update math stays f32;
* ``int8``     — 8-bit Adam: m linear with one f32 scale per last-dim row,
  v in log space with a (log_lo, range) pair per row.

Gradients are first cast to ``grad_reduce_dtype`` (bf16) where they are
f32, and only then clipped and applied, as the reference does: a port
that took the norm of the f32 gradients would drift from it even in f32.
A leaf of rank >= 2 is updated a block of last-dim rows at a time (about
``_UPDATE_BLOCK`` elements), which bounds the f32 temporaries of the
update to a block, where the reference bounds them to one stacked layer
with ``lax.map``; the arithmetic is elementwise or per last-dim row, so
the blocking changes no value.

``apply_updates`` writes the new parameters and state into the tensors it
was given and returns them: the caller gives them up, as it donates them
to the reference's jitted step, and the card holds one copy of each.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.launch.mesh import is_dtensor
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

# elements of one block of the update (f32 temporaries of ~128 MB each)
_UPDATE_BLOCK = 1 << 25

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

_V_LOG_FLOOR = -46.0    # log(1e-20): "zero" second moment


def _v_floor() -> torch.Tensor:
    """exp(_V_LOG_FLOOR) evaluated in float32, as the reference does."""
    return torch.exp(torch.tensor(_V_LOG_FLOOR, dtype=torch.float32))


def _q8(x32: torch.Tensor):
    """Symmetric int8 quantization with per-last-dim-row f32 scales (m)."""
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _q8_log(v32: torch.Tensor):
    """Log-space int8 quantization for the (non-negative) second moment:
    uniform *relative* precision per row.  The scale carries (log_lo,
    range)."""
    vc = torch.maximum(v32, _v_floor().to(v32.device))
    lo = torch.log(vc.amin(dim=-1, keepdim=True))
    hi = torch.log(vc.amax(dim=-1, keepdim=True))
    rng = torch.clamp(hi - lo, min=1e-9)
    q = torch.clamp(torch.round((torch.log(vc) - lo) / rng * 254.0) - 127.0,
                    -127, 127).to(torch.int8)
    return q, torch.cat([lo, rng], dim=-1).float()


def _dq8_log(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    lo = scale[..., :1]
    rng = scale[..., 1:2]
    v = torch.exp(lo + (q.float() + 127.0) / 254.0 * rng)
    floor = _v_floor().to(v.device) * 1.001
    return torch.where(v <= floor, 0.0, v)


@dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    # gradients are rounded to this dtype before the norm and the update,
    # as in the reference (where it is the cross-shard reduction's format)
    grad_reduce_dtype: str = "bfloat16"


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr``; f32, on ``step``'s
    device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(cfg: OptConfig, params: Any) -> dict:
    """Zero moments beside each parameter leaf, on its device (``meta``
    parameters give the state's shapes only); ``count`` is an int32
    scalar."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    count = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.moment_dtype == "int8":
        def zv(p):
            s = torch.zeros(p.shape[:-1] + (2,), dtype=torch.float32,
                            device=p.device)
            s[..., 0] = _V_LOG_FLOOR
            return s

        def z8(p):
            return torch.zeros(p.shape, dtype=torch.int8, device=p.device)

        return {
            "m": tree_map(z8, params),
            "v": tree_map(z8, params),
            "m_scale": tree_map(lambda p: torch.zeros(
                p.shape[:-1] + (1,), dtype=torch.float32, device=p.device),
                params),
            "v_scale": tree_map(zv, params),
            "count": count,
        }
    dt = _DTYPES[cfg.moment_dtype]

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": count}


def _local(t):
    """A replicated DTensor scalar's value on this rank."""
    return t.full_tensor() if is_dtensor(t) else t


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def reduce_grad(cfg: OptConfig, g: torch.Tensor) -> torch.Tensor:
    """One gradient leaf in ``grad_reduce_dtype`` (f32 leaves only)."""
    if cfg.grad_reduce_dtype and g.dtype == torch.float32:
        return g.to(_DTYPES[cfg.grad_reduce_dtype])
    return g


def apply_updates(cfg: OptConfig, params: Any, grads: Any, state: dict):
    """One AdamW step, in place. Returns (params, state, stats).  DTensor
    leaves (a mesh) update shard by shard on each rank, the gradient
    first laid out as its parameter (a reduce-scatter or all-reduce of a
    partial sum); int8 moments, whose per-row scales span a row's shards,
    update as DTensors."""
    grads = tree_map(lambda g: reduce_grad(cfg, g), grads)
    count = state["count"] + 1
    gnorm = global_norm(grads)
    if cfg.clip_norm:
        scale = torch.clamp(gnorm.new_tensor(cfg.clip_norm)
                            / torch.clamp(gnorm, min=1e-9), max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    lr = lr_at(cfg, count)
    b1, b2 = cfg.b1, cfg.b2
    c = count.to(torch.float32)
    bc1 = 1 - b1 ** c
    bc2 = 1 - b2 ** c
    int8 = cfg.moment_dtype == "int8"
    mdt = torch.float32 if int8 else _DTYPES[cfg.moment_dtype]

    scalars = (scale, lr, bc1, bc2)

    def upd(p, g, m, v, ms, vs, decay, scalars=scalars):
        scale, lr, bc1, bc2 = scalars
        g = g.float() * scale
        m32 = _dq8(m, ms) if int8 else m.float()
        v32 = _dq8_log(v, vs) if int8 else v.float()
        m32 = b1 * m32 + (1 - b1) * g
        v32 = b2 * v32 + (1 - b2) * torch.square(g)
        v32 = torch.clamp(v32, min=0.0)
        mhat = m32 / bc1
        vhat = v32 / bc2
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        if decay:
            step = step + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * step).to(p.dtype)
        if int8:
            mq, msc = _q8(m32)
            vq, vsc = _q8_log(v32)
            return new_p, mq, vq, msc, vsc
        return new_p, m32.to(mdt), v32.to(mdt), None, None

    def upd_leaf(p, g, m, v, ms, vs):
        if is_dtensor(p) and not int8:
            # every operation is element-wise: each rank updates its own
            # shards (the gradient in the parameter's layout, the
            # moments in it already) with the replicated scalars
            g = g.redistribute(p.device_mesh, p.placements)
            upd_local(*(t.to_local() for t in (p, g, m, v)), None, None,
                      tuple(_local(s) for s in scalars))
            return (p, m, v, ms, vs)
        return upd_local(p, g, m, v, ms, vs, scalars)

    def upd_local(p, g, m, v, ms, vs, scalars):
        outs = (p, m, v, ms, vs)
        # no decay on norms/bias (rank < 2), as in the reference
        decay = bool(cfg.weight_decay) and p.ndim >= 2
        blocks = [None]
        if (p.ndim >= 2 and not is_dtensor(p)
                and all(t is None or t.is_contiguous() for t in outs)):
            rows = p.numel() // p.shape[-1]
            per = max(1, _UPDATE_BLOCK // max(p.shape[-1], 1))
            blocks = [(r, min(r + per, rows)) for r in range(0, rows, per)]

        def at(t, blk):
            if t is None or blk is None:
                return t
            return t.reshape(-1, t.shape[-1])[blk[0]:blk[1]]

        for blk in blocks:
            new = upd(*(at(t, blk) for t in (p, g, m, v, ms, vs)), decay,
                      scalars)
            for dst, val in zip(outs, new):
                if dst is not None:
                    at(dst, blk).copy_(val)
            del new
        return outs

    flat_p, treedef = tree_flatten(params)
    flat_g = tree_leaves(grads)
    flat_m = tree_leaves(state["m"])
    flat_v = tree_leaves(state["v"])
    none = [None] * len(flat_p)
    flat_ms = tree_leaves(state["m_scale"]) if int8 else none
    flat_vs = tree_leaves(state["v_scale"]) if int8 else none
    out = [upd_leaf(*leaf) for leaf in
           zip(flat_p, flat_g, flat_m, flat_v, flat_ms, flat_vs)]

    def unflat(j):
        return tree_unflatten(treedef, [o[j] for o in out])

    state["count"].copy_(count)
    new_state = {"m": unflat(1), "v": unflat(2), "count": state["count"]}
    if int8:
        new_state["m_scale"] = unflat(3)
        new_state["v_scale"] = unflat(4)
    return unflat(0), new_state, {"lr": lr, "grad_norm": gnorm}
