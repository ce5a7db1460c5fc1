"""Mixture-of-experts layer (DeepSeek-style fine-grained MoE): the local
dispatch of the reference's ``models/moe.py`` on one device.

Sort-based capacity dispatch, as in the reference:

1. router top-k per token over f32 probabilities (gates renormalised over
   the selected experts);
2. the (token, k) pairs flattened token-major, k-minor, and sorted by
   expert id (stable, so a token's pairs keep token order in each expert);
3. each pair's position within its expert; pairs at or past the static
   per-expert capacity ``C = max(8, ceil(T*k/E * capacity_factor))`` are
   dropped (classic capacity-based routing);
4. every expert's ``C`` slot rows gathered into one ``(E, C, D)`` block
   (empty slots read a zero sentinel row), the expert MLPs run as three
   batched matmuls;
5. each token sums its ``k`` gated slot rows (a dropped pair adds a zero
   row) in a fixed order: no ``index_add_``/``scatter_add_``, whose atomics
   on CUDA would make the bf16 sums depend on the order of arrival.

The reference's mesh (expert parallelism, its all-to-all variant) is gone:
one device holds every expert.  Routing and combine are plain tensor ops;
the reference runs no Pallas kernel here.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import cdtype, init_mlp, mlp_fwd, normal


def _shared_cfg(cfg: ModelConfig) -> ModelConfig:
    """The shared experts are one silu-GLU MLP of ``d_ff * n_shared``."""
    return dataclasses.replace(cfg, mlp_kind="silu_glu")


def init_moe(cfg: ModelConfig, device, gen, count: int = 0) -> dict:
    """``router`` (D, E) in f32, the experts' ``w_gate``/``w_up`` (E, D, F)
    and ``w_down`` (E, F, D) in the compute dtype, and ``shared``; ``count``
    stacks that many along a new axis 0."""
    m = cfg.moe
    dt = cdtype(cfg)
    D, E, Fh = cfg.d_model, m.num_experts, m.d_ff
    s_in, s_ff = D ** -0.5, Fh ** -0.5
    p = {
        "router": normal((D, E), s_in, torch.float32, device, gen, count),
        "w_gate": normal((E, D, Fh), s_in, dt, device, gen, count),
        "w_up": normal((E, D, Fh), s_in, dt, device, gen, count),
        "w_down": normal((E, Fh, D), s_ff, dt, device, gen, count),
    }
    if m.num_shared_experts:
        p["shared"] = init_mlp(_shared_cfg(cfg), D, Fh * m.num_shared_experts,
                               device, gen, count)
    return p


def _capacity(tokens: int, k: int, num_experts: int, cf: float) -> int:
    return max(8, int(math.ceil(tokens * k / num_experts * cf)))


def _router_probs(x2d: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """softmax(x @ router) in f32.  On the card the product must not run as
    TF32, which rounds its operands to 10 mantissa bits and can flip a
    top-k choice: no per-call switch exists, so a process that enabled
    TF32 fails here."""
    if x2d.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                        or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("the MoE router needs f32 matmuls: TF32 is on")
    return torch.softmax(x2d.float() @ router_w, dim=-1)


def _top_k(probs: torch.Tensor, k: int):
    """The router's choice: each token's k most probable experts, as
    (probabilities, expert ids).  ``torch.topk`` orders exactly equal
    probabilities in no stated order, where ``jax.lax.top_k`` takes the
    lower expert id first: the two can pick different experts only on a
    bitwise tie.  A comparison of two paths on the card substitutes this
    function to hold their routing equal."""
    return torch.topk(probs, k, dim=-1)


def moe_fwd(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
            live: int | None = None, aux: bool = True):
    """x: (B, S, D) -> (out (B, S, D), aux loss (f32 scalar)).  Prefill
    and decode drop the aux loss, as the reference's do: ``aux=False``
    skips it (None).

    ``live=None`` routes the B*S tokens together with the capacity of
    T = B*S tokens, as the reference's ``moe_fwd``.  ``live=n`` is the
    paged engine's decode step: x is (R, 1, D), its first ``n`` rows the
    lanes and the rest idle padding.  The reference engine decodes each
    lane alone (a vmap over lanes, ``serve/engine.py``), at T = 1, where a
    token's k pairs go to k distinct experts and the capacity of 8 never
    binds; here the rows route together with ``max(8, n)`` slots per
    expert, which keeps every lane's pairs as well.  The idle rows sort
    after every lane, so they never take a lane's slot, and the capacity,
    so the experts' (E, C, D) block, does not depend on the padding.  The
    aux loss is then the lanes' own."""
    m = cfg.moe
    B, S, D = x.shape
    T, k, E = B * S, m.top_k, m.num_experts
    x2d = x.reshape(T, D)
    if live is None:
        n, capacity = T, _capacity(T, k, E, m.capacity_factor)
    else:
        if S != 1 or not 0 < live <= B:
            raise ValueError(f"live={live} needs (R >= live, 1, D) rows, "
                             f"got {tuple(x.shape)}")
        n, capacity = live, max(_capacity(1, k, E, m.capacity_factor), live)

    probs = _router_probs(x2d, p["router"])                     # (T, E)
    top_p, top_e = _top_k(probs, k)                             # (T, k)
    gates = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(-1)                                  # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos = (torch.arange(T * k, device=x.device)
           - torch.searchsorted(sorted_e, sorted_e, side="left"))
    # slot of each sorted pair; a dropped pair gets the sentinel E*C
    slot = torch.where(pos < capacity, sorted_e * capacity + pos,
                       E * capacity)
    # slot -> token (T: the zero row past the tokens), sentinel trimmed;
    # only the sentinel index repeats, so no two kept pairs collide
    tok_for_slot = torch.full((E * capacity + 1,), T, dtype=torch.long,
                              device=x.device)
    tok_for_slot[slot] = order // k
    x_pad = torch.cat([x2d, x2d.new_zeros(1, D)])
    xs = x_pad[tok_for_slot[:-1]].reshape(E, capacity, D)

    h = torch.bmm(xs, p["w_gate"])
    u = torch.bmm(xs, p["w_up"])
    ys = torch.bmm(F.silu(h) * u, p["w_down"])                  # (E, C, D)

    # each pair's slot in (token, k) order; the combine gathers a token's
    # k slot rows (the sentinel is a zero row) and sums them
    pair_slot = torch.empty_like(slot).scatter_(0, order, slot).reshape(T, k)
    ys_pad = torch.cat([ys.reshape(E * capacity, D), ys.new_zeros(1, D)])
    contrib = ys_pad[pair_slot] * gates.to(ys.dtype)[..., None]  # (T, k, D)
    out = contrib.sum(1).reshape(B, S, D)

    if m.num_shared_experts:
        out = out + mlp_fwd(_shared_cfg(cfg), p["shared"], x)
    if not aux:
        return out, None
    # aux load-balancing loss: f counts every routed pair, dropped ones
    # too; p_mean is over the tokens (the lanes, with ``live``)
    # (a count by scatter_add_, exact in int64, where ``bincount`` has no
    # meta kernel: the meta-device dry run runs this step)
    ids = flat_e[:n * k]
    counts = torch.zeros(E, dtype=torch.long, device=x.device)
    counts.scatter_add_(0, ids, torch.ones_like(ids))
    f = counts.float() / (n * k)
    return out, E * torch.sum(f * probs[:n].mean(0))
