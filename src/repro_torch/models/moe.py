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

On a device mesh (``moe_fwd(..., mesh=...)``, DTensor inputs) the
reference's two expert-parallel dispatches run in ``shard_map`` bodies:

* ``"local"`` (``_expert_shard``): rows sharded over the data axes and
  replicated over ``"model"``, each model rank owning ``E/ep`` experts.
  Every rank routes its rows, runs its own experts on the pairs they
  take (steps 3-5 over its experts only), and the partial outputs are
  summed over the model group (``psum``: one all-reduce).
* ``"a2a"`` (``_expert_shard_a2a``): rows sharded over every expert axis
  and the experts resident (``a2a_axes_for``).  Every rank fills an
  (E, C, D) block of its rows for every expert, an ``all_to_all`` sends
  each expert's block to its owner, the owner's experts run, a second
  ``all_to_all`` returns the rows and each rank combines its own tokens.

The aux loss is each rank's own, averaged over the ranks the rows were
split over.  On one rank both dispatches give the local dispatch's bits
(their collectives run and move nothing).  Routing and combine are plain
tensor ops; the reference runs no Pallas kernel here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

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


def _route(x2d: torch.Tensor, router_w: torch.Tensor, k: int):
    """(probs (T, E) f32, expert ids (T, k), gates (T, k)): each token's
    k most probable experts, their probabilities renormalised."""
    probs = _router_probs(x2d, router_w)                        # (T, E)
    top_p, top_e = _top_k(probs, k)                             # (T, k)
    gates = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_e, gates


def _slots(top_e: torch.Tensor, capacity: int, e0: int, n_exp: int):
    """The (token, k) pairs flattened token-major and sorted by expert
    (stable), and each sorted pair's slot in the (n_exp, capacity) block
    of experts ``e0 .. e0 + n_exp - 1``: a pair past its expert's
    capacity, or of an expert outside the block, gets the sentinel
    ``n_exp * capacity``; only the sentinel repeats.  Returns (order,
    slot)."""
    T, k = top_e.shape
    flat_e = top_e.reshape(-1)                                  # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos = (torch.arange(T * k, device=top_e.device)
           - torch.searchsorted(sorted_e, sorted_e, side="left"))
    keep = (pos < capacity) & (sorted_e >= e0) & (sorted_e < e0 + n_exp)
    slot = torch.where(keep, (sorted_e - e0) * capacity + pos,
                       n_exp * capacity)
    return order, slot


def _gather_rows(x2d: torch.Tensor, order, slot, k: int, n_slots: int):
    """The (n_slots, D) block of slot rows: each kept pair's token row,
    a zero row in every empty slot."""
    T, D = x2d.shape
    tok_for_slot = torch.full((n_slots + 1,), T, dtype=torch.long,
                              device=x2d.device)
    tok_for_slot[slot] = order // k
    x_pad = torch.cat([x2d, x2d.new_zeros(1, D)])
    return x_pad[tok_for_slot[:-1]]


def _experts(xs: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """The expert MLPs on their (E, C, D) slot rows, as three batched
    matmuls."""
    h = torch.bmm(xs, wg)
    u = torch.bmm(xs, wu)
    return torch.bmm(F.silu(h) * u, wd)                         # (E, C, D)


def _combine(ys2d: torch.Tensor, order, slot, gates) -> torch.Tensor:
    """Each token's gated sum of its k slot rows (the sentinel is a zero
    row), in (token, k) order: (T, D)."""
    T, k = gates.shape
    pair_slot = torch.empty_like(slot).scatter_(0, order, slot).reshape(T, k)
    ys_pad = torch.cat([ys2d, ys2d.new_zeros(1, ys2d.shape[1])])
    contrib = ys_pad[pair_slot] * gates.to(ys2d.dtype)[..., None]  # (T,k,D)
    return contrib.sum(1)


def _aux_loss(probs, top_e, n: int, E: int) -> torch.Tensor:
    """The load-balancing loss of the first ``n`` tokens: f counts every
    routed pair, dropped ones too (by ``scatter_add_``, exact in int64,
    where ``bincount`` has no meta kernel: the meta-device dry run runs
    this step); p_mean is over the tokens."""
    k = top_e.shape[1]
    ids = top_e.reshape(-1)[:n * k]
    counts = torch.zeros(E, dtype=torch.long, device=probs.device)
    counts.scatter_add_(0, ids, torch.ones_like(ids))
    f = counts.float() / (n * k)
    return E * torch.sum(f * probs[:n].mean(0))


def _expert_shard(x2d, router_w, wg, wu, wd, *, top_k: int,
                  num_experts: int, capacity: int, mesh, ep_axis: str,
                  aux_axes: Tuple[str, ...]):
    """Body of the local expert-parallel dispatch, on one rank's shards:
    x2d (T, D) its rows (replicated over ``ep_axis``), the experts
    ``r*E_l .. (r+1)*E_l - 1`` of its ``ep_axis`` index r.  Returns (its
    rows' output summed over ``ep_axis``, the aux loss averaged over
    ``aux_axes``)."""
    from repro_torch.launch.mesh import axis_group, axis_index, mesh_ranks, psum

    T, D = x2d.shape
    E_l = wg.shape[0]
    e0 = axis_index(mesh, ep_axis) * E_l
    probs, top_e, gates = _route(x2d, router_w, top_k)
    order, slot = _slots(top_e, capacity, e0, E_l)
    xs = _gather_rows(x2d, order, slot, top_k, E_l * capacity)
    ys = _experts(xs.reshape(E_l, capacity, D), wg, wu, wd)
    out = _combine(ys.reshape(E_l * capacity, D), order, slot, gates)
    out = psum(out, axis_group(mesh, ep_axis))
    aux = _aux_loss(probs, top_e, T, num_experts)
    n = mesh_ranks(mesh, aux_axes)
    return out, psum(aux / n, axis_group(mesh, aux_axes))


def _expert_shard_a2a(x2d, router_w, wg, wu, wd, *, top_k: int,
                      num_experts: int, capacity: int, mesh,
                      ep_axes: Tuple[str, ...], aux_axes: Tuple[str, ...]):
    """Body of the 2-D expert-parallel dispatch: tokens travel, weights
    stay resident.  x2d (T, D) is this rank's rows, wg/wu/wd its E/n_ep
    experts.  The (E, C, D) send block goes out by ``all_to_all`` so each
    rank receives every source's rows for its own experts; the expert
    outputs return the same way and each rank combines its rows.  Expert
    gradients are whole on the owning rank."""
    from torch.distributed.nn.functional import all_to_all_single

    from repro_torch.launch.mesh import axis_group, mesh_ranks, psum

    T, D = x2d.shape
    E, E_l = num_experts, wg.shape[0]
    n_ep = E // E_l
    group = axis_group(mesh, ep_axes)
    probs, top_e, gates = _route(x2d, router_w, top_k)
    order, slot = _slots(top_e, capacity, 0, E)
    send = _gather_rows(x2d, order, slot, top_k, E * capacity)
    send = send.reshape(n_ep, E_l, capacity, D)
    # tokens -> expert owners: (n_ep sources, E_l, C, D) on each owner
    recv = all_to_all_single(torch.empty_like(send), send, group=group)
    xs = recv.transpose(0, 1).reshape(E_l, n_ep * capacity, D)
    ys = _experts(xs, wg, wu, wd)
    back = ys.reshape(E_l, n_ep, capacity, D).transpose(0, 1).contiguous()
    ret = all_to_all_single(torch.empty_like(back), back, group=group)
    out = _combine(ret.reshape(E * capacity, D), order, slot, gates)
    aux = _aux_loss(probs, top_e, T, E)
    n = mesh_ranks(mesh, aux_axes)
    return out, psum(aux / n, axis_group(mesh, aux_axes))


def a2a_axes_for(cfg: ModelConfig, mesh) -> Tuple[str, ...]:
    """The largest expert-axis set the expert count divides."""
    from repro_torch.sharding.rules import axis_sizes

    sizes = axis_sizes(mesh)
    E = cfg.moe.num_experts
    for axes in (("data", "model"), ("model",)):
        if all(a in sizes for a in axes):
            if E % math.prod(sizes[a] for a in axes) == 0:
                return axes
    return ()


def _moe_on_mesh(cfg: ModelConfig, p: dict, x2d, *, mesh,
                 dp_axes: Tuple[str, ...], ep_axis: str, dispatch: str):
    """The expert-parallel dispatch of x2d (T, D), a DTensor: "a2a" where
    the expert axes and the rows divide, else "local" (the reference's
    fall-through)."""
    from functools import partial

    from repro_torch.launch.mesh import shard_map
    from repro_torch.sharding.rules import (P, axis_names, axis_sizes,
                                            partial_over)

    m = cfg.moe
    T = x2d.shape[0]
    sizes, names = axis_sizes(mesh), axis_names(mesh)
    ws = (p["router"], p["w_gate"], p["w_up"], p["w_down"])
    ep_axes = a2a_axes_for(cfg, mesh) if dispatch == "a2a" else ()
    if ep_axes:
        tok_axes = tuple(dict.fromkeys(
            [a for a in dp_axes if a != "model"] + list(ep_axes)))
        n_tok = math.prod(sizes[a] for a in tok_axes)
        if T % n_tok == 0:
            body = partial(
                _expert_shard_a2a, top_k=m.top_k, num_experts=m.num_experts,
                capacity=_capacity(T // n_tok, m.top_k, m.num_experts,
                                   m.capacity_factor),
                mesh=mesh, ep_axes=ep_axes, aux_axes=tok_axes)
            rest = tuple(a for a in names if a not in ep_axes)
            w_spec = P(ep_axes, None, None)
            return shard_map(
                body, mesh,
                in_specs=(P(tok_axes, None), P(None, None)) + (w_spec,) * 3,
                out_specs=(P(tok_axes, None), P()),
                in_grad_specs=(P(tok_axes, None),
                               partial_over(P(None, None), names))
                + (partial_over(w_spec, rest),) * 3)(x2d, *ws)

    dp = math.prod(sizes[a] for a in dp_axes)
    body = partial(
        _expert_shard, top_k=m.top_k, num_experts=m.num_experts,
        capacity=_capacity(T // dp, m.top_k, m.num_experts,
                           m.capacity_factor),
        mesh=mesh, ep_axis=ep_axis,
        aux_axes=tuple(dict.fromkeys(tuple(dp_axes) + (ep_axis,))))
    w_spec = P(ep_axis, None, None)
    return shard_map(
        body, mesh,
        in_specs=(P(tuple(dp_axes), None), P(None, None)) + (w_spec,) * 3,
        out_specs=(P(tuple(dp_axes), None), P()),
        in_grad_specs=(partial_over(P(tuple(dp_axes), None), (ep_axis,)),
                       partial_over(P(None, None), names))
        + (partial_over(w_spec, dp_axes),) * 3)(x2d, *ws)


def moe_fwd(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
            live: int | None = None, aux: bool = True, mesh=None,
            dp_axes: Tuple[str, ...] = ("data",), ep_axis: str = "model",
            dispatch: str = "local"):
    """x: (B, S, D) -> (out (B, S, D), aux loss (f32 scalar)).  Prefill
    and decode drop the aux loss, as the reference's do: ``aux=False``
    skips it (None).

    ``mesh`` (a ``DeviceMesh``; x and ``p`` DTensors on it) runs the
    expert-parallel dispatch ``dispatch`` ("local" or "a2a", module
    docstring) over ``dp_axes`` and ``ep_axis``, as the reference's
    ``moe_fwd``.  Without a mesh every expert is on this device.

    ``live=None`` routes the B*S tokens together with the capacity of
    T = B*S tokens, as the reference's ``moe_fwd``.  ``live=n`` is the
    paged engine's decode step (no mesh): x is (R, 1, D), its first ``n``
    rows the lanes and the rest idle padding.  The reference engine
    decodes each lane alone (a vmap over lanes, ``serve/engine.py``), at
    T = 1, where a token's k pairs go to k distinct experts and the
    capacity of 8 never binds; here the rows route together with
    ``max(8, n)`` slots per expert, which keeps every lane's pairs as
    well.  The idle rows sort after every lane, so they never take a
    lane's slot, and the capacity, so the experts' (E, C, D) block, does
    not depend on the padding.  The aux loss is then the lanes' own."""
    m = cfg.moe
    B, S, D = x.shape
    T, k, E = B * S, m.top_k, m.num_experts
    x2d = x.reshape(T, D)
    if mesh is not None:
        if live is not None:
            raise ValueError("the paged decode's live routing runs without "
                             "a mesh")
        out2d, aux_loss = _moe_on_mesh(cfg, p, x2d, mesh=mesh,
                                       dp_axes=tuple(dp_axes),
                                       ep_axis=ep_axis, dispatch=dispatch)
        out = out2d.reshape(B, S, D)
        if m.num_shared_experts:
            out = out + mlp_fwd(_shared_cfg(cfg), p["shared"], x)
        return out, (aux_loss if aux else None)
    if live is None:
        n, capacity = T, _capacity(T, k, E, m.capacity_factor)
    else:
        if S != 1 or not 0 < live <= B:
            raise ValueError(f"live={live} needs (R >= live, 1, D) rows, "
                             f"got {tuple(x.shape)}")
        n, capacity = live, max(_capacity(1, k, E, m.capacity_factor), live)

    probs, top_e, gates = _route(x2d, p["router"], k)
    order, slot = _slots(top_e, capacity, 0, E)
    xs = _gather_rows(x2d, order, slot, k, E * capacity)
    ys = _experts(xs.reshape(E, capacity, D), p["w_gate"], p["w_up"],
                  p["w_down"])
    out = _combine(ys.reshape(E * capacity, D), order, slot,
                   gates).reshape(B, S, D)
    if m.num_shared_experts:
        out = out + mlp_fwd(_shared_cfg(cfg), p["shared"], x)
    if not aux:
        return out, None
    return out, _aux_loss(probs, top_e, n, E)
