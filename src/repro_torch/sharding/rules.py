"""Sharding rules: parameter, batch and cache layouts for every
architecture, the port of ``repro.sharding.rules``.

Conventions (the reference's)
-----------------------------
* mesh axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
  multi-pod.  The batch shards over all of ``("pod", "data")``;
  tensor/expert parallelism rides ``"model"``.
* Three policies: ``tp`` (parameters replicated over the data axes,
  tensor parallel over "model"), ``fsdp_tp`` (the default: tp plus a
  ZeRO-3 shard of one more dimension of each large matrix over "data"),
  ``fsdp`` (no tensor parallelism: the batch shards over every axis and
  the weights over ("data", "model")).
* A dimension is sharded only where the axis size divides it; otherwise it
  falls back to replication (GQA kv heads 4 < model 16, batch 1).

A layout is a ``PartitionSpec``: one entry per tensor dimension, each None
(replicated), a mesh axis name, or a tuple of names (the dimension split
over those axes, the first one outermost).  ``placements(spec, mesh)``
turns it into DTensor placements, one per mesh dimension.  The rules are
name-and-rank based over the parameter trees of ``repro_torch.models``;
the stacked layers (under ``segments``, ``enc_stack``, ``dec_stack``) get
a leading None for the layer axis.

The rules need a mesh's axis names and sizes only: a ``DeviceMesh``, or a
``launch.mesh.MeshShape`` (no process group).
"""

from __future__ import annotations

from typing import Any, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import tree_map, tree_map_with_path


class PartitionSpec(tuple):
    """``PartitionSpec("data", None)``: a tuple of per-dimension entries
    that the tree helpers treat as one leaf."""

    tree_leaf = True

    def __new__(cls, *entries):
        return tuple.__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(tuple(self))


P = PartitionSpec


class _PartialSpec(PartitionSpec):
    partial: Tuple[str, ...] = ()


def partial_over(spec, axes) -> PartitionSpec:
    """``spec`` with its value a partial sum over the mesh ``axes`` (ranks
    along them each hold one term): a gradient's layout."""
    out = _PartialSpec(*spec)
    out.partial = tuple(axes)
    return out


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a ``MeshShape``."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(axis_names(mesh), tuple(shape)))


def dp_axes_of(mesh) -> Tuple[str, ...]:
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0 and n >= size


def _axis_size(sizes: dict, names) -> int:
    if isinstance(names, str):
        names = (names,)
    s = 1
    for n in names:
        s *= sizes[n]
    return s


def placements(spec, mesh, shape=None) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh
    dimension, ``Shard(d)`` for the tensor dimension d that names it, else
    ``Replicate()``.  A tuple entry shards its dimension over each named
    mesh dimension in turn, so the layout is major in the mesh's order;
    a tuple against that order has no such placement and raises.  A spec
    from ``partial_over`` puts ``Partial()`` on its partial axes.  Given
    the tensor's ``shape``, a dimension of size 1 (sharded only over axes
    of size 1) is replicated instead: the same layout, which DTensor's
    view rules do not take for a shard (they drop size-1 dimensions)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for a in getattr(spec, "partial", ()):
        if a in names:
            out[names.index(a)] = Partial()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        at = [names.index(a) for a in axes]
        if at != sorted(at):
            raise ValueError(f"{spec}: dimension {d} names {axes} against "
                             f"the mesh's order {names}")
        if shape is not None and shape[d] == 1:
            continue
        for i in at:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh axis {names[i]} shards two "
                                 "dimensions or a partial sum")
            out[i] = Shard(d)
    return tuple(out)


def spec_of(t, strict: bool = True) -> PartitionSpec:
    """The spec of a DTensor's placements (its Shard entries).  A Partial
    placement has no spec: it raises, or with ``strict=False`` counts as
    replicated (a redistribution to the spec reduces it)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(t.device_mesh)
    dims = [[] for _ in range(t.dim())]
    for name, pl in zip(names, t.placements):
        if isinstance(pl, Shard):
            dims[pl.dim].append(name)
        elif strict and not isinstance(pl, Replicate):
            raise ValueError(f"{pl} on {name} has no spec")
    return P(*(None if not a else a[0] if len(a) == 1 else tuple(a)
               for a in dims))


def axes_of(entry) -> Tuple[str, ...]:
    """A spec entry's mesh axes (None: none)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """A spec on a mesh: what the reference's ``NamedSharding`` holds."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = P(*spec)

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def placements_for(self, shape) -> tuple:
        """``placements`` of a tensor of ``shape``."""
        return placements(self.spec, self.mesh, tuple(shape))

    def __repr__(self):
        return f"NamedSharding({self.spec})"


class ShardingRules:
    """Three layout policies:

    tp       — parameters replicated over data; tensor parallel over
               "model".  Weights stay resident: right for serving.
    fsdp_tp  — tp + a ZeRO-3 shard of one extra dimension over "data".
    fsdp     — pure ZeRO/DP: no tensor parallelism; the batch shards over
               every mesh axis and the weights over ("data", "model").
    """

    def __init__(self, cfg: ModelConfig, mesh, policy: str = "fsdp_tp"):
        if policy not in ("tp", "fsdp_tp", "fsdp"):
            raise ValueError(f"unknown policy {policy!r}")
        self.cfg = cfg
        self.mesh = mesh
        self.policy = policy
        self.sizes = axis_sizes(mesh)
        self.tp = "model"
        self.tp_size = self.sizes["model"]
        self.dp = dp_axes_of(mesh)
        self.dp_size = _axis_size(self.sizes, self.dp)

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """Axes the batch dimension shards over (model too under pure
        fsdp, except for MoE archs whose expert parallelism needs
        "model")."""
        if self.policy == "fsdp" and not self.cfg.moe.enabled:
            return self.dp + ("model",)
        return self.dp

    # -- helpers -------------------------------------------------------------
    def _fsdp(self, dim: int) -> Any:
        """Axis/axes for the ZeRO-sharded dimension of a weight."""
        if self.policy == "fsdp":
            axes = ("data", "model")
            if _div(dim, _axis_size(self.sizes, axes)):
                return axes
            if _div(dim, self.sizes.get("data", 1)):
                return "data"
            return None
        if self.policy == "fsdp_tp" and _div(dim, self.sizes.get("data", 1)):
            return "data"
        return None

    def _tp(self, dim: int) -> Any:
        if self.policy == "fsdp":
            return None
        return self.tp if _div(dim, self.tp_size) else None

    # -- per-leaf rule --------------------------------------------------------
    def spec_for(self, name: str, shape: tuple, stacked: bool) -> P:
        base_shape = tuple(shape[1:] if stacked else shape)
        spec = self._base_spec(name, base_shape)
        if stacked:
            spec = P(None, *spec)
        return spec

    def _base_spec(self, name: str, s: tuple) -> P:
        tp, fsdp = self._tp, self._fsdp
        if name == "embedding":                      # (V, D)
            if self.policy == "fsdp":
                return P(fsdp(s[0]), None)
            return P(tp(s[0]), fsdp(s[1]))
        if name == "lm_head":                        # (D, V)
            if self.policy == "fsdp":
                return P(None, fsdp(s[1]))
            return P(fsdp(s[0]), tp(s[1]))
        if name in ("wq", "wk", "wv"):               # (D, H, hd)
            return P(fsdp(s[0]), tp(s[1]), None)
        if name == "wo":                             # (H, hd, D)
            return P(tp(s[0]), None, fsdp(s[2]))
        if name in ("wq_a", "wkv_a"):                # (D, r)
            return P(fsdp(s[0]), None)
        if name in ("wq_b", "wk_b", "wv_b"):         # (r, H, hd)
            return P(None, tp(s[1]), None)
        if name in ("w_up", "w_gate") and len(s) == 2:   # mlp (D, F)
            return P(fsdp(s[0]), tp(s[1]))
        if name == "w_down" and len(s) == 2:             # mlp (F, D)
            return P(tp(s[0]), fsdp(s[1]))
        if name in ("w_up", "w_gate", "w_down") and len(s) == 3:
            # moe expert stacks (E, D, F) / (E, F, D)
            if self.cfg.moe_dispatch == "a2a":
                axes = ("data", "model")
                if _div(s[0], _axis_size(self.sizes, axes)):
                    return P(axes, None, None)       # resident 2-D EP
            if name == "w_down":
                return P(tp(s[0]), None, fsdp(s[2]))
            return P(tp(s[0]), fsdp(s[1]), None)
        if name == "router":                         # (D, E), replicated
            return P(None, None)
        if name in ("w_z", "w_x", "w_dt") and len(s) == 2:  # ssm (D, di|H)
            return P(fsdp(s[0]), tp(s[1]))
        if name in ("w_B", "w_C"):                   # ssm (D, N), N small
            return P(fsdp(s[0]), None)
        if name == "conv_x":                         # (K, di)
            return P(None, tp(s[1]))
        if name in ("conv_B", "conv_C"):             # (K, N)
            return P(None, None)
        if name in ("dt_bias", "A_log", "D_skip"):   # (H,)
            return P(tp(s[0]))
        if name == "norm_scale":                     # (di,)
            return P(tp(s[0]))
        if name in ("w_in",):                        # rec (D, W)
            return P(fsdp(s[0]), tp(s[1]))
        if name == "conv_w":                         # rec (K, W)
            return P(None, tp(s[1]))
        if name in ("w_a", "w_x") and len(s) == 3:   # rec block-diag
            return P(tp(s[0]), None, None)
        if name in ("b_a", "b_x", "lambda_p"):       # (W,)
            return P(tp(s[0]))
        if name == "w_out":                          # rec (W, D)
            return P(tp(s[0]), fsdp(s[1]))
        # norms, scalars, q_norm/k_norm, everything else: replicated
        return P(*([None] * len(s)))

    # -- whole-tree specs -----------------------------------------------------
    def param_specs(self, params) -> Any:
        """A spec for every leaf of a parameter tree (tensors of any
        device, the meta device's included)."""
        stacked_markers = ("segments", "enc_stack", "dec_stack")

        def rule(path, leaf):
            names = [k for k in path if isinstance(k, str)]
            stacked = any(n in stacked_markers for n in names)
            return self.spec_for(names[-1] if names else "",
                                 tuple(leaf.shape), stacked)

        return tree_map_with_path(rule, params)

    def param_shardings(self, params) -> Any:
        return tree_map(lambda s: NamedSharding(self.mesh, s),
                        self.param_specs(params))

    # -- batches ---------------------------------------------------------------
    def _batch_dim(self, b: int) -> Any:
        """Shard the batch over the policy's batch axes where they divide
        it, else over the data axes, else not at all."""
        axes = self.batch_axes
        if _div(b, _axis_size(self.sizes, axes)):
            return axes
        if _div(b, self.dp_size):
            return self.dp
        return None

    def batch_specs(self, batch) -> Any:
        def rule(path, leaf):
            if leaf.dim() == 0:
                return P()
            return P(self._batch_dim(leaf.shape[0]),
                     *([None] * (leaf.dim() - 1)))

        return tree_map_with_path(rule, batch)

    def cache_specs(self, caches) -> Any:
        """Decode caches: stacked (L, B, ...) -> batch and head dims."""
        def rule(path, leaf):
            names = [k for k in path if isinstance(k, str)]
            name = names[-1] if names else ""
            nd = leaf.dim()
            if name == "kv_pos" or nd < 2:
                return P(*([None] * nd))
            bdim = self._batch_dim(leaf.shape[1])
            rest = [None] * (nd - 2)
            if name in ("k", "v", "cross_k", "cross_v") and nd == 5:
                # (L, B, cap, Hkv, hd): kv heads over model, or where they
                # do not divide it the sequence (a context-parallel cache)
                tp_h = self._tp(leaf.shape[3])
                tp_s = self._tp(leaf.shape[2]) if tp_h is None else None
                rest = [tp_s, tp_h, None]
            elif name == "ckv" and nd == 4 and bdim is None:
                rest = [self._tp(leaf.shape[2]), None]   # MLA at batch 1
            elif name == "ssm_state" and nd == 5:
                rest = [self._tp(leaf.shape[2]), None, None]  # (L,B,H,P,N)
            elif name == "h" and nd == 3:
                rest = [self._tp(leaf.shape[2])]              # (L, B, W)
            elif name in ("x", "conv_state") and nd == 4:
                rest = [None, self._tp(leaf.shape[3])]        # (L,B,K-1,di)
            return P(None, bdim, *rest)

        return tree_map_with_path(rule, caches)

    def shardings_for(self, tree, kind: str) -> Any:
        specs = {"params": self.param_specs, "batch": self.batch_specs,
                 "cache": self.cache_specs}[kind](tree)
        return tree_map(lambda s: NamedSharding(self.mesh, s), specs)


def opt_state_specs(rules: ShardingRules, param_specs) -> dict:
    """Adam moments share the parameters' layout; the count replicates."""
    return {"m": param_specs, "v": param_specs, "count": P()}


def scale_spec(spec) -> P:
    """The layout of an int8 moment's per-row scales (the moment's shape
    with a last axis of 1 or 2): the moment's spec with its last entry
    replicated."""
    spec = tuple(spec)
    return P(*(spec[:-1] + (None,))) if spec else P()
