"""Device meshes, the port of ``repro.launch.mesh``.

Functions only, never module-level meshes: importing this module touches
no device and starts no process group.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
process group the caller initialised; every rank is one device.  The
production shapes are the reference's: single-pod 16 x 16 ``("data",
"model")``, multi-pod 2 x 16 x 16 ``("pod", "data", "model")``.

``MeshShape`` carries a mesh's axis names and sizes without a group, for
the sharding rules and the roofline.  ``shard_map`` is the counterpart of
``jax.shard_map``: the body runs on each rank's local shards (plain
tensors), with whatever explicit collectives it issues.

``fake_process_group`` opens a group of N ranks in one process whose
collectives move nothing (``torch.testing``'s fake backend): only the
meta-device dry run and the roofline use it, to lay a step over a
production mesh without its devices.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


class MeshShape:
    """A mesh's axis names and sizes, without devices or a group:
    ``.shape`` {name: size}, ``.axis_names``, ``.size``."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @classmethod
    def of(cls, mesh) -> "MeshShape":
        """The shape of a ``DeviceMesh`` (or of another ``MeshShape``)."""
        from repro_torch.sharding.rules import axis_sizes

        return cls(axis_sizes(mesh))

    def __repr__(self):
        return f"MeshShape({self.shape})"


def mesh_dims(mesh) -> tuple:
    """(shape, axis names) of the production mesh named "single" or
    "multi", or of a (shape, names) pair."""
    if isinstance(mesh, str):
        return {"single": SINGLE_POD, "multi": MULTI_POD}[mesh]
    shape, names = mesh
    return tuple(shape), tuple(names)


def mesh_name(mesh) -> str:
    """A record's name of a mesh: "card" for None (one device), the
    production mesh's name, or its shape ("4x4")."""
    if mesh is None or isinstance(mesh, str):
        return mesh or "card"
    return "x".join(str(n) for n in mesh_dims(mesh)[0])


def production_shape(multi_pod: bool = False) -> MeshShape:
    """The production mesh's shape, without a group."""
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    return MeshShape(dict(zip(names, shape)))


def _mesh_device_type(device) -> str:
    """The ``DeviceMesh`` device type for tensors on ``device``: the
    card unless the caller asks for the CPU; meta tensors ride a CPU mesh
    (the fake group's)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    return "cpu" if dev.type == "meta" else dev.type


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device=None):
    """A ``DeviceMesh`` of ``axis_shapes`` named ``axis_names`` over every
    rank of the initialised process group.  Raises when no group is
    initialised or when the mesh's size is not the group's: a mesh never
    shrinks or grows to fit."""
    from torch.distributed.device_mesh import init_device_mesh

    axis_shapes, axis_names = tuple(axis_shapes), tuple(axis_names)
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f"{axis_shapes} against names {axis_names}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    n, world = math.prod(axis_shapes), dist.get_world_size()
    if n != world:
        raise ValueError(f"a {axis_shapes} mesh needs {n} ranks, the "
                         f"process group has {world}")
    return init_device_mesh(_mesh_device_type(device), axis_shapes,
                            mesh_dim_names=axis_names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    return make_mesh(shape, names, device=device)


def make_local_mesh(model: int = 1, *, device=None):
    """A ``(world // model, model)`` ``("data", "model")`` mesh over the
    initialised group's ranks."""
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs an initialised process "
                           "group")
    n = dist.get_world_size()
    if model < 1 or n % model:
        raise ValueError(f"model={model} does not divide {n} ranks")
    return make_mesh((n // model, model), ("data", "model"), device=device)


def _as_placements(spec, mesh, shape=None):
    from repro_torch.sharding.rules import placements

    return None if spec is None else placements(spec, mesh, shape)


def shard_map(body, mesh, in_specs, out_specs, in_grad_specs=None):
    """``body`` on each rank's local shards: the counterpart of
    ``jax.shard_map`` over ``local_map``.  ``in_specs`` has one
    ``PartitionSpec`` per positional argument (None for a non-tensor one);
    each DTensor argument is redistributed to its spec first, and a plain
    tensor argument passes as it is (the same on every rank).
    ``out_specs`` is one spec, or a tuple with one per output; the outputs
    become DTensors of those layouts.  ``in_grad_specs`` (one per
    argument, as ``in_specs``; default: ``in_specs``) are the layouts of
    the arguments' gradients: over an axis an argument is replicated on
    but each of whose ranks uses it for its own part of the result, its
    gradient is a partial sum (``sharding.rules.partial_over``).  The body issues its own
    collectives, each with a gradient (``psum`` below,
    ``torch.distributed.nn.functional.all_to_all_single``)."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.rules import PartitionSpec

    single = isinstance(out_specs, PartitionSpec)
    outs = tuple(_as_placements(s, mesh)
                 for s in ((out_specs,) if single else out_specs))

    def run(*args):
        # an argument's dimension of size 1 is replicated, not sharded
        # over axes of size 1 (``placements``)
        def at(specs):
            return tuple(_as_placements(s, mesh, getattr(a, "shape", None))
                         for s, a in zip(specs, args))

        return local_map(
            body, out_placements=outs, in_placements=at(in_specs),
            in_grad_placements=(None if in_grad_specs is None
                                else at(in_grad_specs)),
            device_mesh=mesh, redistribute_inputs=True)(*args)

    return run


def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes`` (a name or a tuple of names, the
    first outermost), as ``jax.lax.axis_index``."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    idx = 0
    for a in axes:
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) \
            + mesh.get_local_rank(a)
    return idx


def axis_group(mesh, axes):
    """The process group of ``axes`` (one name, or several flattened into
    one group, the first outermost)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A process group of ``world_size`` ranks in this process (rank 0),
    on the fake backend: collectives return at once and move nothing, so
    a step over a production mesh runs on the meta device.  The group is
    destroyed on exit.  Refuses to replace a group already open."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(world_size))
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_size(mesh: Optional[object]) -> int:
    """Devices in ``mesh`` (1 for None)."""
    if mesh is None:
        return 1
    return MeshShape.of(mesh).size


class _SumOverRanks(torch.autograd.Function):
    """Forward: the sum of ``t`` over ``group``'s ranks.  Backward: the
    incoming gradient as it is.  Every rank's result is the same
    replicated value, whose gradient each rank already holds whole; each
    rank's ``t`` was one term of the sum."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(t, group):
    """``jax.lax.psum`` inside a ``shard_map`` body whose result is
    replicated over ``group`` (its gradient comes back whole on every
    rank).  ``torch.distributed.nn.functional.all_reduce`` all-reduces the
    gradient too, which would count a replicated gradient once per rank.
    A group of one rank still runs its all-reduce."""
    return _SumOverRanks.apply(t, group)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (a tensor laid out on a mesh)."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def reduced(t):
    """``t`` with its partial sums reduced: a DTensor's ``Partial``
    placements become ``Replicate`` (an all-reduce), its shards stay;
    any other tensor as it is.  A projection of rows replicated over the
    data axes (a batch of one row) against a weight sharded over them on
    its contracted dimension (fsdp) comes out partial over them.  A
    non-linear op then keeps that partial input for its backward, whose
    sharding propagation lays the gradient out as a shard of the batch
    dimension even where it has size 1, which the view rules refuse."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Partial, Replicate

    pl = tuple(Replicate() if isinstance(p, Partial) else p
               for p in t.placements)
    return t if pl == tuple(t.placements) else t.redistribute(
        t.device_mesh, pl)


def mesh_ranks(mesh, axes) -> int:
    """Ranks along ``axes`` (a name or a tuple of names)."""
    from repro_torch.sharding.rules import axis_sizes

    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


@contextlib.contextmanager
def replicating():
    """Plain tensors met among DTensors count as replicated (positions,
    masks and constants the model builds), as
    ``torch.distributed.tensor.experimental.implicit_replication``, but
    nestable: the setting in force before is restored on exit."""
    from torch.distributed.tensor import DTensor

    disp = DTensor._op_dispatcher
    before = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = before
