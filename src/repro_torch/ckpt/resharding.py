"""Resharding loader: re-materialise checkpointed state on another mesh,
the port of ``repro.ckpt.resharding``.

A snapshot stores *global* host arrays (one file per buffer), so restoring
it onto a mesh of another shape (vertical scaling, ``update``; migration
to a larger or smaller slice; elastic recovery after a node is lost) lays
each leaf out with ``distribute_tensor`` in the layout the
``ShardingRules`` give for the new mesh; a dimension that no longer
divides its axes falls back to replication in the rules themselves.
Every rank must hold the same host tree (each reads the snapshot).
"""

from __future__ import annotations

from typing import Any

from repro_torch.sharding.rules import NamedSharding, P, ShardingRules
from repro_torch.tree import tree_map


def _device_of(mesh):
    import torch

    return torch.device(mesh.device_type)


def reshard_tree(host_tree: Any, shardings: Any) -> Any:
    """Each leaf laid out on its ``NamedSharding``'s mesh (a DTensor of
    its placements), moved to the mesh's device first."""
    from torch.distributed.tensor import distribute_tensor

    def put(t, s):
        if t is None:
            return None
        dev = _device_of(s.mesh)
        if t.device.type != "meta" and t.device.type != dev.type:
            t = t.to(dev)
        return distribute_tensor(t, s.mesh, s.placements_for(t.shape))

    return tree_map(put, host_tree, shardings)


def _replicated(tree: Any, mesh) -> Any:
    return reshard_tree(tree, tree_map(lambda _: NamedSharding(mesh, P()),
                                       tree))


def reshard_params(cfg, host_params: Any, new_mesh,
                   policy: str = "fsdp_tp") -> Any:
    rules = ShardingRules(cfg, new_mesh, policy)
    return reshard_tree(host_params, rules.param_shardings(host_params))


def reshard_snapshot_buffers(cfg, buffers: dict, new_mesh,
                             policy: str = "fsdp_tp") -> dict:
    """The snapshot's buffers on ``new_mesh``: ``params`` by the rules,
    ``opt_state``'s moments ``m``/``v`` in the parameters' layout, its
    ``count`` and every other buffer replicated (small, or re-created)."""
    out = {}
    for buff_id, tree in buffers.items():
        if buff_id == "params":
            out[buff_id] = reshard_params(cfg, tree, new_mesh, policy)
        elif (buff_id == "opt_state" and isinstance(tree, dict)
              and tree.get("m") is not None):
            rules = ShardingRules(cfg, new_mesh, policy)
            sh = rules.param_shardings(tree["m"])
            out[buff_id] = {k: (reshard_tree(v, sh) if k in ("m", "v")
                                else _replicated(v, new_mesh))
                            for k, v in tree.items()}
        else:
            out[buff_id] = _replicated(tree, new_mesh)
    return out
