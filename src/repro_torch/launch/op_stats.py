"""Operation statistics of a step: FLOPs and bytes by aten op, and its
collectives.  The port's counterpart of ``repro.launch.hlo_stats``: PyTorch
has no HLO, so the step itself is run (on the meta device, where nothing
is computed or allocated) and its operations counted as they dispatch.

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode``, which counts the
  matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, attention and
  convolution ops) at 2·m·n·k and nothing element-wise.
* Bytes: every op that is not a view reads each tensor argument once and
  writes each output once (in-place ops read and write their target);
  with no fusion this is an upper bound on the step's traffic, as the
  reference's ``bytes accessed`` of an unfused HLO module is.
* Collectives: the functional collectives of ``torch.distributed``
  (``_c10d_functional``: DTensor's redistributions) and its in-place ones
  (``c10d``: the explicit collectives of ``shard_map`` bodies) by the
  reference's kinds, each with its count and output bytes, as
  ``hlo_stats.collective_stats`` reports them.  On one device there are
  none.

Counts are per device, as the reference's per-chip HLO statistics are.  A
step over a mesh runs on DTensors: an op of DTensors dispatches once at
the global shapes (its local op does not reach the counters), so its
FLOPs are divided among the ranks its output is sharded or partial over
(each of those computes its share; a replicated output is computed on
every rank) and its bytes are those of the local shards.  The ops of a
``shard_map`` body run on local tensors and count as they are.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.launch.mesh import is_dtensor

# collectives of torch.distributed -> the reference's kinds: the
# functional ones (``_c10d_functional``) and the in-place ones (``c10d``)
_COLLECTIVE_OPS = {
    "_c10d_functional": {
        "all_gather_into_tensor": "all-gather",
        "all_reduce": "all-reduce",
        "reduce_scatter_tensor": "reduce-scatter",
        "all_to_all_single": "all-to-all",
        "permute_tensor": "collective-permute",
    },
    "c10d": {
        "allreduce_": "all-reduce",
        "allgather_": "all-gather",
        "_allgather_base_": "all-gather",
        "allgather_into_tensor_coalesced_": "all-gather",
        "reduce_scatter_": "reduce-scatter",
        "_reduce_scatter_base_": "reduce-scatter",
        "alltoall_": "all-to-all",
        "alltoall_base_": "all-to-all",
    },
}

# ops that allocate without writing (no traffic)
# (``_unsafe_view`` is a view that the dispatcher does not flag as one)
_NO_TRAFFIC = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided", "detach", "lift_fresh",
                         "_unsafe_view"})


def _nbytes(t: torch.Tensor) -> int:
    """A tensor's bytes on this device (a DTensor's local shard)."""
    if is_dtensor(t):
        t = t._local_tensor
    return t.numel() * t.element_size()


def _split(t) -> int:
    """The ranks a DTensor op's work divides among: the product of the
    mesh dimensions its output is sharded or partial over."""
    n = 1
    for size, pl in zip(t.device_mesh.shape, t.placements):
        if not pl.is_replicate():
            n *= size
    return n


def tensors(tree) -> list:
    """The tensor leaves of ``tree``."""
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class _OpCounter(TorchDispatchMode):
    """Bytes read and written by op, and collectives, as ops dispatch."""

    def __init__(self):
        super().__init__()
        self.bytes_by_op: Dict[str, int] = defaultdict(int)
        self.coll_counts: Counter = Counter()
        self.coll_bytes: Dict[str, int] = defaultdict(int)
        # the FLOPs the flop counter took at global shapes that other
        # ranks do (DTensor ops), by op
        self.flops_elsewhere: Dict[str, float] = defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.__name__.split(".")[0]
        kind = _COLLECTIVE_OPS.get(func.namespace, {}).get(name)
        outs = tensors(out)
        if (outs and is_dtensor(outs[0])
                and func.overloadpacket in flop_registry):
            n = _split(outs[0])
            if n > 1:
                f = flop_registry[func.overloadpacket](
                    *args, **kwargs, out_val=out)
                self.flops_elsewhere[str(func.overloadpacket)] += \
                    f * (1 - 1 / n)
        if kind is not None:
            self.coll_counts[kind] += 1
            self.coll_bytes[kind] += sum(_nbytes(t) for t in outs)
        elif func.namespace in _COLLECTIVE_OPS:
            pass            # waits and wrappers of collectives move nothing
        elif not func.is_view and name not in _NO_TRAFFIC:
            moved = sum(_nbytes(t) for t in tensors((args, kwargs)))
            moved += sum(_nbytes(t) for t in outs)
            self.bytes_by_op[str(func.overloadpacket)] += moved
        return out

    def collectives(self) -> Dict:
        """The reference's ``collective_stats`` layout."""
        by = dict(self.coll_bytes)
        return {"counts": dict(self.coll_counts), "bytes": by,
                "total_bytes": int(sum(by.values())),
                "total_count": int(sum(self.coll_counts.values()))}


def count_step(fn: Callable, *args, **kwargs):
    """Runs ``fn(*args, **kwargs)`` under both counters.  Returns (stats,
    fn's output): stats has ``flops`` and ``flops_by_op`` (matrix
    products), ``bytes`` and ``bytes_by_op`` (read + written), and
    ``collectives`` (``collective_stats``' layout)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = _OpCounter()
    with FlopCounterMode(display=False) as fc, counter:
        out = fn(*args, **kwargs)
    away = counter.flops_elsewhere
    flops_by = {str(op): int(round(n - away.get(str(op), 0.0)))
                for op, n in fc.get_flop_counts().get("Global", {}).items()}
    stats = {"flops": int(sum(flops_by.values())), "flops_by_op": flops_by,
             "bytes": int(sum(counter.bytes_by_op.values())),
             "bytes_by_op": dict(counter.bytes_by_op),
             "collectives": counter.collectives()}
    return stats, out


def collective_seconds(stats: Dict, bw: float) -> float:
    """Per-device collective seconds of ``stats`` (``collectives()``'s
    layout) at ``bw`` bytes/s a direction; a ring all-reduce moves about
    twice its bytes."""
    return sum((2.0 if op == "all-reduce" else 1.0) * b / bw
               for op, b in stats["bytes"].items())
