"""Bridges to the reference package's numbers, for the parity tests, and
``run_ranks``, which runs a function on several CPU ranks of a gloo
process group (the multi-device tests).

The reference initialises with JAX's threefry RNG, which PyTorch cannot
reproduce, so parity runs on shared weights: the reference's ``init``
pytree, as numpy arrays, converted here.  Parameter and cache trees have
the same nesting in both packages (dicts of stacked tensors per segment).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map


def _tensor(x) -> torch.Tensor:
    """A numpy leaf as a CPU tensor of the same dtype (bfloat16 numpy
    arrays, from ml_dtypes, have kind "V" and go through float32, which
    holds their values exactly)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(np_tree: Any) -> Any:
    """The reference's parameter pytree (numpy leaves) as the port's
    parameters: CPU tensors, each leaf in its own dtype (a bf16 config
    keeps its float32 leaves, e.g. Mamba2's ``A_log``, in float32) and
    its own layout, which the port's parameters share (MLA's ``wq_a``
    (D, q_lora), ``wq_b`` (q_lora, H, nope + rope), ``wkv_a`` (D, kv_lora
    + rope), ``wk_b``/``wv_b`` (kv_lora, H, *), ``wo`` (H, v, D) and the
    two norm scales among them)."""
    return tree_map(_tensor, np_tree)


def opt_state_from_jax(np_state: dict) -> dict:
    """The reference's AdamW state (numpy leaves) as the port's: ``m`` and
    ``v`` beside the parameters in their moment dtype (float32, bfloat16
    or int8), the int32 scalar ``count``, and for int8 moments the f32
    ``m_scale`` and ``v_scale`` rows.  Both packages then start from the
    same state."""
    keys = {"m", "v", "count"}
    if "m_scale" in np_state or "v_scale" in np_state:
        keys |= {"m_scale", "v_scale"}
    if set(np_state) != keys:
        raise ValueError(f"optimizer state keys {sorted(np_state)}, "
                         f"expected {sorted(keys)}")
    out = {k: tree_map(_tensor, np_state[k]) for k in keys}
    if out["count"].dtype != torch.int32 or out["count"].ndim:
        raise ValueError("count must be an int32 scalar")
    return out


# the reference's caches convert the same way: k/v stay in the config's
# dtype, SSM/RG-LRU states in float32, ``kv_pos`` in int32
caches_from_jax = params_from_jax


def to_numpy(tree: Any) -> Any:
    """Tensors -> float32 / integer numpy arrays (for comparisons and for
    feeding the reference)."""
    def conv(t):
        t = t.detach().cpu()
        if t.is_floating_point():
            t = t.float()
        return t.numpy()
    return tree_map(conv, tree)


def shard_slice(spec, shape, coords: dict, sizes: dict) -> tuple:
    """The index of a rank's shard of a tensor of ``shape`` laid out by
    ``spec``: along each dimension an entry names, chunk ``i`` of
    ``prod(sizes[a])`` equal chunks, ``i`` the rank's index over the
    entry's axes (``coords``), the first axis outermost; a dimension of
    size 1 is whole."""
    from repro_torch.sharding.rules import axes_of

    idx = []
    for d, n in enumerate(shape):
        axes = axes_of(spec[d]) if d < len(spec) else ()
        if not axes or n == 1:
            idx.append(slice(None))
            continue
        i, k = 0, 1
        for a in axes:
            i, k = i * sizes[a] + coords[a], k * sizes[a]
        idx.append(slice(i * (n // k), (i + 1) * (n // k)))
    return tuple(idx)


def _rank_main(rank: int, fn, world: int, workdir: str, args: tuple,
               timeout: float) -> None:
    import datetime
    import os
    import pickle

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{workdir}/store", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(fn, world: int, workdir, *args, timeout: float = 120.0) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned CPU processes joined
    in one gloo process group (initialised through a file in ``workdir``,
    never a TCP port); returns each rank's result, in rank order.  A rank
    that raises fails the call with its traceback; ranks still running
    after ``timeout`` seconds are killed and the call raises
    ``TimeoutError`` (a hung collective fails, never hangs).  ``fn`` must
    be importable by name (a module-level function)."""
    import os
    import pickle
    import time

    import torch.multiprocessing as mp

    workdir = os.path.abspath(str(workdir))
    os.makedirs(workdir, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(fn, world, workdir, args,
                                               timeout),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=0.5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{world} ranks still ran after {timeout} s")
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
