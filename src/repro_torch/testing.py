"""Bridges to the reference package's numbers, for the parity tests.

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
    keeps its float32 leaves, e.g. Mamba2's ``A_log``, in float32)."""
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
