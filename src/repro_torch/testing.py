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

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import cdtype
from repro_torch.tree import tree_map


def _is_float(a: np.ndarray) -> bool:
    # bfloat16 numpy arrays (ml_dtypes) have kind "V"
    return a.dtype.kind == "f" or a.dtype.name == "bfloat16"


def _tensor(x, dtype=None) -> torch.Tensor:
    a = np.asarray(x)
    if _is_float(a):
        # through float32, which holds bfloat16 values exactly
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(dtype=dtype or torch.float32)
    return torch.from_numpy(np.array(a))


def params_from_jax(cfg: ModelConfig, np_tree: Any) -> Any:
    """The reference's parameter pytree (numpy leaves) as the port's
    parameters: CPU tensors in the config's dtype."""
    return tree_map(lambda x: _tensor(x, cdtype(cfg)), np_tree)


def caches_from_jax(np_tree: Any, dtype: torch.dtype) -> Any:
    """The reference's cache pytree (k/v float, kv_pos int32) as CPU
    tensors."""
    return tree_map(
        lambda x: _tensor(x, dtype if _is_float(np.asarray(x)) else None),
        np_tree)


def to_numpy(tree: Any) -> Any:
    """Tensors -> float32 / integer numpy arrays (for comparisons and for
    feeding the reference)."""
    def conv(t):
        t = t.detach().cpu()
        if t.is_floating_point():
            t = t.float()
        return t.numpy()
    return tree_map(conv, tree)
