"""Minimal pytree helpers over dict / list / tuple nests of tensors.

Dict keys are visited in sorted order (as in JAX), ``None`` is an empty
node, everything else is a leaf."""

from __future__ import annotations

from typing import Any, Callable, List


def tree_flatten(tree: Any):
    """Returns (leaves, treedef); treedef is hashable and comparable."""
    leaves: List[Any] = []

    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", tuple(keys), tuple(walk(t[k]) for k in keys))
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, len(t), tuple(walk(x) for x in t))
        leaves.append(t)
        return "*"

    return leaves, walk(tree)


def tree_leaves(tree: Any) -> list:
    return tree_flatten(tree)[0]


def tree_structure(tree: Any):
    return tree_flatten(tree)[1]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over trees of identical structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, x, *(r[i] for r in rest))
               for i, x in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)
