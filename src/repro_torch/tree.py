"""Minimal pytree helpers over dict / list / tuple nests of tensors.

Dict keys are visited in sorted order (as in JAX), ``None`` is an empty
node, everything else is a leaf, a tuple whose class sets ``tree_leaf``
(``sharding.rules.PartitionSpec``) too.  The recursions are module-level
functions: a nested function that calls itself is a reference cycle, and
one that closed over the leaves kept every tensor it had seen alive until
the cyclic garbage collector ran (device memory that looked leaked)."""

from __future__ import annotations

from typing import Any, Callable, List


def _is_seq(t) -> bool:
    return isinstance(t, (list, tuple)) and not getattr(t, "tree_leaf",
                                                         False)


def _flatten(t, leaves: List[Any]):
    if t is None:
        return None
    if isinstance(t, dict):
        keys = sorted(t)
        return ("dict", tuple(keys), tuple(_flatten(t[k], leaves)
                                           for k in keys))
    if _is_seq(t):
        return (type(t).__name__, len(t),
                tuple(_flatten(x, leaves) for x in t))
    leaves.append(t)
    return "*"


def tree_flatten(tree: Any):
    """Returns (leaves, treedef); treedef is hashable and comparable."""
    leaves: List[Any] = []
    return leaves, _flatten(tree, leaves)


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
    if _is_seq(tree):
        out = [tree_map(fn, x, *(r[i] for r in rest))
               for i, x in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def _build(d, it):
    if d is None:
        return None
    if d == "*":
        return next(it)
    kind, meta, children = d
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(meta, children)}
    out = [_build(c, it) for c in children]
    return tuple(out) if kind == "tuple" else out


def tree_unflatten(treedef: Any, leaves) -> Any:
    """Inverse of ``tree_flatten``: rebuild the nest described by
    ``treedef`` with ``leaves`` in flatten order."""
    it = iter(leaves)
    tree = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return tree


def tree_map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` leaf-wise: ``path`` is the tuple of dict keys
    (str) and sequence indices (int) from the root to the leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], path + (k,))
                for k in tree}
    if _is_seq(tree):
        return type(tree)(tree_map_with_path(fn, x, path + (i,))
                          for i, x in enumerate(tree))
    return fn(path, tree)
