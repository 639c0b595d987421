"""Nested containers of leaves (the port's pytrees).

Parameters, optimizer state and batches are nests of dicts, lists and
tuples with tensors or arrays at the leaves. Dict keys flatten in sorted
order, as ``jax.tree_util`` does, so a JAX tree and its port flatten to the
same leaf order.
"""

from __future__ import annotations

from typing import Any, Callable

#: a tree's structure: ``None`` for a leaf, else ``(kind, meta, children)``
TreeDef = Any


def tree_flatten(tree) -> tuple[list, TreeDef]:
    leaves: list = []

    def rec(node):
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", tuple(keys), tuple(rec(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return (kind, len(node), tuple(rec(c) for c in node))
        leaves.append(node)
        return None

    return leaves, rec(tree)


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    it = iter(leaves)

    def rec(d):
        if d is None:
            return next(it)
        kind, meta, children = d
        if kind == "dict":
            return {k: rec(c) for k, c in zip(meta, children)}
        vals = [rec(c) for c in children]
        return vals if kind == "list" else tuple(vals)

    try:
        out = rec(treedef)
    except StopIteration:
        raise ValueError("too few leaves for the tree structure") from None
    if next(it, _END) is not _END:
        raise ValueError("too many leaves for the tree structure")
    return out


_END = object()


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r)
        if r_def != treedef:
            raise ValueError("tree_map: trees differ in structure")
        others.append(r_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
