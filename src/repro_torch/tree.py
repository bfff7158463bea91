"""Nested parameter and optimizer trees: dicts, lists, tuples and named
tuples whose leaves are tensors (or numpy arrays).

The port's parameters are a dict with a list of per-layer dicts under
``"layers"``; the optimizer state is a named tuple of such trees.  These
helpers walk them in one fixed order (dict keys sorted, as JAX's trees
do, so two dicts with the same keys line up whatever their insertion
order; sequences by index) and name each leaf by its path (``"layers/3/attn/wq"``,
``"m/embed"``), which is what the checkpointer writes and checks.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> list[tuple[str, Any]] | None:
    """(name, child) pairs of an inner node; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten_with_names(tree) -> tuple[list[str], list]:
    """The leaves of ``tree`` in its fixed order, with their paths."""
    names, leaves = [], []

    def walk(node, prefix):
        kids = _children(node)
        if kids is None:
            names.append(prefix)
            leaves.append(node)
            return
        for name, child in kids:
            walk(child, f"{prefix}/{name}" if prefix else name)

    walk(tree, "")
    return names, leaves


def leaves(tree) -> list:
    return flatten_with_names(tree)[1]


def unflatten(like, new_leaves) -> Any:
    """A tree shaped like ``like`` whose leaves are ``new_leaves`` in
    ``flatten_with_names`` order."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def map_leaves(fn: Callable, tree) -> Any:
    return unflatten(tree, [fn(x) for x in leaves(tree)])
