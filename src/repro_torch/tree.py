"""Trees of tensors: nested dicts, lists, tuples and named tuples (``OptState``).

The port's stand-in for ``jax.tree``: ``flatten`` lists the leaves in
JAX's order (dict keys sorted, sequences in order), ``unflatten`` rebuilds
the structure around new leaves, ``map_tree`` maps a function over the
leaves of one tree and the matching leaves of others. ``None`` is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _walk(node, leaves: list, is_leaf):
    if is_leaf is not None and is_leaf(node):
        leaves.append(node)
        return None
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", keys, [_walk(node[k], leaves, is_leaf) for k in keys])
    if _is_namedtuple(node):
        return ("namedtuple", type(node), [_walk(c, leaves, is_leaf) for c in node])
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, None, [_walk(c, leaves, is_leaf) for c in node])
    leaves.append(node)
    return None


def flatten(tree, is_leaf: Callable | None = None) -> tuple[list, Any]:
    """(leaves, spec): the leaves in order, and the structure ``unflatten``
    takes. ``is_leaf(node)`` true makes ``node`` a leaf whatever it is (a
    tree of sharding specs, whose leaves are tuples)."""
    # module-level recursion: a recursive closure is a reference cycle, and
    # it would hold the leaves (a step's gradients) until the next garbage
    # collection
    leaves: list = []
    return leaves, _walk(tree, leaves, is_leaf)


def _build(node, it):
    if node is None:
        return next(it)
    kind, extra, children = node
    built = [_build(c, it) for c in children]
    if kind == "dict":
        return dict(zip(extra, built))
    if kind == "namedtuple":
        return extra._make(built)
    return tuple(built) if kind == "tuple" else built


def unflatten(spec, leaves) -> Any:
    """The tree of ``spec`` with ``leaves`` in ``flatten``'s order."""
    it = iter(leaves)
    out = _build(spec, it)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the structure holds")
    return out


def map_tree(fn: Callable, tree, *rest) -> Any:
    """``fn(leaf, *matching leaves of rest)`` over ``tree``'s leaves, in its
    structure; every tree of ``rest`` has the same structure."""
    leaves, spec = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError(f"map_tree: trees of {len(leaves)} and {len(o)} leaves")
    return unflatten(spec, [fn(*xs) for xs in zip(leaves, *others)])
