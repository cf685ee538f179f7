"""Trees of tensors in the reference's leaf order.

JAX flattens a dict by its sorted keys, a tuple (a NamedTuple too) by
position, and skips ``None``. The port's trees are nested dicts, lists (one
entry per repeat of a layer group, where the reference stacks the repeats
on a leading axis) and NamedTuples; :func:`leaves` walks them in JAX's
order, lists by index, so that sums over leaves (AdamW's global norm) add
up in the reference's order and checkpoints list their arrays the way the
reference's do.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves(tree) -> list:
    """The leaves of ``tree``: dicts by sorted key, lists and tuples in
    order; ``None`` has no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in leaves(sub)]
    return [tree]


def unflatten(like, values: list):
    """A tree shaped as ``like`` whose leaves are ``values`` in
    :func:`leaves` order."""
    it = iter(values)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}         # keep the caller's order
        if _is_namedtuple(t):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def map_up_to(f: Callable[..., Any], tree, *rest):
    """``f(leaf, *subtrees)`` at every leaf of ``tree``, where ``rest`` are
    trees that share ``tree``'s structure down to its leaves and may hold
    whole subtrees there (an 8-bit moment ``{"q", "s"}`` at a parameter's
    place). Returns the tree of results, shaped as ``tree``."""
    if isinstance(tree, dict):
        return {k: map_up_to(f, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_up_to(f, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return f(tree, *rest)
