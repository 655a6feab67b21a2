"""Nested dict/list parameter trees, flattened in the reference's leaf order.

The JAX package keeps parameters as pytrees of nested dicts and lists;
``jax.tree.flatten`` visits dict keys in sorted order and lists in order.
The port keeps the same nesting (plain dicts and lists of tensors) and
these helpers visit leaves in that same order, so a leaf's position, its
offset in the flat ``[S, N]`` buffer and its counterpart in the reference
all line up.  A tree's structure is the tree itself with any leaves.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Sequence


def _walk(tree) -> Iterator[Any]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _walk(v)
    else:
        yield tree


def tree_leaves(tree) -> List[Any]:
    return list(_walk(tree))


def tree_unflatten(like, leaves: Sequence[Any]):
    """A tree shaped like ``like`` holding ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}          # keep the key order of ``like``
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has positions")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of ``rest``)."""
    cols = [tree_leaves(tree)] + [tree_leaves(r) for r in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees do not have the same number of leaves")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*cols)])
