"""Parameter and optimizer-state trees: nested dicts of tensors.

Leaves are visited in sorted-key order, the order in which
``jax.tree_util`` flattens the reference's dicts, so a leaf's path and
position agree across the two packages (checkpoint keys, the order of a
global-norm sum).
"""
from __future__ import annotations

from typing import Any, Iterable, Iterator, Tuple

__all__ = ["leaves", "rebuild"]


def leaves(tree, prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` pairs of ``tree`` in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def rebuild(like, values: Iterable):
    """``like``'s nesting with its leaves replaced by ``values``, taken in
    :func:`leaves` order."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)
