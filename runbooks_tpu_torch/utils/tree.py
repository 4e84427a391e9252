"""Nested-dict parameter trees: map and flatten with keys in sorted order,
as ``jax.tree`` orders them, so the port's leaves line up with the
reference's."""

from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of nested dicts (and the matching leaves of
    ``rest``), returning the same nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> Iterator[Any]:
    """The leaves of nested dicts in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree
