"""Nested dicts of tensors, walked in the JAX package's leaf order.

JAX flattens a dict in sorted-key order.  That order sets the float sum of
``training.optimizer.global_norm`` and the keys and signature of a
checkpoint, so every walk whose order reaches a float or a file goes
through here.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def leaves_with_path(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """``(path, leaf)`` of every leaf, keys sorted at each level."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    else:
        yield path, tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_with_path(fn: Callable, tree: Any, *rest: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf, *other_leaves)`` over trees of one structure."""
    if isinstance(tree, dict):
        return {
            k: map_with_path(fn, tree[k], *(r[k] for r in rest), path=path + (k,))
            for k in sorted(tree)
        }
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    return map_with_path(lambda _, *xs: fn(*xs), tree, *rest)
