"""Trees of tensors: the port's parameters, gradients and optimizer state.

The port's parameters are nested dictionaries and lists with tensors at the
leaves (``models.transformer``: ``params["layers"][super_block][position]``),
where the reference uses JAX pytrees.  ``tree_map`` and ``tree_leaves`` walk
them in a fixed order (dictionary keys as stored, list positions), and
``tree_flatten_with_paths`` names each leaf by its keys joined with ``/``.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["tree_flatten_with_paths", "tree_leaves", "tree_map",
           "tree_unflatten"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), in a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_flatten_with_paths(tree: Any, prefix: str = ""
                            ) -> Iterator[tuple[str, Any]]:
    """``(path, leaf)`` pairs in ``tree_map``'s order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_flatten_with_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_flatten_with_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_flatten_with_paths(tree)]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` in order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
