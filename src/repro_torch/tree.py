"""Nested dict/list/tuple trees of tensors: the port's stand-in for
``jax.tree``.

Dict keys are visited in sorted order, as JAX flattens dicts, so leaf
order and leaf paths (``r1a/w``) match the reference's.
"""

from __future__ import annotations

from typing import Any, Callable, List, Mapping, Tuple

__all__ = ["tree_flatten", "tree_map", "tree_paths"]


def _children(tree: Any):
    if isinstance(tree, Mapping):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def tree_flatten(tree: Any) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """The leaves of ``tree`` and the function that rebuilds a tree of the
    same structure from a list of new leaves."""
    kids = _children(tree)
    if kids is None:
        return [tree], lambda leaves: leaves[0]
    parts = [tree_flatten(v) for _, v in kids]
    sizes = [len(p[0]) for p in parts]

    def unflatten(new: List[Any]) -> Any:
        out, at = [], 0
        for (_, rebuild), size in zip(parts, sizes):
            out.append(rebuild(new[at:at + size]))
            at += size
        if isinstance(tree, Mapping):
            return dict(zip((k for k, _ in kids), out))
        return type(tree)(out)

    return [leaf for p in parts for leaf in p[0]], unflatten


def tree_paths(tree: Any, prefix: str = "") -> List[str]:
    """Each leaf's path, its keys joined with ``/``, in leaf order."""
    kids = _children(tree)
    if kids is None:
        return [prefix]
    return [p for k, v in kids
            for p in tree_paths(v, f"{prefix}/{k}" if prefix else k)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), in a tree of the same structure."""
    leaves, unflatten = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return unflatten([fn(*args) for args in zip(leaves, *others)])
