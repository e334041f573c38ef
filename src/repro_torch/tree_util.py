"""Nested parameter trees: dicts (walked in sorted key order, as
`jax.tree_util` walks them), lists and tuples of tensors; a named tuple
keeps its type, and a tuple whose class sets `tree_leaf = True` (a
sharding spec) is a leaf. A leaf's path is its keys, indices and named-
tuple field names joined by "/" (`sigma/0/w`, `hash/level_3`,
`1/mu/embed/codes`), the reference's `_path_str`."""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


def _children(tree: Any) -> Optional[List[Tuple[Any, str, Any]]]:
    """(key or index, path component, child) of a container; None for a
    leaf."""
    if isinstance(tree, dict):
        return [(k, str(k), tree[k]) for k in tree]
    if not isinstance(tree, (list, tuple)) or getattr(type(tree),
                                                     "tree_leaf", False):
        return None
    names = getattr(tree, "_fields", None) or range(len(tree))
    return [(i, str(n), v) for i, (n, v) in enumerate(zip(names, tree))]


def leaves_with_path(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in the reference's leaf order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    if isinstance(tree, dict):
        kids = sorted(kids, key=lambda kid: kid[0])
    out: List[Tuple[str, Any]] = []
    for _, name, v in kids:
        out += leaves_with_path(v, f"{prefix}/{name}" if prefix else name)
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_with_path(fn: Callable, tree: Any, *rest: Any, prefix: str = ""):
    """A tree of `fn(path, leaf, *leaves of rest at that path)`, with the
    structure of `tree`."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree, *rest)
    out = [map_with_path(fn, v, *(r[k] for r in rest),
                         prefix=f"{prefix}/{name}" if prefix else name)
           for k, name, v in kids]
    if isinstance(tree, dict):
        return dict(zip(tree, out))
    return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)


def tree_map(fn: Callable, tree: Any, *rest: Any):
    return map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)
