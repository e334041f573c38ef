"""Nested parameter trees: dicts (walked in sorted key order, as
`jax.tree_util` walks them), lists and tuples of tensors. A leaf's path is
its keys and indices joined by "/" (`sigma/0/w`, `hash/level_3`), the
reference's `_path_str`."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves_with_path(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in the reference's leaf order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k, v in items:
        out += leaves_with_path(v, f"{prefix}/{k}" if prefix else k)
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_with_path(fn: Callable, tree: Any, *rest: Any, prefix: str = ""):
    """A tree of `fn(path, leaf, *leaves of rest at that path)`, with the
    structure of `tree`."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], *(r[k] for r in rest),
                                 prefix=f"{prefix}/{k}" if prefix else str(k))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            map_with_path(fn, v, *(r[i] for r in rest),
                          prefix=f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(tree))
    return fn(prefix, tree, *rest)


def tree_map(fn: Callable, tree: Any, *rest: Any):
    return map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)
