"""Gradient clipping utilities."""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.tree_util import tree_leaves, tree_map

# Per-leaf sums of squares -> the same leaves' global sums.
LeafSums = Callable[[List[torch.Tensor]], List[torch.Tensor]]


def global_norm(tree: Any, reduce: Optional[LeafSums] = None
                ) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, leaves summed in the
    reference's order. Where the leaves are blocks of placed tensors,
    `reduce` turns each leaf's sum over its block into the sum over the
    whole tensor (`distributed.sharding.sum_over_shards`)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    sq = [torch.sum(torch.square(l.to(torch.float32))) for l in leaves]
    if reduce is not None:
        sq = reduce(sq)
    return torch.sqrt(sum(sq))


def clip_by_global_norm(tree: Any, max_norm: float,
                        reduce: Optional[LeafSums] = None
                        ) -> Tuple[Any, torch.Tensor]:
    """Returns (clipped_tree, pre_clip_norm); `reduce` as `global_norm`
    takes it."""
    norm = global_norm(tree, reduce)
    scale = torch.clamp_max(max_norm / (norm + 1e-12), 1.0)
    return tree_map(lambda l: (l * scale).to(l.dtype), tree), norm
