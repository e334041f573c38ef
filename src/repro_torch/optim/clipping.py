"""Gradient clipping utilities."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree_util import tree_leaves, tree_map


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, leaves summed in the
    reference's order."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    sq = sum(torch.sum(torch.square(l.to(torch.float32))) for l in leaves)
    return torch.sqrt(sq)


def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """Returns (clipped_tree, pre_clip_norm)."""
    norm = global_norm(tree)
    scale = torch.clamp_max(max_norm / (norm + 1e-12), 1.0)
    return tree_map(lambda l: (l * scale).to(l.dtype), tree), norm
