"""Gradient compression: an int8 stochastic-rounding codec for a gradient
reduction across the slow links of a cluster (off by default).

The counterpart of `repro/distributed/compression.py`. Each leaf is
scaled by its rows' absmax / 127 (the last axis) and rounded to
floor(y + u) with u ~ U[0, 1), which keeps the codec unbiased
(E[decode(encode(x))] = x) at a quarter of the f32 bytes. The reference
draws u from `jax.random` keys split per leaf; here it comes from an
explicit `torch.Generator`, leaf after leaf in the tree's order, so the
two give other draws from the same seed (`_encode_leaf` takes the
uniforms, for a caller that has its own).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.tree_util import (
    leaves_with_path,
    map_with_path,
    tree_leaves,
    tree_map,
)


class CompressedTree(NamedTuple):
    codes: Any  # int8 tree, same shapes as the input
    scales: Any  # f32 tree, per-row (last axis) scales


def _encode_leaf(x: torch.Tensor, u: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, f32 scales) of `x` given uniforms `u` in [0, 1) of its
    shape."""
    xf = x.to(torch.float32)
    scale = torch.amax(torch.abs(xf), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-20)
    y = xf / scale
    q = torch.clamp(torch.floor(y + u), -127, 127)
    return q.to(torch.int8), scale


def compress(tree: Any, generator: torch.Generator) -> CompressedTree:
    """Encode every leaf, drawing its uniforms from `generator` (on the
    leaves' device), leaf after leaf in the tree's order."""
    enc = {}
    for path, x in leaves_with_path(tree):
        u = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                       device=x.device)
        enc[path] = _encode_leaf(x, u)
    return CompressedTree(map_with_path(lambda p, _: enc[p][0], tree),
                          map_with_path(lambda p, _: enc[p][1], tree))


def decompress(ct: CompressedTree) -> Any:
    return tree_map(lambda c, s: c.to(torch.float32) * s, ct.codes,
                    ct.scales)


def compressed_bytes(ct: CompressedTree) -> int:
    total = sum(l.numel() for l in tree_leaves(ct.codes))  # int8
    return total + sum(l.numel() * 4 for l in tree_leaves(ct.scales))
