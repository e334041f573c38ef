"""The procedural chair and its occupancy grid.

A frozen copy of the chair's signed distance and its primitives from
`src/repro_torch/nerf/scenes.py` (`_chair`, `_sd_box`, `_union`): the
analytic geometry that a field trained on that scene converges to. The
benchmark bakes the occupancy grid it serves from it, because a field of
random weights is dense everywhere and would leave no space empty.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

# (centre, half extents) of the seat, the back and the four legs.
BOXES = (((0.0, -0.05, 0.0), (0.18, 0.02, 0.18)),
         ((0.0, 0.12, -0.16), (0.18, 0.16, 0.02)),
         ((-0.14, -0.20, -0.14), (0.02, 0.13, 0.02)),
         ((-0.14, -0.20, 0.14), (0.02, 0.13, 0.02)),
         ((0.14, -0.20, -0.14), (0.02, 0.13, 0.02)),
         ((0.14, -0.20, 0.14), (0.02, 0.13, 0.02)))


def chair_sdf(p: torch.Tensor) -> torch.Tensor:
    """Signed distance (...,) of world points (..., 3): the union (min) of
    the chair's boxes."""
    out = None
    for centre, half in BOXES:
        q = torch.abs(p - p.new_tensor(centre)) - p.new_tensor(half)
        d = torch.sqrt(torch.sum(torch.clamp_min(q, 0.0) ** 2, dim=-1)) \
            + torch.clamp_max(torch.amax(q, dim=-1), 0.0)
        out = d if out is None else torch.minimum(out, d)
    return out


def occupancy(spec: Dict, device) -> torch.Tensor:
    """(G, G, G) float32 {0, 1} grid over the unit cube [0, 1]^3 (world
    [-0.5, 0.5]^3): a cell of a `supersample` times finer grid is occupied
    where the distance at its centre is below half its diagonal (so thin
    parts and surfaces count), the fine grid is max-pooled down to G and
    dilated by `dilate` cells, as the port bakes a trained field's grid."""
    G, k = spec["resolution"], spec["supersample"]
    fine = G * k
    axis = (torch.arange(fine, dtype=torch.float32, device=device) + 0.5) \
        / fine - 0.5
    p = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), dim=-1)
    occ = (chair_sdf(p) < 0.5 * np.sqrt(3.0) / fine).to(torch.float32)
    occ = F.max_pool3d(occ[None, None], kernel_size=k, stride=k)
    for _ in range(spec["dilate"]):
        occ = F.max_pool3d(occ, kernel_size=3, stride=1, padding=1)
    return occ[0, 0].contiguous()
