"""Occupancy grid: empty-space culling for the fused render engine.

Baked once from a (pre)trained field by thresholding density on a dense
grid, max-pooled from a supersampled sweep and dilated, so a cell is only
marked empty when a neighbourhood around it is below the threshold.

`ray_t_samples` (host numpy) is the single source of the deterministic
eval sample depths, and `sample_active_mask` (host numpy) the budget
oracle: the device march (`kernels.ops.ray_march`) and the inline
`occupancy_lookup` agree with it bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class OccupancyGrid:
    """Boolean occupancy over the unit cube [0,1]^3, stored as f32 {0,1}."""

    occ: torch.Tensor  # (G, G, G) f32, 1.0 = occupied
    resolution: int
    threshold: float
    occupied_fraction: float  # host-side stat

    @property
    def n_occupied(self) -> int:
        return int(round(self.occupied_fraction * self.resolution**3))

    @functools.cached_property
    def host_occ(self) -> np.ndarray:
        """(G, G, G) bool on the host, copied once for the host oracle."""
        return self.occ.detach().cpu().numpy() > 0.5


def _dilate_max3(occ: torch.Tensor, iterations: int) -> torch.Tensor:
    """3x3x3 max-pool dilation (SAME padding), `iterations` times."""
    x = occ[None, None]
    for _ in range(iterations):
        x = F.max_pool3d(x, kernel_size=3, stride=1, padding=1)
    return x[0, 0]


def dilate_occupancy(grid: OccupancyGrid, cells: int) -> OccupancyGrid:
    """Grid with every occupied cell grown by `cells` in Chebyshev
    distance."""
    if cells <= 0:
        return grid
    occ = _dilate_max3(grid.occ, int(cells))
    return OccupancyGrid(occ=occ, resolution=grid.resolution,
                         threshold=grid.threshold,
                         occupied_fraction=float(occ.mean()))


def ray_t_samples(rcfg) -> np.ndarray:
    """THE deterministic eval t-samples: (n_samples,) f32, host-computed
    (`np.linspace`), shared by the host oracles and the device renderer."""
    return np.linspace(rcfg.near, rcfg.far, rcfg.n_samples, dtype=np.float32)


@torch.no_grad()
def bake_occupancy(params: Dict, cfg, resolution: int = 32,
                   threshold: float = 1e-2, supersample: int = 2,
                   dilate: int = 1, chunk: int = 65536,
                   spec=None) -> OccupancyGrid:
    """Query sigma on a (resolution * supersample)^3 grid of the unit cube
    (on the device of `params`), max-pool down to resolution^3,
    threshold, dilate."""
    from repro_torch.nerf.ngp import ngp_apply

    dev = params["sigma/0"]["w"].device
    fine = resolution * supersample
    axis = (np.arange(fine, dtype=np.float32) + 0.5) / fine
    gx, gy, gz = np.meshgrid(axis, axis, axis, indexing="ij")
    pts = torch.from_numpy(
        np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)).to(dev)
    dirs = torch.tensor([[0.0, 0.0, 1.0]], device=dev)  # view-independent
    sig = torch.empty(pts.shape[0], device=dev)
    for s in range(0, pts.shape[0], chunk):
        p = pts[s:s + chunk]
        sig[s:s + chunk] = ngp_apply(params, p, dirs.expand(p.shape), cfg,
                                     spec)[0]
    sig = sig.reshape(1, 1, fine, fine, fine)
    if supersample > 1:
        sig = F.max_pool3d(sig, kernel_size=supersample, stride=supersample)
    occ = (sig[0, 0] > threshold).to(torch.float32)
    if dilate > 0:
        occ = _dilate_max3(occ, dilate)
    return OccupancyGrid(occ=occ, resolution=resolution,
                         threshold=float(threshold),
                         occupied_fraction=float(occ.mean()))


def occupancy_lookup(grid: OccupancyGrid,
                     pts_unit: torch.Tensor) -> torch.Tensor:
    """(..., 3) points in [0,1] -> (...,) bool, True = occupied cell."""
    idx = torch.clamp((pts_unit * grid.resolution).to(torch.int64), 0,
                      grid.resolution - 1)
    return grid.occ[idx[..., 0], idx[..., 1], idx[..., 2]] > 0.5


def sample_active_mask(grid: OccupancyGrid, rays_o: np.ndarray,
                       rays_d: np.ndarray, rcfg, margin: float = 0.0):
    """Host-side oracle for which samples the renderer may cull.

    Returns (active (..., S) bool, pts (..., S, 3)): a sample is active
    iff it lies strictly inside the scene box AND in an occupied grid
    cell — the single source of truth for `cull_budget`, the engine's
    budget guard and the cull plans.

    `margin > 0` (world units) gives the CONSERVATIVE mask of the
    pose-cache warp plans: the box grows by `margin` and the occupancy
    dilates by `ceil(margin * resolution)` cells, so the mask covers the
    exact (`margin=0`) mask of any rays whose sample points deviate from
    these by at most `margin` in L-inf.
    """
    ro = np.asarray(rays_o, np.float32)
    rd = np.asarray(rays_d, np.float32)
    t = ray_t_samples(rcfg)
    pts = ro[..., None, :] + rd[..., None, :] * t[:, None]
    lo, hi = -0.5 - margin, 0.5 + margin
    inside = np.all((pts > lo) & (pts < hi), axis=-1)
    g = grid.resolution
    cell = np.clip(((pts + 0.5) * g).astype(np.int64), 0, g - 1)
    occ = grid.host_occ
    if margin > 0.0:
        occ = _dilate_max3(torch.from_numpy(occ.astype(np.float32)),
                           int(np.ceil(margin * g))).numpy() > 0.5
    return inside & occ[cell[..., 0], cell[..., 1], cell[..., 2]], pts


def cull_budget(grid: Optional[OccupancyGrid], rays_o: np.ndarray,
                rays_d: np.ndarray, rcfg, chunk: int, slack: float = 1.15,
                align: int = 128) -> int:
    """Per-chunk sample budget for the compacting renderer: the max
    occupied-sample count over `chunk`-ray slices of these rays, times
    `slack`, aligned. Exact for these rays (the active mask depends only
    on geometry and the grid)."""
    n_samples = rcfg.n_samples
    if grid is None:
        return chunk * n_samples
    ro = np.asarray(rays_o, np.float32).reshape(-1, 3)
    rd = np.asarray(rays_d, np.float32).reshape(-1, 3)
    worst = 0
    for s in range(0, ro.shape[0], chunk):
        active, _ = sample_active_mask(grid, ro[s:s + chunk],
                                       rd[s:s + chunk], rcfg)
        worst = max(worst, int(np.sum(active)))
    budget = int(np.ceil(worst * slack / align) * align)
    return int(np.clip(budget, align, chunk * n_samples))
