"""Occupancy grid: empty-space culling for the fused render engine.

Baked once from a (pre)trained field by thresholding density on a dense
grid, max-pooled from a supersampled sweep and dilated, so a cell is only
marked empty when a neighbourhood around it is below the threshold.

`bake_occupancy_cached` keeps one grid per (weights, config) for every
env over the same scene. `ray_t_samples` (host numpy) is the single
source of the deterministic eval sample depths, and `sample_active_mask`
(host numpy) the budget oracle: the device march
(`kernels.ops.ray_march`) and the inline `occupancy_lookup` agree with it
bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
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


# ---------------------------------------------------------------------------
# Bake registry: one grid per (weights, config) — shared across env instances
# ---------------------------------------------------------------------------
# The search instantiates several envs per scene (one per hardware budget,
# plus batched wrappers); each bake is a dense sigma sweep, so re-baking per
# instantiation multiplies the dominant setup cost for identical grids. The
# registry keys on a fingerprint of the frozen pretrained weights plus every
# bake parameter, so two envs on the same scene share ONE grid object while
# a finetuned/retrained model (different weights) still gets its own bake.
_BAKE_REGISTRY: Dict[tuple, OccupancyGrid] = {}
_BAKE_REGISTRY_CAP = 64
# Held around a lookup and its bake, so envs built on several threads at
# once still share ONE grid per key.
_BAKE_REGISTRY_LOCK = threading.Lock()


def params_fingerprint(params: Dict) -> str:
    """Content hash of a parameter tree (leaves in sorted path order): each
    leaf's path, dtype and bytes. The leaves are copied to the host in one
    transfer."""
    import hashlib

    from repro_torch.tree_util import leaves_with_path

    leaves = leaves_with_path(params)
    flat = torch.cat([leaf.detach().contiguous().reshape(-1)
                      .view(torch.uint8) for _, leaf in leaves]).cpu().numpy()
    h = hashlib.sha256()
    off = 0
    for path, leaf in leaves:
        n = leaf.numel() * leaf.element_size()
        h.update(f"{path}:{leaf.dtype}:{tuple(leaf.shape)}".encode())
        h.update(flat[off:off + n].tobytes())
        off += n
    return h.hexdigest()[:24]


def clear_occupancy_registry() -> None:
    _BAKE_REGISTRY.clear()


def occupancy_registry_size() -> int:
    return len(_BAKE_REGISTRY)


def bake_occupancy_cached(params: Dict, cfg, resolution: int = 32,
                          threshold: float = 1e-2, supersample: int = 2,
                          dilate: int = 1,
                          chunk: int = 65536) -> OccupancyGrid:
    """`bake_occupancy` behind a content-addressed registry: identical
    (weights, device, config, bake knobs) return the SAME grid object."""
    key = (
        params_fingerprint(params), str(params["sigma/0"]["w"].device),
        repr(cfg), resolution, float(threshold), supersample, dilate,
    )
    with _BAKE_REGISTRY_LOCK:
        grid = _BAKE_REGISTRY.get(key)
        if grid is None:
            if len(_BAKE_REGISTRY) >= _BAKE_REGISTRY_CAP:
                _BAKE_REGISTRY.clear()  # bakes recompute exactly; cheap reset
            grid = bake_occupancy(
                params, cfg, resolution=resolution, threshold=threshold,
                supersample=supersample, dilate=dilate, chunk=chunk,
            )
            _BAKE_REGISTRY[key] = grid
        return grid


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
