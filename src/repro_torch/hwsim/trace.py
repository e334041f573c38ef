"""Trace generation: the memory-access and compute workload the
accelerator would see for a real ray batch.

A trace is bit-width independent — per-level *entry indices* (not byte
addresses) plus sample positions. The simulator turns indices into byte
addresses under a given quantization policy (entry bytes depend on the
level's bit width), so one trace serves every policy the agent proposes —
this is what makes the RL reward loop fast, mirroring the paper's pre-
generated trace files.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.nerf.hash_encoding import level_corner_data
from repro_torch.nerf.ngp import NGPConfig, _linear_dims, ngp_linear_names
from repro_torch.nerf.render import RenderConfig


@dataclasses.dataclass
class NGPTrace:
    """Workload trace for one rendering batch (host numpy arrays)."""

    n_rays: int
    n_samples: int  # per ray
    # Per hash level: entry indices touched, in access (time) order, (P*8,).
    level_indices: List[np.ndarray]
    # Number of entries per level table (for addressing).
    level_entries: List[int]
    # Subgrid id per sample point, access order, (P,).
    subgrid_ids: np.ndarray
    # MLP layer dims (d_in, d_out) in order; batch dim = P samples.
    mlp_dims: List[Tuple[int, int]]
    mlp_names: List[str]

    @property
    def n_points(self) -> int:
        return self.n_rays * self.n_samples


def build_trace(
    cfg: NGPConfig,
    rcfg: RenderConfig,
    rays_o: np.ndarray,
    rays_d: np.ndarray,
    subgrid_resolution: int = 4,
    device: DeviceLike = None,
) -> NGPTrace:
    """Compute the access trace for a batch of rays (no model weights needed:
    addresses depend only on geometry, which is the paper's observation that
    traces can be generated once on a GPU and reused). The corner indices
    are computed on `device` (the card unless `device="cpu"`) and copied
    back once a level."""
    dev = resolve_device(device)
    n_rays = rays_o.shape[0]
    t = np.linspace(rcfg.near, rcfg.far, rcfg.n_samples, dtype=np.float32)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t[None, :, None]
    pts_unit = np.clip(pts + 0.5, 0.0, 1.0).reshape(-1, 3)  # (P, 3)

    hcfg = cfg.hash
    level_indices: List[np.ndarray] = []
    level_entries: List[int] = []
    pts_t = torch.from_numpy(np.ascontiguousarray(pts_unit,
                                                  np.float32)).to(dev)
    for l in range(hcfg.n_levels):
        idx, _ = level_corner_data(pts_t, l, hcfg)
        level_indices.append(idx.cpu().numpy().reshape(-1))  # (P*8,)
        level_entries.append(hcfg.level_entries(l))

    sg = np.clip(
        (pts_unit * subgrid_resolution).astype(np.int64), 0, subgrid_resolution - 1
    )
    subgrid_ids = (
        sg[:, 0]
        + sg[:, 1] * subgrid_resolution
        + sg[:, 2] * subgrid_resolution**2
    )

    dims = _linear_dims(cfg)
    names = ngp_linear_names(cfg)
    return NGPTrace(
        n_rays=n_rays,
        n_samples=rcfg.n_samples,
        level_indices=level_indices,
        level_entries=level_entries,
        subgrid_ids=subgrid_ids,
        mlp_dims=[dims[n] for n in names],
        mlp_names=list(names),
    )
