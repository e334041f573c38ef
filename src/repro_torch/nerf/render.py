"""Volume rendering (the NeRF quadrature) over the fake-quant field.

alpha_i = 1 - exp(-sigma_i * delta_i), T_i = prod_{j<i}(1 - alpha_j),
w_i = T_i * alpha_i, C = sum_i w_i c_i + (1 - sum_i w_i) * bg.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.nerf.ngp import NGPConfig, NGPQuantSpec, ngp_apply


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    n_samples: int = 32
    near: float = 0.2
    far: float = 2.5
    white_bg: bool = True
    stratified: bool = True  # jitter samples during training


def composite(sigma: torch.Tensor, rgb: torch.Tensor, t: torch.Tensor,
              white_bg: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Alpha compositing. Returns (color (R,3), weights (R,S), depth (R,))."""
    delta = torch.diff(t, dim=-1)
    delta = torch.cat([delta, torch.full_like(delta[..., :1], 1e10)], dim=-1)
    alpha = 1.0 - torch.exp(-sigma * delta)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]],
                      dim=-1)
    weights = trans * alpha
    color = torch.sum(weights[..., None] * rgb, dim=-2)
    depth = torch.sum(weights * t, dim=-1)
    if white_bg:
        color = color + (1.0 - torch.sum(weights, dim=-1, keepdim=True))
    return color, weights, depth


def render_rays(params: Dict, rays_o: torch.Tensor, rays_d: torch.Tensor,
                cfg: NGPConfig, rcfg: RenderConfig,
                spec: Optional[NGPQuantSpec] = None,
                jitter: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render a batch of rays -> (color (R,3), depth (R,)). The scene lives
    in [-0.5, 0.5]^3; samples are clipped into the unit cube for the field
    query and get zero density outside the box. `jitter` (R, S) uniforms
    in [0, 1), on the rays' device, stratify the samples (the reference's
    `jax.random.uniform(key, (R, S))`) when `rcfg.stratified`."""
    n_rays = rays_o.shape[0]
    t = torch.linspace(rcfg.near, rcfg.far, rcfg.n_samples,
                       device=rays_o.device)
    t = t.expand(n_rays, rcfg.n_samples)
    if rcfg.stratified and jitter is not None:
        dt = (rcfg.far - rcfg.near) / rcfg.n_samples
        t = t + jitter * dt

    pts = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
    pts_unit = torch.clamp(pts + 0.5, 0.0, 1.0)
    flat_dirs = rays_d[:, None, :].expand(pts.shape).reshape(-1, 3)
    sigma, rgb = ngp_apply(params, pts_unit.reshape(-1, 3), flat_dirs, cfg,
                           spec)
    sigma = sigma.reshape(n_rays, rcfg.n_samples)
    rgb = rgb.reshape(n_rays, rcfg.n_samples, 3)
    inside = ((pts > -0.5) & (pts < 0.5)).all(dim=-1)
    sigma = torch.where(inside, sigma, torch.zeros((), device=sigma.device))
    color, _, depth = composite(sigma, rgb, t, white_bg=rcfg.white_bg)
    return color, depth
