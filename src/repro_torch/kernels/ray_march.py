"""Occupancy-grid ray march: CUDA wrapper, plain version, counter.

Active mask (R, S) f32 {0, 1}: the sample o + d * t is active iff it lies
strictly inside (-0.5, 0.5)^3 and in an occupied cell of the (G, G, G)
unit-cube grid — exactly `occupancy_lookup` on the renderer's sample
points, and the host `sample_active_mask` oracle. The kernel is
`csrc/ray_march.cu` (bit-equal, per-ray early exit for non-decreasing t);
it replaces the Pallas `repro/kernels/ray_march.py:_ray_march_kernel`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._launch import count_launch, launch, require


def ray_march_plain(occ: torch.Tensor, rays_o: torch.Tensor,
                    rays_d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    G = occ.shape[0]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t[None, :, None]
    inside = ((pts > -0.5) & (pts < 0.5)).all(dim=-1)
    unit = torch.clamp(pts + 0.5, 0.0, 1.0)
    cell = torch.clamp((unit * G).to(torch.int64), 0, G - 1)
    hit = occ[cell[..., 0], cell[..., 1], cell[..., 2]] > 0.5
    return (inside & hit).to(torch.float32)


def ray_march_cuda(occ: torch.Tensor, rays_o: torch.Tensor,
                   rays_d: torch.Tensor, t: torch.Tensor,
                   early_stop: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel. `t` must be non-decreasing when
    `early_stop` is on. Raises on anything it does not take."""
    dev = rays_o.device
    require(occ, "occ", torch.float32, 3, dev)
    require(rays_o, "rays_o", torch.float32, 2, dev)
    require(rays_d, "rays_d", torch.float32, 2, dev)
    require(t, "t", torch.float32, 1, dev)
    G = occ.shape[0]
    R, S = rays_o.shape[0], t.shape[0]
    if tuple(occ.shape) != (G, G, G) or rays_o.shape[1] != 3 \
            or rays_d.shape != rays_o.shape:
        raise ValueError(f"shape mismatch: occ {tuple(occ.shape)}, rays_o "
                         f"{tuple(rays_o.shape)}, rays_d {tuple(rays_d.shape)}")
    out = torch.empty((R, S), dtype=torch.float32, device=dev)
    launch("repro_ray_march", dev, occ.data_ptr(), rays_o.data_ptr(),
           rays_d.data_ptr(), t.data_ptr(), out.data_ptr(), R, S, G,
           int(bool(early_stop)))
    count_launch(ray_march_cuda)
    return out


ray_march_cuda.launches = 0
