"""Volume-rendering alpha compositing: CUDA wrapper, plain version, counter.

alpha = 1 - exp(-sigma * delta); T = exclusive cumprod of (1 - alpha);
color = sum T * alpha * rgb, acc = sum T * alpha, over samples. The kernel
is `csrc/alpha_composite.cu` (per-ray early exit once T < t_eps); it
replaces the Pallas `repro/kernels/alpha_composite.py:_composite_kernel`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels._launch import count_launch, launch, require


def alpha_composite_plain(sigma: torch.Tensor, rgb: torch.Tensor,
                          delta: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """color (R, 3), acc (R, 1) via the exclusive-cumprod transmittance
    (the dense walk: no early exit)."""
    alpha = 1.0 - torch.exp(-sigma * delta)
    cum = torch.cumprod(1.0 - alpha, dim=1)
    T = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
    w = T * alpha
    color = (w[..., None] * rgb).sum(dim=1)
    acc = w.sum(dim=1, keepdim=True)
    return color, acc


def alpha_composite_cuda(sigma: torch.Tensor, rgb: torch.Tensor,
                         delta: torch.Tensor, early_stop: bool = False,
                         t_eps: float = 1e-6
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel. Raises on anything it does not take."""
    dev = sigma.device
    require(sigma, "sigma", torch.float32, 2, dev)
    require(delta, "delta", torch.float32, 2, dev)
    require(rgb, "rgb", torch.float32, 3, dev)
    R, S = sigma.shape
    if delta.shape != sigma.shape or tuple(rgb.shape) != (R, S, 3):
        raise ValueError(f"shape mismatch: sigma {tuple(sigma.shape)}, "
                         f"delta {tuple(delta.shape)}, rgb {tuple(rgb.shape)}")
    color = torch.empty((R, 3), dtype=torch.float32, device=dev)
    acc = torch.empty((R, 1), dtype=torch.float32, device=dev)
    launch("repro_alpha_composite", dev, sigma.data_ptr(), rgb.data_ptr(),
           delta.data_ptr(), color.data_ptr(), acc.data_ptr(), R, S,
           int(bool(early_stop)), float(t_eps))
    count_launch(alpha_composite_cuda)
    return color, acc


alpha_composite_cuda.launches = 0
