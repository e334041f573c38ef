"""Fused gather + compositing: CUDA wrapper, plain version, counter.

From the compacted field outputs of one chunk of R rays x S samples to the
served colour: sample k = r * S + s reads sigma_b[take[k]] and
rgb_b[take[k]] where valid[k] holds (zero elsewhere), then alpha =
1 - exp(-sigma * delta[s]), T the exclusive cumprod of (1 - alpha), color
= sum T * alpha * rgb and acc = sum T * alpha over the samples, plus the
white background 1 - acc when asked. Every serve tier (plan hit, warp,
march) ends in it.

The kernel is `csrc/gather_composite.cu`. It replaces the Pallas
`repro/kernels/alpha_composite.py:alpha_composite` together with the
gathers, selects and background add around it in the reference's
`_chunk_color` and `_slot_warp_impl`. The plain version is that
composition in PyTorch: the take clamp, the two gathers under `valid`,
`alpha_composite_plain` over the (R, S) delta, the background add.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._launch import count_launch, launch, require
from repro_torch.kernels.alpha_composite import alpha_composite_plain


def _check_shapes(sigma_b, rgb_b, take, valid, delta_row, active) -> int:
    """R, raising unless the shapes fit: sigma_b (B,), rgb_b (B, 3), take
    and valid (P,), delta_row (S,), P = R * S, active None or (P,)."""
    B, P, S = sigma_b.shape[0], take.shape[0], delta_row.shape[0]
    if (tuple(rgb_b.shape) != (B, 3) or tuple(valid.shape) != (P,)
            or S == 0 or P % S or B == 0
            or (active is not None and tuple(active.shape) != (P,))):
        raise ValueError(
            f"shape mismatch: sigma_b {tuple(sigma_b.shape)}, rgb_b "
            f"{tuple(rgb_b.shape)}, take {tuple(take.shape)}, valid "
            f"{tuple(valid.shape)}, delta_row {tuple(delta_row.shape)}"
            + ("" if active is None else f", active {tuple(active.shape)}"))
    return P // S


def gather_composite_plain(sigma_b: torch.Tensor, rgb_b: torch.Tensor,
                           take: torch.Tensor, valid: torch.Tensor,
                           delta_row: torch.Tensor, white_bg: bool,
                           active: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """color (R, 3), acc (R, 1) by the composition the kernel fuses (the
    dense walk: no early exit)."""
    n_rays = _check_shapes(sigma_b, rgb_b, take, valid, delta_row, active)
    n_s = delta_row.shape[0]
    if active is not None:
        valid = valid & (active > 0.5)
    zero = torch.zeros((), device=sigma_b.device)
    take = torch.clamp(take, 0, sigma_b.shape[0] - 1)
    sigma = torch.where(valid, sigma_b[take], zero).reshape(n_rays, n_s)
    rgb = torch.where(valid[:, None], rgb_b[take], zero) \
        .reshape(n_rays, n_s, 3)
    delta = delta_row.expand(n_rays, n_s).contiguous()
    color, acc = alpha_composite_plain(sigma.contiguous(), rgb.contiguous(),
                                       delta)
    if white_bg:
        color = color + (1.0 - acc)
    return color, acc


def gather_composite_cuda(sigma_b: torch.Tensor, rgb_b: torch.Tensor,
                          take: torch.Tensor, valid: torch.Tensor,
                          delta_row: torch.Tensor, white_bg: bool,
                          early_stop: bool = False, t_eps: float = 1e-6,
                          active: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel. `take` is int32 or int64, `valid` bool,
    `active` (optional) the march's f32 {0, 1} mask, ANDed into `valid`.
    Raises on anything the kernel does not take."""
    dev = sigma_b.device
    require(sigma_b, "sigma_b", torch.float32, 1, dev)
    require(rgb_b, "rgb_b", torch.float32, 2, dev)
    if take.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"take must be int32 or int64, got {take.dtype}")
    require(take, "take", take.dtype, 1, dev)
    require(valid, "valid", torch.bool, 1, dev)
    require(delta_row, "delta_row", torch.float32, 1, dev)
    if active is not None:
        require(active, "active", torch.float32, 1, dev)
    R = _check_shapes(sigma_b, rgb_b, take, valid, delta_row, active)
    color = torch.empty((R, 3), dtype=torch.float32, device=dev)
    acc = torch.empty((R, 1), dtype=torch.float32, device=dev)
    launch("repro_gather_composite", dev, sigma_b.data_ptr(),
           rgb_b.data_ptr(), take.data_ptr(), valid.data_ptr(),
           None if active is None else active.data_ptr(),
           delta_row.data_ptr(), color.data_ptr(), acc.data_ptr(), R,
           delta_row.shape[0], sigma_b.shape[0],
           int(take.dtype == torch.int64), int(bool(white_bg)),
           int(bool(early_stop)), float(t_eps))
    count_launch(gather_composite_cuda)
    return color, acc


gather_composite_cuda.launches = 0
