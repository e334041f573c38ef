"""Entry points of the port's kernels, dispatched by the tensor's device.

A CUDA tensor launches the hand-written kernel (`csrc/*.cu`) or raises; a
CPU tensor takes the kernel's plain PyTorch version. Nothing here falls
back: there is no flag to pick a path and no `try` around a launch.

`hash_encode` and `fused_field_query` are the compositions the fused
renderer calls: one gather over the concatenated table, the trilinear
8-corner sum (plain tensor code, summed corner by corner in a fixed
order so the CPU and the card round identically), then, for the field
query, activation quantization and the packed matmul.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.alpha_composite import (
    alpha_composite_cuda,
    alpha_composite_plain,
)
from repro_torch.kernels.hash_encoding_kernel import (
    hash_gather_cuda,
    hash_gather_plain,
)
from repro_torch.kernels.quant_matmul import (
    quant_matmul_packed_cuda,
    quant_matmul_packed_plain,
)
from repro_torch.kernels.ray_march import ray_march_cuda, ray_march_plain
from repro_torch.quant.packing import PackedTensor


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def quant_matmul_packed(x_codes: torch.Tensor, wq: PackedTensor, sx, sw,
                        zx) -> torch.Tensor:
    """f32 (M, N) = ((x - zx) @ codes(wq)) * sx * sw; `wq` planar or
    ``tile:<bk>``."""
    if _on_card(x_codes):
        return quant_matmul_packed_cuda(x_codes, wq, sx, sw, zx)
    return quant_matmul_packed_plain(x_codes, wq, sx, sw, zx)


def hash_gather(indices: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(P, F) = table[indices]; out-of-range indices give zero rows."""
    if _on_card(indices):
        return hash_gather_cuda(indices, table)
    return hash_gather_plain(indices, table)


def alpha_composite(sigma: torch.Tensor, rgb: torch.Tensor,
                    delta: torch.Tensor, early_stop: bool = False,
                    t_eps: float = 1e-6
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(color (R, 3), acc (R, 1)). `early_stop` lets the kernel leave a
    ray once its transmittance is below `t_eps` (the result stays within
    t_eps of the dense walk); the plain version always walks densely."""
    if _on_card(sigma):
        return alpha_composite_cuda(sigma, rgb, delta, early_stop, t_eps)
    return alpha_composite_plain(sigma, rgb, delta)


def ray_march(occ: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
              t: torch.Tensor, early_stop: bool = True) -> torch.Tensor:
    """Active-sample mask (R, S) f32 {0, 1}; the early exit never changes
    it. `t` must be non-decreasing for `early_stop=True`."""
    if _on_card(rays_o):
        return ray_march_cuda(occ, rays_o, rays_d, t, early_stop)
    return ray_march_plain(occ, rays_o, rays_d, t)


def trilinear_sum(vals: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_c vals[..., c, :] * w[..., c] over the 8 corners, corner by
    corner (a fixed order: identical on the CPU and the card)."""
    acc = vals[..., 0, :] * w[..., 0, None]
    for c in range(1, vals.shape[-2]):
        acc = acc + vals[..., c, :] * w[..., c, None]
    return acc


def hash_encode(corner_idx: torch.Tensor, corner_w: torch.Tensor,
                table_cat: torch.Tensor,
                level_offsets: torch.Tensor) -> torch.Tensor:
    """Multi-level hash-grid encode: one gather over the concatenated
    table + trilinear interpolation.

    corner_idx    (L, B, 8) int32 — per-level in-table corner indices
    corner_w      (L, B, 8) f32   — matching trilinear weights
    table_cat     (T, F)    f32   — all level tables stacked row-wise
    level_offsets (L,)      int32 — row offset of each level in table_cat

    Returns (B, L*F) features in level-major column order.
    """
    L, B, C = corner_idx.shape
    flat = (corner_idx + level_offsets[:, None, None]).reshape(-1)
    vals = hash_gather(flat.to(torch.int32).contiguous(), table_cat)
    feats = trilinear_sum(vals.reshape(L, B, C, -1), corner_w)  # (L, B, F)
    return feats.permute(1, 0, 2).reshape(B, -1)


def quantize_codes(x: torch.Tensor, act: Dict) -> torch.Tensor:
    """Activation codes of a linear layer's input, shifted into int8:
    clip(round(x / sx + zx_f), 0, qmax) - off."""
    codes = torch.clamp(torch.round(x / act["sx"] + act["zx_f"]), 0.0,
                        act["qmax"])
    return (codes - act["off"]).to(torch.int8)


def fused_field_query(corner_idx: torch.Tensor, corner_w: torch.Tensor,
                      table_cat: torch.Tensor, level_offsets: torch.Tensor,
                      wq: PackedTensor, act: Dict) -> torch.Tensor:
    """hash_gather -> trilinear interp -> quantized matmul: the first-layer
    field query of the fused integer renderer. `act` carries the layer's
    activation grid (sx, zx, zx_f, qmax, off); returns the f32
    pre-activation (B, N) without the bias."""
    enc = hash_encode(corner_idx, corner_w, table_cat, level_offsets)
    return quant_matmul_packed(quantize_codes(enc, act), wq, act["sx"],
                               wq.scale, act["zx"])
