"""Linear quantization exactly as the paper specifies (Eqs. 4-7).

Weights (symmetric, Eq. 4-5):
    s      = r_v / (2^b - 1),   r_v = v_max - v_min     (calibrated)
    q      = clip(round(x / s), q_min, q_max)
    q_min  = -2^(b-1) - 1   [paper's printed text; conventional grid is
                             -2^(b-1) + 1 -- selectable via paper_exact]
    q_max  =  2^(b-1) - 1

Activations (asymmetric, Eq. 6-7):
    Z = round((1 - v_max / r_v) * (2^b - 1))
    q = clip(round(x / s + Z), 0, 2^b - 1)

Everything is float32 tensor arithmetic, as in the JAX reference, so the
grids agree bit for bit: `torch.round` rounds half to even like
`jnp.round`, and a range given as two Python floats is differenced in
double precision before the float32 cast, as JAX does with weak types.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class QuantParams(NamedTuple):
    """Scale/zero-point/clip bundle for one tensor (0-d f32 tensors)."""

    scale: torch.Tensor
    zero_point: torch.Tensor
    q_min: torch.Tensor
    q_max: torch.Tensor
    bits: torch.Tensor


def _f32(x, like=None) -> torch.Tensor:
    device = like.device if isinstance(like, torch.Tensor) else None
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.tensor(x, dtype=torch.float32, device=device)


def _levels(bits_f: torch.Tensor) -> torch.Tensor:
    return 2.0 ** bits_f - 1.0


def weight_qparams(v_min, v_max, bits, paper_exact: bool = True
                   ) -> QuantParams:
    """Symmetric weight quantization parameters (Eq. 4)."""
    like = v_min if isinstance(v_min, torch.Tensor) else v_max
    bits_f = _f32(bits, like)
    r_v = torch.clamp_min(_f32(v_max - v_min, like), 1e-8)
    scale = r_v / _levels(bits_f)
    half = 2.0 ** (bits_f - 1.0)
    q_max = half - 1.0
    q_min = -half - 1.0 if paper_exact else -half + 1.0
    return QuantParams(scale=scale, zero_point=torch.zeros_like(scale),
                       q_min=q_min, q_max=q_max, bits=bits_f)


def activation_qparams(v_min, v_max, bits) -> QuantParams:
    """Asymmetric activation quantization parameters (Eq. 6)."""
    like = v_min if isinstance(v_min, torch.Tensor) else v_max
    bits_f = _f32(bits, like)
    r_v = torch.clamp_min(_f32(v_max - v_min, like), 1e-8)
    levels = _levels(bits_f)
    scale = r_v / levels
    zero_point = torch.round((1.0 - _f32(v_max, like) / r_v) * levels)
    return QuantParams(scale=scale, zero_point=zero_point,
                       q_min=torch.zeros_like(scale), q_max=levels,
                       bits=bits_f)


def quantize_weight(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """Eq. 5: q = clip(round(x/s), q_min, q_max). Float-typed ints."""
    return torch.clamp(torch.round(x / qp.scale), qp.q_min, qp.q_max)


def dequantize_weight(q: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    return q * qp.scale


def quantize_activation(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """Eq. 7: q = clip(round(x/s + Z), 0, 2^b - 1)."""
    return torch.clamp(torch.round(x / qp.scale + qp.zero_point),
                       qp.q_min, qp.q_max)


def dequantize_activation(q: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    return (q - qp.zero_point) * qp.scale


def fake_quant_weight(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """Quantize->dequantize in one shot (QAT forward / PTQ simulation)."""
    return dequantize_weight(quantize_weight(x, qp), qp)


def fake_quant_activation(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    return dequantize_activation(quantize_activation(x, qp), qp)
