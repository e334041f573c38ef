"""Quantization-aware training support: round() with a straight-through
gradient (`STERound`), and the differentiable fake quantizer built on it.
Gradients flow to x straight through inside the clip range, are zero
outside it, and are halved for a code exactly on a clip edge."""
from __future__ import annotations

import torch

from repro_torch.quant.linear_quant import QuantParams


class STERound(torch.autograd.Function):
    """round() forward, identity backward."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    return STERound.apply(x)


def _clip(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """clip as min(max(x, lo), hi): at a code exactly on a clip edge the
    gradient is halved, as `jnp.clip`'s is."""
    return torch.minimum(torch.maximum(x, lo), hi)


def ste_fake_quant(x: torch.Tensor, qp: QuantParams,
                   symmetric: bool) -> torch.Tensor:
    """Differentiable fake quantization using the STE."""
    if symmetric:
        return _clip(ste_round(x / qp.scale), qp.q_min, qp.q_max) * qp.scale
    q = _clip(ste_round(x / qp.scale + qp.zero_point), qp.q_min, qp.q_max)
    return (q - qp.zero_point) * qp.scale
