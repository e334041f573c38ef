"""Quantization-aware training support: round() with a straight-through
gradient (`STERound`), and the differentiable fake quantizer built on it.
Gradients flow to x straight through inside the clip range, are zero
outside it, and are halved for a code exactly on a clip edge; and
`fake_quant_params_tree`, which fake-quantizes a params tree leaf by leaf
(leaves named by their '/'-joined paths, as the reference names them)."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.quant.linear_quant import QuantParams, weight_qparams
from repro_torch.tree_util import map_with_path


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


def fake_quant_params_tree(params: Any, bits_fn: Callable[[str], int],
                           ranges: Optional[Dict[str, Any]] = None,
                           paper_exact: bool = True) -> Any:
    """Fake-quantize every weight leaf of a params tree.

    bits_fn maps the '/'-joined leaf path to a bit width (return 0 or >=16
    to leave the leaf unquantized). ranges optionally maps path -> (lo,
    hi); defaults to per-leaf min/max.
    """

    def _leaf(name, p):
        bits = bits_fn(name)
        if bits <= 0 or bits >= 16:
            return p
        if ranges is not None and name in ranges:
            lo, hi = (torch.as_tensor(v, dtype=torch.float32,
                                      device=p.device)
                      for v in ranges[name])
        else:
            lo, hi = torch.min(p), torch.max(p)
        qp = weight_qparams(lo, hi, bits, paper_exact=paper_exact)
        return ste_fake_quant(p, qp, symmetric=True).to(p.dtype)

    return map_with_path(_leaf, params)
