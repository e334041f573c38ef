"""Bit-serial systolic-array timing model (Stripes-style PEs, paper Fig. 2).

"The Bitserial PE architecture enables N-bit multiply-accumulate (MAC)
operations to be computed in N cycles" — so a K-deep dot product on one PE
costs K * serial_factor cycles, and an (M x K) @ (K x N) matmul on an
R x C weight-stationary array costs

  ceil(N / C) tile columns x ceil(M / R) tile rows
      x (K * serial_factor + fill)            compute per tile
  + weight-load cycles per tile (K * C weights, w_bits each, amortized
    across the M dimension when M spans multiple row-tiles).

The model is deliberately analytic (utilization, fill, serialization) — the
cycle counts are exact for a dense schedule, which is what NeuRex's MLP unit
executes (MLPs here have no sparsity).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.hwsim.config import HWConfig


@dataclasses.dataclass
class MatmulCycles:
    compute_cycles: float
    weight_load_cycles: float
    total: float
    macs: int


def bit_serial_matmul_cycles(
    m: int,
    k: int,
    n: int,
    w_bits: float,
    a_bits: float,
    cfg: HWConfig,
) -> MatmulCycles:
    """Cycles for (m x k) @ (k x n) with the given operand bit widths."""
    rows, cols = cfg.systolic_rows, cfg.systolic_cols
    row_tiles = math.ceil(m / rows)
    col_tiles = math.ceil(n / cols)
    serial = cfg.serial_factor(w_bits, a_bits)

    fill = rows + cols  # systolic pipeline fill/drain per tile
    per_tile = k * serial + fill
    compute = row_tiles * col_tiles * per_tile

    # Weight-stationary: weights for a (k x cols) tile are loaded once per
    # column tile (streamed over all row tiles). Loading is bit-serial too:
    # k*cols weights, w_bits each, cols lanes wide.
    weight_load = col_tiles * k * w_bits

    return MatmulCycles(
        compute_cycles=float(compute),
        weight_load_cycles=float(weight_load),
        total=float(compute + weight_load),
        macs=m * k * n,
    )


def serial_factor_torch(w_bits: torch.Tensor, a_bits: torch.Tensor,
                        cfg: HWConfig) -> torch.Tensor:
    """Elementwise counterpart of HWConfig.serial_factor over bit tensors."""
    if cfg.serial_mode == "stripes":
        return a_bits
    if cfg.serial_mode == "max":
        return torch.maximum(w_bits, a_bits)
    raise ValueError(f"unknown serial_mode {cfg.serial_mode!r}")


def mlp_cycles_torch(
    m: int,
    layer_dims: Sequence[Tuple[int, int]],
    w_bits: torch.Tensor,
    a_bits: torch.Tensor,
    cfg: HWConfig,
) -> torch.Tensor:
    """`mlp_cycles` in f32 over a leading K axis: w_bits, a_bits (K,
    n_layers) on any device -> (K,) total MLP-unit cycles. Layer dims and
    tiling are static (they come from the trace); only the bit widths vary
    by policy."""
    dev = w_bits.device
    d_in = torch.tensor([d for d, _ in layer_dims], dtype=torch.float32,
                        device=dev)
    d_out = np.asarray([d for _, d in layer_dims], np.float32)
    row_tiles = float(np.float32(np.ceil(m / cfg.systolic_rows)))
    col_tiles = torch.from_numpy(
        np.ceil(d_out / np.float32(cfg.systolic_cols))).to(dev)
    fill = float(cfg.systolic_rows + cfg.systolic_cols)

    serial = serial_factor_torch(w_bits, a_bits, cfg)  # (K, n_layers)
    per_tile = d_in * serial + fill
    compute = row_tiles * col_tiles * per_tile
    weight_load = col_tiles * d_in * w_bits
    return torch.sum(compute + weight_load, dim=-1)


def mlp_cycles(
    m: int,
    layer_dims: Sequence[Tuple[int, int]],
    w_bits: Sequence[float],
    a_bits: Sequence[float],
    cfg: HWConfig,
) -> Tuple[float, List[MatmulCycles]]:
    """Total MLP-unit cycles for a batch of m samples through a stack of
    linear layers with per-layer bit widths."""
    assert len(layer_dims) == len(w_bits) == len(a_bits)
    per_layer = [
        bit_serial_matmul_cycles(m, d_in, d_out, wb, ab, cfg)
        for (d_in, d_out), wb, ab in zip(layer_dims, w_bits, a_bits)
    ]
    return sum(c.total for c in per_layer), per_layer
