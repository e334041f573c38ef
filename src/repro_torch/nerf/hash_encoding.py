"""Multi-resolution hash encoding (Instant NGP, Muller et al. 2022).

L levels of feature grids with geometrically increasing resolution
N_l = floor(N_min * b^l). Levels whose dense grid fits the table budget are
direct-indexed; finer levels use the spatial hash

    h(x) = (x0 * pi0) xor (x1 * pi1) xor (x2 * pi2)  mod T

with pi = (1, 2654435761, 805459861) in uint32 with wrap-around. PyTorch
has little uint32 arithmetic, so the products are taken in int64 and
masked back to 32 bits after each multiply: the indices equal the JAX
reference's exactly at every level. The corner math itself lives beside
the fused encode kernel (`kernels/hash_encode.py`), which computes it on
the card.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.hash_encode import corner_data
from repro_torch.kernels.ops import trilinear_sum
from repro_torch.quant.linear_quant import weight_qparams
from repro_torch.quant.qat import ste_fake_quant


@dataclasses.dataclass(frozen=True)
class HashEncodingConfig:
    n_levels: int = 16
    n_features: int = 2  # F: features per entry
    log2_table_size: int = 12  # T = 2^log2_table_size (max entries per level)
    base_resolution: int = 4  # N_min
    max_resolution: int = 128  # N_max

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    def level_scale(self) -> float:
        """Growth factor b = exp((ln N_max - ln N_min) / (L - 1))."""
        if self.n_levels == 1:
            return 1.0
        return float(
            np.exp(
                (np.log(self.max_resolution) - np.log(self.base_resolution))
                / (self.n_levels - 1)
            )
        )

    def resolutions(self) -> List[int]:
        b = self.level_scale()
        return [
            int(np.floor(self.base_resolution * (b**l)))
            for l in range(self.n_levels)
        ]

    def level_entries(self, level: int) -> int:
        """Number of entries actually stored for a level (direct vs hashed)."""
        res = self.resolutions()[level]
        return min((res + 1) ** 3, self.table_size)

    def is_direct(self, level: int) -> bool:
        res = self.resolutions()[level]
        return (res + 1) ** 3 <= self.table_size

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features


def init_hash_tables(generator: torch.Generator, cfg: HashEncodingConfig,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """Uniform init in [-1e-4, 1e-4] as in Instant NGP. Drawn on the CPU
    from `generator` (so a seed gives the same tables on any device)."""
    tables = {}
    for l in range(cfg.n_levels):
        n = cfg.level_entries(l)
        u = torch.rand((n, cfg.n_features), generator=generator)
        tables[f"level_{l}"] = (u * 2e-4 - 1e-4).to(device)
    return tables


def level_corner_data(points: torch.Tensor, level: int,
                      cfg: HashEncodingConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-level voxel-corner indices and trilinear weights.

    points: (P, 3) in [0, 1]. Returns (idx (P, 8) int32, w (P, 8) f32).
    The weight is the product of the three per-axis factors, taken left
    to right.
    """
    return corner_data(points, cfg.resolutions()[level], cfg.is_direct(level),
                       cfg.level_entries(level))


@functools.lru_cache(maxsize=None)
def level_rows(cfg: HashEncodingConfig) -> Tuple[Tuple[int, int, int, int],
                                                 ...]:
    """One row a level: resolution, 1 if direct (else hashed), entries,
    row offset in the concatenated table (levels stacked in order)."""
    rows, off = [], 0
    for l in range(cfg.n_levels):
        n = cfg.level_entries(l)
        rows.append((cfg.resolutions()[l], int(cfg.is_direct(l)), n, off))
        off += n
    return tuple(rows)


@functools.lru_cache(maxsize=None)
def level_meta(cfg: HashEncodingConfig, device: torch.device) -> torch.Tensor:
    """`level_rows` as an (L, 4) int32 tensor on `device`: the fused encode
    kernel's level description, copied to the device once per (config,
    device)."""
    return torch.tensor(level_rows(cfg), dtype=torch.int32).to(device)


def hash_encode(tables: Dict[str, torch.Tensor], points: torch.Tensor,
                cfg: HashEncodingConfig,
                level_bits: Optional[torch.Tensor] = None,
                paper_exact: bool = True) -> torch.Tensor:
    """Encode points (P, 3) in [0,1] -> features (P, L*F).

    level_bits: optional (L,) per-level bit widths; each level's table is
    then fake-quantized (symmetric, Eq. 4-5) through the STE. Bit widths
    >= 16 keep full precision.
    """
    feats = []
    for l in range(cfg.n_levels):
        table = tables[f"level_{l}"]
        if level_bits is not None:
            bits = level_bits[l]
            qp = weight_qparams(table.min(), table.max(), bits,
                                paper_exact=paper_exact)
            q = ste_fake_quant(table, qp, symmetric=True)
            table = torch.where(bits >= 16.0, table, q)
        idx, w = level_corner_data(points, l, cfg)
        vals = table[idx.to(torch.int64)]  # (P, 8, F)
        feats.append(trilinear_sum(vals, w))
    return torch.cat(feats, dim=-1)
