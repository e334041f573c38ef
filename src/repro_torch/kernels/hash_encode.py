"""Fused multi-resolution hash encode: CUDA wrappers, plain versions,
counters.

Two forms of one encode, each one kernel of `csrc/hash_encode.cu`:

- `hash_encode_points_*`: points (B, 3) in [0, 1] -> enc (B, L*F) f32 in
  level-major column order. For each level: the point's voxel, its 8
  corner indices (direct or hashed), their trilinear weights, the corner
  rows of the staged concatenated table (`table_cat`, each level at its
  row offset, an index outside the table giving a zero row) and the
  8-corner sum as a chain of exactly rounded fused multiply-adds: what the
  jitted reference's `level_corner_data` + `hash_encode` compute, bit for
  bit. `meta` (L, 4) int32 describes the levels, one row each:
  resolution, 1 if the level is direct-indexed (else hashed), entries,
  row offset in `table_cat`.
- `hash_encode_corners_*`: the same encode from baked corner data, the
  (L, B, 8) corner indices (each within its level's table) and weights a
  cull plan carries, with the (L,) level offsets: the reference's
  `ops.hash_encode` under its signature.

With `act` (a first linear's activation grid: sx, zx_f, qmax, off) either
gives that layer's int8 activation codes instead, as `quantize_codes`
gives them (the reference's `fused_field_query` before its matmul).

The kernels replace the Pallas `repro/kernels/hash_encoding_kernel.py:
hash_gather` together with the composition around it (`repro/kernels/
ops.py:hash_encode`, and for points the corner math of `repro/nerf/
hash_encoding.py:level_corner_data`). The plain versions are those
compositions in PyTorch. Neither kernel has a backward: the corners
wrapper refuses a table or weights that need a gradient.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels._launch import (
    count_launch,
    device_scalar,
    launch,
    require,
)
from repro_torch.kernels.hash_encoding_kernel import hash_gather_plain

PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
# The feature counts F the kernels are built for: those the Instant-NGP
# paper sweeps (2 is every configuration's).
KERNEL_FEATURES = (1, 2, 4, 8)
# Threads a block of the corners kernel: it holds all of a point's levels.
CORNERS_MAX_LEVELS = 256

# The 8 binary corner offsets of a voxel, shape (8, 3): corner c takes
# bits (c & 1, c >> 1 & 1, c >> 2 & 1).
_CORNERS = np.stack(
    [[(c >> d) & 1 for d in range(3)] for c in range(8)], axis=0
).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _corners_on(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The corner offsets on `device`, int32 and f32, copied there once: a
    copy from host memory per call would stall the card's stream."""
    corners = torch.from_numpy(_CORNERS).to(device)
    return corners, corners.to(torch.float32)


def corner_data(points: torch.Tensor, res: int, direct: bool,
                entries: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level's voxel-corner indices and trilinear weights.

    points: (P, 3) in [0, 1]. Returns (idx (P, 8) int32, w (P, 8) f32).
    Direct levels index x + y*s + z*s^2 (s = res + 1); hashed ones
    (x*1 ^ y*2654435761 ^ z*805459861) mod entries in uint32 with
    wrap-around, taken here in int64 and masked back to 32 bits after
    each multiply. The weight is the product of the three per-axis
    factors, taken left to right.
    """
    x = points * res
    x0f = torch.floor(x)
    frac = x - x0f
    x0 = torch.clamp(x0f.to(torch.int32), 0, res)  # (P, 3)
    corners, corners_f = _corners_on(points.device)
    xc = torch.clamp(x0[:, None, :] + corners[None], 0, res).to(torch.int64)
    if direct:
        stride = res + 1
        idx = xc[..., 0] + xc[..., 1] * stride + xc[..., 2] * stride * stride
        idx = (idx & _U32).to(torch.int32)
    else:
        h = ((xc[..., 0] * PRIMES[0]) & _U32) \
            ^ ((xc[..., 1] * PRIMES[1]) & _U32) \
            ^ ((xc[..., 2] * PRIMES[2]) & _U32)
        idx = (h % entries).to(torch.int32)
    c = corners_f[None]  # (1, 8, 3)
    f = frac[:, None, :]
    t = c * f + (1.0 - c) * (1.0 - f)  # (P, 8, 3)
    return idx, t[..., 0] * t[..., 1] * t[..., 2]


def _fma_f32(a64: torch.Tensor, b64: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """round_f32(a * b + c) rounded once, as a fused multiply-add does, for
    f32 values `a64`, `b64` (held in float64) and f32 `c`.

    The product of two f32 values is exact in float64. The sum is rounded
    to float64 and the error kept (TwoSum); the float64 result is then
    moved to its odd neighbour when it was inexact and even ("round to
    odd"), which makes the final rounding to f32 equal to a single
    rounding of the exact value. Elementwise IEEE arithmetic only, so the
    CPU and the card give the same bits."""
    p = a64 * b64
    c64 = c.to(torch.float64)
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    bits = s.view(torch.int64)
    fix = (err != 0) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)  # toward the exact sum
    s = torch.where(fix, bits + step, bits).view(torch.float64)
    return s.to(torch.float32)


def _fma_chain(vals: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    v64 = vals.to(torch.float64)
    w64 = w.to(torch.float64)[..., None]
    acc = torch.zeros(vals[..., 0, :].shape, dtype=torch.float32,
                      device=vals.device)
    for c in range(vals.shape[-2]):
        acc = _fma_f32(v64[..., c, :], w64[..., c, :], acc)
    return acc


class _TrilinearSum(torch.autograd.Function):
    """The FMA chain forward; the gradient of the plain product-sum
    `sum(vals * w[..., None], -2)` backward, as `jax.grad` takes it of
    the reference (the chain's bit-reinterpretation has no gradient)."""

    @staticmethod
    def forward(ctx, vals, w):
        ctx.save_for_backward(vals, w)
        return _fma_chain(vals, w)

    @staticmethod
    def backward(ctx, g):
        vals, w = ctx.saved_tensors
        dvals = dw = None
        if ctx.needs_input_grad[0]:
            dvals = g[..., None, :] * w[..., :, None]
        if ctx.needs_input_grad[1]:
            dw = torch.sum(g[..., None, :] * vals, dim=-1)
        return dvals, dw


def trilinear_sum(vals: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_c vals[..., c, :] * w[..., c] over the 8 corners as a chain of
    fused multiply-adds from 0: acc = fma(vals[c], w[c], acc), c = 0..7.
    That is what XLA compiles the reference's
    `jnp.sum(vals * w[..., None], axis=-2)` to under `jit`, so the
    encodings, and the activation codes rounded from them, are bit-equal
    to the jitted reference's at the paper's widths (at some narrower
    shapes XLA vectorizes the sum in another order). Differentiable in
    both operands: dvals = g * w, dw = sum_F g * vals."""
    return _TrilinearSum.apply(vals, w)


@functools.lru_cache(maxsize=None)
def _zero(device: torch.device) -> torch.Tensor:
    """A float32 zero on `device`, made once: the codes' lower bound."""
    return torch.zeros((), dtype=torch.float32, device=device)


def act_codes(x: torch.Tensor, act: Dict) -> torch.Tensor:
    """clip(round(x / sx + zx_f), 0, qmax): a linear layer's activation
    codes, as floats. Both bounds are tensors, so `torch.clamp` is one
    pass that reads nothing to the host (a number beside the one-element
    `qmax` would read it, a blocking read)."""
    return torch.clamp(torch.round(x / act["sx"] + act["zx_f"]),
                       _zero(x.device), act["qmax"])


def quantize_codes(x: torch.Tensor, act: Dict) -> torch.Tensor:
    """Activation codes of a linear layer's input, shifted into int8:
    clip(round(x / sx + zx_f), 0, qmax) - off."""
    return (act_codes(x, act) - act["off"]).to(torch.int8)


def hash_encode_corners_plain(corner_idx: torch.Tensor,
                              corner_w: torch.Tensor,
                              table_cat: torch.Tensor,
                              level_offsets: torch.Tensor,
                              act: Optional[Dict] = None) -> torch.Tensor:
    """The composition the corners kernel fuses: one gather over the
    concatenated table at each level's offset (an int32 sum), the
    FMA-chain trilinear sum, and with `act` the activation codes."""
    L, B, C = corner_idx.shape
    flat = (corner_idx + level_offsets[:, None, None]).reshape(-1)
    vals = hash_gather_plain(flat.to(torch.int32), table_cat)
    enc = trilinear_sum(vals.reshape(L, B, C, -1), corner_w)  # (L, B, F)
    enc = enc.permute(1, 0, 2).reshape(B, -1)
    return enc if act is None else quantize_codes(enc, act)


def hash_encode_points_plain(points: torch.Tensor, table_cat: torch.Tensor,
                             meta: torch.Tensor,
                             act: Optional[Dict] = None) -> torch.Tensor:
    """The composition the points kernel fuses: `corner_data` per level,
    then `hash_encode_corners_plain`."""
    per_level = [corner_data(points, res, bool(direct), entries)
                 for res, direct, entries, _ in meta.tolist()]
    idx = torch.stack([i for i, _ in per_level])  # (L, B, 8)
    w = torch.stack([wl for _, wl in per_level])
    return hash_encode_corners_plain(idx, w, table_cat, meta[:, 3], act)


def _table_features(table_cat: torch.Tensor) -> int:
    """F of a table the kernels take: F in `KERNEL_FEATURES`, each row on
    a vector-load boundary."""
    F = table_cat.shape[1]
    if F not in KERNEL_FEATURES:
        raise ValueError(f"the kernel takes F in {KERNEL_FEATURES}, got {F}")
    if table_cat.data_ptr() % min(4 * F, 16):
        raise ValueError(f"table_cat must start on a {min(4 * F, 16)}-byte "
                         "boundary (one row a vector load)")
    return F


def _output(B: int, width: int, act: Optional[Dict], dev: torch.device):
    """(out, grid): f32 encodings and four Nones, or with `act` int8 codes
    and its scalars (sx, zx_f, qmax, off), one-element tensors on `dev`
    (no host copy, no sync)."""
    if act is None:
        out = torch.empty((B, width), dtype=torch.float32, device=dev)
        return out, (None,) * 4
    out = torch.empty((B, width), dtype=torch.int8, device=dev)
    return out, tuple(device_scalar(act[k], k, torch.float32, dev)
                      for k in ("sx", "zx_f", "qmax", "off"))


def _pointers(grid) -> Tuple:
    return tuple(None if t is None else t.data_ptr() for t in grid)


def hash_encode_points_cuda(points: torch.Tensor, table_cat: torch.Tensor,
                            meta: torch.Tensor,
                            act: Optional[Dict] = None) -> torch.Tensor:
    """Launch the points kernel: enc (B, L*F) f32, or with `act` int8
    codes. The activation grid is read from device memory (no host sync).
    Raises on anything the kernel does not take."""
    dev = points.device
    require(points, "points", torch.float32, 2, dev)
    require(table_cat, "table_cat", torch.float32, 2, dev)
    require(meta, "meta", torch.int32, 2, dev)
    B, L, T = points.shape[0], meta.shape[0], table_cat.shape[0]
    if points.shape[1] != 3 or meta.shape[1] != 4:
        raise ValueError(f"shape mismatch: points {tuple(points.shape)}, "
                         f"meta {tuple(meta.shape)}")
    F = _table_features(table_cat)
    if meta.data_ptr() % 16:
        raise ValueError("meta must start on a 16-byte boundary (one level "
                         "a vector load)")
    out, grid = _output(B, L * F, act, dev)
    launch("repro_hash_encode", dev, points.data_ptr(), table_cat.data_ptr(),
           meta.data_ptr(), *_pointers(grid), out.data_ptr(), B, L, T, F,
           int(act is not None))
    count_launch(hash_encode_points_cuda)
    return out


hash_encode_points_cuda.launches = 0


def hash_encode_corners_cuda(corner_idx: torch.Tensor,
                             corner_w: torch.Tensor,
                             table_cat: torch.Tensor,
                             level_offsets: torch.Tensor,
                             act: Optional[Dict] = None) -> torch.Tensor:
    """Launch the corners kernel: enc (B, L*F) f32, or with `act` int8
    codes. The activation grid is read from device memory (no host sync).
    Raises on anything the kernel does not take, and on a `table_cat` or
    `corner_w` that requires a gradient while grad mode is on: the kernel
    has no backward, and would drop it without a word."""
    if torch.is_grad_enabled() and (table_cat.requires_grad
                                    or corner_w.requires_grad):
        raise RuntimeError("hash_encode_corners has no backward: call it "
                           "under torch.no_grad() or on detached tensors")
    dev = corner_idx.device
    require(corner_idx, "corner_idx", torch.int32, 3, dev)
    require(corner_w, "corner_w", torch.float32, 3, dev)
    require(table_cat, "table_cat", torch.float32, 2, dev)
    require(level_offsets, "level_offsets", torch.int32, 1, dev)
    L, B, C = corner_idx.shape
    if C != 8 or corner_w.shape != corner_idx.shape \
            or level_offsets.shape != (L,) or L > CORNERS_MAX_LEVELS:
        raise ValueError(f"the kernel takes (L, B, 8) corners, matching "
                         f"weights and (L,) offsets, L <= "
                         f"{CORNERS_MAX_LEVELS}: got corner_idx "
                         f"{tuple(corner_idx.shape)}, corner_w "
                         f"{tuple(corner_w.shape)}, level_offsets "
                         f"{tuple(level_offsets.shape)}")
    for t, name in ((corner_idx, "corner_idx"), (corner_w, "corner_w")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (a "
                             "point's 8 corners are two vector loads)")
    T, F = table_cat.shape[0], _table_features(table_cat)
    out, grid = _output(B, L * F, act, dev)
    launch("repro_hash_encode_corners", dev, corner_idx.data_ptr(),
           corner_w.data_ptr(), table_cat.data_ptr(),
           level_offsets.data_ptr(), *_pointers(grid), out.data_ptr(), B, L,
           T, F, int(act is not None))
    count_launch(hash_encode_corners_cuda)
    return out


hash_encode_corners_cuda.launches = 0
