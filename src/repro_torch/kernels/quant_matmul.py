"""Quantized matmuls: CUDA wrappers, plain versions, counters.

f32 (M, N) = ((x - zx) @ q) * sx * sw, with x int8 activation codes and q
int8 weight codes, summed exactly in integers. Two weight forms:

- `quant_matmul`: q an unpacked int8 (K, N) matrix. The kernel is
  `csrc/quant_matmul.cu`; it replaces the Pallas
  `repro/kernels/quant_matmul.py:_qmm_kernel`.
- `quant_matmul_packed`: q the codes of a sub-byte `PackedTensor` (planar
  or ``tile:<bk>`` words), unpacked to clip(u + offset, -128, 127). The
  kernel is `csrc/quant_matmul_packed.cu`; it replaces the Pallas
  `repro/kernels/quant_matmul.py:_qmm_packed_kernel`.

Both kernels share `csrc/qmm_tile.cuh`: s8 tensor-core tiles of 128 rows
and up to 64 columns, the weight staged once per block, x tiles streamed
through a `cp.async` ring by blocks that each walk several M tiles. The C
entry points plan the launch themselves from (M, K, N) and the card's SM
count.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._launch import (
    count_launch,
    device_scalar,
    launch,
    require,
    sm_count,
)
from repro_torch.quant.packing import PackedTensor, packed_groups, tile_layout_bk


def quant_matmul_plain(x_codes: torch.Tensor, w_codes: torch.Tensor,
                       sx, sw, zx) -> torch.Tensor:
    """Exact integer semantics on any device: the integer product is taken
    in float64 (every partial sum is an integer below 2^53, so exact;
    CUDA has no integer matmul), then cast to f32 and scaled by sx, sw."""
    dev = x_codes.device
    zx = torch.as_tensor(zx, device=dev).to(torch.float64)
    acc = (x_codes.to(torch.float64) - zx) @ w_codes.to(torch.float64)
    sx = torch.as_tensor(sx, dtype=torch.float32, device=dev)
    sw = torch.as_tensor(sw, dtype=torch.float32, device=dev)
    return acc.to(torch.float32) * sx * sw


def quant_matmul_cuda(x_codes: torch.Tensor, w_codes: torch.Tensor,
                      sx, sw, zx) -> torch.Tensor:
    """Launch the CUDA kernel. Raises on anything it does not take."""
    dev = x_codes.device
    require(x_codes, "x_codes", torch.int8, 2, dev)
    require(w_codes, "w_codes", torch.int8, 2, dev)
    M, K = x_codes.shape
    if w_codes.shape[0] != K:
        raise ValueError(f"w {tuple(w_codes.shape)} does not match x "
                         f"{tuple(x_codes.shape)}")
    N = w_codes.shape[1]
    sx_t = device_scalar(sx, "sx", torch.float32, dev)
    sw_t = device_scalar(sw, "sw", torch.float32, dev)
    zx_t = device_scalar(zx, "zx", torch.int32, dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    launch("repro_quant_matmul", dev, x_codes.data_ptr(), w_codes.data_ptr(),
           sx_t.data_ptr(), sw_t.data_ptr(), zx_t.data_ptr(), out.data_ptr(),
           M, K, N, sm_count(dev.index))
    count_launch(quant_matmul_cuda)
    return out


quant_matmul_cuda.launches = 0


def quant_matmul_packed_plain(x_codes: torch.Tensor, wq: PackedTensor,
                              sx, sw, zx) -> torch.Tensor:
    """`quant_matmul_plain` over the unpacked codes, clipped to int8."""
    return quant_matmul_plain(x_codes, torch.clamp(wq.codes(), -128, 127),
                              sx, sw, zx)


def quant_matmul_packed_cuda(x_codes: torch.Tensor, wq: PackedTensor,
                             sx, sw, zx) -> torch.Tensor:
    """Launch the CUDA kernel. Raises on anything it does not take."""
    dev = x_codes.device
    require(x_codes, "x_codes", torch.int8, 2, dev)
    require(wq.words, "wq.words", torch.int32, 2, dev)
    M, K = x_codes.shape
    if len(wq.shape) != 2 or wq.rows != K:
        raise ValueError(f"weight shape {wq.shape} does not match x {tuple(x_codes.shape)}")
    N, bits = wq.cols, int(wq.bits)
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in 1..8, got {bits}")
    groups = packed_groups(K)
    bk = tile_layout_bk(wq.layout)
    gpt = 0 if bk is None else bk // 32
    rows = groups * bits if bk is None else -(-groups // gpt) * gpt * bits
    if tuple(wq.words.shape) != (rows, N):
        raise ValueError(f"{wq.layout} words must be {(rows, N)}, got "
                         f"{tuple(wq.words.shape)}")
    off = device_scalar(wq.offset, "wq.offset", torch.int32, dev)
    sx_t = device_scalar(sx, "sx", torch.float32, dev)
    sw_t = device_scalar(sw, "sw", torch.float32, dev)
    zx_t = device_scalar(zx, "zx", torch.int32, dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    launch("repro_quant_matmul_packed", dev,
           x_codes.data_ptr(), wq.words.data_ptr(), off.data_ptr(),
           sx_t.data_ptr(), sw_t.data_ptr(), zx_t.data_ptr(), out.data_ptr(),
           M, K, N, bits, gpt, sm_count(dev.index))
    count_launch(quant_matmul_packed_cuda)
    return out


quant_matmul_packed_cuda.launches = 0
