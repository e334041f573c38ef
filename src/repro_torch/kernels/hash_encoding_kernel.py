"""Hash-table gather: CUDA wrapper, plain version, counter.

(P, F) = table[indices], an index outside [0, T) giving a zero row. The
kernel is `csrc/hash_gather.cu`; it replaces the Pallas
`repro/kernels/hash_encoding_kernel.py:_hash_gather_kernel`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._launch import count_launch, launch, require


def hash_gather_plain(indices: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    T = table.shape[0]
    idx = indices.to(torch.int64)
    ok = (idx >= 0) & (idx < T)
    rows = table[torch.where(ok, idx, 0)].to(torch.float32)
    return torch.where(ok[:, None], rows, torch.zeros((), device=rows.device))


def hash_gather_cuda(indices: torch.Tensor,
                     table: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel. Raises on anything it does not take."""
    dev = indices.device
    require(indices, "indices", torch.int32, 1, dev)
    require(table, "table", torch.float32, 2, dev)
    P, (T, F) = indices.shape[0], table.shape
    out = torch.empty((P, F), dtype=torch.float32, device=dev)
    launch("repro_hash_gather", dev, indices.data_ptr(), table.data_ptr(),
           out.data_ptr(), P, T, F)
    count_launch(hash_gather_cuda)
    return out


hash_gather_cuda.launches = 0
