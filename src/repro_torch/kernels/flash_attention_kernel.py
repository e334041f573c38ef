"""Flash attention (prefill forward): CUDA wrapper, plain version, counter.

q (B, Hkv, S, G, hd) holds the G query heads of each KV head; k, v are
(B, Hkv, Sk, hd): Sk == S when causal, any Sk >= 1 for full attention
(an encoder's self-attention, cross-attention over an encoder's
positions). Scores are f32 and scaled by 1/sqrt(hd), masked entries
(causal) are set to -1e30, p = exp(s - max) is rounded to v's dtype
before the PV product, and the output is the f32 sum over max(l, 1e-30).
The kernel is `csrc/flash_attention.cu` (online softmax over key tiles);
it replaces the Pallas
`repro/kernels/flash_attention_kernel.py:_flash_kernel`. The dtype picks
its route: bfloat16 runs on the tensor cores (wgmma) from tiles staged by
`cp.async`, float32 on the CUDA cores.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels._launch import (
    count_launch,
    launch,
    require_aligned,
    require_rows,
)

NEG_INF = -1e30
HD_MAX = 128  # the kernel's largest head dim
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """The same function with the whole key axis in one tile (so `m` is the
    row's maximum): (B, Hkv, S, G, hd) f32. Causal needs Sk == S."""
    hd, S = q.shape[-1], q.shape[2]
    s = torch.einsum("bhsgd,bhtd->bhsgt", q.float(), k.float()) \
        * (1.0 / math.sqrt(hd))
    if causal:
        pos = torch.arange(S, device=q.device)
        keep = pos[:, None] >= pos[None, :]
        s = torch.where(keep[None, None, :, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhsgt,bhtd->bhsgd", p.to(v.dtype).float(), v.float())
    return out / torch.clamp(l, min=1e-30)


def full_attention_plain(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Full (non-causal) attention of q (B, Hkv, Sq, G, hd) over k, v
    (B, Hkv, Sk, hd) for any Sq and Sk: (B, Hkv, Sq, G, hd) f32."""
    return flash_attention_plain(q, k, v, causal=False)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel on strided views (innermost axis contiguous).
    Returns (B, Hkv, S, G, hd) f32: a view of a buffer laid out
    (B, S, Hkv, G, hd), the order the model reads it back in. Raises on
    anything the kernel does not take; in bfloat16 that includes a q, k
    or v whose start or strides are not 16-byte aligned (the tensor-core
    route copies 16-byte pieces of rows), which the model's views never
    are."""
    dev = q.device
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    require_rows(q, "q", q.dtype, 5, dev)
    require_rows(k, "k", q.dtype, 4, dev)
    require_rows(v, "v", q.dtype, 4, dev)
    B, Hkv, S, G, hd = q.shape
    Sk = k.shape[2]
    if tuple(k.shape) != (B, Hkv, Sk, hd) or k.shape != v.shape or (
            causal and Sk != S) or Sk < 1:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}{' (causal)' * causal}")
    if hd > HD_MAX:
        raise ValueError(f"head dim {hd} > {HD_MAX}")
    if q.dtype == torch.bfloat16:
        for t, name in ((q, "q"), (k, "k"), (v, "v")):
            require_aligned(t, name)
    out = torch.empty((B, S, Hkv, G, hd), dtype=torch.float32,
                      device=dev).permute(0, 2, 1, 3, 4)
    launch("repro_flash_attention", dev, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), B, Hkv, S, Sk, G, hd,
           *(q.stride(i) for i in range(4)),
           *(k.stride(i) for i in range(3)),
           *(v.stride(i) for i in range(3)),
           *(out.stride(i) for i in range(4)),
           int(bool(causal)), 1.0 / math.sqrt(hd), _DTYPES[q.dtype])
    count_launch(flash_attention_cuda)
    return out


flash_attention_cuda.launches = 0
