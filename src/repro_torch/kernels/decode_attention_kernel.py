"""Flash-decoding attention (one query token against a KV cache): CUDA
wrapper, plain version, counter.

q (B, Hkv, G, hd) holds the G query heads of each KV head; k, v are
(B, Hkv, S, hd), and positions pos < length take part. Scores are f32 and
scaled by 1/sqrt(hd), p = exp(s - max) is rounded to v's dtype before the
PV product, and the output, the sum over max(l, 1e-30), is cast to q's
dtype. The kernel is `csrc/decode_attention.cu` (the cache split across
blocks, then combined); it replaces the Pallas
`repro/kernels/decode_attention_kernel.py:_decode_attn_kernel`.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels._launch import device_scalar, launch, require_rows

NEG_INF = -1e30
CHUNK = 64  # cache positions per block of the kernel
G_MAX, HD_MAX = 16, 256  # the kernel's largest group and head dim
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           length) -> torch.Tensor:
    """The same function over the whole cache at once: (B, Hkv, G, hd) in
    q's dtype. `length` is an int or a one-element tensor."""
    hd, S = q.shape[-1], k.shape[2]
    s = torch.einsum("bhgd,bhsd->bhgs", q.float(), k.float()) \
        * (1.0 / math.sqrt(hd))
    keep = torch.arange(S, device=q.device) < torch.as_tensor(
        length, device=q.device).reshape(())
    s = torch.where(keep, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bhsd->bhgd", p.to(v.dtype).float(), v.float())
    return (out / torch.clamp(l, min=1e-30)).to(q.dtype)


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          length) -> torch.Tensor:
    """Launch the CUDA kernels (per-split partials, then their combine) on
    strided views (innermost axis contiguous), so a (B, S_max, Hkv, hd)
    cache is read in place. `length` (an int, or a one-element tensor on
    the card) must be >= 1. Raises on anything the kernel does not take."""
    dev = q.device
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    require_rows(q, "q", q.dtype, 4, dev)
    require_rows(k, "k", q.dtype, 4, dev)
    require_rows(v, "v", q.dtype, 4, dev)
    B, Hkv, G, hd = q.shape
    S = k.shape[2]
    if tuple(k.shape) != (B, Hkv, S, hd) or k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if not (1 <= G <= G_MAX and hd <= HD_MAX and S >= 1):
        raise ValueError(f"needs 1 <= G <= {G_MAX}, hd <= {HD_MAX} and a "
                         f"non-empty cache; got G={G}, hd={hd}, S={S}")
    n_split = -(-S // CHUNK)
    length_t = device_scalar(length, "length", torch.int32, dev)
    stats = torch.empty((2, B * Hkv * n_split * G), dtype=torch.float32,
                        device=dev)
    acc = torch.empty((B * Hkv * n_split * G, hd), dtype=torch.float32,
                      device=dev)
    out = torch.empty((B, Hkv, G, hd), dtype=q.dtype, device=dev)
    launch("repro_decode_attention", dev, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), length_t.data_ptr(), out.data_ptr(),
           stats[0].data_ptr(), stats[1].data_ptr(), acc.data_ptr(),
           B, Hkv, G, S, hd,
           *(q.stride(i) for i in range(3)),
           *(k.stride(i) for i in range(3)),
           *(v.stride(i) for i in range(3)),
           1.0 / math.sqrt(hd), _DTYPES[q.dtype])
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
