"""Flash-decoding attention (one query token against a KV cache): CUDA
wrapper, plain version, counter.

q (B, Hkv, G, hd) holds the G query heads of each KV head; k, v are
(B, Hkv, S, hd), and positions pos < length take part. Scores are f32 and
scaled by 1/sqrt(hd), p = exp(s - max) is rounded to v's dtype before the
PV product, and the output, the sum over max(l, 1e-30), is cast to q's
dtype. The kernel is `csrc/decode_attention.cu` (the cache split across
blocks, the partials combined by the last block of each sequence, in one
launch); it replaces the Pallas
`repro/kernels/decode_attention_kernel.py:_decode_attn_kernel`.

The partial form (`lse=True`): the output in float32, unrounded, and the
float32 log-sum-exp of each head's masked scores (B, Hkv, G), so that the
results over several blocks of a cache's positions combine into the
result over all of them (`distributed.sharding.combine_partials`). A
length of 0 (a block wholly past the token) gives a zero output and a
log-sum-exp of -inf, without a read of k or v.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels._launch import (
    count_launch,
    device_scalar,
    launch,
    require_aligned,
    require_rows,
    sm_count,
)

NEG_INF = -1e30
G_MAX, HD_MAX = 16, 256  # the kernel's largest group and head dim
SPLIT_MAX = 128  # cache positions a block at most
KV_SMEM = 64 * 1024  # bytes of K and V rows a block stages at most
FAC_MAX = 16384  # G * splits: the combine's factors in shared memory
BLOCKS_PER_SM = 3  # enough blocks that every K/V byte is in flight at once
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           length, lse: bool = False):
    """The same function over the whole cache at once: (B, Hkv, G, hd) in
    q's dtype; with `lse`, (that output in float32, the log-sum-exp (B,
    Hkv, G) float32). `length` is an int or a one-element tensor, >= 0."""
    hd, S = q.shape[-1], k.shape[2]
    s = torch.einsum("bhgd,bhsd->bhgs", q.float(), k.float()) \
        * (1.0 / math.sqrt(hd))
    keep = torch.arange(S, device=q.device) < torch.as_tensor(
        length, device=q.device).reshape(())
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bhsd->bhgd", p.to(v.dtype).float(), v.float())
    out = out / torch.clamp(l, min=1e-30)
    if lse:
        return out, (m + torch.log(l))[..., 0]
    return out.to(q.dtype)


def split_len(n_seq: int, S: int, G: int, hd: int, elem_bytes: int,
              n_sm: int) -> int:
    """Cache positions a block of the kernel takes, for `n_seq` = B * Hkv
    sequences of a cache of S positions on a card of `n_sm`
    multiprocessors: a multiple of 16 near n_seq * S / (BLOCKS_PER_SM *
    n_sm), so that about three blocks a multiprocessor hold every K/V byte
    of the call in flight at once; at most SPLIT_MAX and what KV_SMEM holds, and at least
    16 and long enough that the combine's G * ceil(S / split) factors fit
    in FAC_MAX. Raises when the cache is too long for both."""
    row_bytes = -(-hd * elem_bytes // 16) * 16
    most = min(SPLIT_MAX, KV_SMEM // (2 * row_bytes) // 16 * 16)
    need = -(-S // (FAC_MAX // G))  # the fewest positions a block may take
    need = max(16, -(-need // 16) * 16)
    if need > most:
        raise ValueError(f"a cache of {S} positions needs splits of {need} "
                         f"> {most} positions (G={G}, hd={hd})")
    split = -(-n_seq * S // (BLOCKS_PER_SM * n_sm))
    return min(most, max(need, -(-split // 16) * 16))


# (device, B * Hkv, splits, G, padded hd) -> (m and l partials, acc
# partials, tickets). Kept across calls; the tickets start at 0 and every
# call leaves them at 0.
_SCRATCH: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def _scratch(dev: torch.device, n_seq: int, n_split: int, G: int,
             hdp: int):
    key = (dev, n_seq, n_split, G, hdp)
    if key not in _SCRATCH:
        rows = n_seq * n_split * G
        _SCRATCH[key] = (
            torch.empty((2, rows), dtype=torch.float32, device=dev),
            torch.empty((rows, hdp), dtype=torch.float32, device=dev),
            torch.zeros(n_seq, dtype=torch.int32, device=dev))
    return _SCRATCH[key]


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          length, lse: bool = False):
    """Launch the CUDA kernel (per-split partials combined by the last
    block of each sequence, one launch) on strided views (innermost axis
    contiguous), so a (B, S_max, Hkv, hd) cache is read in place. q, k
    and v must start on 16-byte boundaries with strides of whole 16-byte
    units. `length` (an int, passed by value, or a one-element tensor on
    the card, read there) must be >= 0. Raises on anything the kernel does
    not take. With `lse`, returns (the output in float32, the log-sum-exp
    (B, Hkv, G) float32), the partial form.

    The partial sums and the combine's tickets are kept across calls,
    per device and shape, so calls must not overlap: the wrapper serves
    one stream. Each call allocates only its result. Raises on a q, k or
    v that requires a gradient while grad mode is on: the kernel has no
    backward (decode is never trained), and would drop it without a
    word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("decode_attention has no backward: call it under "
                           "torch.no_grad() or on detached tensors")
    dev = q.device
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    require_rows(q, "q", q.dtype, 4, dev)
    require_rows(k, "k", q.dtype, 4, dev)
    require_rows(v, "v", q.dtype, 4, dev)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        require_aligned(t, name)
    B, Hkv, G, hd = q.shape
    S = k.shape[2]
    if tuple(k.shape) != (B, Hkv, S, hd) or k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if not (1 <= G <= G_MAX and hd <= HD_MAX and S >= 1):
        raise ValueError(f"needs 1 <= G <= {G_MAX}, hd <= {HD_MAX} and a "
                         f"non-empty cache; got G={G}, hd={hd}, S={S}")
    if isinstance(length, torch.Tensor):
        length_t = device_scalar(length, "length", torch.int32, dev)
        length_ptr, length_v = length_t.data_ptr(), 0
    else:
        length_ptr, length_v = None, int(length)
        if length_v < 0:
            raise ValueError(f"length must be >= 0, got {length_v}")
    n_seq = B * Hkv
    split = split_len(n_seq, S, G, hd, q.element_size(),
                      sm_count(dev.index if dev.index is not None
                               else torch.cuda.current_device()))
    unit = 16 // q.element_size()
    stats, acc, tickets = _scratch(dev, n_seq, -(-S // split), G,
                                   -(-hd // unit) * unit)
    out = torch.empty((B, Hkv, G, hd), dtype=torch.float32 if lse
                      else q.dtype, device=dev)
    lse_t = torch.empty((B, Hkv, G), dtype=torch.float32, device=dev) \
        if lse else None
    launch("repro_decode_attention", dev, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), length_ptr, length_v, out.data_ptr(),
           None if lse_t is None else lse_t.data_ptr(),
           stats[0].data_ptr(), stats[1].data_ptr(), acc.data_ptr(),
           tickets.data_ptr(), B, Hkv, G, S, hd,
           *(q.stride(i) for i in range(3)),
           *(k.stride(i) for i in range(3)),
           *(v.stride(i) for i in range(3)),
           split, 1.0 / math.sqrt(hd), _DTYPES[q.dtype])
    count_launch(decode_attention_cuda)
    return (out, lse_t) if lse else out


decode_attention_cuda.launches = 0
