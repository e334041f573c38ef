"""Entry points of the port's kernels, dispatched by the tensor's device.

A CUDA tensor launches the hand-written kernel (`csrc/*.cu`) or raises; a
CPU tensor takes the kernel's plain PyTorch version. Nothing here falls
back: there is no flag to pick a path and no `try` around a launch.

The hash encode has two forms, one kernel each, both exact against the
jitted reference (the trilinear 8-corner sum a chain of exactly rounded
fused multiply-adds): `hash_encode_points` takes sample points (the march
and warp tiers), `hash_encode` the corner data a cull plan bakes (the
hit tier and the PSNR plan path), under the reference's signature. Each
gives the encodings, or with an activation grid the first linear's int8
codes; `fused_field_query_points` and `fused_field_query` follow the
codes with the packed matmul. `gather_composite` takes a chunk's
compacted field outputs to its served colour in one kernel.

Tensors without data (`FakeTensor` on any device, `meta`) take each
entry's shape-only route: it returns the kernel's outputs, empty, and
records the kernel's cost (`kernels/cost.py`) in the recording
`distributed.hlo_counters` runs, never its plain version. Under a
recording that counts the card (`Recorder(kernels="cost")`) the plain
version on CPU tensors also counts as its kernel: its cost is recorded
and its own ops are not.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.alpha_composite import (
    alpha_composite_cuda,
    alpha_composite_plain,
)
from repro_torch.kernels.decode_attention_kernel import (
    decode_attention_cuda,
    decode_attention_plain,
)
from repro_torch.kernels import cost
from repro_torch.kernels.flash_attention_kernel import (
    counted_attention,
    flash_attention_card,
    flash_attention_plain,
    full_attention_plain,
)
from repro_torch.kernels.gather_composite import (
    gather_composite_cuda,
    gather_composite_plain,
)
from repro_torch.kernels.hash_encode import (  # noqa: F401 (re-exported)
    hash_encode_corners_cuda,
    hash_encode_corners_plain,
    hash_encode_points_cuda,
    hash_encode_points_plain,
    quantize_codes,
    trilinear_sum,
)
from repro_torch.kernels.hash_encoding_kernel import (
    hash_gather_cuda,
    hash_gather_plain,
)
from repro_torch.kernels.quant_matmul import (
    quant_matmul_cuda,
    quant_matmul_packed_cuda,
    quant_matmul_packed_plain,
    quant_matmul_plain,
)
from repro_torch.kernels.ray_march import ray_march_cuda, ray_march_plain
from repro_torch.quant.packing import PackedTensor


def _shape_only(t: torch.Tensor) -> bool:
    """Whether `t` holds no data: a `FakeTensor` or a `meta` tensor."""
    from torch._subclasses.fake_tensor import is_fake

    return t.device.type == "meta" or is_fake(t)


def _on_card(t: torch.Tensor) -> bool:
    """Whether `t` is a CUDA tensor that holds data."""
    return t.device.type == "cuda" and not _shape_only(t)


def _route(t: torch.Tensor) -> str:
    """"shape" for a tensor without data, "card" for a CUDA tensor,
    "plain" for a CPU tensor; any other device raises."""
    if _shape_only(t):
        return "shape"
    if _on_card(t):
        return "card"
    if t.device.type == "cpu":
        return "plain"
    raise ValueError(f"unsupported device {t.device}")


def _dispatch(name: str, c, t: torch.Tensor, card, plain, shapes):
    """`card()` on the card; elsewhere `shapes()` (no data) or `plain()`,
    counted as kernel `name` of cost `c()` under a recording
    (`hlo_counters.kernel_call`)."""
    route = _route(t)
    if route == "card":
        return card()
    from repro_torch.distributed.hlo_counters import kernel_call

    with kernel_call(name, c, route == "shape"):
        return shapes() if route == "shape" else plain()


def _empty(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=like.device)


def quant_matmul(x_codes: torch.Tensor, w_codes: torch.Tensor, sx, sw,
                 zx) -> torch.Tensor:
    """f32 (M, N) = ((x - zx) @ w) * sx * sw over int8 codes, summed
    exactly in integers."""
    (M, K), N = x_codes.shape, w_codes.shape[1]
    return _dispatch(
        "quant_matmul", lambda: cost.quant_matmul(M, K, N), x_codes,
        lambda: quant_matmul_cuda(x_codes, w_codes, sx, sw, zx),
        lambda: quant_matmul_plain(x_codes, w_codes, sx, sw, zx),
        lambda: _empty((M, N), torch.float32, x_codes))


def quant_matmul_packed(x_codes: torch.Tensor, wq: PackedTensor, sx, sw,
                        zx) -> torch.Tensor:
    """f32 (M, N) = ((x - zx) @ codes(wq)) * sx * sw; `wq` planar or
    ``tile:<bk>``."""
    return _dispatch(
        "quant_matmul_packed",
        lambda: cost.quant_matmul_packed(*x_codes.shape, wq.cols,
                                         wq.words.numel()), x_codes,
        lambda: quant_matmul_packed_cuda(x_codes, wq, sx, sw, zx),
        lambda: quant_matmul_packed_plain(x_codes, wq, sx, sw, zx),
        lambda: _empty((x_codes.shape[0], wq.cols), torch.float32, x_codes))


def hash_gather(indices: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(P, F) = table[indices]; out-of-range indices give zero rows."""
    P, F = indices.numel(), table.shape[1]
    return _dispatch(
        "hash_gather", lambda: cost.hash_gather(P, F), indices,
        lambda: hash_gather_cuda(indices, table),
        lambda: hash_gather_plain(indices, table),
        lambda: _empty((P, F), torch.float32, indices))


def alpha_composite(sigma: torch.Tensor, rgb: torch.Tensor,
                    delta: torch.Tensor, early_stop: bool = False,
                    t_eps: float = 1e-6
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(color (R, 3), acc (R, 1)). `early_stop` lets the kernel leave a
    ray once its transmittance is below `t_eps` (the result stays within
    t_eps of the dense walk); the plain version always walks densely."""
    R, S = sigma.shape
    return _dispatch(
        "alpha_composite", lambda: cost.alpha_composite(R, S), sigma,
        lambda: alpha_composite_cuda(sigma, rgb, delta, early_stop, t_eps),
        lambda: alpha_composite_plain(sigma, rgb, delta),
        lambda: (_empty((R, 3), torch.float32, sigma),
                 _empty((R, 1), torch.float32, sigma)))


def gather_composite(sigma_b: torch.Tensor, rgb_b: torch.Tensor,
                     take: torch.Tensor, valid: torch.Tensor,
                     delta_row: torch.Tensor, white_bg: bool,
                     early_stop: bool = False, t_eps: float = 1e-6,
                     active: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(color (R, 3), acc (R, 1)) of R rays x S samples from compacted
    field outputs: sample k = r * S + s reads sigma_b[take[k]] (B,) and
    rgb_b[take[k]] (B, 3) where valid[k] (and active[k] > 0.5, when the
    march's f32 mask is given) holds, composites over delta_row (S,), and
    adds the white background 1 - acc when asked. `early_stop` lets the
    kernel leave a ray between 32-sample chunks once its transmittance is
    below `t_eps`; the plain version always walks densely."""
    S = delta_row.shape[0]
    R = take.numel() // S
    return _dispatch(
        "gather_composite",
        lambda: cost.gather_composite(R, S, take.element_size()), sigma_b,
        lambda: gather_composite_cuda(sigma_b, rgb_b, take, valid, delta_row,
                                      white_bg, early_stop, t_eps, active),
        lambda: gather_composite_plain(sigma_b, rgb_b, take, valid,
                                       delta_row, white_bg, active),
        lambda: (_empty((R, 3), torch.float32, sigma_b),
                 _empty((R, 1), torch.float32, sigma_b)))


def ray_march(occ: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
              t: torch.Tensor, early_stop: bool = True) -> torch.Tensor:
    """Active-sample mask (R, S) f32 {0, 1}; the early exit never changes
    it. `t` must be non-decreasing for `early_stop=True`."""
    R, S = rays_o.shape[0], t.numel()
    return _dispatch(
        "ray_march", lambda: cost.ray_march(R, S), rays_o,
        lambda: ray_march_cuda(occ, rays_o, rays_d, t, early_stop),
        lambda: ray_march_plain(occ, rays_o, rays_d, t),
        lambda: _empty((R, S), torch.float32, rays_o))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Grouped-query attention forward: q (B, Hkv, S, G, hd) against k, v
    (B, Hkv, S, hd) -> (B, Hkv, S, G, hd) f32. Non-causal attention needs
    S % 128 == 0, as the reference's kernel does at its default key tile
    (it has no key mask). On the card it differentiates through the
    backward kernel (`FlashAttention`)."""
    if not causal and q.shape[2] % 128:
        raise ValueError("non-causal flash requires S % bk == 0")
    return _attention(q, k, v, causal, flash_attention_plain)


def full_attention(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Non-causal grouped-query attention for any query and key lengths:
    q (B, Hkv, Sq, G, hd) against k, v (B, Hkv, Sk, hd) -> (B, Hkv, Sq, G,
    hd) f32. The model's entry for an encoder's self-attention and for
    cross-attention; on the card the flash kernel masks keys >= Sk
    itself, so neither length need be a multiple of a tile, and
    differentiates through the backward kernel."""
    return _attention(q, k, v, False,
                      lambda q, k, v, _: full_attention_plain(q, k, v))


def _attention(q, k, v, causal: bool, plain):
    """Kernel 6 by route: the card's `FlashAttention`; without data, or
    under a recording that counts the card, `counted_attention` (its
    forward and backward kernels' costs, the plain versions computing
    the values on CPU tensors); else the plain version."""
    from repro_torch.distributed.hlo_counters import active

    route = _route(q)
    if route == "card":
        return flash_attention_card(q, k, v, causal)
    rec = active()
    if route == "shape" or (rec is not None and rec.kernels == "cost"):
        return counted_attention(q, k, v, causal, route == "shape")
    return plain(q, k, v, causal)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length, lse: bool = False):
    """One query token per head: q (B, Hkv, G, hd) against the cache k, v
    (B, Hkv, S, hd) masked to positions < length (>= 0) -> (B, Hkv, G, hd)
    in q's dtype; with `lse`, the partial form: (that output in float32,
    the log-sum-exp (B, Hkv, G) float32), zero and -inf at length 0. The
    card's kernel has no backward (decode is never trained) and raises
    under grad mode on an input requiring one."""
    B, Hkv, G, hd = q.shape
    n = min(length, k.shape[2]) if isinstance(length, int) else k.shape[2]
    return _dispatch(
        "decode_attention",
        lambda: cost.decode_attention(B, Hkv, G, hd, n, q.element_size(),
                                      lse), q,
        lambda: decode_attention_cuda(q, k, v, length, lse),
        lambda: decode_attention_plain(q, k, v, length, lse),
        lambda: (_empty(q.shape, torch.float32, q),
                 _empty(q.shape[:3], torch.float32, q)) if lse
        else _empty(q.shape, q.dtype, q))


def hash_encode(corner_idx: torch.Tensor, corner_w: torch.Tensor,
                table_cat: torch.Tensor,
                level_offsets: torch.Tensor) -> torch.Tensor:
    """Multi-level hash-grid encode from precomputed corner data, in one
    kernel: the gather over the concatenated table and the trilinear
    8-corner sum.

    corner_idx    (L, B, 8) int32 — per-level in-table corner indices
    corner_w      (L, B, 8) f32   — matching trilinear weights
    table_cat     (T, F)    f32   — all level tables stacked row-wise
    level_offsets (L,)      int32 — row offset of each level in table_cat

    Returns (B, L*F) features in level-major column order; a row outside
    the table reads as zeros."""
    return hash_encode_corners(corner_idx, corner_w, table_cat,
                               level_offsets)


def hash_encode_corners(corner_idx: torch.Tensor, corner_w: torch.Tensor,
                        table_cat: torch.Tensor, level_offsets: torch.Tensor,
                        act: Optional[Dict] = None) -> torch.Tensor:
    """`hash_encode`, and with `act` (a linear's activation grid) that
    layer's int8 codes instead, as `quantize_codes` gives them."""
    L, B, _ = corner_idx.shape
    F = table_cat.shape[1]
    return _dispatch(
        "hash_encode_corners", lambda: cost.hash_encode_corners(L, B, F),
        corner_idx,
        lambda: hash_encode_corners_cuda(corner_idx, corner_w, table_cat,
                                         level_offsets, act),
        lambda: hash_encode_corners_plain(corner_idx, corner_w, table_cat,
                                          level_offsets, act),
        lambda: _empty((B, L * F), torch.float32 if act is None
                       else torch.int8, corner_idx))


def hash_encode_points(points: torch.Tensor, table_cat: torch.Tensor,
                       meta: torch.Tensor,
                       act: Optional[Dict] = None) -> torch.Tensor:
    """Multi-level hash-grid encode from sample points, in one kernel.

    points    (B, 3)  f32 in [0, 1]
    table_cat (T, F)  f32   — all level tables stacked row-wise
    meta      (L, 4)  int32 — per level: resolution, direct flag,
                              entries, row offset in table_cat

    Returns (B, L*F) f32 features in level-major column order, equal to
    `hash_encode` over each level's `corner_data`; with `act` (a linear's
    activation grid) that layer's int8 codes, as `quantize_codes` gives
    them."""
    B, L, F = points.shape[0], meta.shape[0], table_cat.shape[1]
    return _dispatch(
        "hash_encode", lambda: cost.hash_encode_points(B, L, F), points,
        lambda: hash_encode_points_cuda(points, table_cat, meta, act),
        lambda: hash_encode_points_plain(points, table_cat, meta, act),
        lambda: _empty((B, L * F), torch.float32 if act is None
                       else torch.int8, points))


def fused_field_query(corner_idx: torch.Tensor, corner_w: torch.Tensor,
                      table_cat: torch.Tensor, level_offsets: torch.Tensor,
                      wq: PackedTensor, act: Dict) -> torch.Tensor:
    """`hash_encode` over precomputed corner data straight to the first
    linear's activation codes in one kernel, then the quantized matmul:
    the first-layer field query of the fused integer renderer, under the
    reference's signature. `act` carries the layer's activation grid (sx,
    zx, zx_f, qmax, off); returns the f32 pre-activation (B, N) without
    the bias."""
    codes = hash_encode_corners(corner_idx, corner_w, table_cat,
                                level_offsets, act)
    return quant_matmul_packed(codes, wq, act["sx"], wq.scale, act["zx"])


def fused_field_query_points(points: torch.Tensor, table_cat: torch.Tensor,
                             meta: torch.Tensor, wq: PackedTensor,
                             act: Dict) -> torch.Tensor:
    """`fused_field_query` from sample points: the hash encode straight to
    activation codes in one kernel, then the quantized matmul. Same
    result as `fused_field_query` over each level's corner data."""
    codes = hash_encode_points(points, table_cat, meta, act)
    return quant_matmul_packed(codes, wq, act["sx"], wq.scale, act["zx"])
