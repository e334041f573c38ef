"""Flash attention (forward and backward): CUDA wrappers, plain versions,
counters, and the autograd function that joins the two kernels.

q (B, Hkv, S, G, hd) holds the G query heads of each KV head; k, v are
(B, Hkv, Sk, hd): Sk == S when causal, any Sk >= 1 for full attention
(an encoder's self-attention, cross-attention over an encoder's
positions). Scores are f32 and scaled by 1/sqrt(hd), masked entries
(causal) are set to -1e30, p = exp(s - max) is rounded to v's dtype
before the PV product, and the output is the f32 sum over max(l, 1e-30).
The kernel is `csrc/flash_attention.cu` (online softmax over key tiles);
it replaces the Pallas
`repro/kernels/flash_attention_kernel.py:_flash_kernel`. `flash_route`
picks its route: bfloat16 runs on the tensor cores (wgmma) from tiles
staged by `cp.async`, in 64-column tiles at hd <= 64 and 128-column ones
above; float32 runs on the CUDA cores.

On the card the model calls `FlashAttention.apply`. Under grad mode, with
an input that requires a gradient, its forward also has the kernel write
each row's log-sum-exp (`lse`, (B, Hkv, S, G) f32), and its backward
launches `csrc/flash_attention_bwd.cu` (`flash_attention_bwd_cuda`), which
recomputes P from it; otherwise it is one forward launch. The reference
has no backward kernel: it differentiates plain `jnp` attention.
`flash_attention_bwd_plain` is the backward's plain version.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import cost
from repro_torch.kernels._launch import (
    count_launch,
    launch,
    require,
    require_aligned,
    require_rows,
)

NEG_INF = -1e30
HD_MAX = 128  # the kernel's largest head dim
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The forward's routes, as `csrc/flash_attention.cu` numbers them.
ROUTES = {"f32": 0, "tc128": 1, "tc64": 2}


def flash_route(dtype: torch.dtype, hd: int) -> str:
    """The forward kernel a call of `dtype` at head dim `hd` takes:
    "tc64" (bfloat16, hd <= 64: `flash_tcp_kernel<64>`, one 64-column
    panel a tile), "tc128" (bfloat16 above: `flash_tc_kernel`, hd zero-padded to
    128) or "f32" (`flash_f32_kernel`)."""
    if dtype == torch.bfloat16:
        return "tc64" if hd <= 64 else "tc128"
    return "f32"


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


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Each query row's log-sum-exp of its scaled, masked scores:
    (B, Hkv, S, G) f32, what the kernel writes beside its output."""
    hd, S = q.shape[-1], q.shape[2]
    s = torch.einsum("bhsgd,bhtd->bhsgt", q.float(), k.float()) \
        * (1.0 / math.sqrt(hd))
    if causal:
        pos = torch.arange(S, device=q.device)
        keep = pos[:, None] >= pos[None, :]
        s = torch.where(keep[None, None, :, None, :], s, NEG_INF)
    return torch.logsumexp(s, dim=-1)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor,
                              causal: bool = True):
    """The backward kernel's function in plain PyTorch: (dq, dk, dv) in the
    inputs' dtype from the forward's output `out` and `lse` and the f32
    gradient `dout`. P = exp(s - lse) is recomputed; dv takes P rounded
    to v's dtype, as the forward's P V product does; dk and dv sum over
    the G query heads of their KV head."""
    hd, S = q.shape[-1], q.shape[2]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bhsgd,bhtd->bhsgt", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(S, device=q.device)
        keep = pos[:, None] >= pos[None, :]
        s = torch.where(keep[None, None, :, None, :], s, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dout = dout.float()
    dp = torch.einsum("bhsgd,bhtd->bhsgt", dout, v.float())
    ds = p * (dp - (dout * out).sum(dim=-1, keepdim=True))
    dv = torch.einsum("bhsgt,bhsgd->bhtd", p.to(v.dtype).float(), dout)
    dq = torch.einsum("bhsgt,bhtd->bhsgd", ds, k.float()) * scale
    dk = torch.einsum("bhsgt,bhsgd->bhtd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> None:
    """Raise on q, k, v the kernels do not take."""
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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel on strided views (innermost axis contiguous).
    Returns (B, Hkv, S, G, hd) f32: a view of a buffer laid out
    (B, S, Hkv, G, hd), the order the model reads it back in. With `lse`
    (a contiguous (B, Hkv, S, G) f32 buffer) the kernel also writes each
    row's log-sum-exp there. Raises on anything the kernel does not take;
    in bfloat16 that includes a q, k or v whose start or strides are not
    16-byte aligned (the tensor-core route copies 16-byte pieces of rows),
    which the model's views never are, and on an input that requires a
    gradient while grad mode is on: this launch keeps nothing for a
    backward, and would drop the gradient without a word (call
    `FlashAttention.apply`, as `ops` does). The kernel is the one
    `flash_route` picks."""
    return _flash_launch(flash_route(q.dtype, q.shape[-1]), q, k, v, causal,
                         lse)


def _flash_launch(route: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, causal: bool = True,
                  lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`flash_attention_cuda` by the kernel `route` of ROUTES. Tests and
    scripts/torch_attention_routes.py hold and time each route through it
    (a bfloat16 call at hd <= 64 may take "tc128"); a route that does not
    take the call raises."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention_cuda has no backward of its own: "
                           "differentiate through FlashAttention.apply")
    _check(q, k, v, causal)
    dev = q.device
    B, Hkv, S, G, hd = q.shape
    Sk = k.shape[2]
    if q.dtype == torch.bfloat16:
        for t, name in ((q, "q"), (k, "k"), (v, "v")):
            require_aligned(t, name)
    if lse is not None:
        require(lse, "lse", torch.float32, 4, dev)
        if tuple(lse.shape) != (B, Hkv, S, G):
            raise ValueError(f"lse {tuple(lse.shape)} must be "
                             f"{(B, Hkv, S, G)}")
    if route not in ROUTES or (route == "f32") != (q.dtype == torch.float32) \
            or (route == "tc64" and hd > 64):
        raise ValueError(f"route {route!r} does not take {q.dtype} at head "
                         f"dim {hd}")
    out = torch.empty((B, S, Hkv, G, hd), dtype=torch.float32,
                      device=dev).permute(0, 2, 1, 3, 4)
    launch("repro_flash_attention", dev, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(),
           None if lse is None else lse.data_ptr(), B, Hkv, S, Sk, G, hd,
           *(q.stride(i) for i in range(4)),
           *(k.stride(i) for i in range(3)),
           *(v.stride(i) for i in range(3)),
           *(out.stride(i) for i in range(4)),
           int(bool(causal)), 1.0 / math.sqrt(hd), ROUTES[route])
    count_launch(flash_attention_cuda)
    return out


flash_attention_cuda.launches = 0


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             causal: bool = True):
    """Launch the backward kernel (`csrc/flash_attention_bwd.cu`: the row
    dots D = dO . o, then dk/dv a key tile a block, then dq a query tile a
    block; no atomics, so the result is the same bits every run):
    (dq, dk, dv) in the inputs' dtype, laid out as q, k and v are. `out`
    and `lse` are the forward's; `dout` is f32 with `out`'s shape. Raises
    on anything the kernel does not take; in bfloat16 (the tensor-core
    route) that includes a q, k or v whose start or strides are not
    16-byte aligned, as in the forward."""
    _check(q, k, v, causal)
    dev = q.device
    B, Hkv, S, G, hd = q.shape
    Sk = k.shape[2]
    if q.dtype == torch.bfloat16:
        for t, name in ((q, "q"), (k, "k"), (v, "v")):
            require_aligned(t, name)
    require_rows(out, "out", torch.float32, 5, dev)
    require_rows(dout, "dout", torch.float32, 5, dev)
    require(lse, "lse", torch.float32, 4, dev)
    if out.shape != q.shape or dout.shape != q.shape or \
            tuple(lse.shape) != (B, Hkv, S, G):
        raise ValueError(f"out {tuple(out.shape)}, dout {tuple(dout.shape)} "
                         f"and lse {tuple(lse.shape)} do not match q "
                         f"{tuple(q.shape)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B, Hkv, S, G), dtype=torch.float32, device=dev)
    dob = None  # the tensor-core route's scratch: dO rounded to bf16
    if q.dtype == torch.bfloat16:
        dob = torch.empty((B, Hkv, S * G, (hd + 7) // 8 * 8),
                          dtype=torch.bfloat16, device=dev)
    strides = [t.stride(i) for t, n in ((q, 4), (k, 3), (v, 3), (out, 4),
                                        (dout, 4), (dq, 4), (dk, 3), (dv, 3))
               for i in range(n)]
    launch("repro_flash_attention_bwd", dev, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
           delta.data_ptr(), None if dob is None else dob.data_ptr(),
           dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
           B, Hkv, S, Sk, G, hd, (ctypes.c_longlong * 28)(*strides),
           int(bool(causal)), 1.0 / math.sqrt(hd), _DTYPES[q.dtype])
    count_launch(flash_attention_bwd_cuda)
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


class FlashAttention(torch.autograd.Function):
    """Kernel 6 on the card with its backward kernel: `apply(q, k, v,
    causal)` -> (B, Hkv, S, G, hd) f32. The log-sum-exp is written, and
    the inputs and output kept, only when a gradient will be asked for
    (grad mode on and an input requiring one); otherwise this is one
    forward launch and nothing is kept."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, needs_grad: bool = False):
        if not needs_grad:
            return flash_attention_cuda(q, k, v, causal)
        B, Hkv, S, G, _ = q.shape
        lse = torch.empty((B, Hkv, S, G), dtype=torch.float32,
                          device=q.device)
        out = flash_attention_cuda(q, k, v, causal, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse,
                                              dout.float(), ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_card(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """`FlashAttention.apply`, told whether a gradient will be taken."""
    needs = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return FlashAttention.apply(q, k, v, causal, needs)


class CountedAttention(torch.autograd.Function):
    """Kernel 6 and its backward where a recording counts them
    (`distributed.hlo_counters`): each pass records its kernel's cost
    (`kernels/cost.py`: the forward writes the log-sum-exp where a
    gradient will be taken, as on the card) and counts nothing of what
    computes it. On tensors without data (`shape_only`) the outputs are
    empty tensors laid out as the card's kernels write them; on CPU
    tensors the plain versions compute them."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, needs_grad: bool,
                shape_only: bool):
        from repro_torch.distributed.hlo_counters import kernel_call

        B, Hkv, S, G, hd = q.shape
        c = cost.flash_attention(B, Hkv, G, hd, S, k.shape[2], causal,
                                 q.element_size(), lse=needs_grad)
        with kernel_call("flash_attention", lambda: c, True):
            # laid out as the card's kernel writes it
            out = torch.empty((B, S, Hkv, G, hd), dtype=torch.float32,
                              device=q.device).permute(0, 2, 1, 3, 4)
            lse = torch.empty((B, Hkv, S, G), dtype=torch.float32,
                              device=q.device) if needs_grad else None
            if not shape_only:
                out.copy_(flash_attention_plain(q, k, v, causal))
                if needs_grad:
                    lse.copy_(attention_lse_plain(q, k, causal))
        if needs_grad:
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.causal, ctx.shape_only = causal, shape_only
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.distributed.hlo_counters import kernel_call

        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dout = dout.float()
        B, Hkv, S, G, hd = q.shape
        c = cost.flash_attention_bwd(B, Hkv, G, hd, S, k.shape[2],
                                     ctx.causal, q.element_size())
        with kernel_call("flash_attention_bwd", lambda: c, True):
            # laid out as q, k and v, as the card's kernel writes them
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            if ctx.shape_only:
                # the card's scratch: the row dots D, and dO in bf16
                scratch = [torch.empty((B, Hkv, S, G), dtype=torch.float32,
                                       device=q.device)]
                if q.dtype == torch.bfloat16:
                    scratch.append(torch.empty(
                        (B, Hkv, S * G, (hd + 7) // 8 * 8),
                        dtype=torch.bfloat16, device=q.device))
                del scratch
            else:
                for t, g in zip((dq, dk, dv), flash_attention_bwd_plain(
                        q, k, v, out, lse, dout, ctx.causal)):
                    t.copy_(g)
        return dq, dk, dv, None, None, None


def counted_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, shape_only: bool) -> torch.Tensor:
    """`CountedAttention.apply`, told whether a gradient will be taken."""
    needs = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return CountedAttention.apply(q, k, v, causal, needs, shape_only)
