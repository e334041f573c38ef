"""Mamba selective-state-space block (Jamba's SSM mixer).

The counterpart of `repro/models/ssm.py`, in plain PyTorch (the
reference has no kernel here). The sequence is cut into chunks of Q
positions: within a chunk, a log-step (Hillis-Steele) scan combines the
(exp(delta A), delta B x) pairs of every position with those of the
positions before it in log2(Q) steps of whole-tensor ops, and the
(B, d_inner, d_state) state at the chunk's start is then applied to
every position at once, as the reference applies it after its
`associative_scan`. Only the boundary state crosses chunks, so the
(B, Q, d_inner, d_state) tensors exist for one chunk at a time. The scan
combines in another order than `jax.lax.associative_scan`, so results
agree to float32 rounding, not bit for bit.

The chunks run through `hlo_counters.counted_loop`: as they are, but
under a recording with trip counts by a stand-in that counts two and
three chunks.

Decode is the plain recurrence on (conv window, SSM state): O(1) a
token.

Placed training splits the block over `model` by its inner channels
(`ssm_forward`'s `placement`): each rank runs the conv, the scan and D on
its d_inner / tp channels, as GSPMD splits the reference's by the same
specs.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.hlo_counters import counted_loop
from repro_torch.models.common import ModelConfig, dense_init


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return d_inner, dt_rank, cfg.ssm_state


def ssm_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple]:
    d = cfg.d_model
    din, r, n = ssm_dims(cfg)
    return {
        "in_proj": (d, 2 * din),  # -> (x, z)
        "conv_w": (cfg.ssm_conv, din),  # depthwise causal conv
        "conv_b": (din,),
        "x_proj": (din, r + 2 * n),  # -> (dt, B, C)
        "dt_proj_w": (r, din),
        "dt_proj_b": (din,),
        "A_log": (din, n),
        "D": (din,),
        "out_proj": (din, d),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) without a threshold (`jax.nn.softplus`)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_ssm(generator: torch.Generator, cfg: ModelConfig) -> Dict:
    """Weights from `generator` on its device: the reference's
    distributions (dt log-uniform in [1e-3, 1e-1] behind an inverse
    softplus bias, A_log = log(1..n), D = 1)."""
    dev = generator.device
    d = cfg.d_model
    din, r, n = ssm_dims(cfg)
    f32 = torch.float32
    u = torch.rand((din,), generator=generator, device=dev, dtype=f32)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    dt = torch.clamp(dt, min=1e-4)
    # Inverse softplus so softplus(dt_proj_b) == dt at init.
    dt_b = dt + torch.log(-torch.expm1(-dt))
    conv_w = torch.randn((cfg.ssm_conv, din), generator=generator,
                         device=dev, dtype=f32) / math.sqrt(cfg.ssm_conv)
    A = torch.arange(1, n + 1, dtype=f32, device=dev).expand(din, n)
    return {
        "in_proj": dense_init(generator, d, 2 * din, cfg.param_dtype),
        "conv_w": conv_w.to(cfg.param_dtype),
        "conv_b": torch.zeros((din,), dtype=cfg.param_dtype, device=dev),
        "x_proj": dense_init(generator, din, r + 2 * n, cfg.param_dtype),
        "dt_proj_w": dense_init(generator, r, din, f32, scale=r ** -0.5),
        "dt_proj_b": dt_b,
        "A_log": torch.log(A).contiguous(),
        "D": torch.ones((din,), dtype=f32, device=dev),
        "out_proj": dense_init(generator, din, d, cfg.param_dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over S. x: (B, S, din); w: (K, din). The K
    shifted products are added in the reference's order."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + pad[:, i:i + S, :] * w[K - 1 - i]
    return out + b


def _scan_chunk(a: torch.Tensor, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along axis 1 of the pairs (a_t, x_t) under
    (a1, x1) then (a2, x2) = (a1 a2, a2 x1 + x2): log2(Q) steps, each
    combining every position with the one `step` places before it."""
    Q, step = a.shape[1], 1
    while step < Q:
        a_prev, x_prev = a[:, :-step], x[:, :-step]
        a_cur, x_cur = a[:, step:], x[:, step:]
        x = torch.cat([x[:, :step], a_cur * x_prev + x_cur], dim=1)
        a = torch.cat([a[:, :step], a_prev * a_cur], dim=1)
        step *= 2
    return a, x


def _selective_scan_chunked(
    delta: torch.Tensor,  # (B, S, din) f32
    A: torch.Tensor,  # (din, n) f32
    Bc: torch.Tensor,  # (B, S, n)
    Cc: torch.Tensor,  # (B, S, n)
    xs: torch.Tensor,  # (B, S, din)
    h0: torch.Tensor,  # (B, din, n) f32
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """y_t = C_t . h_t with h_t = exp(delta_t A) h_{t-1} + delta_t B_t x_t.
    Returns (y (B, S, din) f32, h_S)."""
    S = delta.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"S={S} is not a whole number of chunks of {chunk}")
    return counted_loop(lambda n, *t: _scan_chunks(n, chunk, *t), S // chunk,
                        delta, A, Bc, Cc, xs, h0)


def _scan_chunks(n: int, chunk: int, delta, A, Bc, Cc, xs, h0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan over the first n chunks: (y (B, n chunk, din) f32, the
    state after them)."""
    h, ys = h0, []
    for c0 in range(0, n * chunk, chunk):
        d = delta[:, c0:c0 + chunk]
        bc = Bc[:, c0:c0 + chunk].float()
        cc = Cc[:, c0:c0 + chunk].float()
        x = xs[:, c0:c0 + chunk].float()
        cA = torch.exp(d[..., None] * A)  # (B, chunk, din, n)
        cBx = d[..., None] * bc[:, :, None, :] * x[..., None]
        accA, accX = _scan_chunk(cA, cBx)
        hs = accA * h[:, None] + accX
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, cc))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


# Each leaf's (axis of channels, runs along it) under a split over
# `model`: `in_proj`'s columns are x's channels, then z's.
_CHANNELS = {"in_proj": (1, 2), "conv_w": (1, 1), "conv_b": (0, 1),
             "x_proj": (0, 1), "dt_proj_w": (1, 1), "dt_proj_b": (0, 1),
             "A_log": (0, 1), "D": (0, 1), "out_proj": (0, 1)}


def _own_channels(params: Dict, cfg: ModelConfig, placement
                  ) -> Optional[Dict]:
    """This rank's leaves where `model` divides d_inner (at one `model`
    rank, every channel), else None. Rank r holds channels
    [r din/tp, (r+1) din/tp): of `in_proj`, those columns of the x half
    and of the z half (`Placement.own`)."""
    din = ssm_dims(cfg)[0]
    if placement is None or din % placement.tp:
        return None
    return {name: placement.own(w, dim, runs * din, runs)
            for name, w in params.items()
            for dim, runs in (_CHANNELS[name],)}


def ssm_forward(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                chunk: int = 128, return_state: bool = False,
                placement=None):
    """Training/prefill pass. x: (B, S, d) -> (B, S, d); with
    `return_state`, also the decode cache at position S (the conv window
    of raw post-in_proj inputs and the final SSM state). Under a
    `placement` whose `model` axis divides d_inner, this rank's channels
    (`_own_channels`) between Megatron's two operators: the conv, the
    scan and D run on them, and x_proj's product, a part of (dt, B, C)
    over the channels, is summed over `model` first."""
    own = _own_channels(params, cfg, placement)
    if own is not None:
        params = own
    if placement is not None:
        x = placement.enter(x, own is not None)
    B, S, d = x.shape
    _, r, n = ssm_dims(cfg)
    din = params["conv_w"].shape[1]
    xz = x @ params["in_proj"]
    xs_raw, z = xz[..., :din], xz[..., din:]
    xs = F.silu(_causal_conv(xs_raw, params["conv_w"], params["conv_b"]))

    dbc = xs @ params["x_proj"]
    if own is not None:
        dbc = placement.sum_over_model(dbc)
    dt_in, Bc, Cc = dbc[..., :r], dbc[..., r:r + n], dbc[..., r + n:]
    delta = _softplus(dt_in.float() @ params["dt_proj_w"]
                      + params["dt_proj_b"])  # (B, S, din) f32
    A = -torch.exp(params["A_log"])  # (din, n)
    if S % chunk != 0:
        chunk = S  # small/smoke sequences: single chunk
    h0 = torch.zeros((B, din, n), dtype=torch.float32, device=x.device)
    y, hN = _selective_scan_chunked(delta, A, Bc, Cc, xs, h0, chunk)
    y = y + params["D"] * xs.float()
    y = y.to(x.dtype) * F.silu(z)
    out = y @ params["out_proj"]
    if placement is not None:
        out = placement.leave(out, own is not None)
    if return_state:
        K = cfg.ssm_conv
        window = F.pad(xs_raw, (0, 0, K - 1, 0))[:, S:, :]
        return out, {"conv": window.to(cfg.param_dtype), "ssm": hN}
    return out


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def init_ssm_cache(cfg: ModelConfig, batch: int, device: torch.device,
                   dtype=None) -> Dict:
    din, _, n = ssm_dims(cfg)
    dtype = dtype or cfg.param_dtype
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, din), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, din, n), dtype=torch.float32,
                           device=device),
    }


def ssm_decode_step(params: Dict, x: torch.Tensor, cache: Dict,
                    cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d). O(1) recurrent update: (out (B, 1, d), new cache)."""
    din, r, n = ssm_dims(cfg)
    xz = x[:, 0] @ params["in_proj"]
    xs, z = xz[..., :din], xz[..., din:]

    # Conv over the rolling window [cache, x]. window[K-1] is the CURRENT
    # token; _causal_conv puts conv_w[0] on the current token (w[j] pairs
    # with x[t-j]), so the kernel is applied time-reversed here.
    window = torch.cat([cache["conv"], xs[:, None, :]], dim=1)  # (B, K, din)
    conv = torch.einsum("bkd,kd->bd", window,
                        torch.flip(params["conv_w"], dims=(0,))) \
        + params["conv_b"]
    xs = F.silu(conv)
    new_conv = window[:, 1:]

    dbc = xs @ params["x_proj"]
    dt_in, Bc, Cc = dbc[..., :r], dbc[..., r:r + n], dbc[..., r + n:]
    delta = _softplus(dt_in.float() @ params["dt_proj_w"]
                      + params["dt_proj_b"])  # (B, din)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(delta[..., None] * A)  # (B, din, n)
    dBx = delta[..., None] * Bc[:, None, :].float() * xs[..., None].float()
    h = dA * cache["ssm"] + dBx
    y = torch.einsum("bdn,bn->bd", h, Cc.float())
    y = y + params["D"] * xs.float()
    y = y.to(x.dtype) * F.silu(z)
    out = (y @ params["out_proj"])[:, None, :]
    return out, {"conv": new_conv, "ssm": h}
