"""Shared model building blocks and the `ModelConfig` of the LM stack.

The counterpart of `repro/models/common.py`: the same config dataclasses
(`param_dtype` gives a `torch.dtype`), layer kinds, norms, rotary position
embedding and dense init, as plain functions on tensors. `dense_init`
draws from a `torch.Generator`, so it does not give the reference's
numbers; the parity tests carry the reference's weights across instead.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0  # expert hidden dim (0 -> use cfg.d_ff)
    capacity_factor: float = 1.25
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    every_n_layers: int = 1  # MoE on layers where (layer % n == n-1)
    router_dtype: str = "float32"
    # Token groups for EP dispatch: positions-in-expert are computed with a
    # group-LOCAL prefix scan and capacity is per (group, expert).
    dispatch_groups: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads
    # FFN
    ffn_type: str = "swiglu"  # swiglu | geglu | gelu | relu2
    # Attention
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    attn_chunk: int = 512  # flash-style q-chunk for long sequences
    # Block pattern
    pattern: str = "dense"  # dense | moe | jamba | xlstm | encdec
    attn_every: int = 1  # jamba: attention on layers where l % attn_every == 0
    # MoE
    moe: Optional[MoEConfig] = None
    # SSM (jamba mamba blocks)
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    # enc-dec (whisper)
    encoder_layers: int = 0
    max_source_len: int = 0  # encoder positions (learned)
    # positional scheme: "rope" | "learned" (learned needs max_pos_embed)
    pos_embed: str = "rope"
    max_pos_embed: int = 0
    # Modality frontend stub: inputs arrive as precomputed embeddings.
    embed_frontend: str = "tokens"  # tokens | stub_frames | prefix_patches
    n_prefix_patches: int = 0  # llava: patch embeddings prepended
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # numerics / scale knobs
    dtype: str = "bfloat16"
    remat: bool = True
    grad_accum: int = 1
    # Residual-stream spec of the reference's launcher: where its second
    # entry names the tensor-parallel axis, a placed train step runs
    # Megatron sequence parallelism (`distributed.sharding.Placement`).
    act_pspec: Optional[Tuple] = None
    # embedding quant bands (HERO: the hash-level analogue)
    n_embed_bands: int = 8

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head > 0 else self.d_model // self.n_heads

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, dff, v = self.d_model, self.d_ff, self.vocab_size
        hd, nh, nkv = self.head_dim, self.n_heads, self.n_kv_heads
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        glu = self.ffn_type in ("swiglu", "geglu")
        ffn_dense = d * dff * (3 if glu else 2)
        attn = d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d
        for l in range(self.n_layers):
            kind = layer_kind(self, l)
            if kind in ("attn", "enc", "dec"):
                total += attn
                if kind == "dec":
                    total += attn  # cross attention
            elif kind == "mamba":
                din = self.ssm_expand * d
                total += 2 * d * din + din * d  # in/out proj
                total += din * (self.ssm_conv + 2 * self.ssm_state + 2)
            elif kind in ("mlstm", "slstm"):
                total += 4 * d * (nh * hd) + (nh * hd) * d
            # FFN / MoE
            if self.pattern == "xlstm":
                continue  # no separate FFN (d_ff = 0)
            if self.moe is not None and (l % self.moe.every_n_layers == self.moe.every_n_layers - 1):
                dffe = self.moe.d_ff_expert or dff
                total += self.moe.n_experts * d * dffe * (3 if glu else 2)
                total += d * self.moe.n_experts  # router
                if self.moe.dense_residual:
                    total += ffn_dense
            else:
                total += ffn_dense
        return total


def layer_kind(cfg: ModelConfig, layer: int) -> str:
    """What lives at a given depth for each pattern."""
    if cfg.pattern == "jamba":
        return "attn" if layer % cfg.attn_every == cfg.attn_every - 1 else "mamba"
    if cfg.pattern == "xlstm":
        return "mlstm" if layer % 2 == 0 else "slstm"
    if cfg.pattern == "encdec":
        return "enc" if layer < cfg.encoder_layers else "dec"
    return "attn"


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------
ACT_FNS = {
    # jax.nn.gelu defaults to the tanh approximation.
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "relu2": lambda x: torch.square(torch.relu(x)),  # nemotron squared-ReLU
}


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def apply_norm(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm_type == "rmsnorm":
        return rms_norm(x, params["scale_param"], cfg.norm_eps)
    return layer_norm(x, params["scale_param"], params["bias"], cfg.norm_eps)


def norm_init(cfg: ModelConfig, d: int, device: torch.device) -> dict:
    p = {"scale_param": torch.ones((d,), dtype=cfg.param_dtype, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=cfg.param_dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(device: torch.device, head_dim: int,
                   theta: float) -> torch.Tensor:
    """`rope_freqs` in f32 on `device`, copied there once: a copy from
    host memory on every call would stall the card's stream twice a
    layer."""
    return torch.from_numpy(rope_freqs(head_dim, theta).astype(np.float32)) \
        .to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,). Rotates pairs (even, odd).
    On a tensor without data the frequencies are an empty tensor of their
    shape (nothing to cache)."""
    from torch._subclasses.fake_tensor import is_fake

    if is_fake(x):
        freqs = torch.empty((x.shape[-1] // 2,), dtype=torch.float32,
                            device=x.device)
    else:
        freqs = _rope_freqs_on(x.device, x.shape[-1], float(theta))
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # (B, S, d/2)
    cos = torch.cos(angles)[:, :, None, :]  # (B, S, 1, d/2)
    sin = torch.sin(angles)[:, :, None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Parameter init helpers
# ---------------------------------------------------------------------------
def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """N(0, 1) * scale (1/sqrt(d_in) by default), drawn in f32 on the
    generator's device and cast to `dtype`."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return w.mul_(scale).to(dtype)
