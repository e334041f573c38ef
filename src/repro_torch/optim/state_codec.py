"""Optimizer-state codecs: f32 / bf16 / blockwise-int8 Adam moments.

The counterpart of `repro/optim/state_codec.py`. int8 moments ("8-bit
Adam") keep p (bf16) + g (f32 accumulator) + m, v (int8) where f32 moments
would not fit. Encoding: symmetric absmax over the last axis (row-wise
scales), `round(x / a)` with `a = max(absmax / 127, 1e-12)`; `torch.round`
rounds half to even, as `jnp.round` does. The second moment is encoded on
a sqrt scale to compress its dynamic range. Codes keep the parameter's
shape; scales keep the last axis as 1.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree_util import map_with_path


class Quantized(NamedTuple):
    codes: torch.Tensor  # int8, same shape as the logical tensor
    scale: torch.Tensor  # f32, shape[:-1] + (1,)


def _encode(x: torch.Tensor) -> Quantized:
    x = x.to(torch.float32)
    a = torch.amax(torch.abs(x), dim=-1, keepdim=True) / 127.0
    a = torch.clamp_min(a, 1e-12)
    return Quantized(torch.round(x / a).to(torch.int8), a)


def _decode(q: Quantized) -> torch.Tensor:
    return q.codes.to(torch.float32) * q.scale


class MomentCodec:
    """encode/decode one moment leaf. kind in {f32, float32, bf16,
    bfloat16, int8, param}."""

    def __init__(self, kind: str = "param", sqrt_domain: bool = False):
        self.kind = kind
        self.sqrt_domain = sqrt_domain

    def encode(self, x: torch.Tensor, like: torch.Tensor):
        if self.kind == "param":
            return x.to(like.dtype)
        if self.kind in ("f32", "float32"):
            return x.to(torch.float32)
        if self.kind in ("bf16", "bfloat16"):
            return x.to(torch.bfloat16)
        if self.kind == "int8":
            y = torch.sqrt(torch.clamp_min(x, 0.0)) if self.sqrt_domain \
                else x
            return _encode(y)
        raise ValueError(self.kind)

    def decode(self, s) -> torch.Tensor:
        if isinstance(s, Quantized):
            y = _decode(s)
            return torch.square(y) if self.sqrt_domain else y
        return s.to(torch.float32)

    def init(self, p: torch.Tensor):
        return self.encode(torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), p)


def moment_codecs(moment_dtype: str):
    """(mu codec, nu codec). nu uses the sqrt domain under int8."""
    return (
        MomentCodec(moment_dtype, sqrt_domain=False),
        MomentCodec(moment_dtype, sqrt_domain=moment_dtype == "int8"),
    )


def is_quantized(x) -> bool:
    return isinstance(x, Quantized)


def _map(fn, tree: Any, *rest: Any):
    """`fn` over the leaves of `tree`, a `Quantized` counted as one leaf."""
    if isinstance(tree, Quantized):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_encode(codec: MomentCodec, tree: Any, like: Any):
    return map_with_path(lambda _, x, p: codec.encode(x, p), tree, like)


def tree_decode(codec: MomentCodec, tree: Any):
    return _map(codec.decode, tree)
