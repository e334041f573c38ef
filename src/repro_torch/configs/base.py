"""Config substrate: the shape grid, `ArchSpec` and the input specs.

The counterpart of `repro/configs/base.py`. Every architecture file
exports `spec() -> ArchSpec` with the exact published config plus a
reduced `smoke` config of the same family. The input specs are tensors
on the `meta` device (shape and dtype, no storage), the counterparts of
the reference's `jax.ShapeDtypeStruct`s.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    model: ModelConfig
    smoke: ModelConfig
    # Training microbatch (global sequences per accumulation step), per shape.
    microbatch: Mapping[str, int] = dataclasses.field(
        default_factory=lambda: {"train_4k": 32}
    )
    moment_dtype: str = "float32"  # adam moments; "int8" = 8-bit Adam
    # shape name -> reason, for assignment-recorded skips
    skips: Mapping[str, str] = dataclasses.field(default_factory=dict)
    source: str = ""
    # Small models: disable tensor parallelism (replicate weights, pure DP)
    no_tp: bool = False

    def runs(self, shape: str) -> bool:
        return shape not in self.skips


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _frontend_extras(model: ModelConfig, batch: int, seq: int
                     ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Modality-stub inputs + number of text tokens."""
    extras: Dict[str, torch.Tensor] = {}
    text = seq
    if model.embed_frontend == "prefix_patches":
        p = model.n_prefix_patches
        extras["patches"] = _spec((batch, p, model.d_model),
                                  model.param_dtype)
        text = seq - p
    elif model.embed_frontend == "stub_frames":
        extras["frames"] = _spec((batch, model.max_source_len, model.d_model),
                                 model.param_dtype)
    return extras, text


def train_input_specs(model: ModelConfig, shape: ShapeSpec,
                      microbatch: Optional[int] = None
                      ) -> Dict[str, torch.Tensor]:
    """One accumulation microbatch (the train step loops over these)."""
    b = microbatch or shape.global_batch
    extras, text = _frontend_extras(model, b, shape.seq_len)
    return {"tokens": _spec((b, text), torch.int32), **extras}


def prefill_input_specs(model: ModelConfig, shape: ShapeSpec
                        ) -> Dict[str, torch.Tensor]:
    b = shape.global_batch
    extras, text = _frontend_extras(model, b, shape.seq_len)
    return {"tokens": _spec((b, text), torch.int32), **extras}


def decode_input_specs(model: ModelConfig, shape: ShapeSpec
                       ) -> Dict[str, torch.Tensor]:
    """(tokens, pos) for decode_step; the cache comes from the model."""
    return {"tokens": _spec((shape.global_batch, 1), torch.int32),
            "pos": _spec((), torch.int32)}
