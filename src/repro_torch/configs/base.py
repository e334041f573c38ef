"""Config substrate: the shape grid and `ArchSpec`.

The counterpart of `repro/configs/base.py` without the dry-run's input
specs (they describe JAX shapes for XLA's compiler). Every architecture
file exports `spec() -> ArchSpec` with the exact published config plus a
reduced `smoke` config of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

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
