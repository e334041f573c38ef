"""Model configurations: the NeRF field's (`ngp`) and the LM registry.

`get_arch(<id>)` returns an `ArchSpec` with the exact published config
of each of the reference's ten architectures; an id nobody has raises
`KeyError`.
"""
import importlib
from typing import Dict, List

from repro_torch.configs.base import (
    SHAPES,
    ArchSpec,
    ShapeSpec,
    decode_input_specs,
    prefill_input_specs,
    train_input_specs,
)

_MODULES = {
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "granite-34b": "repro_torch.configs.granite_34b",
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
}

ARCH_IDS: List[str] = list(_MODULES)
_CACHE: Dict[str, ArchSpec] = {}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    if arch_id not in _CACHE:
        _CACHE[arch_id] = importlib.import_module(_MODULES[arch_id]).spec()
    return _CACHE[arch_id]


def all_cells():
    """Every (arch, shape) pair, with assignment-recorded skips excluded."""
    for aid in ARCH_IDS:
        spec = get_arch(aid)
        for shape in SHAPES.values():
            if spec.runs(shape.name):
                yield spec, shape


__all__ = ["SHAPES", "ArchSpec", "ShapeSpec", "ARCH_IDS", "get_arch",
           "all_cells", "train_input_specs", "prefill_input_specs",
           "decode_input_specs"]
