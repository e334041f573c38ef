"""The LM stack (attention blocks with dense or mixture-of-experts FFNs):
common blocks, attention, FFN and MoE, and `lm`'s init, quantized
forward and loss, prefill and decode, and the abstract shape trees the
dry-run reads (`param_specs`, `cache_specs`: `meta` tensors)."""
from repro_torch.models.common import ModelConfig, MoEConfig, ACT_FNS
from repro_torch.models.lm import (
    init_params,
    loss_fn,
    forward,
    prefill,
    decode_step,
    init_cache,
    param_specs,
    cache_specs,
)

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "ACT_FNS",
    "init_params",
    "loss_fn",
    "forward",
    "prefill",
    "decode_step",
    "init_cache",
    "param_specs",
    "cache_specs",
]
