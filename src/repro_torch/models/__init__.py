"""The LM stack (attention blocks with dense or mixture-of-experts FFNs):
common blocks, attention, FFN and MoE, and `lm`'s init, quantized
forward and loss, prefill and decode.

The reference's `param_specs` and `cache_specs` (abstract shape trees)
are not ported yet (ROADMAP item 10)."""
from repro_torch.models.common import ModelConfig, MoEConfig, ACT_FNS
from repro_torch.models.lm import (
    init_params,
    loss_fn,
    forward,
    prefill,
    decode_step,
    init_cache,
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
]
