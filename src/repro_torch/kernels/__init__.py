"""Hand-written Hopper kernels, their plain PyTorch versions, and the
device-dispatching entry points (`ops`)."""
from repro_torch.kernels.ops import (
    alpha_composite,
    decode_attention,
    flash_attention,
    hash_gather,
    quant_matmul,
)

__all__ = [
    "alpha_composite",
    "decode_attention",
    "flash_attention",
    "hash_gather",
    "quant_matmul",
]
