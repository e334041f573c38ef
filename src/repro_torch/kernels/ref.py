"""The plain PyTorch versions of the port's kernels under the reference's
`*_ref` names (`repro.kernels.ref`): the CPU path of `ops`, and what
`chip_smoke.py` holds each CUDA kernel against on the card."""
from repro_torch.kernels.alpha_composite import (
    alpha_composite_plain as alpha_composite_ref,
)
from repro_torch.kernels.decode_attention_kernel import (
    decode_attention_plain as decode_attention_ref,
)
from repro_torch.kernels.flash_attention_kernel import (
    flash_attention_plain as flash_attention_ref,
)
from repro_torch.kernels.hash_encoding_kernel import (
    hash_gather_plain as hash_gather_ref,
)
from repro_torch.kernels.quant_matmul import (
    quant_matmul_packed_plain as quant_matmul_packed_ref,
    quant_matmul_plain as quant_matmul_ref,
)
from repro_torch.kernels.ray_march import ray_march_plain as ray_march_ref

__all__ = [
    "alpha_composite_ref",
    "decode_attention_ref",
    "flash_attention_ref",
    "hash_gather_ref",
    "quant_matmul_packed_ref",
    "quant_matmul_ref",
    "ray_march_ref",
]
