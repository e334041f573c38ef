"""llama3-405b [dense] — GQA, 128k vocab. [arXiv:2407.21783; unverified]"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

_SKIP_LONG = "long_500k skipped: pure full-attention arch (assignment rule)"


def spec() -> ArchSpec:
    model = ModelConfig(
        name="llama3-405b",
        n_layers=126,
        d_model=16384,
        n_heads=128,
        n_kv_heads=8,
        d_ff=53248,
        vocab_size=128_256,
        ffn_type="swiglu",
        rope_theta=500_000.0,
    )
    smoke = ModelConfig(
        name="llama3-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        ffn_type="swiglu",
        dtype="float32",
        n_embed_bands=4,
    )
    return ArchSpec(
        arch_id="llama3-405b",
        model=model,
        smoke=smoke,
        microbatch={"train_4k": 16},
        moment_dtype="int8",
        skips={"long_500k": _SKIP_LONG},
        source="arXiv:2407.21783",
    )
