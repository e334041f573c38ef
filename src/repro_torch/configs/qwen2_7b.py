"""qwen2-7b [dense] — GQA, QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

_SKIP_LONG = "long_500k skipped: pure full-attention arch (assignment rule)"


def spec() -> ArchSpec:
    model = ModelConfig(
        name="qwen2-7b",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab_size=152_064,
        ffn_type="swiglu",
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )
    smoke = ModelConfig(
        name="qwen2-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        ffn_type="swiglu",
        qkv_bias=True,
        dtype="float32",
        n_embed_bands=4,
    )
    return ArchSpec(
        arch_id="qwen2-7b",
        model=model,
        smoke=smoke,
        microbatch={"train_4k": 64},
        skips={"long_500k": _SKIP_LONG},
        source="arXiv:2407.10671",
    )
