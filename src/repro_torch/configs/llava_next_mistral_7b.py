"""llava-next-mistral-7b [vlm] — mistral backbone, anyres tiling stubbed as
precomputed patch embeddings (assignment: frontend is a STUB; input_specs
provides (B, P, d) patch embeddings prepended to the text tokens).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

_SKIP_LONG = "long_500k skipped: pure full-attention arch (assignment rule)"


def spec() -> ArchSpec:
    model = ModelConfig(
        name="llava-next-mistral-7b",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=32_000,
        ffn_type="swiglu",
        rope_theta=1_000_000.0,
        embed_frontend="prefix_patches",
        n_prefix_patches=576,  # one 24x24 anyres base tile
    )
    smoke = ModelConfig(
        name="llava-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        ffn_type="swiglu",
        dtype="float32",
        embed_frontend="prefix_patches",
        n_prefix_patches=8,
        n_embed_bands=4,
    )
    return ArchSpec(
        arch_id="llava-next-mistral-7b",
        model=model,
        smoke=smoke,
        microbatch={"train_4k": 32},
        skips={"long_500k": _SKIP_LONG},
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    )
