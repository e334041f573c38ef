"""arctic-480b [moe] — 128 experts top-2 + dense residual.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig, MoEConfig

_SKIP_LONG = (
    "long_500k skipped: pure full-attention arch (assignment rule)"
)


def spec() -> ArchSpec:
    model = ModelConfig(
        name="arctic-480b",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,
        vocab_size=32_000,
        ffn_type="swiglu",
        pattern="moe",
        moe=MoEConfig(
            n_experts=128, top_k=2, d_ff_expert=4864, dense_residual=True
        ),
    )
    smoke = ModelConfig(
        name="arctic-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=512,
        ffn_type="swiglu",
        pattern="moe",
        dtype="float32",
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96, dense_residual=True),
        n_embed_bands=4,
    )
    return ArchSpec(
        arch_id="arctic-480b",
        model=model,
        smoke=smoke,
        microbatch={"train_4k": 16},
        moment_dtype="int8",  # 8-bit Adam: 480B params on 16 GB/chip HBM
        skips={"long_500k": _SKIP_LONG},
        source="hf:Snowflake/snowflake-arctic-base",
    )
