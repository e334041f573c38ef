"""qwen3-moe-235b-a22b [moe] — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig, MoEConfig

_SKIP_LONG = (
    "long_500k skipped: pure full-attention arch; 500k dense KV is "
    "infeasible (assignment rule, DESIGN.md §4)"
)


def spec() -> ArchSpec:
    model = ModelConfig(
        name="qwen3-moe-235b-a22b",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        d_ff=1536,
        vocab_size=151_936,
        ffn_type="swiglu",
        pattern="moe",
        rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
    )
    smoke = ModelConfig(
        name="qwen3-moe-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=512,
        ffn_type="swiglu",
        pattern="moe",
        dtype="float32",
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96),
        n_embed_bands=4,
    )
    return ArchSpec(
        arch_id="qwen3-moe-235b-a22b",
        model=model,
        smoke=smoke,
        microbatch={"train_4k": 32},
        skips={"long_500k": _SKIP_LONG},
        source="hf:Qwen/Qwen3-30B-A3B (scaled per assignment)",
    )
