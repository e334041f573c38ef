"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE 16e top-2
on every other layer. Runs long_500k: the Mamba state is O(1) and the four
attention layers' 500k KV shards over the model axis (flash-decoding).
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig, MoEConfig


def spec() -> ArchSpec:
    model = ModelConfig(
        name="jamba-v0.1-52b",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=65_536,
        ffn_type="swiglu",
        pattern="jamba",
        attn_every=8,  # 1 attention : 7 mamba
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        moe=MoEConfig(n_experts=16, top_k=2, every_n_layers=2),
    )
    smoke = ModelConfig(
        name="jamba-smoke",
        n_layers=8,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        ffn_type="swiglu",
        pattern="jamba",
        attn_every=4,
        ssm_state=4,
        ssm_conv=4,
        ssm_expand=2,
        dtype="float32",
        moe=MoEConfig(n_experts=4, top_k=2, every_n_layers=2),
        n_embed_bands=4,
    )
    return ArchSpec(
        arch_id="jamba-v0.1-52b",
        model=model,
        smoke=smoke,
        microbatch={"train_4k": 16},
        source="arXiv:2403.19887",
    )
