"""granite-34b [dense] — llama-arch, MQA (kv=1), code. [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

_SKIP_LONG = "long_500k skipped: pure full-attention arch (assignment rule)"


def spec() -> ArchSpec:
    model = ModelConfig(
        name="granite-34b",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24576,
        vocab_size=49_152,
        ffn_type="swiglu",
    )
    smoke = ModelConfig(
        name="granite-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=512,
        ffn_type="swiglu",
        dtype="float32",
        n_embed_bands=4,
    )
    return ArchSpec(
        arch_id="granite-34b",
        model=model,
        smoke=smoke,
        microbatch={"train_4k": 32},
        skips={"long_500k": _SKIP_LONG},
        source="arXiv:2405.04324",
    )
