"""nemotron-4-340b [dense] — GQA, squared-ReLU FFN. [arXiv:2402.16819;
unverified]. The non-negative relu^2 activations are exactly the asymmetric
activation-quant case (Eqs. 6-7)."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

_SKIP_LONG = "long_500k skipped: pure full-attention arch (assignment rule)"


def spec() -> ArchSpec:
    model = ModelConfig(
        name="nemotron-4-340b",
        n_layers=96,
        d_model=18432,
        n_heads=96,
        n_kv_heads=8,
        d_ff=73728,
        vocab_size=256_000,
        ffn_type="relu2",
        norm_type="layernorm",
    )
    smoke = ModelConfig(
        name="nemotron-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        ffn_type="relu2",
        norm_type="layernorm",
        dtype="float32",
        n_embed_bands=4,
    )
    return ArchSpec(
        arch_id="nemotron-4-340b",
        model=model,
        smoke=smoke,
        microbatch={"train_4k": 16},
        moment_dtype="int8",
        skips={"long_500k": _SKIP_LONG},
        source="arXiv:2402.16819",
    )
