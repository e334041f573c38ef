"""whisper-large-v3 [audio] — enc-dec; conv frontend stubbed (input_specs
provides precomputed (B, 1500, d) frame embeddings). 32 encoder + 32
decoder layers, learned positions. [arXiv:2212.04356; unverified]

Enc-dec (not encoder-only), so decode_32k runs: 32k self-KV decoded tokens
+ static cross-KV from the encoder. long_500k skipped (full attention).
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

_SKIP_LONG = "long_500k skipped: pure full-attention arch (assignment rule)"


def spec() -> ArchSpec:
    model = ModelConfig(
        name="whisper-large-v3",
        n_layers=32,  # decoder
        encoder_layers=32,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab_size=51_866,
        ffn_type="gelu",
        norm_type="layernorm",
        pattern="encdec",
        pos_embed="learned",
        max_pos_embed=32_768,
        max_source_len=1500,
        embed_frontend="stub_frames",
    )
    smoke = ModelConfig(
        name="whisper-smoke",
        n_layers=2,
        encoder_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        ffn_type="gelu",
        norm_type="layernorm",
        pattern="encdec",
        pos_embed="learned",
        max_pos_embed=128,
        max_source_len=24,
        embed_frontend="stub_frames",
        dtype="float32",
        n_embed_bands=4,
    )
    return ArchSpec(
        arch_id="whisper-large-v3",
        model=model,
        smoke=smoke,
        microbatch={"train_4k": 32},
        skips={"long_500k": _SKIP_LONG},
        source="arXiv:2212.04356",
    )
