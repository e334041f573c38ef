"""xlstm-350m [ssm] — alternating mLSTM/sLSTM blocks, no separate FFN
(d_ff=0). Constant-size recurrent state -> long_500k runs.
[arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig


def spec() -> ArchSpec:
    model = ModelConfig(
        name="xlstm-350m",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50_304,
        pattern="xlstm",
    )
    smoke = ModelConfig(
        name="xlstm-smoke",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=512,
        pattern="xlstm",
        dtype="float32",
        n_embed_bands=4,
    )
    return ArchSpec(
        arch_id="xlstm-350m",
        model=model,
        smoke=smoke,
        microbatch={"train_4k": 64},
        source="arXiv:2405.04517",
        # no_tp=True (pure DP, replicated weights) was measured and REFUTED
        # for this arch: it cuts prefill collectives 84x but the idle model
        # axis duplicates compute 16x, so train regresses 10.6s -> 31s and
        # prefill 54s -> 91s (EXPERIMENTS.md §Perf hillclimb 3). Keep TP.
        no_tp=False,
    )
