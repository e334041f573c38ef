"""Data substrate: the deterministic synthetic token pipeline."""
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig

__all__ = ["TokenPipeline", "TokenPipelineConfig"]
