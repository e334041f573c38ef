"""Step functions for serving: prefill and decode.

The counterpart of the serve half of `repro/launch/steps.py`. The
reference's steps are pure functions that `jit` compiles and shards; the
port's run eagerly on one card, and the decode step updates its cache in
place (the counterpart of the reference's donated cache buffer).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.models import lm
from repro_torch.models.common import ModelConfig


def make_prefill_step(cfg: ModelConfig, max_seq: int) -> Callable:
    def prefill_step(params, batch):
        return lm.prefill(params, batch, cfg, max_seq)

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    def decode_step(params, cache, tokens, pos):
        return lm.decode_step(params, cache, tokens, pos, cfg)

    return decode_step
