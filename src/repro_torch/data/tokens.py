"""Deterministic, shardable, exactly-resumable synthetic token pipeline.

The JAX package's `repro/data/tokens.py`, copied: it is numpy only, and a
copy keeps the port free of the JAX package while giving the same tokens
for the same config and step.

Counter-based generation: batch `i` of host `h` is a pure function of
(seed, step=i, host=h) via a Philox-style hash — no RNG state object to
checkpoint, no files to re-seek. Resume = "set step := manifest['data_step']"
(a checkpoint manifest carries it). The same design
is what makes the pipeline elastic: re-sharding to a different host count
re-partitions the counter space without replaying history.

Content: a Zipf unigram mixture with per-sequence "topic" tilt so batches
have non-trivial, deterministic structure (tests assert exact resumability
and cross-host disjointness).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.2
    n_topics: int = 64
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


def _philox_hash(x: np.ndarray) -> np.ndarray:
    """64-bit mix (splitmix64), vectorized."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = x
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(
        0xFFFFFFFFFFFFFFFF
    )
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(
        0xFFFFFFFFFFFFFFFF
    )
    return z ^ (z >> np.uint64(31))


class TokenPipeline:
    def __init__(self, cfg: TokenPipelineConfig, step: int = 0):
        self.cfg = cfg
        self.step = step
        # Zipf CDF over the vocab (hot tokens = low ids, matching the
        # embedding-band quantization prior in DESIGN.md §4).
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        w = ranks ** (-cfg.zipf_alpha)
        self._cdf = np.cumsum(w / w.sum())

    # ------------------------------------------------------------------
    def state(self) -> Dict:
        return {"data_step": self.step, "seed": self.cfg.seed}

    @classmethod
    def from_state(cls, cfg: TokenPipelineConfig, state: Dict) -> "TokenPipeline":
        assert state.get("seed", cfg.seed) == cfg.seed, "seed mismatch on resume"
        return cls(cfg, step=int(state["data_step"]))

    # ------------------------------------------------------------------
    def _uniforms(self, step: int, shape: Tuple[int, ...], salt: int) -> np.ndarray:
        cfg = self.cfg
        n = int(np.prod(shape))
        base = (
            np.uint64(cfg.seed) * np.uint64(0x100000001B3)
            + np.uint64(step) * np.uint64(0x1000193)
            + np.uint64(cfg.host_id) * np.uint64(0x10001)
            + np.uint64(salt) * np.uint64(0x2545F4914F6CDD1D)
        )
        ctr = np.arange(n, dtype=np.uint64) + base
        bits = _philox_hash(ctr)
        return (bits >> np.uint64(11)).astype(np.float64) / float(1 << 53)

    def batch(self, step: Optional[int] = None) -> np.ndarray:
        """(host_batch, seq_len) int32 tokens for the given (or next) step."""
        cfg = self.cfg
        if step is None:
            step = self.step
            self.step += 1
        B, S = cfg.host_batch, cfg.seq_len
        u = self._uniforms(step, (B, S), salt=1).reshape(B, S)
        base_ids = np.searchsorted(self._cdf, u).astype(np.int64)
        # per-sequence topic tilt: rotate a slice of the id space
        topic_u = self._uniforms(step, (B,), salt=2)
        topic = (topic_u * cfg.n_topics).astype(np.int64)
        tilt_mask = self._uniforms(step, (B, S), salt=3).reshape(B, S) < 0.15
        tilted = (base_ids + topic[:, None] * 17) % cfg.vocab_size
        ids = np.where(tilt_mask, tilted, base_ids)
        return np.clip(ids, 0, cfg.vocab_size - 1).astype(np.int32)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.batch()
