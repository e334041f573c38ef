"""Direct-mapped cache simulation.

NeuRex's grid cache is direct mapped (paper Sec. III-F: "the same
direct-mapped cache configuration for grid cache in NeuRex"). A direct-mapped
cache has the convenient property that an access hits iff the *previous
access to the same set* carried the same tag. That turns the inherently
sequential cache walk into a vectorized computation:

  1. stable-sort accesses by set (ties keep time order),
  2. within each equal-set run, hit[i] = (tag[i] == tag[i-1]),
  3. unsort.

This is exact (bit-identical hit/miss sequence to a sequential simulation).
`simulate_direct_mapped` runs it in numpy on the host; `direct_mapped_stats`
is the same algorithm in torch on the addresses' device, batched over any
leading axes (one address stream per candidate quantization policy), which
is what the batched NeuRex simulator runs on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass
class CacheStats:
    accesses: int
    hits: int
    misses: int
    cold_misses: int

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.accesses, 1)


def simulate_direct_mapped(
    addresses: np.ndarray, n_lines: int, line_bytes: int
) -> CacheStats:
    """Exact direct-mapped hit/miss accounting for a byte-address trace."""
    addresses = np.asarray(addresses, np.int64).ravel()
    n = addresses.size
    if n == 0:
        return CacheStats(0, 0, 0, 0)
    lines = addresses // line_bytes
    sets = lines % n_lines
    tags = lines // n_lines

    order = np.argsort(sets, kind="stable")
    s_sorted = sets[order]
    t_sorted = tags[order]

    same_set = np.empty(n, bool)
    same_set[0] = False
    same_set[1:] = s_sorted[1:] == s_sorted[:-1]
    same_tag = np.empty(n, bool)
    same_tag[0] = False
    same_tag[1:] = t_sorted[1:] == t_sorted[:-1]
    hit_sorted = same_set & same_tag

    hits = int(hit_sorted.sum())
    # Cold misses = first touch of each line.
    cold = int(np.unique(lines).size)
    return CacheStats(accesses=n, hits=hits, misses=n - hits, cold_misses=cold)


def direct_mapped_stats(
    addresses: torch.Tensor, n_lines: int, line_bytes: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """torch form of `simulate_direct_mapped` (the same sort-based
    algorithm), on the addresses' device.

    addresses: (..., N) integer byte addresses in access order, N > 0; the
    leading axes are independent streams. Returns (hits, misses,
    cold_misses) as int64 tensors of the leading shape.

    The access time is fused into the sort key (``set * N + t``: unique,
    so the sort needs no stability), all in int64, which holds the key of
    any stream a simulation can build. After sorting by (set, time), an
    access hits iff its line equals the previous line in the same set
    (same set + same tag <=> same line).
    """
    addresses = addresses.to(torch.int64)
    n = addresses.shape[-1]
    lines = addresses // line_bytes
    sets = lines % n_lines
    t = torch.arange(n, dtype=torch.int64, device=addresses.device)
    keys = torch.sort(sets * n + t, dim=-1).values
    ls = torch.gather(lines, -1, keys % n)
    hit = (keys[..., 1:] // n == keys[..., :-1] // n) \
        & (ls[..., 1:] == ls[..., :-1])
    hits = hit.sum(dim=-1)

    lines_sorted = torch.sort(lines, dim=-1).values
    cold = (lines_sorted[..., 1:] != lines_sorted[..., :-1]).sum(dim=-1) + 1
    return hits, n - hits, cold


class DirectMappedCache:
    """Stateful sequential reference implementation (oracle for tests)."""

    def __init__(self, n_lines: int, line_bytes: int):
        self.n_lines = n_lines
        self.line_bytes = line_bytes
        self.tags = np.full(n_lines, -1, np.int64)
        self.hits = 0
        self.accesses = 0

    def access(self, address: int) -> bool:
        self.accesses += 1
        line = address // self.line_bytes
        s = line % self.n_lines
        t = line // self.n_lines
        if self.tags[s] == t:
            self.hits += 1
            return True
        self.tags[s] = t
        return False

    def run(self, addresses) -> CacheStats:
        addresses = np.asarray(addresses, np.int64).ravel()
        lines = addresses // self.line_bytes
        cold = int(np.unique(lines).size)
        for a in addresses:
            self.access(int(a))
        return CacheStats(
            accesses=self.accesses,
            hits=self.hits,
            misses=self.accesses - self.hits,
            cold_misses=cold,
        )
