"""Vectorized NeuRex simulator: score a (K, n_units) batch of quantization
policies in one call.

The scalar simulator walks one policy at a time through numpy; the RL search
therefore explores the accuracy/latency/size space one point per episode.
This module runs the analytic hot path — address generation, direct-mapped
cache statistics, subgrid prefetch volume, bit-serial systolic cycles, and
the NeuRex latency composition — as torch functions of the bit widths over
a leading K axis. Everything that does not depend on the policy (the trace
geometry, tiling factors, lookup-datapath cycles, subgrid transition count)
is folded into constants at build time.

Exactness notes:
  - Addresses are computed in int64 arithmetic: entry bytes are expressed
    in 1/8-byte units (``eb8 = round(n_features * bits)``), which is exact
    for the integer bit widths the search emits and reproduces the numpy
    path's float64 `floor` bit-for-bit. The cache hit/miss counts are
    therefore *identical* to the sequential oracle, not approximate, for
    any trace (int64 holds every address and sort key a trace can make).
  - Cycle totals are accumulated in f32; relative to the float64 numpy
    reference this introduces O(1e-7) rounding, far inside the 1e-3 parity
    tolerance the tests enforce.
  - `model_bytes` is the shared size function evaluated per policy in
    float64 on the host: exact.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.hwsim.cache import direct_mapped_stats, simulate_direct_mapped
from repro_torch.hwsim.config import HWConfig
from repro_torch.hwsim.systolic import mlp_cycles_torch
from repro_torch.hwsim.trace import NGPTrace
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.quant.packing import policy_model_bytes

# Cache-walk accesses sorted in one device call: (1 << 27) int64 keys are
# 1 GiB a buffer; at the paper trace (2.1 M accesses) 64 streams.
_SORT_ACCESSES = 1 << 27


@dataclasses.dataclass(frozen=True)
class TraceConstants:
    """Policy-independent workload constants extracted from an NGPTrace
    (host numpy arrays)."""

    n_rays: int
    n_points: int
    n_levels: int
    n_coarse: int
    n_features: int
    # (n_coarse, P*8) int32 entry indices in point order (level-major).
    coarse_indices: np.ndarray
    # (n_levels,) int32 entries per level table.
    level_entries: np.ndarray
    # Subgrid transitions over the trace (bit-width independent).
    n_transitions: int
    # (n_fine,) int32 entries prefetched per subgrid per fine level.
    fine_per_sub: np.ndarray
    # Static MLP layer dims [(d_in, d_out), ...].
    mlp_dims: Tuple[Tuple[int, int], ...]
    # Policy-independent encode term (lookup + interpolation datapath).
    lookup_cycles: float


def build_trace_constants(
    trace: NGPTrace,
    cfg: HWConfig,
    n_features: int = 2,
    resolutions: Optional[Sequence[int]] = None,
) -> TraceConstants:
    """Hoist everything bit-width independent out of the simulation."""
    n_levels = len(trace.level_indices)
    n_coarse = min(cfg.coarse_levels, n_levels)
    P = trace.n_points

    if resolutions is None:
        resolutions = [
            max(int(round(e ** (1.0 / 3.0))) - 1, 1) for e in trace.level_entries
        ]

    if n_coarse > 0:
        coarse = np.stack(
            [trace.level_indices[l].astype(np.int32) for l in range(n_coarse)]
        )  # (n_coarse, P*8)
    else:
        coarse = np.zeros((0, P * 8), np.int32)

    transitions = 1 + int(
        np.count_nonzero(trace.subgrid_ids[1:] != trace.subgrid_ids[:-1])
    )
    fine_per_sub = np.asarray(
        [
            min(
                trace.level_entries[l],
                (resolutions[l] // cfg.subgrid_resolution + 1) ** 3,
            )
            for l in range(n_coarse, n_levels)
        ],
        np.int32,
    )

    lookup_cycles = float(
        P * n_levels * 8 / 8 + P * n_levels * cfg.interp_cycles_per_sample_level
    )

    return TraceConstants(
        n_rays=trace.n_rays,
        n_points=P,
        n_levels=n_levels,
        n_coarse=n_coarse,
        n_features=n_features,
        coarse_indices=coarse,
        level_entries=np.asarray(trace.level_entries, np.int32),
        n_transitions=transitions,
        fine_per_sub=fine_per_sub,
        mlp_dims=tuple(tuple(d) for d in trace.mlp_dims),
        lookup_cycles=lookup_cycles,
    )


def _coarse_address_stream(
    eb8: torch.Tensor, coarse: torch.Tensor, tc: TraceConstants,
    cfg: HWConfig,
) -> torch.Tensor:
    """Byte addresses of the coarse-level accesses in true time order.

    eb8: (M, n_coarse) int64 entry bytes scaled by 8 (``round(F * bits)`` —
    exact for integer bit widths); coarse: the trace's (n_coarse, P*8)
    indices on eb8's device. Addresses are ``(idx * eb8) // 8`` which
    equals ``floor(idx * entry_bytes)`` — the numpy reference semantics.
    Returns (M, P * n_coarse * 8) int64.
    """
    M, Lc = eb8.shape
    addr = coarse.to(torch.int64)[None] * eb8[:, :, None] // 8  # (M, Lc, P*8)

    # Level tables laid out back-to-back, line-aligned.
    lb = cfg.cache_line_bytes
    entries = torch.from_numpy(tc.level_entries[:Lc].astype(np.int64)) \
        .to(eb8.device)
    table_bytes = (entries * eb8 + 7) // 8
    table_span = (table_bytes + lb - 1) // lb * lb
    base = torch.cumsum(table_span, dim=1) - table_span  # exclusive
    addr = addr + base[:, :, None]

    # (M, Lc, P, 8) level-major -> (M, P, Lc, 8) time order -> flat.
    return addr.reshape(M, Lc, tc.n_points, 8).permute(0, 2, 1, 3) \
        .reshape(M, -1)


def grid_cache_stats(
    eb8: torch.Tensor, tc: TraceConstants, cfg: HWConfig,
    coarse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hits, misses, cold) int64 of the grid cache for coarse-bit
    assignments, on eb8's device: eb8 (..., n_coarse) -> three tensors of
    the leading shape.

    This is the only policy-dependent term that needs a sort, and it depends
    on nothing but the (n_coarse,) entry-byte vector — the hook the batched
    simulator uses to dedup and memoize across policies. `coarse` is the
    trace's indices already on the device (copied from `tc` otherwise).
    """
    lead = eb8.shape[:-1]
    eb8 = eb8.reshape(-1, tc.n_coarse).to(torch.int64)
    if coarse is None:
        coarse = torch.from_numpy(tc.coarse_indices).to(eb8.device)
    addrs = _coarse_address_stream(eb8, coarse, tc, cfg)
    stats = direct_mapped_stats(addrs, cfg.grid_cache_lines,
                                cfg.cache_line_bytes)
    return tuple(s.reshape(lead) for s in stats)


def grid_cache_stats_host(
    eb8: np.ndarray, tc: TraceConstants, cfg: HWConfig
) -> Tuple[int, int, int]:
    """Host numpy twin of `grid_cache_stats` for one (n_coarse,) entry-byte
    vector (identical integer results)."""
    Lc = tc.n_coarse
    eb8 = np.asarray(eb8, np.int64)
    addr = tc.coarse_indices.astype(np.int64) * eb8[:, None] // 8  # (Lc, P*8)

    lb = cfg.cache_line_bytes
    table_bytes = (tc.level_entries[:Lc].astype(np.int64) * eb8 + 7) // 8
    table_span = (table_bytes + lb - 1) // lb * lb
    base = np.concatenate([[0], np.cumsum(table_span)[:-1]])
    addr = addr + base[:, None]

    addrs = addr.reshape(Lc, tc.n_points, 8).transpose(1, 0, 2).reshape(-1)
    st = simulate_direct_mapped(addrs, cfg.grid_cache_lines, cfg.cache_line_bytes)
    return st.hits, st.misses, st.cold_misses


def policy_latency(
    hash_bits: torch.Tensor,  # (K, n_levels) or (n_levels,) f32
    w_bits: torch.Tensor,  # (K, n_mlp) or (n_mlp,) f32
    a_bits: torch.Tensor,  # (K, n_mlp) or (n_mlp,) f32
    tc: TraceConstants,
    cfg: HWConfig,
    pipeline_overlap: float,
) -> Dict[str, torch.Tensor]:
    """The full NeuRex latency/size model as a pure function of the bit
    tensors, on their device: K policies (or one, without the K axis) ->
    a dict of (K,) metrics (scalars for one). Mirrors NeuRexSimulator's
    numpy reference term-for-term; `BatchedNeuRexSimulator` runs the same
    model but factored so the sort-heavy grid-cache term is
    deduped/memoized, and this fused form is the reference composition."""
    single = hash_bits.dim() == 1
    hb, wb, ab = (x.reshape(-1, x.shape[-1]).to(torch.float32)
                  for x in (hash_bits, w_bits, a_bits))
    K = hb.shape[0]
    if tc.n_coarse > 0:
        eb8 = torch.round(hb[:, : tc.n_coarse] * tc.n_features).to(torch.int64)
        hits, misses, cold = grid_cache_stats(eb8, tc, cfg)
    else:
        hits = misses = cold = torch.zeros(K, dtype=torch.int64,
                                           device=hb.device)
    out = _compose_latency(hb, wb, ab, hits, misses, cold, tc, cfg,
                           pipeline_overlap)
    out["model_bytes"] = torch.from_numpy(_model_bytes(
        hb.cpu().numpy(), wb.cpu().numpy(), tc)).to(hb.device)
    out.update(grid_hits=hits, grid_misses=misses, grid_cold_misses=cold)
    return {k: v[0] for k, v in out.items()} if single else out


def _model_bytes(hb: np.ndarray, wb: np.ndarray, tc: TraceConstants
                 ) -> np.ndarray:
    """(K,) float64 packed model bytes, exact: the shared size function
    over the (K,) columns of the bit arrays."""
    return np.asarray(policy_model_bytes(
        [int(e) for e in tc.level_entries], tc.n_features, tc.mlp_dims,
        hb.T.astype(np.float64), wb.T.astype(np.float64),
    ), np.float64)


def _compose_latency(
    hash_bits: torch.Tensor,
    w_bits: torch.Tensor,
    a_bits: torch.Tensor,
    hits: torch.Tensor,
    misses: torch.Tensor,
    cold: torch.Tensor,
    tc: TraceConstants,
    cfg: HWConfig,
    pipeline_overlap: float,
) -> Dict[str, torch.Tensor]:
    """Everything downstream of the cache statistics — closed-form, no
    sort, in f32 in the reference's order of operations. (K, ·) bit
    tensors and (K,) integer statistics on one device -> (K,) f32 metrics
    (the integer statistics and model bytes are the caller's)."""
    K, dev = hash_bits.shape[0], hash_bits.device
    accesses = torch.full((K,), float(tc.n_points * 8 * tc.n_coarse),
                          dtype=torch.float32, device=dev)
    missf = misses.to(torch.float32)
    miss_bytes = missf * cfg.cache_line_bytes
    grid_miss_cycles = miss_bytes / cfg.bytes_per_cycle + missf * (
        cfg.dram_latency_cycles * (1.0 - cfg.dram_latency_overlap)
    )

    # --- Encoding Engine: subgrid prefetch (fine levels) -------------------
    entry_bytes_fine = hash_bits[:, tc.n_coarse :] * (tc.n_features / 8.0)
    fine_per_sub = torch.from_numpy(tc.fine_per_sub.astype(np.float32)).to(dev)
    per_transition = torch.sum(fine_per_sub * entry_bytes_fine, dim=-1)
    prefetch_bytes = tc.n_transitions * per_transition
    subgrid_prefetch_cycles = (
        prefetch_bytes / cfg.bytes_per_cycle * (1.0 - cfg.dram_latency_overlap)
    )

    encode_cycles = tc.lookup_cycles + grid_miss_cycles + subgrid_prefetch_cycles

    # --- MLP Unit ----------------------------------------------------------
    mlp_total = mlp_cycles_torch(tc.n_points, tc.mlp_dims, w_bits, a_bits, cfg)

    # --- Pipeline composition ---------------------------------------------
    hi = torch.maximum(encode_cycles, mlp_total)
    lo = torch.minimum(encode_cycles, mlp_total)
    total = hi + (1.0 - pipeline_overlap) * lo

    return {
        "lookup_cycles": torch.full((K,), tc.lookup_cycles,
                                    dtype=torch.float32, device=dev),
        "grid_miss_cycles": grid_miss_cycles,
        "subgrid_prefetch_cycles": subgrid_prefetch_cycles,
        "encode_cycles": encode_cycles,
        "mlp_compute_cycles": mlp_total,
        "total_cycles": total,
        "cycles_per_ray": total / max(tc.n_rays, 1),
        "dram_bytes": miss_bytes + prefetch_bytes,
        "grid_accesses": accesses,
        "grid_hit_rate": hits.to(torch.float32) / torch.clamp(accesses,
                                                              min=1.0),
    }


class BatchedNeuRexSimulator:
    """Scores a (K, ·) batch of bit-width policies in one vectorized pass,
    on `device` (the card unless `device="cpu"`).

    Built once per trace. The latency model factors into

      grid-cache stats  — the only sort-heavy term, a function of the
                          coarse-level entry bytes alone (n_coarse small
                          integers, each from 8 possible bit widths);
      everything else   — closed-form in the bit vectors, batched over K.

    `simulate_batch` therefore dedups the coarse-bit combinations within the
    batch, runs the cache simulation only for combos not already in a
    host-side memo (exact — the stats are integers), and composes the
    remaining terms for all K policies in one pass. On the card the missing
    combos go through the device form (`grid_cache_stats`, all of them in
    one sort); on the CPU through the numpy host form, which is faster
    there. As a CEM / DDPG population converges, batches collapse onto a
    handful of coarse combos and the dominant sort cost amortizes away;
    repeated scalar calls (latency-slope estimation, constraint
    enforcement) hit the same memo.
    """

    def __init__(
        self,
        trace: NGPTrace,
        cfg: HWConfig = HWConfig(),
        pipeline_overlap: float = 0.5,
        n_features: int = 2,
        resolutions: Optional[Sequence[int]] = None,
        stats_memo_size: int = 4096,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.pipeline_overlap = pipeline_overlap
        self.tc = build_trace_constants(trace, cfg, n_features, resolutions)
        self._memo: Dict[Tuple[int, ...], Tuple[int, int, int]] = {}
        self._memo_cap = stats_memo_size
        # Cells on several threads share one simulator: the memo's
        # check, fill and read run under one lock.
        self._memo_lock = threading.Lock()
        self._coarse = (torch.from_numpy(self.tc.coarse_indices)
                        .to(self.device)
                        if self.device.type == "cuda" else None)

    # ------------------------------------------------------------------
    @property
    def n_levels(self) -> int:
        return self.tc.n_levels

    @property
    def n_mlp(self) -> int:
        return len(self.tc.mlp_dims)

    def cache_stats_memo_size(self) -> int:
        return len(self._memo)

    def vmappable(self):
        """Pure per-policy latency fn `(hb, wb, ab) -> metric dict` (the
        `BatchedHardwareSim` protocol hook; `policy_latency` also takes a
        leading K axis). Always exact: the int64 addresses never wrap."""
        tc, cfg, overlap = self.tc, self.cfg, self.pipeline_overlap
        return lambda hb, wb, ab: policy_latency(hb, wb, ab, tc, cfg, overlap)

    def clear_stats_memo(self) -> None:
        """Drop memoized cache stats (benchmarking cold-path behaviour)."""
        with self._memo_lock:
            self._memo.clear()

    # ------------------------------------------------------------------
    def _missing_stats(self, missing):
        """Cache stats of coarse combos not in the memo: on the card all of
        them through the device form (one sort per `_SORT_ACCESSES`), on
        the CPU one host walk each."""
        if self.device.type != "cuda":
            return [grid_cache_stats_host(np.asarray(k, np.int32), self.tc,
                                          self.cfg) for k in missing]
        n_acc = self.tc.n_points * 8 * self.tc.n_coarse
        step = max(1, _SORT_ACCESSES // n_acc)
        out = []
        for s in range(0, len(missing), step):
            eb8 = torch.tensor(missing[s:s + step], dtype=torch.int64,
                               device=self.device)
            stats = grid_cache_stats(eb8, self.tc, self.cfg, self._coarse)
            out += [tuple(int(v) for v in row)
                    for row in torch.stack(stats, dim=-1).cpu().tolist()]
        return out

    def _grid_stats(self, hash_bits: np.ndarray) -> np.ndarray:
        """(K, 3) int64 (hits, misses, cold) with dedup + memoization."""
        K = hash_bits.shape[0]
        if self.tc.n_coarse == 0:
            return np.zeros((K, 3), np.int64)
        eb8 = np.round(
            hash_bits[:, : self.tc.n_coarse].astype(np.float64)
            * self.tc.n_features
        ).astype(np.int32)
        keys = [tuple(int(v) for v in row) for row in eb8]

        with self._memo_lock:
            # The batch's stats are read before any reset: a reset that
            # makes room for the new combos drops none this batch needs.
            known = {k: self._memo[k] for k in dict.fromkeys(keys)
                     if k in self._memo}
            missing = [k for k in dict.fromkeys(keys) if k not in known]
            if missing:
                known.update(zip(missing, self._missing_stats(missing)))
                if len(self._memo) + len(missing) > self._memo_cap:
                    self._memo.clear()  # cheap reset; stats recompute exactly
                self._memo.update((k, known[k]) for k in missing)
        return np.asarray([known[k] for k in keys], np.int64)

    # ------------------------------------------------------------------
    def simulate_batch(
        self,
        hash_bits: np.ndarray,  # (K, n_levels)
        w_bits: np.ndarray,  # (K, n_mlp)
        a_bits: np.ndarray,  # (K, n_mlp)
    ) -> Dict[str, np.ndarray]:
        """Latency/size metrics for K policies at once: dict of (K,) arrays."""
        hb = np.asarray(hash_bits, np.float32)
        wb = np.asarray(w_bits, np.float32)
        ab = np.asarray(a_bits, np.float32)
        assert hb.ndim == 2 and hb.shape[1] == self.n_levels, hb.shape
        assert wb.shape == ab.shape == (hb.shape[0], self.n_mlp), (wb.shape, ab.shape)

        stats = self._grid_stats(hb)
        dev = self.device
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        out = _compose_latency(t(hb), t(wb), t(ab), t(stats[:, 0]),
                               t(stats[:, 1]), t(stats[:, 2]), self.tc,
                               self.cfg, self.pipeline_overlap)
        # One copy back for every f32 metric.
        host = torch.stack(list(out.values())).cpu().numpy()
        res = dict(zip(out, host))
        res.update(model_bytes=_model_bytes(hb, wb, self.tc),
                   grid_hits=stats[:, 0], grid_misses=stats[:, 1],
                   grid_cold_misses=stats[:, 2])
        return res

    def simulate_one(
        self,
        hash_bits: Sequence[float],
        w_bits: Sequence[float],
        a_bits: Sequence[float],
    ) -> Dict[str, np.ndarray]:
        """Single-policy metrics through the same memoized path."""
        out = self.simulate_batch(
            np.asarray(hash_bits, np.float32)[None],
            np.asarray(w_bits, np.float32)[None],
            np.asarray(a_bits, np.float32)[None],
        )
        return {k: v[0] for k, v in out.items()}

    def baseline_batch(self, bits: int = 8, k: int = 1) -> Dict[str, np.ndarray]:
        """Uniform-bit batch (the Eq. 9 `original_cost` reference point)."""
        b = float(bits)
        return self.simulate_batch(
            np.full((k, self.n_levels), b),
            np.full((k, self.n_mlp), b),
            np.full((k, self.n_mlp), b),
        )
