"""Top-level NeuRex-style simulator: Encoding Engine + MLP Unit + DRAM.

Latency composition per rendering batch (one trace):

  encode = lookup/interp cycles
         + grid-cache miss stalls     (coarse levels, direct-mapped cache)
         + subgrid prefetch stalls    (fine levels, buffer refills on
                                       subgrid transitions)
  mlp    = bit-serial systolic cycles over all sample points
  total  = max(encode, mlp) + (1 - pipeline_overlap) * min(encode, mlp)

The two engines pipeline across subgrid batches (NeuRex Sec. 4), captured by
`pipeline_overlap`. All quantization-policy dependence is explicit:
  - hash level l: entry bytes = F * b_l / 8 -> addresses, miss rates, and
    prefetch volumes change with b_l;
  - MLP layer i: serial factor from (w_bits_i, a_bits_i).

`NeuRexSimulator` is a thin scalar wrapper over the torch implementation
in repro_torch/hwsim/batched.py (backend="torch", the default — one batched
simulator per trace, on the card unless device="cpu", whose memo every
policy reuses). backend="numpy" runs the original float64 host
implementation and serves as the parity oracle in tests; use it when
auditing the torch path, not in the search loop.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.hwsim.cache import CacheStats, simulate_direct_mapped
from repro_torch.hwsim.config import HWConfig
from repro_torch.hwsim.systolic import mlp_cycles
from repro_torch.hwsim.trace import NGPTrace
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.quant.packing import policy_model_bytes


@dataclasses.dataclass
class LatencyBreakdown:
    lookup_cycles: float
    grid_miss_cycles: float
    subgrid_prefetch_cycles: float
    encode_cycles: float
    mlp_compute_cycles: float
    total_cycles: float
    cycles_per_ray: float
    grid_cache: CacheStats
    model_bytes: float
    dram_bytes: float

    def as_dict(self) -> Dict[str, float]:
        return {
            "lookup_cycles": self.lookup_cycles,
            "grid_miss_cycles": self.grid_miss_cycles,
            "subgrid_prefetch_cycles": self.subgrid_prefetch_cycles,
            "encode_cycles": self.encode_cycles,
            "mlp_compute_cycles": self.mlp_compute_cycles,
            "total_cycles": self.total_cycles,
            "cycles_per_ray": self.cycles_per_ray,
            "grid_hit_rate": self.grid_cache.hit_rate,
            "model_bytes": self.model_bytes,
            "dram_bytes": self.dram_bytes,
        }


class NeuRexSimulator:
    def __init__(
        self,
        cfg: HWConfig = HWConfig(),
        pipeline_overlap: float = 0.5,
        backend: str = "torch",
        device: DeviceLike = None,
    ):
        """`device` (the card unless "cpu") is where the torch backend
        simulates; the numpy oracle runs on the host and takes none."""
        if backend not in ("torch", "numpy"):
            raise ValueError(f"unknown backend {backend!r}")
        self.cfg = cfg
        self.pipeline_overlap = pipeline_overlap
        self.backend = backend
        self.device = resolve_device(device) if backend == "torch" else None
        # (key -> (trace, BatchedNeuRexSimulator)); identity-checked so a
        # recycled id() can't alias a dead trace. Bounded FIFO, looked up
        # and filled under a lock (cells on several threads share it).
        self._sims: Dict[tuple, tuple] = {}
        self._sims_lock = threading.Lock()

    # ------------------------------------------------------------------
    def _entry_bytes(self, n_features: int, bits: float) -> float:
        return n_features * bits / 8.0

    def _grid_cache_trace(
        self, trace: NGPTrace, hash_bits: Sequence[float], n_features: int
    ) -> np.ndarray:
        """Byte-address stream for the coarse levels, in true access order
        (per sample point, levels visited coarse->fine, 8 corners each)."""
        cfg = self.cfg
        n_coarse = min(cfg.coarse_levels, len(trace.level_indices))
        if n_coarse == 0:
            return np.zeros((0,), np.int64)
        P = trace.n_points
        streams = []
        base = 0
        for l in range(n_coarse):
            eb = self._entry_bytes(n_features, hash_bits[l])
            addr = (trace.level_indices[l].astype(np.float64) * eb).astype(np.int64)
            streams.append(addr + base)
            # Level tables are laid out back-to-back, line-aligned.
            table_bytes = int(math.ceil(trace.level_entries[l] * eb))
            base += (
                (table_bytes + cfg.cache_line_bytes - 1)
                // cfg.cache_line_bytes
            ) * cfg.cache_line_bytes
        # streams[l] has shape (P*8,) in point order; interleave to
        # (P, n_coarse, 8) time order.
        arr = np.stack([s.reshape(P, 8) for s in streams], axis=1)  # (P, L, 8)
        return arr.reshape(-1)

    def _subgrid_prefetch_bytes(
        self, trace: NGPTrace, hash_bits: Sequence[float], n_features: int,
        resolutions: Sequence[int],
    ) -> float:
        """Bytes prefetched into the subgrid buffer over the whole trace."""
        cfg = self.cfg
        n_levels = len(trace.level_indices)
        transitions = 1 + int(
            np.count_nonzero(trace.subgrid_ids[1:] != trace.subgrid_ids[:-1])
        )
        per_transition = 0.0
        for l in range(cfg.coarse_levels, n_levels):
            eb = self._entry_bytes(n_features, hash_bits[l])
            # Entries covering one subgrid: the level's voxels that fall in
            # a (1/subgrid_res)^3 region, capped by the hash table size.
            res = resolutions[l]
            per_sub = min(
                trace.level_entries[l],
                (res // cfg.subgrid_resolution + 1) ** 3,
            )
            per_transition += per_sub * eb
        return transitions * per_transition

    # ------------------------------------------------------------------
    def _batched_for(
        self,
        trace: NGPTrace,
        n_features: int,
        resolutions: Optional[Sequence[int]],
    ):
        """Per-trace BatchedNeuRexSimulator, built once and memoized."""
        from repro_torch.hwsim.batched import BatchedNeuRexSimulator

        key = (
            id(trace),
            n_features,
            tuple(resolutions) if resolutions is not None else None,
        )
        with self._sims_lock:
            hit = self._sims.get(key)
            if hit is not None and hit[0] is trace:
                return hit[1]
            bsim = BatchedNeuRexSimulator(
                trace, self.cfg, self.pipeline_overlap, n_features,
                resolutions, device=self.device,
            )
            if len(self._sims) >= 8:  # bound the per-trace cache
                self._sims.pop(next(iter(self._sims)))
            self._sims[key] = (trace, bsim)
            return bsim

    # ------------------------------------------------------------------
    def simulate(
        self,
        trace: NGPTrace,
        hash_bits: Sequence[float],
        w_bits: Sequence[float],
        a_bits: Sequence[float],
        n_features: int = 2,
        resolutions: Optional[Sequence[int]] = None,
    ) -> LatencyBreakdown:
        n_levels = len(trace.level_indices)
        assert len(hash_bits) == n_levels, (len(hash_bits), n_levels)
        assert len(w_bits) == len(trace.mlp_dims)
        if self.backend == "torch":
            r = self._batched_for(trace, n_features, resolutions).simulate_one(
                hash_bits, w_bits, a_bits
            )
            return LatencyBreakdown(
                lookup_cycles=float(r["lookup_cycles"]),
                grid_miss_cycles=float(r["grid_miss_cycles"]),
                subgrid_prefetch_cycles=float(r["subgrid_prefetch_cycles"]),
                encode_cycles=float(r["encode_cycles"]),
                mlp_compute_cycles=float(r["mlp_compute_cycles"]),
                total_cycles=float(r["total_cycles"]),
                cycles_per_ray=float(r["cycles_per_ray"]),
                grid_cache=CacheStats(
                    accesses=int(r["grid_accesses"]),
                    hits=int(r["grid_hits"]),
                    misses=int(r["grid_misses"]),
                    cold_misses=int(r["grid_cold_misses"]),
                ),
                model_bytes=float(r["model_bytes"]),
                dram_bytes=float(r["dram_bytes"]),
            )
        return self._simulate_numpy(
            trace, hash_bits, w_bits, a_bits, n_features, resolutions
        )

    # ------------------------------------------------------------------
    def _simulate_numpy(
        self,
        trace: NGPTrace,
        hash_bits: Sequence[float],
        w_bits: Sequence[float],
        a_bits: Sequence[float],
        n_features: int = 2,
        resolutions: Optional[Sequence[int]] = None,
    ) -> LatencyBreakdown:
        """Original scalar float64 implementation (parity oracle)."""
        cfg = self.cfg
        n_levels = len(trace.level_indices)
        if resolutions is None:
            # Infer approximate resolutions from entry counts (dense levels).
            resolutions = [
                max(int(round(e ** (1.0 / 3.0))) - 1, 1) for e in trace.level_entries
            ]

        P = trace.n_points

        # --- Encoding Engine ------------------------------------------------
        # Lookup/interp datapath: one corner per cycle per bank; 8 corners
        # per level per sample, interpolation pipelined behind lookups.
        lookup_cycles = float(
            P * n_levels * 8 / 8  # 8 banks service the 8 corners in parallel
            + P * n_levels * cfg.interp_cycles_per_sample_level
        )

        addrs = self._grid_cache_trace(trace, hash_bits, n_features)
        stats = simulate_direct_mapped(
            addrs, cfg.grid_cache_lines, cfg.cache_line_bytes
        )
        miss_bytes = stats.misses * cfg.cache_line_bytes
        grid_miss_cycles = (
            miss_bytes / cfg.bytes_per_cycle
            + stats.misses * cfg.dram_latency_cycles * (1.0 - cfg.dram_latency_overlap)
        )

        prefetch_bytes = self._subgrid_prefetch_bytes(
            trace, hash_bits, n_features, resolutions
        )
        # Prefetch overlaps rendering of the previous subgrid; the visible
        # stall is the non-overlapped fraction of the transfer.
        subgrid_prefetch_cycles = (
            prefetch_bytes / cfg.bytes_per_cycle * (1.0 - cfg.dram_latency_overlap)
        )

        encode_cycles = lookup_cycles + grid_miss_cycles + subgrid_prefetch_cycles

        # --- MLP Unit --------------------------------------------------------
        mlp_total, _ = mlp_cycles(P, trace.mlp_dims, w_bits, a_bits, cfg)

        # --- Pipeline composition -------------------------------------------
        hi, lo = max(encode_cycles, mlp_total), min(encode_cycles, mlp_total)
        total = hi + (1.0 - self.pipeline_overlap) * lo

        # --- Model size under this policy ------------------------------------
        # The shared packed-size function (quant.packing): bytes the
        # sub-byte artifact ACTUALLY stores, not the analytic n*b/8 — so
        # the frontier objective equals the shipped payload exactly.
        model_bytes = float(policy_model_bytes(
            trace.level_entries, n_features, trace.mlp_dims,
            hash_bits, w_bits,
        ))

        return LatencyBreakdown(
            lookup_cycles=lookup_cycles,
            grid_miss_cycles=grid_miss_cycles,
            subgrid_prefetch_cycles=subgrid_prefetch_cycles,
            encode_cycles=encode_cycles,
            mlp_compute_cycles=mlp_total,
            total_cycles=total,
            cycles_per_ray=total / max(trace.n_rays, 1),
            grid_cache=stats,
            model_bytes=model_bytes,
            dram_bytes=float(miss_bytes + prefetch_bytes),
        )

    # Convenience: latency under a uniform bit width (the 8-bit baseline that
    # defines original_cost in Eq. 9). Pass the same `resolutions` used for
    # policy simulations so the Eq. 9 cost ratio compares like with like.
    def baseline(
        self,
        trace: NGPTrace,
        bits: int = 8,
        n_features: int = 2,
        resolutions: Optional[Sequence[int]] = None,
    ):
        n_levels = len(trace.level_indices)
        n_mlp = len(trace.mlp_dims)
        return self.simulate(
            trace,
            [float(bits)] * n_levels,
            [float(bits)] * n_mlp,
            [float(bits)] * n_mlp,
            n_features=n_features,
            resolutions=resolutions,
        )
