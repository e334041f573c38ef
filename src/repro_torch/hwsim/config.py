"""Hardware configuration: NeuRex timing/memory parameters (paper Sec. III-F:
"identical timing and memory configurations as in [8] ... 1 GHz clock and
LPDDR4-3200")."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HWConfig:
    # Clock
    clock_ghz: float = 1.0

    # MLP Unit: systolic array of bit-serial PEs.
    systolic_rows: int = 16
    systolic_cols: int = 16
    # 'stripes': serial factor = activation bits (Stripes serializes one
    # operand); 'max': serial factor = max(weight, activation) bits — the
    # conservative reading of the paper's "N-bit MAC in N cycles".
    serial_mode: str = "stripes"

    # Encoding Engine: grid cache (coarse levels) — direct mapped, NeuRex.
    # Sized so that the coarse working set under 8-bit entries overflows it
    # (the regime NeuRex targets): hash bit width then visibly moves the
    # hit rate, which is the coupling the paper's simulator exists to model.
    grid_cache_kb: int = 8
    cache_line_bytes: int = 64
    coarse_levels: int = 8  # levels [0, coarse_levels) use the grid cache

    # Subgrid buffer (fine levels) — heavily banked, prefetched per subgrid.
    subgrid_buffer_kb: int = 128
    subgrid_resolution: int = 4  # scene is split into res^3 subgrids

    # DRAM: LPDDR4-3200, 64-bit channel -> 25.6 GB/s peak.
    dram_peak_gbps: float = 25.6
    dram_latency_cycles: int = 100  # per-miss latency (row activate + CAS)
    dram_latency_overlap: float = 0.8  # fraction hidden by banking/prefetch

    # Encoding datapath: corners interpolated per sample per level.
    interp_cycles_per_sample_level: int = 1

    @property
    def bytes_per_cycle(self) -> float:
        return self.dram_peak_gbps / self.clock_ghz

    @property
    def grid_cache_lines(self) -> int:
        return (self.grid_cache_kb * 1024) // self.cache_line_bytes

    def serial_factor(self, w_bits: float, a_bits: float) -> float:
        if self.serial_mode == "stripes":
            return float(a_bits)
        if self.serial_mode == "max":
            return float(max(w_bits, a_bits))
        raise ValueError(f"unknown serial_mode {self.serial_mode!r}")
