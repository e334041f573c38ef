"""Cycle-accurate NeuRex-style accelerator simulator (paper Sec. III-F).

Components (Fig. 2 of the paper):
  - Encoding Engine: direct-mapped *grid cache* for coarse hash levels and a
    *subgrid buffer* for fine levels (prefetch on subgrid transitions).
  - MLP Unit: systolic array with Stripes-style bit-serial PEs (an N-bit MAC
    takes N cycles).
  - LPDDR4-3200 memory at a 1 GHz core clock.

Two execution paths share one analytic model:
  - NeuRexSimulator: scalar API (one policy -> LatencyBreakdown). By default
    a thin wrapper over the batched torch path; backend="numpy" is the
    float64 reference oracle.
  - BatchedNeuRexSimulator: a (K, n_units) batch of policies in one call,
    its cache walks sorted on the card — what population-based HERO search
    runs on (repro_torch/core/batched_env.py).
"""
from repro_torch.hwsim.config import HWConfig
from repro_torch.hwsim.cache import (
    DirectMappedCache,
    direct_mapped_stats,
    simulate_direct_mapped,
)
from repro_torch.hwsim.systolic import bit_serial_matmul_cycles, mlp_cycles_torch
from repro_torch.hwsim.trace import NGPTrace, build_trace
from repro_torch.hwsim.neurex import NeuRexSimulator, LatencyBreakdown
from repro_torch.hwsim.batched import (
    BatchedNeuRexSimulator,
    TraceConstants,
    build_trace_constants,
    policy_latency,
)

__all__ = [
    "HWConfig",
    "DirectMappedCache",
    "direct_mapped_stats",
    "simulate_direct_mapped",
    "bit_serial_matmul_cycles",
    "mlp_cycles_torch",
    "NGPTrace",
    "build_trace",
    "NeuRexSimulator",
    "LatencyBreakdown",
    "BatchedNeuRexSimulator",
    "TraceConstants",
    "build_trace_constants",
    "policy_latency",
]
