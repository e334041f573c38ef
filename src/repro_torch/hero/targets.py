"""Hardware targets: the pluggable accelerator models behind the HERO loop.

HERO's promise is navigating the accuracy/latency/size space *for a given
accelerator* — which makes the hardware side a family of targets, not one
simulator (FlexNeRFer's multi-dataflow design, RT-NeRF's on-device
pipeline). This module defines the `HardwareTarget` protocol the search
stack (`core/env.py`, `core/batched_env.py`) consumes, plus the built-in
targets and a by-name registry:

  neurex         — the paper's cycle-accurate NeuRex simulator (default)
  neurex-edge    — NeuRex timing with an edge-device config (smaller
                   systolic array / grid cache, half the DRAM bandwidth)
  neurex-cloud   — a datacenter-ish config (32x32 array, 4x bandwidth)
  roofline-edge  — an analytic bandwidth/compute roofline (RT-NeRF-style
                   on-device budget), NOT backed by the NeuRex machinery:
                   closed-form in the bit vectors

A target provides four things: a workload (a trace from real rays),
a scalar `simulate` (one policy -> `LatencyBreakdown`), a `batched`
evaluator (K policies -> dict of (K,) metric arrays, with a pure per-policy
form), and `describe()` metadata that rides in deployable `QuantArtifact`s
so a served bundle records what hardware its latency numbers mean. Every
target is bound to a torch device (the card unless `device="cpu"`): its
workloads are traced there and its batched evaluator runs there.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Protocol, Sequence, Union, runtime_checkable

import numpy as np
import torch

from repro_torch.hwsim import HWConfig, NeuRexSimulator, build_trace
from repro_torch.hwsim.batched import BatchedNeuRexSimulator
from repro_torch.hwsim.cache import CacheStats
from repro_torch.hwsim.neurex import LatencyBreakdown
from repro_torch.hwsim.trace import NGPTrace
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.quant.packing import policy_model_bytes


def device_key(device: torch.device) -> str:
    """`cuda:<device name>` or `cpu`: recorded in every target's
    `describe()` so a deployed artifact carries which device its
    compile-time numbers were produced on."""
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


# ---------------------------------------------------------------------------
# The protocol
# ---------------------------------------------------------------------------
class BatchedHardwareSim(Protocol):
    """Population-rate evaluator a target hands to `BatchedQuantEnv`."""

    def simulate_batch(
        self, hash_bits: np.ndarray, w_bits: np.ndarray, a_bits: np.ndarray
    ) -> Dict[str, np.ndarray]:
        """(K, ·) bit arrays -> dict of (K,) metric arrays. Must include
        at least `total_cycles` and `model_bytes`."""
        ...

    def vmappable(self) -> Optional[Callable]:
        """Pure per-policy fn `(hb, wb, ab) -> Dict[str, tensor]` of bit
        tensors on the target's device."""
        ...


@runtime_checkable
class HardwareTarget(Protocol):
    """One accelerator model the RL loop can be pointed at.

    Implementations must be stateless with respect to policies: the same
    (workload, bits) always yields the same numbers, so envs can share a
    target across scenes and hardware budgets.
    """

    name: str
    device: torch.device

    def build_workload(self, cfg, rcfg, rays_o, rays_d) -> NGPTrace:
        """Workload trace for a ray batch (policy-independent)."""
        ...

    def simulate(
        self,
        workload: NGPTrace,
        hash_bits: Sequence[float],
        w_bits: Sequence[float],
        a_bits: Sequence[float],
        *,
        n_features: int = 2,
        resolutions: Optional[Sequence[int]] = None,
    ) -> LatencyBreakdown:
        ...

    def baseline(
        self,
        workload: NGPTrace,
        bits: int = 8,
        *,
        n_features: int = 2,
        resolutions: Optional[Sequence[int]] = None,
    ) -> LatencyBreakdown:
        ...

    def batched(
        self,
        workload: NGPTrace,
        *,
        n_features: int = 2,
        resolutions: Optional[Sequence[int]] = None,
    ) -> BatchedHardwareSim:
        ...

    def describe(self) -> Dict:
        """JSON-serializable identity (name + timing config) recorded in
        checkpoints and deployable artifacts."""
        ...


# ---------------------------------------------------------------------------
# NeuRex-family target (the paper's simulator)
# ---------------------------------------------------------------------------
class NeuRexTarget:
    """The cycle-accurate NeuRex-style simulator as a `HardwareTarget`.

    Thin composition of the existing machinery: `build_trace` for
    workloads, `NeuRexSimulator` for scalar calls (the batched torch path,
    memoized cache stats), `BatchedNeuRexSimulator` for populations.
    """

    def __init__(
        self,
        hw: HWConfig = HWConfig(),
        pipeline_overlap: float = 0.5,
        name: str = "neurex",
        device: DeviceLike = None,
    ):
        self.name = name
        self.hw = hw
        self.pipeline_overlap = pipeline_overlap
        self.device = resolve_device(device)
        # Exposed for legacy call sites (`env.sim`); new code should stay
        # on the protocol surface.
        self.sim = NeuRexSimulator(hw, pipeline_overlap, device=self.device)

    def build_workload(self, cfg, rcfg, rays_o, rays_d) -> NGPTrace:
        return build_trace(
            cfg, rcfg, rays_o, rays_d,
            subgrid_resolution=self.hw.subgrid_resolution,
            device=self.device,
        )

    def simulate(
        self, workload, hash_bits, w_bits, a_bits, *,
        n_features: int = 2, resolutions=None,
    ) -> LatencyBreakdown:
        return self.sim.simulate(
            workload, hash_bits, w_bits, a_bits,
            n_features=n_features, resolutions=resolutions,
        )

    def baseline(
        self, workload, bits: int = 8, *, n_features: int = 2, resolutions=None
    ) -> LatencyBreakdown:
        return self.sim.baseline(
            workload, bits, n_features=n_features, resolutions=resolutions
        )

    def batched(
        self, workload, *, n_features: int = 2, resolutions=None
    ) -> BatchedHardwareSim:
        return BatchedNeuRexSimulator(
            workload, self.hw, self.pipeline_overlap, n_features, resolutions,
            device=self.device,
        )

    def describe(self) -> Dict:
        return {
            "name": self.name,
            "family": "neurex",
            "pipeline_overlap": self.pipeline_overlap,
            "config": dataclasses.asdict(self.hw),
            "device": device_key(self.device),
        }


# ---------------------------------------------------------------------------
# Roofline target (non-NeuRex analytic model)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RooflineHWConfig:
    """Bandwidth/compute roofline of an on-device renderer (RT-NeRF-ish).

    No cache simulation, no subgrid model: memory time is total traffic
    over peak bandwidth, compute time is precision-scaled MACs over the
    MAC array, and the two overlap perfectly (`total = max(mem, compute)`).
    Quantization enters through the traffic (table entries, weights and
    activations shrink with their bits) and through the per-MAC serial
    factor `max(w_bits, a_bits) / mac_bits`.
    """

    clock_ghz: float = 1.0
    dram_peak_gbps: float = 12.8  # edge LPDDR4 single channel
    mac_lanes: int = 128  # parallel MACs at `mac_bits` precision
    mac_bits: int = 8  # native operand width of one lane

    @property
    def bytes_per_cycle(self) -> float:
        return self.dram_peak_gbps / self.clock_ghz


@dataclasses.dataclass(frozen=True)
class _RooflineConsts:
    """Policy-independent workload constants (the roofline's trace view)."""

    n_points: int
    n_rays: int
    n_features: int
    level_entries: np.ndarray  # (L,) f32
    d_in: np.ndarray  # (n_mlp,) f32
    d_out: np.ndarray  # (n_mlp,) f32


def _roofline_metrics(
    hash_bits: torch.Tensor,
    w_bits: torch.Tensor,
    a_bits: torch.Tensor,
    consts: _RooflineConsts,
    hw: RooflineHWConfig,
) -> Dict[str, torch.Tensor]:
    """Closed-form roofline, f32, over a leading K axis ((K, ·) bit
    tensors -> (K,) metrics) or for one policy (1-D bits -> scalars)."""
    single = hash_bits.dim() == 1
    hb, wb, ab = (x.reshape(-1, x.shape[-1]).to(torch.float32)
                  for x in (hash_bits, w_bits, a_bits))
    dev = hb.device
    P = float(consts.n_points)
    d_in = torch.from_numpy(np.asarray(consts.d_in, np.float32)).to(dev)
    d_out = torch.from_numpy(np.asarray(consts.d_out, np.float32)).to(dev)
    F = float(consts.n_features)

    # --- memory side: model stream + per-sample feature/activation traffic
    # The model stream is the PACKED payload (shared size function,
    # quant.packing): what a deployed artifact actually moves through
    # DRAM, which is also the frontier's model_bytes objective. Exact per
    # policy (float64 on the host), then carried as f32 as the reference's.
    model_bytes = torch.from_numpy(np.asarray(policy_model_bytes(
        [int(e) for e in consts.level_entries], int(F),
        list(zip(consts.d_in.astype(int), consts.d_out.astype(int))),
        hb.cpu().numpy().T.astype(np.float64),
        wb.cpu().numpy().T.astype(np.float64),
    ), np.float32)).to(dev)
    lookup_bits = P * 8.0 * torch.sum(F * hb, dim=-1)  # 8 corners per level
    act_bits = P * torch.sum((d_in + d_out) * ab, dim=-1)
    mem_bytes = model_bytes + (lookup_bits + act_bits) / 8.0
    mem_cycles = mem_bytes / hw.bytes_per_cycle

    # --- compute side: precision-scaled MACs over the lane array
    serial = torch.maximum(wb, ab) / float(hw.mac_bits)
    compute_cycles = P * torch.sum(d_in * d_out * serial, dim=-1) \
        / float(hw.mac_lanes)

    total = torch.maximum(mem_cycles, compute_cycles)
    zero = torch.zeros_like(total)
    izero = torch.zeros(total.shape, dtype=torch.int64, device=dev)
    out = {
        "lookup_cycles": mem_cycles - model_bytes / hw.bytes_per_cycle,
        "grid_miss_cycles": zero,
        "subgrid_prefetch_cycles": zero,
        "encode_cycles": mem_cycles,
        "mlp_compute_cycles": compute_cycles,
        "total_cycles": total,
        "cycles_per_ray": total / max(consts.n_rays, 1),
        "model_bytes": model_bytes,
        "dram_bytes": mem_bytes,
        "grid_accesses": zero,
        "grid_hits": izero,
        "grid_misses": izero,
        "grid_cold_misses": izero,
        "grid_hit_rate": zero,
    }
    return {k: v[0] for k, v in out.items()} if single else out


class _RooflineBatched:
    def __init__(self, fn: Callable, device: torch.device):
        self._fn = fn
        self.device = device

    def simulate_batch(self, hash_bits, w_bits, a_bits) -> Dict[str, np.ndarray]:
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(self.device)
        out = self._fn(t(hash_bits), t(w_bits), t(a_bits))
        return {k: v.cpu().numpy() for k, v in out.items()}

    def vmappable(self) -> Optional[Callable]:
        return self._fn


class RooflineTarget:
    """Analytic roofline accelerator model — not NeuRex-backed."""

    def __init__(self, hw: RooflineHWConfig = RooflineHWConfig(),
                 name: str = "roofline", device: DeviceLike = None):
        self.name = name
        self.hw = hw
        self.device = resolve_device(device)

    # The trace is shared: the workload (points, table touches, layer
    # dims) is hardware-agnostic; only the timing model differs.
    def build_workload(self, cfg, rcfg, rays_o, rays_d) -> NGPTrace:
        return build_trace(cfg, rcfg, rays_o, rays_d, device=self.device)

    def _consts(self, workload: NGPTrace, n_features: int) -> _RooflineConsts:
        return _RooflineConsts(
            n_points=workload.n_points,
            n_rays=workload.n_rays,
            n_features=n_features,
            level_entries=np.asarray(workload.level_entries, np.float32),
            d_in=np.asarray([d for d, _ in workload.mlp_dims], np.float32),
            d_out=np.asarray([d for _, d in workload.mlp_dims], np.float32),
        )

    def simulate(
        self, workload, hash_bits, w_bits, a_bits, *,
        n_features: int = 2, resolutions=None,
    ) -> LatencyBreakdown:
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(self.device)
        r = _roofline_metrics(t(hash_bits), t(w_bits), t(a_bits),
                              self._consts(workload, n_features), self.hw)
        return LatencyBreakdown(
            lookup_cycles=float(r["lookup_cycles"]),
            grid_miss_cycles=0.0,
            subgrid_prefetch_cycles=0.0,
            encode_cycles=float(r["encode_cycles"]),
            mlp_compute_cycles=float(r["mlp_compute_cycles"]),
            total_cycles=float(r["total_cycles"]),
            cycles_per_ray=float(r["cycles_per_ray"]),
            grid_cache=CacheStats(accesses=0, hits=0, misses=0, cold_misses=0),
            model_bytes=float(r["model_bytes"]),
            dram_bytes=float(r["dram_bytes"]),
        )

    def baseline(
        self, workload, bits: int = 8, *, n_features: int = 2, resolutions=None
    ) -> LatencyBreakdown:
        L = len(workload.level_indices)
        M = len(workload.mlp_dims)
        b = float(bits)
        return self.simulate(
            workload, [b] * L, [b] * M, [b] * M,
            n_features=n_features, resolutions=resolutions,
        )

    def batched(
        self, workload, *, n_features: int = 2, resolutions=None
    ) -> BatchedHardwareSim:
        consts = self._consts(workload, n_features)
        hw = self.hw
        return _RooflineBatched(
            lambda hb, wb, ab: _roofline_metrics(hb, wb, ab, consts, hw),
            self.device,
        )

    def describe(self) -> Dict:
        return {
            "name": self.name,
            "family": "roofline",
            "config": dataclasses.asdict(self.hw),
            "device": device_key(self.device),
        }


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_TARGET_REGISTRY: Dict[str, tuple] = {}  # name -> (factory, description)


def register_target(name: str, factory: Callable[..., HardwareTarget],
                    description: str = "") -> None:
    """Register a target factory under `name`. Factories take keyword
    overrides (e.g. `coarse_levels=2`, `device="cpu"`) and return a fresh
    target."""
    _TARGET_REGISTRY[name] = (factory, description)


# Family-specific knobs that generic call sites pass unconditionally
# (a scene env scales `coarse_levels` to the scene). A factory that
# rejects one of THESE is retried without it; any other unknown override
# is a typo and still raises.
_CROSS_FAMILY_KNOBS = ("coarse_levels",)

def make_target(name: str = "neurex", **overrides) -> HardwareTarget:
    """Instantiate a registered target by name with config overrides."""
    if name == "roofline-lm":
        raise NotImplementedError(
            "hardware target 'roofline-lm': the LM decode roofline is ported "
            "with the LM workload (ROADMAP §1 item 8); its preset is a TPU's "
            "HBM rate, and the port needs the card's own figures")
    if name not in _TARGET_REGISTRY:
        known = ", ".join(sorted(_TARGET_REGISTRY))
        raise KeyError(f"unknown hardware target {name!r} (registered: {known})")
    factory, _ = _TARGET_REGISTRY[name]
    try:
        return factory(**overrides)
    except TypeError:
        stripped = {
            k: v for k, v in overrides.items() if k not in _CROSS_FAMILY_KNOBS
        }
        if stripped == overrides:
            raise
        return factory(**stripped)


def list_targets() -> Dict[str, str]:
    """name -> one-line description of every registered target."""
    return {k: d for k, (_, d) in sorted(_TARGET_REGISTRY.items())}


def resolve_target(
    hardware: Union[str, HardwareTarget, None], **overrides
) -> HardwareTarget:
    """Name or instance -> instance (None = the default `neurex`).

    Overrides only apply when resolving by name — an instance is already
    configured and is returned as-is."""
    if hardware is None:
        hardware = "neurex"
    if isinstance(hardware, str):
        return make_target(hardware, **overrides)
    return hardware


def _neurex_factory(preset: HWConfig, name: str):
    def factory(**kw) -> HardwareTarget:
        overlap = kw.pop("pipeline_overlap", 0.5)
        device = kw.pop("device", None)
        return NeuRexTarget(
            dataclasses.replace(preset, **kw), pipeline_overlap=overlap,
            name=name, device=device,
        )
    return factory


def _roofline_factory(preset: RooflineHWConfig, name: str):
    def factory(**kw) -> HardwareTarget:
        # Unknown fields raise via dataclasses.replace; make_target strips
        # cross-family knobs (coarse_levels) on retry, so this factory
        # stays as plain as a user-registered one.
        device = kw.pop("device", None)
        return RooflineTarget(dataclasses.replace(preset, **kw), name=name,
                              device=device)
    return factory


register_target(
    "neurex", _neurex_factory(HWConfig(), "neurex"),
    "paper-default NeuRex simulator (16x16 bit-serial array, 8 KB grid "
    "cache, LPDDR4-3200)",
)
register_target(
    "neurex-edge",
    _neurex_factory(
        HWConfig(systolic_rows=8, systolic_cols=8, grid_cache_kb=4,
                 subgrid_buffer_kb=64, dram_peak_gbps=12.8),
        "neurex-edge",
    ),
    "NeuRex timing, edge-device config (8x8 array, 4 KB cache, half the "
    "DRAM bandwidth)",
)
register_target(
    "neurex-cloud",
    _neurex_factory(
        HWConfig(systolic_rows=32, systolic_cols=32, grid_cache_kb=32,
                 dram_peak_gbps=102.4),
        "neurex-cloud",
    ),
    "NeuRex timing, datacenter config (32x32 array, 32 KB cache, 4x DRAM "
    "bandwidth)",
)
register_target(
    "roofline-edge", _roofline_factory(RooflineHWConfig(), "roofline-edge"),
    "analytic bandwidth/compute roofline of an on-device renderer "
    "(non-NeuRex)",
)
