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
  roofline-lm    — weight-bound transformer decode roofline (the H100's
                   HBM stream; the JAX package's preset is a TPU v5e's):
                   the LM workload's cost model. Not a renderer target;
                   `repro_torch.workloads.lm` consumes it

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
# LM decode roofline target (the LM workload's cost model)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LMRooflineHWConfig:
    """Weight-bound autoregressive decode on an HBM-class chip.

    At batch-1 decode every weight byte is streamed from HBM once per
    token, so seconds/token = bytes(embed bands + per-layer weights) over
    peak bandwidth. Activation bits shape quality, not this cost model
    (their traffic is negligible next to the weight stream). The preset
    is the card the port runs on: NVIDIA H100 SXM5 80GB HBM3 at 700 W,
    3.35 TB/s of HBM3 and 989 dense bf16 tensor-core TFLOP/s (NVIDIA's
    H100 datasheet). The JAX package's preset is a TPU v5e (819 GB/s,
    197 TFLOP/s); pass `hbm_gbps=819.0` to reproduce its seconds. The
    search reads latency only as a ratio to the same target's 8-bit
    baseline, so the rate cancels there.
    """

    chip: str = "nvidia-h100-sxm"
    hbm_gbps: float = 3350.0  # GB/s peak HBM bandwidth
    peak_tflops_bf16: float = 989.0  # recorded identity; unused by the model

    @property
    def hbm_bw(self) -> float:
        """B/s."""
        return self.hbm_gbps * 1e9


@dataclasses.dataclass(frozen=True)
class LMDecodeWorkload:
    """Policy-independent constants of one arch's decode step (the LM
    analogue of `NGPTrace`): embedding-band row counts and per-layer
    weight-group element counts."""

    arch: str
    n_layers: int
    d_model: int
    band_rows: np.ndarray  # (n_bands,) f32 — vocab rows per embed band
    group_elems: np.ndarray  # (N_GROUPS,) f32 — weight elems per group/layer


def _lm_decode_metrics(
    embed_bits: torch.Tensor,  # (K, n_bands) or (n_bands,)
    w_bits: torch.Tensor,  # (K, n_layers, N_GROUPS) or (n_layers, N_GROUPS)
    a_bits: torch.Tensor,  # like w_bits; quality-only
    consts: LMDecodeWorkload,
    hw: LMRooflineHWConfig,
) -> Dict[str, torch.Tensor]:
    """Closed-form decode cost in f32, over a leading K axis ((K, ·) bit
    tensors -> (K,) metrics) or for one policy (scalars). `total_cycles`
    is in SECONDS per token — the closed loop only ever consumes latency
    as a ratio to the same target's 8-bit baseline, so the unit cancels."""
    single = embed_bits.dim() == 1
    eb = embed_bits.reshape(-1, embed_bits.shape[-1]).to(torch.float32)
    wb = w_bits.reshape(-1, *w_bits.shape[-2:]).to(torch.float32)
    ab = a_bits.reshape(-1, *a_bits.shape[-2:]).to(torch.float32)
    dev = eb.device
    band_rows = torch.from_numpy(np.asarray(consts.band_rows, np.float32)) \
        .to(dev)
    group = torch.from_numpy(np.asarray(consts.group_elems, np.float32)) \
        .to(dev)
    embed_bytes = torch.sum(band_rows * float(consts.d_model) * eb,
                            dim=-1) / 8.0
    w_bytes = torch.sum(group * wb, dim=(-2, -1)) / 8.0
    model_bytes = embed_bytes + w_bytes
    seconds = model_bytes / hw.hbm_bw
    # Every output depends on every input (a_bits is cost-neutral by
    # design), as the reference's sharded outputs must.
    zero = torch.sum(ab, dim=(-2, -1)) * 0.0
    out = {
        "total_cycles": seconds + zero,
        "seconds_per_token": seconds + zero,
        "model_bytes": model_bytes + zero,
        "dram_bytes": model_bytes + zero,
    }
    return {k: v[0] for k, v in out.items()} if single else out


class LMRooflineTarget:
    """Weight-bound LM decode roofline as a `HardwareTarget`.

    Same protocol shape as the renderer targets, different workload type:
    `build_workload` takes a `repro_torch.models.common.ModelConfig` and
    returns `LMDecodeWorkload` consts; bit arrays are (embed_band, w, a)
    instead of (hash, w, a). `repro_torch.workloads.lm` is the intended
    consumer. As in the reference, the FFN groups count the config's
    `d_ff` once a layer, also for MoE archs (the experts are not counted).
    """

    def __init__(self, hw: LMRooflineHWConfig = LMRooflineHWConfig(),
                 name: str = "roofline-lm", device: DeviceLike = None):
        self.name = name
        self.hw = hw
        self.device = resolve_device(device)

    def build_workload(self, model_cfg) -> LMDecodeWorkload:
        from repro_torch.models.lm import embed_band_boundaries, total_layers

        cfg = model_cfg
        bounds = embed_band_boundaries(cfg.vocab_size, cfg.n_embed_bands)
        band_rows = np.diff(np.asarray(bounds, np.float64))
        d, hd = cfg.d_model, cfg.head_dim
        glu = cfg.ffn_type in ("swiglu", "geglu")
        group_elems = np.asarray([
            d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd,  # qkv
            cfg.n_heads * hd * d,  # out proj
            d * cfg.d_ff * (2 if glu else 1),  # ffn in (+gate)
            cfg.d_ff * d,  # ffn out
        ], np.float64)
        return LMDecodeWorkload(
            arch=cfg.name,
            n_layers=total_layers(cfg),
            d_model=d,
            band_rows=band_rows.astype(np.float32),
            group_elems=group_elems.astype(np.float32),
        )

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def simulate(self, workload: LMDecodeWorkload, embed_bits, w_bits,
                 a_bits) -> Dict[str, float]:
        r = _lm_decode_metrics(self._t(embed_bits), self._t(w_bits),
                               self._t(a_bits), workload, self.hw)
        return {k: float(v) for k, v in r.items()}

    def baseline(self, workload: LMDecodeWorkload,
                 bits: int = 8) -> Dict[str, float]:
        b = float(bits)
        n_bands = len(workload.band_rows)
        shape = (workload.n_layers, len(workload.group_elems))
        return self.simulate(
            workload, np.full(n_bands, b), np.full(shape, b),
            np.full(shape, b),
        )

    def batched(self, workload: LMDecodeWorkload) -> BatchedHardwareSim:
        hw = self.hw
        return _RooflineBatched(
            lambda eb, wb, ab: _lm_decode_metrics(eb, wb, ab, workload, hw),
            self.device,
        )

    def describe(self) -> Dict:
        return {
            "name": self.name,
            "family": "roofline-lm",
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


def _lm_roofline_factory(preset: LMRooflineHWConfig, name: str):
    def factory(**kw) -> HardwareTarget:
        device = kw.pop("device", None)
        return LMRooflineTarget(dataclasses.replace(preset, **kw), name=name,
                                device=device)
    return factory


register_target(
    "roofline-lm",
    _lm_roofline_factory(LMRooflineHWConfig(), "roofline-lm"),
    "weight-bound LM decode roofline (NVIDIA H100 SXM, 3.35 TB/s HBM "
    "stream of embed-band + per-layer weight bytes; the --workload lm cost "
    "model)",
)
