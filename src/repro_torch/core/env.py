"""NGP quantization environment for the DDPG agent.

One episode = one sequential walk over all quantizable units (hash levels
coarse->fine, then per-MLP-layer activation/weight pairs), mirroring the
paper's "sequentially determining the bit width for each layer across the
entire NeRF architecture". After the walk:

  1. optional latency-constraint enforcement ("dynamically adjusts bit width
     configurations when performance metrics exceed predefined latency
     targets", Sec. IV-C) — greedy bit reduction ordered by per-unit latency
     slope;
  2. QAT finetune of a copy of the pretrained model under the policy
     ("we perform model retraining to restore reconstruction quality");
  3. PSNR on held-out views + latency from the cycle-accurate simulator;
  4. reward Eq. 8 against the all-8-bit baseline.

The env lives on one torch device (the card unless `device="cpu"`): the
parameters, the trace, the finetunes, the PSNR renders and the simulator's
cache walks all run there.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.action import action_to_bits
from repro_torch.core.reward import hero_reward
from repro_torch.hero.targets import HardwareTarget, NeuRexTarget
from repro_torch.hwsim import HWConfig
from repro_torch.kernels.backend import DeviceLike, check_device, resolve_device
from repro_torch.nerf.dataset import NGPDataset
from repro_torch.nerf.ngp import (
    NGPConfig,
    NGPQuantSpec,
    make_quant_units,
    ngp_apply,
    ngp_linear_names,
    spec_from_policy,
)
from repro_torch.nerf.occupancy import bake_occupancy_cached
from repro_torch.nerf.render import RenderConfig
from repro_torch.nerf.train import TrainConfig, evaluate_psnr, finetune_ngp
from repro_torch.quant.policy import QuantPolicy, QuantUnit, UnitKind


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    finetune_steps: int = 40
    latency_target: Optional[float] = None  # cycles; None = unconstrained
    trace_rays: int = 1024  # rays traced for the simulator workload
    calib_points: int = 2048
    b_min: int = 1
    b_max: int = 8
    lam: float = 0.1  # reward scale (Eq. 8); ablated in benchmarks
    # Episode PSNR render engine: "fused" = occupancy-culled integer
    # inference (repro_torch.nerf.fast_render); "reference" = fake-quant
    # oracle.
    render_backend: str = "fused"
    occ_resolution: int = 32
    occ_threshold: float = 1e-2


@dataclasses.dataclass
class EpisodeResult:
    policy: QuantPolicy
    bits: List[int]
    psnr: float
    latency_cycles: float
    model_bytes: float
    reward: float
    fqr: float
    wall_seconds: float


class NGPQuantEnv:
    """Host-side environment; the heavy math runs on the env's device."""

    def __init__(
        self,
        params: Dict,
        dataset: NGPDataset,
        cfg: NGPConfig,
        rcfg: RenderConfig,
        tcfg: TrainConfig,
        ecfg: EnvConfig = EnvConfig(),
        hw_cfg: Optional[HWConfig] = None,
        seed: int = 0,
        target: Optional[HardwareTarget] = None,
        device: DeviceLike = None,
    ):
        """Hardware is injected as a `HardwareTarget` (`target=`, on the
        env's device); the legacy `hw_cfg=` keeps working and means "the
        default NeuRex target under this timing config". Passing both is a
        conflict. `params` must live on `device`."""
        if target is not None and hw_cfg is not None:
            raise ValueError("pass either target= or hw_cfg=, not both")
        self.device = resolve_device(device)
        check_device(params["sigma/0"]["w"], self.device, "the parameters")
        self.params = params  # pretrained full-precision weights (frozen)
        self.dataset = dataset
        self.cfg = cfg
        self.rcfg = rcfg
        self.tcfg = tcfg
        self.ecfg = ecfg
        self.units: List[QuantUnit] = make_quant_units(cfg)
        if target is None:
            target = NeuRexTarget(hw_cfg if hw_cfg is not None else HWConfig(),
                                  device=self.device)
        if target.device.type != self.device.type:
            raise ValueError(f"the hardware target runs on {target.device}, "
                             f"the env on {self.device}")
        self.target: HardwareTarget = target
        rng = np.random.RandomState(seed)

        # Simulator workload trace from real rays of the train set.
        idx = rng.randint(0, dataset.train_rays_o.shape[0], size=ecfg.trace_rays)
        self.trace = self.target.build_workload(
            cfg, rcfg, dataset.train_rays_o[idx], dataset.train_rays_d[idx]
        )

        # Activation-range calibration on real samples (paper Sec. III-C
        # "determined through calibration").
        self.act_ranges = self._calibrate(rng)

        # Occupancy grid baked ONCE from the frozen pretrained geometry;
        # every episode PSNR render culls empty space against it (QAT
        # finetunes are short, so the geometry stays inside the dilated
        # grid). The bake goes through the content-addressed registry so
        # several envs over the same scene (e.g. one per hardware budget)
        # share one grid instead of re-baking.
        # `render_backend="reference"` keeps the dense oracle.
        self.occ = (
            bake_occupancy_cached(
                params, cfg, resolution=ecfg.occ_resolution,
                threshold=ecfg.occ_threshold,
            )
            if ecfg.render_backend == "fused"
            else None
        )

        # Observation normalization constants (per-dim max over units).
        obs = np.asarray([u.observation(1.0) for u in self.units], np.float32)
        self._obs_scale = np.maximum(np.abs(obs).max(axis=0), 1e-6)

        # All-8-bit baseline: original cost + PSNR_org (Sec. III-D).
        base = self.target.baseline(
            self.trace, 8, n_features=cfg.hash.n_features,
            resolutions=cfg.hash.resolutions(),
        )
        self.original_cost = base.total_cycles
        base_policy = QuantPolicy.uniform(self.units, 8)
        base_spec = spec_from_policy(cfg, base_policy, self.act_ranges)
        ft, _ = finetune_ngp(
            dict(params), dataset, cfg, rcfg, tcfg, base_spec,
            ecfg.finetune_steps, device=self.device,
        )
        self.psnr_org = self.eval_psnr(ft, base_spec)

        # Per-unit latency slope (cycles per bit) for constraint enforcement.
        self._latency_slopes = self._estimate_slopes()

    # ------------------------------------------------------------------
    def eval_psnr(self, params: Dict, spec: Optional[NGPQuantSpec]) -> float:
        """Episode PSNR through the configured render engine — the shared
        entry point for baselines and benchmarks as well."""
        return evaluate_psnr(
            params, self.dataset, self.cfg, self.rcfg, spec,
            occ=self.occ, mode=self.ecfg.render_backend, device=self.device,
        )

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _calibrate(self, rng) -> torch.Tensor:
        ds = self.dataset
        idx = rng.randint(0, ds.train_rays_o.shape[0], size=64)
        t = np.linspace(self.rcfg.near, self.rcfg.far, self.rcfg.n_samples)
        pts = (
            ds.train_rays_o[idx][:, None, :]
            + ds.train_rays_d[idx][:, None, :] * t[None, :, None]
        )
        pts = np.clip(pts + 0.5, 0.0, 1.0).reshape(-1, 3)
        dirs = np.broadcast_to(
            ds.train_rays_d[idx][:, None, :], (idx.size, t.size, 3)
        ).reshape(-1, 3)
        n = min(self.ecfg.calib_points, pts.shape[0])
        as_t = lambda a: torch.from_numpy(
            np.ascontiguousarray(a, np.float32)).to(self.device)
        _, _, taps = ngp_apply(
            self.params, as_t(pts[:n]), as_t(dirs[:n]), self.cfg, None,
            return_taps=True,
        )
        names = ngp_linear_names(self.cfg)
        return torch.stack([torch.stack([taps[nm].min(), taps[nm].max()])
                            for nm in names]).to(torch.float32)

    # ------------------------------------------------------------------
    def unit_index_maps(self):
        """Walk-order unit index -> simulator-array position, per kind.

        Returns {"h"|"w"|"a": (unit_indices, positions, width)} — the single
        source of truth for mapping a bits vector onto the simulator's
        (hash_bits, w_bits, a_bits) arrays; shared with BatchedQuantEnv.
        """
        if not hasattr(self, "_unit_maps"):
            names = ngp_linear_names(self.cfg)
            maps = {k: ([], []) for k in ("h", "w", "a")}
            for i, u in enumerate(self.units):
                if u.kind == UnitKind.HASH_LEVEL:
                    key, pos = "h", u.param_size  # param_size = level index
                else:
                    key = "w" if u.kind == UnitKind.WEIGHT else "a"
                    pos = names.index(u.name.rsplit(":", 1)[0])
                maps[key][0].append(i)
                maps[key][1].append(pos)
            widths = {"h": self.cfg.hash.n_levels, "w": len(names), "a": len(names)}
            self._unit_maps = {
                k: (np.asarray(idx), np.asarray(pos), widths[k])
                for k, (idx, pos) in maps.items()
            }
        return self._unit_maps

    def _policy_arrays(self, policy: QuantPolicy):
        assert [u.name for u in policy.units] == [u.name for u in self.units], (
            "policy units must be in the env's walk order"
        )
        bits = np.asarray([float(u.bits) for u in policy.units])
        maps = self.unit_index_maps()
        out = []
        for key in ("h", "w", "a"):
            unit_idx, pos, width = maps[key]
            arr = np.full(width, 8.0)
            arr[pos] = bits[unit_idx]
            out.append(list(arr))
        return tuple(out)

    def simulate_policy(self, policy: QuantPolicy):
        hb, wb, ab = self._policy_arrays(policy)
        return self.target.simulate(
            self.trace, hb, wb, ab, n_features=self.cfg.hash.n_features,
            resolutions=self.cfg.hash.resolutions(),
        )

    def _estimate_slopes(self) -> np.ndarray:
        """cycles/bit per unit, measured by dropping each unit 8 -> 4 bits."""
        base = self.original_cost
        slopes = np.zeros(len(self.units))
        eight = QuantPolicy.uniform(self.units, 8)
        for i, u in enumerate(self.units):
            bits = [8] * len(self.units)
            bits[i] = 4
            r = self.simulate_policy(eight.with_bits(bits))
            slopes[i] = max(base - r.total_cycles, 0.0) / 4.0
        return slopes

    # ------------------------------------------------------------------
    # Observations
    # ------------------------------------------------------------------
    def observation(self, unit_index: int, prev_action: float) -> np.ndarray:
        raw = np.asarray(
            self.units[unit_index].observation(prev_action), np.float32
        )
        return raw / self._obs_scale

    @property
    def n_units(self) -> int:
        return len(self.units)

    @property
    def scene_name(self) -> str:
        """Scene identity of the workload this env scores (dataset-derived)."""
        return self.dataset.scene_name

    @property
    def sim(self):
        """Legacy alias for the scalar simulator of a NeuRex-family target.

        New code should use `self.target` (`HardwareTarget` protocol);
        non-NeuRex targets have no `NeuRexSimulator` to expose."""
        sim = getattr(self.target, "sim", None)
        if sim is None:
            raise AttributeError(
                f"hardware target {self.target.name!r} exposes no scalar "
                "NeuRex simulator; use env.target"
            )
        return sim

    def set_latency_target(self, target: Optional[float]) -> None:
        """Deprecated: mutate the env-default hardware budget.

        The budget is *search state*, not env identity — pass it per call
        instead (`hero_search(..., latency_target=...)`,
        `enforce_latency_target(bits, target=...)`,
        `evaluate_population(..., latency_target=...)`), which lets one
        env serve many budgets concurrently."""
        warnings.warn(
            "NGPQuantEnv.set_latency_target is deprecated; pass "
            "latency_target per call (hero_search / enforce_latency_target /"
            " evaluate_population) instead of mutating the env",
            DeprecationWarning,
            stacklevel=2,
        )
        self.ecfg = dataclasses.replace(self.ecfg, latency_target=target)

    # ------------------------------------------------------------------
    # Constraint enforcement (resource-constrained search)
    # ------------------------------------------------------------------
    _UNSET = object()

    def enforce_latency_target(
        self, bits: List[int], target=_UNSET
    ) -> List[int]:
        """Greedy bit reduction until `target` cycles is met. `target`
        defaults to the env-configured budget; pass it explicitly to score
        the same env under several hardware budgets."""
        if target is NGPQuantEnv._UNSET:
            target = self.ecfg.latency_target
        if target is None:
            return bits
        bits = list(bits)
        policy = QuantPolicy.uniform(self.units, 8).with_bits(bits)
        lat = self.simulate_policy(policy).total_cycles
        # Greedy: reduce the unit with the best predicted cycles/bit first;
        # re-simulate after each sweep to stay honest to the cache model.
        guard = 0
        while lat > target and guard < 8 * len(bits):
            order = np.argsort(-self._latency_slopes)
            changed = False
            predicted = lat
            for i in order:
                if predicted <= target:
                    break
                if bits[i] > self.ecfg.b_min:
                    bits[i] -= 1
                    predicted -= self._latency_slopes[i]
                    changed = True
            if not changed:
                break
            policy = policy.with_bits(bits)
            lat = self.simulate_policy(policy).total_cycles
            guard += 1
        return bits

    # ------------------------------------------------------------------
    # Episode evaluation
    # ------------------------------------------------------------------
    def evaluate_bits(
        self, bits: Sequence[int], finetune_steps: Optional[int] = None
    ) -> EpisodeResult:
        t0 = time.time()
        steps = self.ecfg.finetune_steps if finetune_steps is None else finetune_steps
        policy = QuantPolicy.uniform(self.units, 8).with_bits(list(bits))
        spec = spec_from_policy(self.cfg, policy, self.act_ranges)

        ft_params, _ = finetune_ngp(
            dict(self.params), self.dataset, self.cfg, self.rcfg, self.tcfg,
            spec, steps, device=self.device,
        )
        psnr = self.eval_psnr(ft_params, spec)
        lat = self.simulate_policy(policy)
        reward = hero_reward(psnr, self.psnr_org, lat.total_cycles,
                             self.original_cost, lam=self.ecfg.lam)
        return EpisodeResult(
            policy=policy,
            bits=list(bits),
            psnr=psnr,
            latency_cycles=lat.total_cycles,
            model_bytes=lat.model_bytes,
            reward=reward,
            fqr=policy.fqr(),
            wall_seconds=time.time() - t0,
        )

    def actions_to_bits(self, actions: Sequence[float]) -> List[int]:
        return [
            action_to_bits(a, self.ecfg.b_min, self.ecfg.b_max) for a in actions
        ]
