"""The `Workload` protocol: what the HERO closed loop needs from a task.

Nothing in the closed loop — population CEM + DDPG proposals, Pareto
frontier with exact hypervolume, cell-granular checkpoint/resume — is
NeRF-specific. A workload packages the five things the loop consumes for
one *case* (a NeRF scene name) behind one bundle:

  1. policy shape    — bit-vector layout + bounds (`policy_shape`,
                       `env.n_units`, `env.ecfg.b_min/b_max`)
  2. quality proxy   — batched ranking signal
                       (`benv.proxy_quality`, `benv.evaluate_population`)
  3. full eval       — exact per-policy quality (`env.evaluate_bits`)
  4. hardware cost   — a registered `HardwareTarget` adapter
                       (`benv.simulate_batch`, `env.original_cost`)
  5. baseline anchor — the all-8-bit point every objective is normalized
                       against (`bundle.baseline_point/normalize`)

The loop drives the bundle duck-typed, through exactly the surface
`hero_population_search` and `HeroSearchRun` use:

  env:  `n_units`, `ecfg.b_min/b_max/lam/latency_target`, `device`,
        `observation(i, prev)` (7-dim, `DDPGConfig.obs_dim`),
        `actions_to_bits`, `enforce_latency_target(bits, target=)`,
        `evaluate_bits(bits)`, `original_cost`, `params`
  benv: `env`, `sharded`, `evaluate_population(bits, latency_target=)`
        -> `repro_torch.core.batched_env.PopulationEval`, `simulate_batch`,
        `proxy_quality(params, bits_batch)`, `psnr_org_proxy`

A bundle lives on one torch device, its env's: the searches over it run
there. Implementations live next door (`repro_torch.workloads.nerf`) and
are resolved by name through the registry in
`repro_torch.workloads.__init__` (`ClosedLoopConfig.workload`).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Optional, Protocol, Tuple, runtime_checkable

from repro_torch.kernels.backend import DeviceLike

if TYPE_CHECKING:  # repro_torch.core imports this module at package-init time
    from repro_torch.core.pareto import ParetoPoint


@dataclasses.dataclass(frozen=True)
class PolicyShape:
    """Bit-vector layout of one case: how many decisions the episode walk
    makes and the bounds each one is clipped to (Eq. 3)."""

    n_units: int
    b_min: int
    b_max: int
    labels: Tuple[str, ...] = ()  # per-unit names, len == n_units when set


@dataclasses.dataclass
class WorkloadBundle:
    """Everything the loop needs per case, built once and shared across
    budgets: the scalar env (full-fidelity eval, constraint enforcement,
    8-bit baselines) and its batched population wrapper.

    `scene` is the case name; the frontier tags and checkpoint scene_meta
    key on it (the checkpoint schema-v2 wire name).
    """

    scene: str
    env: Any
    benv: Any
    baseline_latency: float  # all-8-bit cost (env.original_cost)
    baseline_psnr: float  # all-8-bit quality through the proxy
    # All-8-bit model size — the denominator of the joint frontier's size
    # ratio (for NeRF, the PACKED artifact bytes).
    baseline_bytes: float

    def baseline_point(self) -> "ParetoPoint":
        from repro_torch.core.pareto import ParetoPoint

        return ParetoPoint(
            latency=self.baseline_latency,
            psnr=self.baseline_psnr,
            model_bytes=self.baseline_bytes,
            bits=tuple([8] * self.env.n_units),
            scene=self.scene,
            reward=0.0,
        )

    def normalize(self, p: "ParetoPoint") -> "ParetoPoint":
        """Raw metrics -> case-normalized objectives (cross-case joint
        frontier): latency/size as ratios vs the 8-bit baseline, quality
        as a delta against the 8-bit proxy quality."""
        return dataclasses.replace(
            p,
            latency=p.latency / self.baseline_latency,
            psnr=p.psnr - self.baseline_psnr,
            model_bytes=p.model_bytes / self.baseline_bytes,
        )


@runtime_checkable
class Workload(Protocol):
    """One task family the closed loop can search over."""

    kind: str  # registry name ("nerf", "lm")
    default_hardware: str  # registered HardwareTarget the family scores on

    def policy_shape(self, case: str, scale: Any = None) -> PolicyShape:
        """Cheap (no training / param init) layout of `case`'s bit vector."""
        ...

    def build_bundle(
        self,
        case: str,
        *,
        scale: Any = None,
        seed: int = 0,
        sharded: Optional[bool] = None,
        hardware: Any = None,
        device: DeviceLike = None,
    ) -> WorkloadBundle:
        """Build the case's env + batched env + 8-bit baselines on
        `device` (the card unless "cpu").

        `hardware` is a registered target name or `HardwareTarget`
        instance; None means the workload's `default_hardware`. `scale`
        is the family's env-building knob object (`SceneScale` for NeRF);
        None means the family default.
        """
        ...
