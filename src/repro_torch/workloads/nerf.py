"""NeRF scene workload: the original HERO task behind the protocol.

A pure adapter — `build_bundle` IS `repro_torch.core.closed_loop
.build_scene_bundle`, so frontiers and checkpoint fingerprints are those
of the closed loop's own scene bundles.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.kernels.backend import DeviceLike
from repro_torch.workloads.base import PolicyShape, WorkloadBundle


class NerfSceneWorkload:
    kind = "nerf"
    default_hardware = "neurex"

    def policy_shape(self, case: str, scale: Any = None) -> PolicyShape:
        """Unit layout without training a scene: the walk order is a pure
        function of the NGP config the scale implies (hash levels
        coarse->fine, then per-MLP-layer activation/weight pairs)."""
        from repro_torch.core.closed_loop import SceneScale, scene_configs
        from repro_torch.core.env import EnvConfig
        from repro_torch.nerf.ngp import make_quant_units

        scale = scale if scale is not None else SceneScale()
        cfg, _, _ = scene_configs(scale)
        units = make_quant_units(cfg)
        ecfg = EnvConfig()
        return PolicyShape(
            n_units=len(units), b_min=ecfg.b_min, b_max=ecfg.b_max,
            labels=tuple(u.name for u in units),
        )

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
        from repro_torch.core.closed_loop import SceneScale, build_scene_bundle

        return build_scene_bundle(
            case,
            scale if scale is not None else SceneScale(),
            seed=seed,
            sharded=sharded,
            hardware=hardware if hardware is not None
            else self.default_hardware,
            device=device,
        )

    def describe(self) -> dict:
        return {"kind": self.kind}
