"""Workload registry: `ClosedLoopConfig.workload` name -> `Workload`.

Factories import lazily so `repro_torch.core.closed_loop` can depend on
this package (for `WorkloadBundle` and by-name resolution) while the
concrete workloads depend back on `repro_torch.core` without a cycle.

The registry lists the same names and descriptions as the JAX package's:
`nerf` (`repro_torch.workloads.nerf`) and `lm`
(`repro_torch.workloads.lm`).
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.workloads.base import PolicyShape, Workload, WorkloadBundle

_WORKLOAD_REGISTRY: Dict[str, tuple] = {}  # name -> (factory, description)


def register_workload(name: str, factory: Callable[..., Workload],
                      description: str = "") -> None:
    """Register a workload factory under `name`. Factories take keyword
    overrides and return a fresh `Workload`."""
    _WORKLOAD_REGISTRY[name] = (factory, description)


def get_workload(name: str, **overrides) -> Workload:
    """Instantiate a registered workload by name."""
    if name not in _WORKLOAD_REGISTRY:
        known = ", ".join(sorted(_WORKLOAD_REGISTRY))
        raise KeyError(
            f"unknown workload {name!r} (registered: {known})"
        )
    factory, _ = _WORKLOAD_REGISTRY[name]
    return factory(**overrides)


def list_workloads() -> Dict[str, str]:
    """name -> one-line description of every registered workload."""
    return {k: d for k, (_, d) in sorted(_WORKLOAD_REGISTRY.items())}


def _nerf_factory(**kw) -> Workload:
    from repro_torch.workloads.nerf import NerfSceneWorkload

    return NerfSceneWorkload(**kw)


def _lm_factory(**kw) -> Workload:
    from repro_torch.workloads.lm import LMWorkload

    return LMWorkload(**kw)


register_workload(
    "nerf", _nerf_factory,
    "NeRF scene quantization (hash levels + MLP W/A bits, NeuRex-family "
    "targets) — the paper's original task",
)
register_workload(
    "lm", _lm_factory,
    "LM quantization (embed-band + per-layer W/A bits, real forward-pass "
    "loss deltas, roofline-lm decode cost)",
)

__all__ = [
    "PolicyShape",
    "Workload",
    "WorkloadBundle",
    "register_workload",
    "get_workload",
    "list_workloads",
]
