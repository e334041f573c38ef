"""`repro_torch.hero` facade: search -> compile -> serve.

The three documented entry points:

  result   = hero.search(scenes=..., budget_fracs=..., hardware="neurex")
  artifact = hero.compile(env_or_bundle, bits)      # or hero.compile_scene
  service  = hero.serve(artifact)                   # request-batching renderer

`search` wraps the closed-loop multi-scene search (`core/closed_loop.py`),
`compile` lowers a policy to a deployable `QuantArtifact`, and `serve`
stands up the batched fused render service. Everything underneath stays
importable — these are thin, stable names, not a new layer of behavior.
`search`, `compile_scene` and `serve` run on the card unless given
`device="cpu"`; `compile` runs on its env's device.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

from repro_torch.hero.artifact import QuantArtifact, compile_artifact
from repro_torch.hero.engine import EngineConfig, ServeEngine, serve_engine
from repro_torch.hero.service import RenderService, ServeConfig
from repro_torch.hero.service import serve as _serve
from repro_torch.hero.targets import HardwareTarget
from repro_torch.kernels.backend import DeviceLike


def search(
    scenes: Sequence[str] = ("chair", "lego"),
    budget_fracs: Sequence[float] = (1.0, 0.85),
    *,
    workload: str = "nerf",
    hardware: Union[str, HardwareTarget, None] = None,
    scale=None,  # SceneScale; None = SceneScale.quick()
    n_iterations: int = 4,
    population: int = 8,
    agent_fraction: float = 0.5,
    seed: int = 0,
    sharded: Optional[bool] = None,
    checkpoint_path: Optional[str] = None,
    verbose: bool = True,
    stop_after_cells: Optional[int] = None,
    device: DeviceLike = None,
):
    """Closed-loop HERO search over cases x latency budgets, on `device`.

    Returns a `ClosedLoopResult` (joint + per-case Pareto frontiers,
    per-cell summaries). `workload` picks the task family (see
    `repro_torch.workloads.list_workloads()`). `hardware` is a registered
    target name (see `repro_torch.hero.list_targets()`) or a
    `HardwareTarget` instance on `device`; None uses the workload's
    default.
    """
    from repro_torch.core.closed_loop import (
        ClosedLoopConfig,
        HeroSearchRun,
        SceneScale,
    )
    from repro_torch.workloads import get_workload

    if scale is None:
        scale = SceneScale.quick()
    if hardware is None:
        hardware = get_workload(workload).default_hardware
    hw_name = hardware if isinstance(hardware, str) else hardware.name
    cfg = ClosedLoopConfig(
        scenes=tuple(scenes),
        budget_fracs=tuple(float(b) for b in budget_fracs),
        seed=seed,
        scale=scale,
        n_iterations=n_iterations,
        population=population,
        agent_fraction=agent_fraction,
        sharded=sharded,
        checkpoint_path=checkpoint_path,
        verbose=verbose,
        hardware=hw_name,
        workload=workload,
    )
    run = HeroSearchRun(
        cfg, target=None if isinstance(hardware, str) else hardware,
        device=device,
    )
    return run.run(stop_after_cells=stop_after_cells)


def compile(  # noqa: A001 — the documented entry-point name
    env_or_bundle,
    bits: Optional[Sequence[int]] = None,
    finetune_steps: Optional[int] = None,
) -> QuantArtifact:
    """Lower (scene env, policy bits) to a deployable `QuantArtifact`, on
    the env's device.

    Accepts an `NGPQuantEnv` or a closed-loop `SceneBundle`; `bits=None`
    compiles uniform 8-bit.
    """
    env = getattr(env_or_bundle, "env", env_or_bundle)
    return compile_artifact(env, bits, finetune_steps=finetune_steps)


def compile_scene(
    scene: str,
    bits: Optional[Sequence[int]] = None,
    *,
    scale=None,  # SceneScale; None = SceneScale.quick()
    hardware: Union[str, HardwareTarget] = "neurex",
    seed: int = 0,
    finetune_steps: Optional[int] = None,
    device: DeviceLike = None,
) -> QuantArtifact:
    """Train the scene's NGP, build its quantization env, and compile
    `bits` in one call, on `device` — the from-scratch path."""
    from repro_torch.core.closed_loop import SceneScale, build_scene_env

    if scale is None:
        scale = SceneScale.quick()
    env = build_scene_env(scene, scale, seed=seed, hardware=hardware,
                          device=device)
    return compile_artifact(env, bits, finetune_steps=finetune_steps)


def serve(
    artifacts,
    cfg=None,
    warmup: bool = True,
    *,
    loader=None,
    cache_bytes: Optional[int] = None,
    device: DeviceLike = None,
) -> Union[RenderService, ServeEngine]:
    """Stand up the batched fused render serving layer on `device` (the
    card unless "cpu"; the artifacts must be loaded there).

    One `QuantArtifact` -> the single-artifact `RenderService` facade. A
    dict/list of artifacts -> the multi-scene `ServeEngine` (continuous
    batching across scenes, LRU artifact cache with `loader` on miss and
    `cache_bytes` eviction budget, streaming `poll()`). `cfg` is a
    `ServeConfig` (shared knobs) or, for the engine, an `EngineConfig`
    directly.
    """
    if isinstance(artifacts, QuantArtifact):
        return _serve(artifacts, cfg or ServeConfig(), warmup=warmup,
                      device=device)
    if isinstance(cfg, EngineConfig):
        ecfg = cfg
    else:
        ecfg = (cfg or ServeConfig()).engine_config(cache_bytes=cache_bytes)
    return serve_engine(artifacts, ecfg, loader=loader, warmup=warmup,
                        device=device)


def best_bits(result, scene: Optional[str] = None) -> Tuple[str, List[int]]:
    """(scene, bits) of the highest-reward cell in a search result —
    the natural input to `hero.compile`."""
    cells = result.cells
    if scene is not None:
        cells = [c for c in cells if c.scene == scene]
    if not cells:
        raise ValueError(f"no completed search cells for scene={scene!r}")
    top = max(cells, key=lambda c: c.best_reward)
    return top.scene, list(top.best_bits)
