"""Closed-loop multi-scene HERO search: the end-to-end product.

`hero_population_search` optimizes ONE scene under ONE hardware budget.
The paper (and the accelerator co-design work it sits in — FlexNeRFer,
Gen-NeRF) frames the real problem as navigating a multi-workload design
space under several hardware budgets at once. `HeroSearchRun` composes
the pieces into that loop:

  scene grid ──► per-case workload bundle (`repro_torch.workloads`): the
                 NeRF workload trains an NGPQuantEnv per scene (shared
                 occupancy bake, one BatchedQuantEnv each); the LM
                 workload builds an LMQuantEnv per arch id
  budget grid ─► per-cell `hero_population_search` with the budget passed
                 as call state (no env mutation, envs are shared)
  every evaluated policy ─► per-scene raw `ParetoFrontier` + one joint
                 frontier over scene-normalized objectives (latency ratio
                 and PSNR delta vs that scene's all-8-bit baseline)

The loop itself is workload-generic: everything below drives the bundle
through the duck-typed surface documented in `repro_torch.workloads.base`.

The run is a deterministic function of its seed: cells execute in a fixed
order with seeds derived per (scene, budget) cell, every stochastic
component below (CEM sampling, DDPG init/noise, proxy-ray choice, NGP
training) is seeded, and frontier contents are insertion-order invariant.
Checkpointing is cell-granular: after each cell the cell outputs and the
completed-cell set are written atomically (tmp + rename, JSON); a resumed
run skips completed cells and reproduces the uninterrupted run's frontier
exactly.

A run lives on one torch device (the card unless `device="cpu"`): its
bundles are built there and every cell's search runs on its bundle's
env's device. The device is not part of the run's identity: it enters
neither `ClosedLoopConfig.fingerprint()` nor the checkpoint, which is the
JAX package's schema v2 key for key, so a checkpoint written on one
device (or by the JAX package, for a by-name target) resumes on another.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.batched_env import BatchedEnvConfig, BatchedQuantEnv
from repro_torch.core.ddpg import DDPGConfig
from repro_torch.core.env import EnvConfig, NGPQuantEnv
from repro_torch.core.pareto import ConstraintSet, ParetoFrontier, ParetoPoint
from repro_torch.core.search import PopulationSearchConfig, hero_population_search
from repro_torch.distributed.population import auto_shard
from repro_torch.hero.targets import HardwareTarget, resolve_target
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.workloads.base import Workload, WorkloadBundle

# The scene bundle IS the generic workload bundle.
SceneBundle = WorkloadBundle

# Joint-frontier hypervolume reference (normalized objectives): latency
# ratio <= 1x the 8-bit baseline, PSNR delta >= -5 dB, size ratio <= 1.
DEFAULT_HV_REF = (1.0, -5.0, 1.0)


# ---------------------------------------------------------------------------
# Scene bundles
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SceneScale:
    """Env-building knobs shared by every scene of a run (`tiny` exists
    for the test suite)."""

    image_hw: int = 24
    n_train_views: int = 5
    n_test_views: int = 2
    n_levels: int = 4
    log2_table: int = 9
    max_res: int = 32
    hidden: int = 16
    n_samples: int = 16
    train_steps: int = 120
    finetune_steps: int = 8
    trace_rays: int = 256
    proxy_rays: int = 256

    @staticmethod
    def quick() -> "SceneScale":
        return SceneScale()

    @staticmethod
    def standard() -> "SceneScale":
        """The benchmark 'standard' scale of the JAX package."""
        return SceneScale(
            image_hw=32, n_train_views=8, n_levels=8, log2_table=11,
            max_res=64, hidden=32, n_samples=24, train_steps=300,
            finetune_steps=14, trace_rays=512, proxy_rays=512,
        )

    @staticmethod
    def tiny() -> "SceneScale":
        return SceneScale(
            image_hw=12, n_train_views=3, n_test_views=2, train_steps=20,
            finetune_steps=2, trace_rays=32, proxy_rays=64, n_samples=8,
        )


def scene_configs(scale: SceneScale, seed: int = 0):
    """(NGPConfig, RenderConfig, TrainConfig) a scene env of `scale` is
    trained and scored at."""
    from repro_torch.nerf.hash_encoding import HashEncodingConfig
    from repro_torch.nerf.ngp import NGPConfig
    from repro_torch.nerf.render import RenderConfig
    from repro_torch.nerf.train import TrainConfig

    cfg = NGPConfig(
        hash=HashEncodingConfig(
            n_levels=scale.n_levels, log2_table_size=scale.log2_table,
            base_resolution=4, max_resolution=scale.max_res,
        ),
        hidden_dim=scale.hidden, color_hidden_dim=scale.hidden,
        geo_feat_dim=15, sh_degree=3,
    )
    rcfg = RenderConfig(n_samples=scale.n_samples)
    tcfg = TrainConfig(steps=scale.train_steps, batch_rays=512, lr=5e-3,
                       seed=seed)
    return cfg, rcfg, tcfg


def scene_env(
    params,
    dataset,
    scale: SceneScale = SceneScale(),
    seed: int = 0,
    render_backend: str = "fused",
    hardware: Union[str, HardwareTarget, None] = "neurex",
    device: DeviceLike = None,
) -> NGPQuantEnv:
    """The quantization env of a trained field (`params` on `device`) and
    its dataset at `scale`: what `build_scene_env` builds after training."""
    dev = resolve_device(device)
    cfg, rcfg, tcfg = scene_configs(scale, seed)
    target = resolve_target(
        hardware, coarse_levels=min(8, scale.n_levels // 2), device=dev,
    )
    return NGPQuantEnv(
        params, dataset, cfg, rcfg, tcfg,
        EnvConfig(
            finetune_steps=scale.finetune_steps, trace_rays=scale.trace_rays,
            render_backend=render_backend,
        ),
        seed=seed,
        target=target,
        device=dev,
    )


def build_scene_env(
    scene: str,
    scale: SceneScale = SceneScale(),
    seed: int = 0,
    render_backend: str = "fused",
    hardware: Union[str, HardwareTarget, None] = "neurex",
    device: DeviceLike = None,
) -> NGPQuantEnv:
    """Train a small NGP on `scene` and build its quantization env, on
    `device` (the card unless "cpu").

    `hardware` is a registered target name or a `HardwareTarget` instance
    on that device (see `repro_torch.hero.targets`). Name resolution
    passes a `coarse_levels` override scaled to the scene's hash levels;
    targets without that knob (e.g. the roofline family) ignore it.
    """
    from repro_torch.nerf.dataset import make_dataset
    from repro_torch.nerf.scenes import SceneConfig
    from repro_torch.nerf.train import train_ngp

    dev = resolve_device(device)
    ds = make_dataset(SceneConfig(
        name=scene, image_hw=scale.image_hw,
        n_train_views=scale.n_train_views, n_test_views=scale.n_test_views,
    ), device=dev)
    cfg, rcfg, tcfg = scene_configs(scale, seed)
    params, _ = train_ngp(ds, cfg, rcfg, tcfg, device=dev)
    return scene_env(params, ds, scale, seed=seed,
                     render_backend=render_backend, hardware=hardware,
                     device=dev)


def scene_bundle(env: NGPQuantEnv, benv: BatchedQuantEnv) -> SceneBundle:
    """Wrap a scene's env and batched env with their 8-bit anchors."""
    eight = benv.simulate_batch(np.full((1, env.n_units), 8, np.int32))
    return SceneBundle(
        scene=env.scene_name,  # keyed on the env's identity
        env=env,
        benv=benv,
        baseline_latency=float(env.original_cost),
        baseline_psnr=float(benv.psnr_org_proxy),
        baseline_bytes=float(eight["model_bytes"][0]),
    )


def build_scene_bundle(
    scene: str,
    scale: SceneScale = SceneScale(),
    seed: int = 0,
    sharded: Optional[bool] = None,
    render_backend: str = "fused",
    hardware: Union[str, HardwareTarget, None] = "neurex",
    device: DeviceLike = None,
) -> SceneBundle:
    """Train a small NGP on `scene` and wrap it in env + batched env, on
    `device` (the card unless "cpu")."""
    env = build_scene_env(
        scene, scale, seed=seed, render_backend=render_backend,
        hardware=hardware, device=device,
    )
    benv = BatchedQuantEnv(
        env, BatchedEnvConfig(proxy_rays=scale.proxy_rays, seed=seed),
        sharded=sharded, device=env.device,
    )
    return scene_bundle(env, benv)


# ---------------------------------------------------------------------------
# The closed loop
# ---------------------------------------------------------------------------
def _cell_name(scene: str, frac: float) -> str:
    """Checkpoint key of one (scene, budget) cell — the single format the
    `completed` list is matched against across interrupted runs."""
    return f"{scene}@{frac:g}"


def _insert_unless_present(frontier: ParetoFrontier, p: ParetoPoint) -> bool:
    """Insert `p` unless an identical point (same objectives AND identity
    tags) already survives — equal vectors tie rather than evict, so a
    checkpoint-restored anchor would otherwise duplicate on resume."""
    for q in frontier:
        if (
            q.objectives() == p.objectives()
            and q.scene == p.scene
            and q.bits == p.bits
        ):
            return False
    return frontier.insert(p)


@dataclasses.dataclass(frozen=True)
class ClosedLoopConfig:
    scenes: Tuple[str, ...] = ("chair", "lego")
    # Latency budgets as fractions of each scene's all-8-bit latency.
    budget_fracs: Tuple[float, ...] = (1.0, 0.85)
    seed: int = 0
    scale: SceneScale = SceneScale()
    # Per-cell population search shape.
    n_iterations: int = 4
    population: int = 8
    agent_fraction: float = 0.5
    # None = split each population over the visible cards iff the run is
    # on a card and the host has more than one (`auto_shard`).
    sharded: Optional[bool] = None
    checkpoint_path: Optional[str] = None
    verbose: bool = True
    # Registered hardware-target name scene envs are built against (see
    # repro_torch.hero.targets); part of the checkpoint fingerprint because
    # the frontier's latency axis means nothing across targets.
    hardware: str = "neurex"
    # Registered workload name (`repro_torch.workloads`): what kind of task
    # the `scenes` entries name — NeRF scene names or LM arch ids.
    workload: str = "nerf"

    def fingerprint(self) -> Dict:
        """Config identity a checkpoint must match to be resumable (the
        JAX package's, key for key). The `workload` key is only present
        for non-NeRF runs."""
        fp = {
            "scenes": list(self.scenes),
            "budget_fracs": [float(f) for f in self.budget_fracs],
            "seed": self.seed,
            "scale": dataclasses.asdict(self.scale),
            "n_iterations": self.n_iterations,
            "population": self.population,
            "agent_fraction": self.agent_fraction,
            "hardware": self.hardware,
        }
        if self.workload != "nerf":
            fp["workload"] = self.workload
        return fp


# ---------------------------------------------------------------------------
# Cells: the unit of work and of checkpointing
# ---------------------------------------------------------------------------
# Checkpoint schema: v2 stores per-cell outputs (plus the scene-level
# constants needed to merge them) instead of the merged frontier, so a
# resumed run rebuilds the joint frontier by replaying cell merges in
# CANONICAL cell order and is exactly equal to the uninterrupted run.
# Unknown/older versions are quarantined like corrupt files.
CHECKPOINT_VERSION = 2


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """One (scene, budget) cell — the unit of work the loop leases,
    executes and checkpoints."""

    scene: str
    scene_idx: int
    budget_idx: int
    budget_frac: float
    seed: int

    @property
    def name(self) -> str:
        return _cell_name(self.scene, self.budget_frac)

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict) -> "CellSpec":
        return CellSpec(**d)


@dataclasses.dataclass
class CellOutput:
    """Everything one executed cell contributes to the run, as plain data
    (JSON round-trip: Python floats and ints only, never a tensor or a
    numpy scalar): the evaluated points in emission order — each with the
    cumulative in-cell evaluation seconds at emission (`t_emit`), the time
    base of `seconds_to_fixed_bit` — plus the search summary."""

    cell: str
    scene: str
    budget_frac: float
    latency_target: float
    seed: int
    best_reward: float
    best_bits: List[int]
    policies_evaluated: int
    wall_seconds: float
    sharded: bool
    points: List[Dict]

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict) -> "CellOutput":
        return CellOutput(**d)


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Scene-level constants the merge needs — the 8-bit anchor/baselines
    (the joint frontier's normalization) and the uniform fixed-bit
    competitor — as plain data, so a resumed run can replay checkpointed
    cell outputs WITHOUT rebuilding (re-training) the scene bundle."""

    scene: str
    n_units: int
    baseline_latency: float
    baseline_psnr: float
    baseline_bytes: float
    fixed_bits: int
    fixed_latency: float
    fixed_psnr: float
    fixed_bytes: float

    @staticmethod
    def from_bundle(bundle: "SceneBundle", fixed: ParetoPoint) -> "SceneMeta":
        return SceneMeta(
            scene=bundle.scene,
            n_units=bundle.env.n_units,
            baseline_latency=bundle.baseline_latency,
            baseline_psnr=bundle.baseline_psnr,
            baseline_bytes=bundle.baseline_bytes,
            fixed_bits=int(fixed.bits[0]),
            fixed_latency=fixed.latency,
            fixed_psnr=fixed.psnr,
            fixed_bytes=fixed.model_bytes,
        )

    def baseline_point(self) -> ParetoPoint:
        return ParetoPoint(
            latency=self.baseline_latency,
            psnr=self.baseline_psnr,
            model_bytes=self.baseline_bytes,
            bits=tuple([8] * self.n_units),
            scene=self.scene,
            reward=0.0,
        )

    def fixed_point(self) -> ParetoPoint:
        return ParetoPoint(
            latency=self.fixed_latency,
            psnr=self.fixed_psnr,
            model_bytes=self.fixed_bytes,
            bits=tuple([self.fixed_bits] * self.n_units),
            scene=self.scene,
        )

    def normalize(self, p: ParetoPoint) -> ParetoPoint:
        """Identical to `SceneBundle.normalize` (raw -> scene-normalized)."""
        return dataclasses.replace(
            p,
            latency=p.latency / self.baseline_latency,
            psnr=p.psnr - self.baseline_psnr,
            model_bytes=p.model_bytes / self.baseline_bytes,
        )

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict) -> "SceneMeta":
        return SceneMeta(**d)


@dataclasses.dataclass
class CellResult:
    """Summary of one (scene, budget) population search."""

    scene: str
    budget_frac: float
    latency_target: float
    best_reward: float
    best_bits: List[int]
    policies_evaluated: int
    admitted_to_frontier: int
    search_seconds: float

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict) -> "CellResult":
        return CellResult(**d)


@dataclasses.dataclass
class ClosedLoopResult:
    frontier: ParetoFrontier  # joint, scene-normalized objectives
    scene_frontiers: Dict[str, ParetoFrontier]  # raw objectives per scene
    cells: List[CellResult]
    policies_evaluated: int
    search_seconds: float  # population-search time only (policies/sec base)
    wall_seconds: float  # including env building
    resumed_cells: int  # cells restored from a checkpoint, not re-run
    # Wall-clock (search time) until some evaluated policy dominated-or-
    # tied the CAQ-style uniform fixed-bit reference; None if never.
    seconds_to_fixed_bit: Optional[float]
    fixed_bit_reference: int
    # True iff every population evaluator that EXECUTED cells in this run
    # split its populations over devices; None when the run was fully
    # resumed.
    sharded: Optional[bool] = None
    # The type of the torch device the run lived on ("cuda" or "cpu");
    # `bench_report` counts that kind's devices.
    device: Optional[str] = None

    @property
    def policies_per_sec(self) -> float:
        return self.policies_evaluated / max(self.search_seconds, 1e-9)

    def hypervolume(self, ref=DEFAULT_HV_REF) -> float:
        return self.frontier.hypervolume(ref)


class HeroSearchRun:
    """Driver for one closed-loop run over scenes x hardware budgets.

    Scene bundles may be injected (`bundles=`) to share trained envs
    across runs; otherwise they are built lazily with seeds derived from
    the run seed. Injected or built, envs are never mutated — budgets
    travel as call arguments — so one bundle set can serve many runs.
    """

    FIXED_BIT_REFERENCE = 6  # CAQ-style uniform fixed-bit competitor

    def __init__(
        self,
        cfg: ClosedLoopConfig = ClosedLoopConfig(),
        bundles: Optional[Dict[str, SceneBundle]] = None,
        target: Optional[HardwareTarget] = None,
        workload: Optional[Workload] = None,
        device: DeviceLike = None,
    ):
        """`target=` injects a `HardwareTarget` INSTANCE for scene-env
        building (overriding the by-name `cfg.hardware` resolution).
        `workload=` likewise injects a `Workload` INSTANCE (e.g. an
        `LMWorkload` with non-default eval knobs). The run lives
        on `device` (the card unless "cpu"): built bundles are built
        there, and injected ones must live there."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self._bundles: Dict[str, SceneBundle] = dict(bundles or {})
        for name, b in self._bundles.items():
            if b.env.device.type != self.device.type:
                raise ValueError(f"the bundle of {name!r} lives on "
                                 f"{b.env.device}, the run on {self.device}")
        self._target = target
        self._workload = workload
        # Scene merge constants, gathered from built bundles or restored
        # from a checkpoint (whichever happens first wins — they are equal
        # by construction, both derive from the same seeded training).
        self._scene_meta: Dict[str, SceneMeta] = {}

    # ------------------------------------------------------------------
    @property
    def workload(self) -> Workload:
        if self._workload is None:
            from repro_torch.workloads import get_workload

            self._workload = get_workload(self.cfg.workload)
        return self._workload

    def bundle(self, scene: str) -> SceneBundle:
        if scene not in self._bundles:
            if self.cfg.verbose:
                print(f"[closed-loop] building scene bundle {scene!r} ...",
                      flush=True)
            self._bundles[scene] = self.workload.build_bundle(
                scene, scale=self.cfg.scale, seed=self._scene_seed(scene),
                sharded=self.cfg.sharded,
                hardware=self._target if self._target is not None
                else self.cfg.hardware,
                device=self.device,
            )
        b = self._bundles[scene]
        if scene not in self._scene_meta:
            self._scene_meta[scene] = SceneMeta.from_bundle(
                b, self._fixed_bit_point(b)
            )
        return b

    def _scene_seed(self, scene: str) -> int:
        return self.cfg.seed * 1000 + self.cfg.scenes.index(scene)

    def _cell_seed(self, scene_idx: int, budget_idx: int) -> int:
        # Stable, collision-free within a run: cells never share RNG.
        return (
            self.cfg.seed * 7919
            + scene_idx * len(self.cfg.budget_fracs)
            + budget_idx
        )

    # ------------------------------------------------------------------
    # Checkpointing
    # ------------------------------------------------------------------
    def _fingerprint(self) -> Dict:
        """Config identity checkpoints are written/matched against. An
        injected target instance contributes its FULL `describe()` (not
        just a name): two differently-configured instances must not
        resume each other's frontiers. The port's `describe()` records
        the target's device where the JAX package's records its TPU
        autotune key, so injected-target checkpoints of the two packages
        refuse each other (ROADMAP §3)."""
        fp = self.cfg.fingerprint()
        if self._target is not None:
            fp["hardware"] = self._target.describe()
        if self.cfg.workload != "nerf":
            wl = self.workload
            if hasattr(wl, "describe"):
                fp["workload_config"] = wl.describe()
        return fp

    def _quarantine_checkpoint(self, path: str, why: str) -> None:
        """A checkpoint that cannot be parsed/replayed must not crash the
        sweep OR be silently reused: move it aside (audit trail), warn,
        and let the run restart its cells cleanly."""
        corrupt = f"{path}.corrupt"
        os.replace(path, corrupt)
        warnings.warn(
            f"checkpoint {path} is unusable ({why}); quarantined to "
            f"{corrupt} — restarting cells from scratch",
            RuntimeWarning,
            stacklevel=3,
        )
        if self.cfg.verbose:
            print(f"[closed-loop] quarantined corrupt checkpoint -> "
                  f"{corrupt}", flush=True)

    def _load_checkpoint(self) -> Optional[Dict]:
        """Parse + validate the checkpoint. Corrupt files (torn writes,
        truncation, garbage) and unknown schema versions are quarantined
        to `<path>.corrupt` (fresh start); a config-fingerprint mismatch
        still REFUSES loudly — silently discarding a valid checkpoint of
        a different run would be data loss, not robustness."""
        path = self.cfg.checkpoint_path
        if not path or not Path(path).exists():
            return None
        try:
            state = json.loads(Path(path).read_text())
            if not isinstance(state, dict):
                raise ValueError(f"not a JSON object: {type(state).__name__}")
        except (json.JSONDecodeError, UnicodeDecodeError, ValueError) as e:
            self._quarantine_checkpoint(path, str(e))
            return None
        if state.get("version") != CHECKPOINT_VERSION:
            self._quarantine_checkpoint(
                path, f"unsupported schema version {state.get('version')!r}"
            )
            return None
        if state.get("config") != self._fingerprint():
            raise ValueError(
                f"checkpoint {path} was written by a different closed-loop "
                "config; refusing to resume (delete it to start over)"
            )
        return state

    def _save_checkpoint(
        self, outputs: Dict[str, CellOutput], order: List[str],
    ) -> Optional[str]:
        """Atomically persist the completed cell outputs (+ the scene
        constants needed to merge them). Returns the path written, or
        None when checkpointing is disabled."""
        path = self.cfg.checkpoint_path
        if not path:
            return None
        scenes_with_output = {o.scene for o in outputs.values()}
        state = {
            "version": CHECKPOINT_VERSION,
            "config": self._fingerprint(),
            "completed": list(order),
            "scene_meta": {
                s: m.to_json() for s, m in self._scene_meta.items()
                if s in scenes_with_output
            },
            "cell_outputs": {c: o.to_json() for c, o in outputs.items()},
        }
        tmp = f"{path}.tmp"
        Path(tmp).parent.mkdir(parents=True, exist_ok=True)
        Path(tmp).write_text(json.dumps(state, indent=2))
        os.replace(tmp, path)  # atomic on POSIX: no torn checkpoints
        return path

    def _restore(
        self, state: Optional[Dict],
    ) -> Tuple[Dict[str, CellOutput], List[str]]:
        """Checkpoint state -> (completed cell outputs, completion order)."""
        if state is None:
            return {}, []
        for s, m in state.get("scene_meta", {}).items():
            self._scene_meta.setdefault(s, SceneMeta.from_json(m))
        outputs = {
            c: CellOutput.from_json(o)
            for c, o in state["cell_outputs"].items()
        }
        order = [c for c in state["completed"] if c in outputs]
        return outputs, order

    # ------------------------------------------------------------------
    # Cell execution
    # ------------------------------------------------------------------
    def cell_specs(self) -> List[CellSpec]:
        """Every cell of the run in CANONICAL order (scene-major, then
        budget) — the order merges replay in, whatever order cells
        actually completed in."""
        return [
            CellSpec(
                scene=scene, scene_idx=si, budget_idx=bi,
                budget_frac=float(frac), seed=self._cell_seed(si, bi),
            )
            for si, scene in enumerate(self.cfg.scenes)
            for bi, frac in enumerate(self.cfg.budget_fracs)
        ]

    def run_cell(self, spec: CellSpec) -> CellOutput:
        """Execute ONE cell's population search, on its bundle's device,
        and package the result as plain data. Deterministic given the spec
        (per-cell seed, budget as call state, env never mutated), so a
        retried cell reproduces the original output exactly."""
        cfg = self.cfg
        bundle = self.bundle(spec.scene)
        target = bundle.baseline_latency * float(spec.budget_frac)
        res = hero_population_search(
            bundle.benv,
            PopulationSearchConfig(
                n_iterations=cfg.n_iterations,
                population=cfg.population,
                agent_fraction=cfg.agent_fraction,
                seed=spec.seed,
                verbose=False,
            ),
            DDPGConfig(
                seed=spec.seed,
                warmup_episodes=max(1, cfg.n_iterations // 4),
                updates_per_episode=8,
            ),
            latency_target=target,
            device=bundle.env.device,
        )
        points: List[Dict] = []
        cell_seconds = 0.0  # evaluation time up to the current iteration
        for h in res.history:
            ev = h.eval
            cell_seconds += ev.wall_seconds
            for j in range(ev.k):
                points.append({
                    "latency": float(ev.latency_cycles[j]),
                    "psnr": float(ev.psnr[j]),
                    "model_bytes": float(ev.model_bytes[j]),
                    "bits": [int(b) for b in ev.bits[j]],
                    "reward": float(ev.reward[j]),
                    # Evaluation seconds charged before this policy
                    # existed (proposal overhead between iterations is
                    # not attributed, a slight undercount) — the
                    # time-to-fixed-bit base.
                    "t_emit": cell_seconds,
                })
        return CellOutput(
            cell=spec.name,
            scene=spec.scene,
            budget_frac=float(spec.budget_frac),
            latency_target=float(target),
            seed=spec.seed,
            best_reward=float(res.best_reward),
            best_bits=[int(b) for b in res.best_bits],
            policies_evaluated=int(res.policies_evaluated),
            wall_seconds=float(res.wall_seconds),
            sharded=bool(bundle.benv.sharded),
            points=points,
        )

    # ------------------------------------------------------------------
    # Merging: canonical-order replay of completed cell outputs
    # ------------------------------------------------------------------
    def _replay(self, outputs: Dict[str, CellOutput]):
        """Merge the completed cells in canonical order, so the frontier,
        per-cell admission counts, and the time-to-fixed-bit clock are
        identical no matter which run finished which cells when."""
        # Joint frontier lives in normalized space and only admits points
        # inside the hypervolume reference box: no slower/larger than the
        # 8-bit baseline, no more than 5 dB below it (1-bit garbage
        # policies are Pareto-optimal on size alone but useless).
        joint = ParetoFrontier(constraints=ConstraintSet(
            max_latency=DEFAULT_HV_REF[0],
            min_psnr=DEFAULT_HV_REF[1],
            max_model_bytes=DEFAULT_HV_REF[2],
        ))
        scene_frontiers: Dict[str, ParetoFrontier] = {}
        cells: List[CellResult] = []
        policies_evaluated = 0
        search_seconds = 0.0
        seconds_to_fixed_bit: Optional[float] = None

        for spec in self.cell_specs():
            out = outputs.get(spec.name)
            if out is None:
                continue
            meta = self._scene_meta[spec.scene]
            raw = scene_frontiers.get(spec.scene)
            if raw is None:
                raw = scene_frontiers.setdefault(spec.scene, ParetoFrontier())
                # 8-bit anchor: guarantees a non-empty frontier in which
                # no point is dominated by the fixed-8-bit configuration.
                # Deduped insertion keeps a resumed anchor from tying
                # with itself and duplicating.
                base = meta.baseline_point()
                _insert_unless_present(raw, base)
                _insert_unless_present(joint, meta.normalize(base))
            # CAQ-style uniform fixed-bit competitor for time-to-baseline.
            fixed = meta.fixed_point()

            admitted = 0
            for pt in out.points:
                p = ParetoPoint(
                    latency=float(pt["latency"]),
                    psnr=float(pt["psnr"]),
                    model_bytes=float(pt["model_bytes"]),
                    bits=tuple(int(b) for b in pt["bits"]),
                    scene=spec.scene,
                    budget=float(spec.budget_frac),
                    reward=float(pt["reward"]),
                )
                # Identity-deduped insertion: CEM resampling and budget
                # enforcement routinely re-emit the same bit vector, and
                # exact ties would otherwise pile up on the frontier.
                if _insert_unless_present(raw, p):
                    admitted += 1
                _insert_unless_present(joint, meta.normalize(p))
                if (
                    seconds_to_fixed_bit is None
                    and p.dominates_or_ties(fixed)
                ):
                    seconds_to_fixed_bit = (
                        search_seconds + float(pt["t_emit"])
                    )

            policies_evaluated += out.policies_evaluated
            search_seconds += out.wall_seconds
            cells.append(CellResult(
                scene=spec.scene,
                budget_frac=float(spec.budget_frac),
                latency_target=out.latency_target,
                best_reward=out.best_reward,
                best_bits=list(out.best_bits),
                policies_evaluated=out.policies_evaluated,
                admitted_to_frontier=admitted,
                search_seconds=out.wall_seconds,
            ))

        return (joint, scene_frontiers, cells, policies_evaluated,
                search_seconds, seconds_to_fixed_bit)

    def finalize(
        self,
        outputs: Dict[str, CellOutput],
        resumed_cells: int,
        t_start: float,
        fresh: Sequence[str] = (),
    ) -> ClosedLoopResult:
        """Canonical-order replay of `outputs` -> `ClosedLoopResult`.
        `fresh` names the cells EXECUTED this run (vs restored): the
        result's `sharded` flag describes only evaluators that actually
        ran, None when everything was resumed."""
        (joint, scene_frontiers, cells, policies_evaluated, search_seconds,
         seconds_to_fixed_bit) = self._replay(outputs)
        executed = [outputs[c].sharded for c in fresh if c in outputs]
        return ClosedLoopResult(
            frontier=joint,
            scene_frontiers=scene_frontiers,
            cells=cells,
            policies_evaluated=policies_evaluated,
            search_seconds=search_seconds,
            wall_seconds=time.time() - t_start,
            resumed_cells=resumed_cells,
            seconds_to_fixed_bit=seconds_to_fixed_bit,
            fixed_bit_reference=self.FIXED_BIT_REFERENCE,
            sharded=all(executed) if executed else None,
            device=self.device.type,
        )

    # ------------------------------------------------------------------
    def run(self, stop_after_cells: Optional[int] = None) -> ClosedLoopResult:
        """Execute (or resume) the closed loop sequentially: cells in
        canonical order, a checkpoint after each, a replay to the final
        result. `stop_after_cells` ends the run gracefully after that many
        NEW cells — a controlled stand-in for interruption (the checkpoint
        then carries the partial state a later `run()` resumes from)."""
        cfg = self.cfg
        t_start = time.time()
        outputs, order = self._restore(self._load_checkpoint())
        resumed = len(outputs)
        if resumed and cfg.verbose:
            print(f"[closed-loop] resumed {resumed} completed cell(s) "
                  f"from {cfg.checkpoint_path}", flush=True)

        fresh: List[str] = []
        for spec in self.cell_specs():
            if spec.name in outputs:
                continue
            if stop_after_cells is not None and len(fresh) >= stop_after_cells:
                break
            self.bundle(spec.scene)  # build (or reuse) outside the cell
            if cfg.verbose:
                print(f"[closed-loop] cell {spec.name}: budget="
                      f"{spec.budget_frac:g}, seed={spec.seed}", flush=True)
            out = self.run_cell(spec)
            outputs[spec.name] = out
            order.append(spec.name)
            fresh.append(spec.name)
            self._save_checkpoint(outputs, order)
            if cfg.verbose:
                print(
                    f"[closed-loop]   {spec.name}: "
                    f"{out.policies_evaluated} policies, "
                    f"{len(out.points)} points "
                    f"({out.wall_seconds:.1f}s)",
                    flush=True,
                )

        return self.finalize(outputs, resumed, t_start, fresh=fresh)

    # ------------------------------------------------------------------
    def _fixed_bit_point(self, bundle: SceneBundle) -> ParetoPoint:
        """CAQ-style uniform fixed-bit reference through the same proxy,
        on the bundle's device."""
        b = self.FIXED_BIT_REFERENCE
        bits = np.full((1, bundle.env.n_units), b, np.int32)
        sim = bundle.benv.simulate_batch(bits)
        psnr = bundle.benv.proxy_quality(
            bundle.env.params, bits.astype(np.float32)
        )
        return ParetoPoint(
            latency=float(sim["total_cycles"][0]),
            psnr=float(psnr[0]),
            model_bytes=float(sim["model_bytes"][0]),
            bits=tuple([b] * bundle.env.n_units),
            scene=bundle.scene,
        )


# ---------------------------------------------------------------------------
# Config round-trip
# ---------------------------------------------------------------------------
def config_to_json(cfg: ClosedLoopConfig) -> Dict:
    d = dataclasses.asdict(cfg)
    d["scenes"] = list(cfg.scenes)
    d["budget_fracs"] = [float(f) for f in cfg.budget_fracs]
    return d


def config_from_json(d: Dict) -> ClosedLoopConfig:
    d = dict(d)
    d["scenes"] = tuple(d["scenes"])
    d["budget_fracs"] = tuple(float(f) for f in d["budget_fracs"])
    d["scale"] = SceneScale(**d["scale"])
    return ClosedLoopConfig(**d)


# ---------------------------------------------------------------------------
# Benchmark report (the BENCH_search.json schema)
# ---------------------------------------------------------------------------
def bench_report(result: ClosedLoopResult, cfg: ClosedLoopConfig) -> Dict:
    """The search report, the JAX package's `BENCH_search.json` schema key
    for key.

    Validity flags encode the acceptance contract against the fixed-8-bit
    baseline (the (1, 0, 1) anchor in normalized space): the joint
    frontier either still CONTAINS the anchor ("matches") or some point
    strictly dominates it (the anchor was evicted by a better policy),
    and by the frontier invariant no surviving point is dominated by it —
    every point is at least as good as fixed-8-bit in some objective.
    `n_devices` counts the devices of the kind the run lived on: the
    visible cards, or 1 on the CPU.
    """
    n_devices = (torch.cuda.device_count() if result.device == "cuda"
                 else 1)
    anchor = ParetoPoint(latency=1.0, psnr=0.0, model_bytes=1.0)
    pts = result.frontier.points
    contains_anchor = any(
        p.objectives() == anchor.objectives() for p in pts
    )
    some_dominates_anchor = any(p.dominates(anchor) for p in pts)
    none_dominated_by_anchor = all(not anchor.dominates(p) for p in pts)
    return {
        "scenes": list(cfg.scenes),
        "budget_fracs": [float(f) for f in cfg.budget_fracs],
        "hardware": cfg.hardware,
        "workload": cfg.workload,
        "seed": cfg.seed,
        "scale": dataclasses.asdict(cfg.scale),
        "n_iterations": cfg.n_iterations,
        "population": cfg.population,
        "n_devices": n_devices,
        # The evaluators' state when known; a fully resumed run reports
        # the config's, or what `sharded=None` would have chosen there.
        "sharded": result.sharded if result.sharded is not None
        else (bool(cfg.sharded) if cfg.sharded is not None
              else result.device == "cuda" and auto_shard()),
        "policies_evaluated": result.policies_evaluated,
        "search_seconds": round(result.search_seconds, 4),
        "wall_seconds": round(result.wall_seconds, 4),
        "policies_per_sec": round(result.policies_per_sec, 4),
        "seconds_to_fixed_bit": result.seconds_to_fixed_bit,
        "fixed_bit_reference": result.fixed_bit_reference,
        "frontier_size": len(result.frontier),
        "frontier_hypervolume": result.hypervolume(),
        "hypervolume_ref": list(DEFAULT_HV_REF),
        "scene_frontier_sizes": {
            s: len(f) for s, f in result.scene_frontiers.items()
        },
        "frontier": [p.to_json() for p in pts],
        "contains_8bit_anchor": contains_anchor,
        "some_point_dominates_8bit": some_dominates_anchor,
        "no_point_dominated_by_8bit": none_dominated_by_anchor,
        "frontier_valid_vs_8bit": none_dominated_by_anchor
        and (contains_anchor or some_dominates_anchor),
        "cells": [c.to_json() for c in result.cells],
    }
