"""Continuous-batching multi-scene serve engine over `QuantArtifact`s.

The shape of an LLM inference engine, specialized to NeRF rays:

  submit -> per-scene FIFO queues -> [Scheduler] -> single-scene bucket
         -> [ArtifactCache: LRU load-on-miss, byte-budgeted eviction]
         -> device step (fixed padded shapes)
         -> scatter into request buffers -> poll()/result() streaming

Every `step()` admits up to `slots` queued work items of ONE scene (the
scheduler's oldest-first bucket), renders them in one device call at the
engine's fixed `(slots, slot_rays, 3)` padded shape, and scatters the
colors back. Multiple artifacts are resident at once; the padded bucket
shape is a property of the ENGINE (not the artifact), so alternating
scenes step after step keeps every launch at the same shapes. Completed
work items surface through `poll()` before the full request drains
(streaming partial frames).

Two seams make the whole scheduler drivable from tests with zero real
renders, and they are the design constraint on this layer:

  * `clock=` — any zero-arg float callable; defaults to
    `time.perf_counter`. All timestamps (submit, done, latency stats)
    come from it, so a fake counter makes timing assertions exact.
  * `device_step=` — `(scene, artifact, ro, rd) -> (S, R, 3) colors`;
    defaults to `FusedDeviceStep` (the real fused integer render with
    grow-on-overflow sample budgets, on the engine's `device`). A scripted
    fake turns `step()` into a pure state transition.

`loader=` (scene -> artifact) serves cache misses; `size_fn=` prices an
artifact for the byte budget (defaults to `resident_bytes()` where
available). Eviction never drops an artifact with in-flight work — with
the synchronous step loop, in-flight == queued items, and such scenes
are protected; if every resident scene is protected the cache runs over
budget (counted as an overflow) rather than dropping work.

Spans (`repro_torch.spans`, recorded only while a recording is open):
`hero.submit` (attrs `rid`, `n_items`) with its child
`hero.submit.pose_key`; `hero.step` (attrs `scene` and `items`: each
rendered item's `(rid, seq, queue_age_s)`, the engine clock's age at the
take) with its children `hero.step.pack` (the padded host buffers, then
the fused stepper's copy of them to the device), `hero.slot` (attrs
`tier`, `rid`, `seq`, and `graph`: "capture", "replay" or "eager", how
its launches ran), `hero.sync` (each blocking device read, so their
count is the step's syncs) and `hero.step.scatter`.

On the card a march slot's launch chain is captured once as a CUDA graph
and replayed (`SlotGraph`, keyed by scene, artifact and sample budget):
a slot costs two copies and one launch on the host instead of ~160. The
hit and warp tiers, the `"scatter"` compaction and every CPU path run
eagerly. `stats()["slot_graphs"]` counts captures, replays and eager
march slots, and the device bytes of the memory pool the live graphs
share (charged to the cache's byte budget beside the pose plans).
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter, OrderedDict, deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import spans
from repro_torch.hero.scheduler import (
    AdmissionFull,
    ArtifactLoadError,
    CompletedRecord,
    EngineConfig,
    RequestExpired,
    RequestState,
    Scheduler,
    WorkItem,
)
from repro_torch.kernels._launch import add_launches, tallied
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.nerf.fast_render import (
    frame_colors,
    slot_march,
    slot_plan,
    slot_warp,
)
from repro_torch.nerf.occupancy import sample_active_mask
from repro_torch.nerf.pose_cache import (
    PoseGridConfig,
    PosePlanCache,
    build_warp_plan,
    pose_cell_key,
    ray_fingerprint,
    warp_deviation,
)


def _to_host(t: torch.Tensor):
    """A blocking device read of the step path: a 0-d tensor as an int,
    any other as a NumPy array."""
    with spans.span("hero.sync"):
        return int(t) if t.dim() == 0 else t.cpu().numpy()


def _default_size_fn(artifact) -> int:
    fn = getattr(artifact, "resident_bytes", None)
    return int(fn()) if callable(fn) else 0


# ---------------------------------------------------------------------------
# LRU artifact cache
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CacheEntry:
    scene: str
    artifact: object
    nbytes: int


class ArtifactCache:
    """Byte-budgeted LRU over resident artifacts with load-on-miss."""

    def __init__(
        self,
        cache_bytes: Optional[int],
        loader: Optional[Callable[[str], object]],
        size_fn: Callable[[object], int],
        protected: Callable[[str], bool],
        on_event: Callable[[Tuple], None],
        extra_bytes: Optional[Callable[[], int]] = None,
    ):
        self.cache_bytes = cache_bytes
        self._loader = loader
        self._size_fn = size_fn
        self._protected = protected
        self._event = on_event
        # Non-artifact resident payload charged against the byte budget
        # (the engine wires the pose-plan cache here, so plan bytes add
        # eviction pressure like any other device-resident state).
        self._extra_bytes = extra_bytes
        self._entries: "OrderedDict[str, CacheEntry]" = OrderedDict()
        self.loads = 0
        self.evictions = 0
        self.hits = 0
        self.overflows = 0
        self.load_failures = 0

    # ------------------------------------------------------------------
    @property
    def resident_bytes(self) -> int:
        extra = self._extra_bytes() if self._extra_bytes is not None else 0
        return sum(e.nbytes for e in self._entries.values()) + extra

    def scenes(self) -> List[str]:
        return list(self._entries)

    def __contains__(self, scene: str) -> bool:
        return scene in self._entries

    def add(self, scene: str, artifact) -> CacheEntry:
        """Install a resident artifact (engine construction / explicit)."""
        e = CacheEntry(scene, artifact, int(self._size_fn(artifact)))
        self._entries[scene] = e
        self._entries.move_to_end(scene)
        return e

    # ------------------------------------------------------------------
    def ensure(self, scene: str) -> CacheEntry:
        """Resident entry for `scene`, loading on miss (LRU-touched)."""
        e = self._entries.get(scene)
        if e is not None:
            self._entries.move_to_end(scene)
            self.hits += 1
            return e
        if self._loader is None:
            raise KeyError(
                f"scene {scene!r} is not resident and the engine has no "
                "artifact loader"
            )
        # Exception safety: nothing below mutates cache state until BOTH
        # the loader and the size function have succeeded — a raising
        # loader leaves no partial entry, no skewed resident_bytes()/LRU,
        # and only the load_failures counter moves.
        try:
            artifact = self._loader(scene)
            if artifact is None:
                raise KeyError(f"artifact loader returned None for {scene!r}")
            nbytes = int(self._size_fn(artifact))
        except Exception as e:
            self.load_failures += 1
            self._event(("load_failed", scene, repr(e)))
            raise ArtifactLoadError(
                f"loading artifact for scene {scene!r} failed: {e!r}"
            ) from e
        self._evict_for(nbytes)
        e = CacheEntry(scene, artifact, nbytes)
        self._entries[scene] = e
        self.loads += 1
        self._event(("load", scene, nbytes))
        return e

    def _evict_for(self, incoming_bytes: int) -> None:
        """Evict LRU-first until `incoming_bytes` fits; scenes with queued
        work are protected, so the cache may run over budget instead."""
        if self.cache_bytes is None:
            return
        for scene in list(self._entries):  # LRU -> MRU order
            if self.resident_bytes + incoming_bytes <= self.cache_bytes:
                return
            if self._protected(scene):
                continue
            e = self._entries.pop(scene)
            self.evictions += 1
            self._event(("evict", scene, e.nbytes))
        if self.resident_bytes + incoming_bytes > self.cache_bytes:
            self.overflows += 1

    def reset_stats(self) -> None:
        self.loads = self.evictions = self.hits = self.overflows = 0
        self.load_failures = 0


# ---------------------------------------------------------------------------
# A march slot's launches as one CUDA graph
# ---------------------------------------------------------------------------
class SlotGraph:
    """`run()`'s launches captured once as a CUDA graph, then replayed on
    the current stream. The graph reads the tensors it was captured over
    in place, so it holds `artifact` (whose tensors it reads) and its
    outputs. It captures on the side stream of `shared` into its memory
    pool (`SlotGraph.shared`): graphs of one pool may reuse each other's
    scratch memory, safe here because they replay on one stream and each
    replay's outputs are read back before the next replay. `nbytes` is the
    device memory the capture added to the pool. The kernel wrappers ran
    once, at the capture, so their `launches` were tallied there and each
    replay adds the tally."""

    @staticmethod
    def shared(device: torch.device) -> Tuple:
        """A memory pool and a capture stream for graphs to share."""
        return torch.cuda.graph_pool_handle(), torch.cuda.Stream(device)

    def __init__(self, run: Callable, artifact, device: torch.device,
                 shared: Tuple):
        pool, side = shared
        self.artifact = artifact
        self.graph = torch.cuda.CUDAGraph()
        side.wait_stream(torch.cuda.current_stream(device))
        before = torch.cuda.memory_reserved(device)
        with torch.cuda.stream(side), tallied() as self.launches:
            # Thread-local: another thread's calls do not void the capture,
            # and a blocking call of this one's raises.
            self.graph.capture_begin(pool=pool,
                                     capture_error_mode="thread_local")
            try:
                self.out = run()
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(side)
        self.nbytes = torch.cuda.memory_reserved(device) - before

    def replay(self):
        """Run the captured launches again; their outputs, rewritten."""
        self.graph.replay()
        add_launches(self.launches)
        return self.out


# ---------------------------------------------------------------------------
# Default device step: the real fused integer render
# ---------------------------------------------------------------------------
class FusedDeviceStep:
    """`(scene, artifact, ro, rd) -> colors` through the fused render path.

    Per-scene state (quant spec, eval rcfg, grow-on-overflow sample
    budget) lives HERE, not in the cache entry: a scene's budget survives
    eviction and reload. Derived spec/rcfg rebuild only when the artifact
    object actually changes (reload). Artifacts must live on `device`,
    where the pose cache's plans are baked too.

    On the card a march slot's rays are copied into static inputs made
    once, which every graph reads. The first march slot at a key (scene,
    artifact, budget) runs eagerly, which makes every constant the chain
    creates lazily; the next one captures its launches as a `SlotGraph`
    and later ones replay it. A scene's graphs are dropped when its budget
    grows, its artifact reloads or is evicted; the graphs share one memory
    pool, dropped with the last of them.
    """

    def __init__(self, cfg: EngineConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        self._align = 128
        self._state: Dict[str, Dict] = {}
        # The graph path: static inputs (slot_rays, 3), key -> its graph
        # (None once the key's eager warm-up has run), the pool and stream
        # the graphs share and the bytes the pool holds.
        self._graphed = device.type == "cuda"
        self._ro_in: Optional[torch.Tensor] = None
        self._rd_in: Optional[torch.Tensor] = None
        self._graphs: Dict[Tuple, Optional[SlotGraph]] = {}
        self._shared: Optional[Tuple] = None
        self._pool_bytes = 0
        self._runs: Counter = Counter()  # march slots by how they ran
        assert cfg.compaction in ("march", "scatter"), cfg.compaction
        self._pose_cache = None
        self._pose_grid = None
        if cfg.pose_cache and cfg.compaction == "march":
            self._pose_grid = PoseGridConfig(
                pos_cell=cfg.pose_pos_cell, dir_cell=cfg.pose_dir_cell,
                margin_cells=cfg.pose_margin_cells,
                entries=cfg.pose_cache_entries,
                build_after=cfg.pose_build_after,
            )
            self._pose_cache = PosePlanCache(cfg.pose_cache_entries)

    # ------------------------------------------------------------------
    def _initial_budget(self, artifact, rcfg) -> Optional[int]:
        cap = self.cfg.slot_rays * rcfg.n_samples
        b = self.cfg.budget
        if b is None:
            return None
        if b == "auto":
            occf = artifact.occ.occupied_fraction
            est = cap * min(1.0, occf * self.cfg.budget_headroom)
            est = int(np.ceil(max(est, 1) / self._align) * self._align)
            return int(np.clip(est, self._align, cap))
        return int(np.clip(int(b), self._align, cap))

    def _scene_state(self, scene: str, artifact) -> Dict:
        st = self._state.get(scene)
        if st is None or st["artifact_id"] != id(artifact):
            if artifact.device.type != self.device.type:
                raise ValueError(
                    f"artifact {scene!r} lives on {artifact.device}, the "
                    f"engine runs on {self.device}"
                )
            rcfg = dataclasses.replace(artifact.rcfg, stratified=False)
            self._drop_graphs(scene)  # they read the old artifact
            st = {
                "artifact_id": id(artifact),
                "spec": artifact.spec(),
                "rcfg": rcfg,
                # Reload of the same scene keeps its grown budget.
                "budget": (
                    st["budget"] if st is not None
                    else self._initial_budget(artifact, rcfg)
                ),
                "retraces": 0 if st is None else st["retraces"],
            }
            self._state[scene] = st
        return st

    def _grow(self, st, need: int) -> None:
        cap = self.cfg.slot_rays * st["rcfg"].n_samples
        grown = int(np.ceil(max(need * self.cfg.budget_headroom, need)
                            / self._align) * self._align)
        st["budget"] = min(grown, cap)
        st["retraces"] += 1

    # ------------------------------------------------------------------
    def __call__(self, scene: str, artifact, ro: np.ndarray, rd: np.ndarray):
        """One padded bucket through `frame_colors` (the scatter
        strategy's path), with the host-side budget guard."""
        st = self._scene_state(scene, artifact)
        if st["budget"] is not None:
            # Exactness guard: grow the static budget before a step could
            # overflow and silently drop samples.
            active, _ = sample_active_mask(artifact.occ, ro, rd, st["rcfg"])
            need = int(active.reshape(ro.shape[0], -1).sum(axis=1).max())
            if need > st["budget"]:
                self._grow(st, need)
        colors = frame_colors(
            artifact.params, artifact.pack, st["spec"], artifact.occ,
            torch.from_numpy(ro).to(self.device),
            torch.from_numpy(rd).to(self.device),
            artifact.cfg, st["rcfg"], "fused", st["budget"],
            self.cfg.early_stop, self.cfg.compaction,
        )
        return _to_host(colors)

    # ------------------------------------------------------------------
    # Pose-cache tiers (the `step_items` serve path)
    # ------------------------------------------------------------------
    def pose_key(self, scene: str, ro: np.ndarray, rd: np.ndarray):
        """(scene,) + pose-grid cell of a request bundle, None when the
        pose cache is disabled."""
        if self._pose_cache is None or ro.shape[0] == 0:
            return None
        return (scene,) + pose_cell_key(
            ro, rd, self._pose_grid.pos_cell, self._pose_grid.dir_cell
        )

    def note_pose_use(self, key) -> None:
        """Count ONE visit of the pose cell (called once per submitted
        request, not per item — `build_after` is in request visits, so a
        never-revisited pose costs zero plan builds)."""
        if self._pose_cache is not None and key is not None:
            self._pose_cache.note_use(key)

    def pin_pose(self, key) -> None:
        if self._pose_cache is not None and key is not None:
            self._pose_cache.pin(key)

    def unpin_pose(self, key) -> None:
        if self._pose_cache is not None and key is not None:
            self._pose_cache.unpin(key)

    def drop_scene_plans(self, scene: str) -> int:
        """Artifact left the device -> its plans index nothing and its
        slot graphs read freed tensors; drop both (plans even pinned: the
        in-flight work re-loads and re-misses). Returns the plans
        dropped."""
        self._drop_graphs(scene)
        if self._pose_cache is None:
            return 0
        return self._pose_cache.drop_scene(scene)

    def plan_bytes(self) -> int:
        return self._pose_cache.nbytes if self._pose_cache is not None else 0

    def graph_bytes(self) -> int:
        """Device bytes the live slot graphs' shared pool holds."""
        return self._pool_bytes

    def graph_stats(self) -> Dict:
        return {"captures": self._runs["capture"],
                "replays": self._runs["replay"],
                "eager": self._runs["eager"], "bytes": self.graph_bytes()}

    def _drop_graphs(self, scene: Optional[str] = None) -> None:
        """Drop `scene`'s graphs, or every graph with None. The pool goes
        with the last graph: its memory returns to the allocator's cache."""
        for key in [k for k in self._graphs if scene in (None, k[0])]:
            del self._graphs[key]
        if not any(self._graphs.values()):
            self._shared, self._pool_bytes = None, 0

    def pose_stats(self) -> Optional[Dict]:
        return (
            self._pose_cache.stats() if self._pose_cache is not None else None
        )

    def _march_slot(self, scene: str, st, artifact, ro, rd
                    ) -> Tuple[np.ndarray, str]:
        """Cache-miss tier for one padded slot, with grow-on-overflow: the
        march render returns the TRUE device active count of its own mask,
        so an overflowing slot grows the budget, drops the scene's graphs
        and re-renders — no silently dropped samples, no host-side mask
        pass per step. Returns the colours and how the last render ran."""
        if self._graphed:
            if self._ro_in is None or self._ro_in.shape != ro.shape:
                self._drop_graphs()  # they read the old inputs
                self._ro_in = torch.empty_like(ro)
                self._rd_in = torch.empty_like(rd)
            self._ro_in.copy_(ro)
            self._rd_in.copy_(rd)
            ro, rd = self._ro_in, self._rd_in
        while True:
            (color, need), how = self._march(scene, st, artifact, ro, rd)
            if st["budget"] is not None:
                need = _to_host(need)
                if need > st["budget"]:
                    self._grow(st, need)
                    self._drop_graphs(scene)
                    continue
            return _to_host(color), how

    def _march(self, scene: str, st, artifact, ro, rd):
        """((color, need) of `slot_march` over the rays, how it ran):
        "eager", "capture" (captured, then replayed) or "replay"."""
        def run():
            return slot_march(
                artifact.params, artifact.pack, st["spec"], artifact.occ,
                ro, rd, artifact.cfg, st["rcfg"], "fused", st["budget"],
                self.cfg.early_stop,
            )
        key = (scene, id(artifact), st["budget"])
        if not self._graphed or key not in self._graphs:
            if self._graphed:
                self._graphs[key] = None  # warmed up: the next one captures
            self._runs["eager"] += 1
            return run(), "eager"
        graph = self._graphs[key]
        how = "replay"
        if graph is None:
            if self._shared is None:
                self._shared = SlotGraph.shared(self.device)
            graph = self._graphs[key] = SlotGraph(run, artifact, self.device,
                                                  self._shared)
            self._pool_bytes += graph.nbytes
            how = "capture"
        self._runs[how] += 1
        return graph.replay(), how

    def _tier(self, st, it: WorkItem, ro_s: np.ndarray, rd_s: np.ndarray):
        """(tier, cell entry, plan) of one slot: "hit" (the rays
        fingerprint-match the cell's baked plan), "warp" (they deviate
        within its coverage margin) or "march"."""
        cache, key = self._pose_cache, getattr(it, "pose_key", None)
        if cache is None or key is None:
            return "march", None, None
        # Visits were counted at submit; a cell dropped between submit and
        # step (scene eviction) restarts at one use.
        entry = cache.get(key)
        if entry is None:
            entry = cache.note_use(key)
        plan = entry.plans.get(it.seq)
        if plan is not None:
            if ray_fingerprint(ro_s, rd_s) == plan.fp:
                return "hit", entry, plan
            if warp_deviation(ro_s, rd_s, plan.ref_o, plan.ref_d,
                              st["rcfg"]) <= plan.margin:
                return "warp", entry, plan
        return "march", entry, None  # none yet, or out of coverage

    def step_items(
        self, scene: str, artifact, items: List[WorkItem],
        ro: np.ndarray, rd: np.ndarray,
    ) -> np.ndarray:
        """Tiered per-slot render of one padded bucket.

        Each live slot resolves to cache-hit (rays fingerprint-match the
        cell's baked plan), warp (pose deviates within the plan's
        conservative coverage margin), or march (miss; the cell's use
        count decides whether to bake a plan for next time). Every tier
        runs at the same fixed (slot_rays, 3) padded shape; empty slots
        are not rendered."""
        if self.cfg.compaction != "march":
            # Legacy scatter strategy has no tiers: one padded-bucket call.
            return np.asarray(self(scene, artifact, ro, rd))
        st = self._scene_state(scene, artifact)
        S = ro.shape[0]
        colors = np.zeros((S, ro.shape[1], 3), np.float32)
        n = len(items)
        with spans.span("hero.step.pack"):
            ro_d = torch.from_numpy(ro[:n]).to(self.device)
            rd_d = torch.from_numpy(rd[:n]).to(self.device)
        cache = self._pose_cache
        args = (artifact.params, artifact.pack, st["spec"], artifact.occ)
        kw = dict(cfg=artifact.cfg, rcfg=st["rcfg"], mode="fused",
                  early_stop=self.cfg.early_stop)
        for slot, it in enumerate(items):
            with spans.span("hero.slot", rid=it.rid, seq=it.seq) as sp:
                tier, entry, plan = self._tier(st, it, ro[slot], rd[slot])
                sp.set(tier=tier, graph="eager")
                if tier == "hit":
                    cache.hits += 1
                    color = slot_plan(*args, ro_d[slot], rd_d[slot],
                                      plan.plan_row, **kw)
                    colors[slot] = _to_host(color)
                elif tier == "warp":
                    cache.warps += 1
                    color = slot_warp(*args, ro_d[slot], rd_d[slot],
                                      plan.inv_take, plan.take,
                                      plan.valid_cons, **kw)
                    colors[slot] = _to_host(color)
                else:
                    if entry is not None:
                        cache.misses += 1
                    colors[slot], how = self._march_slot(
                        scene, st, artifact, ro_d[slot], rd_d[slot])
                    sp.set(graph=how)
                    if (entry is not None
                            and entry.uses >= self._pose_grid.build_after):
                        cache.put_plan(it.pose_key, it.seq, build_warp_plan(
                            artifact.occ, ro[slot], rd[slot], st["rcfg"],
                            artifact.cfg,
                            self._pose_grid.margin(artifact.occ),
                        ))
        return colors

    # ------------------------------------------------------------------
    def budgets(self) -> Dict[str, Optional[int]]:
        return {s: st["budget"] for s, st in self._state.items()}

    @property
    def retraces(self) -> int:
        return sum(st["retraces"] for st in self._state.values())

    def reset_stats(self) -> None:
        for st in self._state.values():
            st["retraces"] = 0
        self._runs.clear()
        if self._pose_cache is not None:
            self._pose_cache.reset_stats()


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
class ServeEngine:
    """Multi-scene continuous-batching render engine (module docstring)."""

    def __init__(
        self,
        artifacts=None,
        cfg: EngineConfig = EngineConfig(),
        *,
        loader: Optional[Callable[[str], object]] = None,
        clock: Optional[Callable[[], float]] = None,
        device_step: Optional[Callable] = None,
        size_fn: Optional[Callable[[object], int]] = None,
        device: DeviceLike = None,
    ):
        """Without an injected `device_step`, the engine renders through
        `FusedDeviceStep` on `device` — the card unless `device="cpu"`."""
        self.cfg = cfg
        self._clock = time.perf_counter if clock is None else clock
        self._stepper = (
            FusedDeviceStep(cfg, resolve_device(device))
            if device_step is None else None
        )
        self._device_step = device_step if device_step is not None else self._stepper
        self._sched = Scheduler(cfg.slots)
        self._events = (
            deque(maxlen=cfg.trace_events) if cfg.trace_events > 0 else None
        )
        self._cache = ArtifactCache(
            cfg.cache_bytes, loader,
            size_fn if size_fn is not None else _default_size_fn,
            protected=lambda scene: self._sched.pending(scene) > 0,
            on_event=self._event,
            extra_bytes=(
                (lambda: self._stepper.plan_bytes()
                 + self._stepper.graph_bytes())
                if self._stepper is not None else None
            ),
        )
        for scene, artifact in self._as_scene_map(artifacts).items():
            self._cache.add(scene, artifact)

        self._requests: Dict[int, RequestState] = {}
        self._ring: deque = deque(maxlen=max(1, cfg.completed_ring))
        self._next_rid = 0
        self._steps = 0
        self._items_rendered = 0
        self._rays_rendered = 0
        self._items_dropped = 0
        self._rays_dropped = 0
        self._requests_submitted = 0
        self._requests_completed = 0
        self._requests_expired = 0
        self._rejected = 0
        self._t_first_submit: Optional[float] = None
        self._t_last_done: Optional[float] = None

    # ------------------------------------------------------------------
    @staticmethod
    def _as_scene_map(artifacts) -> Dict[str, object]:
        if artifacts is None:
            return {}
        if hasattr(artifacts, "items"):
            return dict(artifacts)
        if isinstance(artifacts, (list, tuple)):
            return {a.scene: a for a in artifacts}
        return {artifacts.scene: artifacts}

    def _event(self, ev: Tuple) -> None:
        # Evicting a scene's artifact invalidates its pose plans (they
        # index device state that just left) — unconditional, not only
        # when event tracing is on.
        if ev and ev[0] == "evict" and self._stepper is not None:
            self._stepper.drop_scene_plans(ev[1])
        if self._events is not None:
            self._events.append(ev)

    @property
    def events(self) -> List[Tuple]:
        """Recorded scheduler/cache events (cfg.trace_events > 0)."""
        return list(self._events) if self._events is not None else []

    # ------------------------------------------------------------------
    @property
    def pending(self) -> int:
        """Queued work items (all scenes)."""
        return self._sched.pending()

    @property
    def scenes(self) -> List[str]:
        """Scenes known to the engine (resident or with queued work)."""
        out = list(self._cache.scenes())
        for s in self._sched.scenes_with_work():
            if s not in out:
                out.append(s)
        return out

    @property
    def resident_scenes(self) -> List[str]:
        return self._cache.scenes()

    @property
    def budget(self) -> Optional[int]:
        """Single-scene convenience: THE sample budget (facade compat)."""
        if self._stepper is None:
            return None
        budgets = self._stepper.budgets()
        if len(budgets) == 1:
            return next(iter(budgets.values()))
        return None

    def budget_of(self, scene: str) -> Optional[int]:
        if self._stepper is None:
            return None
        return self._stepper.budgets().get(scene)

    @property
    def retraces(self) -> int:
        return self._stepper.retraces if self._stepper is not None else 0

    # ------------------------------------------------------------------
    def submit(self, rays_o, rays_d, scene: Optional[str] = None,
               deadline: Optional[float] = None) -> int:
        """Enqueue one render request ((N, 3) rays) for `scene`; returns a
        request id. `scene=None` resolves only when exactly one scene is
        resident (the single-artifact facade case).

        `deadline` (engine-clock timestamp) makes the request droppable:
        queued items whose deadline has passed are discarded at bucket-
        take time and `result()` raises `RequestExpired`. With
        `cfg.max_pending` set, a submit that would push the queued-item
        count past the cap raises `AdmissionFull` (counted in the
        `requests_rejected` stat) without enqueuing anything."""
        with spans.span("hero.submit") as sp:
            return self._submit(sp, rays_o, rays_d, scene, deadline)

    def _submit(self, sp, rays_o, rays_d, scene, deadline) -> int:
        ro = np.asarray(rays_o, np.float32).reshape(-1, 3)
        rd = np.asarray(rays_d, np.float32).reshape(-1, 3)
        assert ro.shape == rd.shape, (ro.shape, rd.shape)
        if scene is None:
            resident = self._cache.scenes()
            if len(resident) != 1:
                raise ValueError(
                    "submit(scene=None) needs exactly one resident scene; "
                    f"resident: {resident}"
                )
            scene = resident[0]
        if scene not in self._cache and self._cache._loader is None:
            raise ValueError(
                f"scene {scene!r} is not resident and no loader is "
                "configured — the request could never be served"
            )
        R = self.cfg.slot_rays
        n_rays = ro.shape[0]
        n_items = max(1, -(-n_rays // R))
        if (
            self.cfg.max_pending is not None
            and self._sched.pending() + n_items > self.cfg.max_pending
        ):
            self._rejected += 1
            self._event(("reject", scene, n_items))
            raise AdmissionFull(
                f"admission rejected: {self._sched.pending()} item(s) "
                f"queued + {n_items} requested > max_pending="
                f"{self.cfg.max_pending}"
            )
        rid = self._next_rid
        self._next_rid += 1
        sp.set(rid=rid, n_items=n_items)
        now = self._clock()
        self._requests[rid] = RequestState(
            rid=rid, scene=scene, n_rays=n_rays, n_items=n_items,
            colors=np.zeros((n_rays, 3), np.float32),
            done=np.zeros((n_rays,), bool), t_submit=now,
            deadline=deadline,
        )
        self._requests_submitted += 1
        if self._t_first_submit is None:
            self._t_first_submit = now
        with spans.span("hero.submit.pose_key"):
            pose_key = (
                self._stepper.pose_key(scene, ro, rd)
                if self._stepper is not None else None
            )
        if self._stepper is not None:
            self._stepper.note_pose_use(pose_key)
        for i in range(n_items):
            s = i * R
            e = min(s + R, n_rays) if n_rays else 0
            self._sched.push(WorkItem(
                rid=rid, scene=scene, seq=i, start=s, stop=e,
                rays_o=ro[s:e], rays_d=rd[s:e],
                order=self._sched.next_order(), t_enqueue=now,
                pose_key=pose_key,
            ))
            # Pin per item: the pose cell stays un-evictable while ANY of
            # the request's items is in flight (unpinned on render/drop).
            if self._stepper is not None:
                self._stepper.pin_pose(pose_key)
        self._event(("submit", rid, scene, n_items))
        return rid

    # ------------------------------------------------------------------
    def _item_expired(self, it: WorkItem, now: float) -> bool:
        req = self._requests.get(it.rid)
        if req is None:
            # Expired request already freed by result(); its stragglers
            # drain as drops.
            return True
        return req.expired or (
            req.deadline is not None and now >= req.deadline
        )

    def _drop_item(self, it: WorkItem, now: float) -> None:
        self._items_dropped += 1
        self._rays_dropped += it.stop - it.start
        if self._stepper is not None:
            self._stepper.unpin_pose(it.pose_key)
        self._event(("drop", it.rid, it.seq))
        req = self._requests.get(it.rid)
        if req is None:
            return
        req.items_dropped += 1
        if not req.expired:
            req.expired = True
            self._requests_expired += 1
            self._event(("expire", it.rid))

    def step(self) -> int:
        """Admit + render ONE single-scene bucket (up to `slots` items) in
        one device call, dropping past-deadline items at take time. Loops
        internally past fully-expired buckets, so 0 means IDLE — `drain()`
        never stops early on a run of expired work. Returns items removed
        from the queues (rendered + dropped)."""
        with spans.span("hero.step") as sp:
            return self._step(sp)

    def _step(self, sp) -> int:
        dropped_total = 0
        while True:
            scene = self._sched.oldest_scene()
            if scene is None:
                return dropped_total
            scene2, items = self._sched.take_bucket()
            assert scene2 == scene and items, (scene2, scene)
            now = self._clock()
            live = []
            for it in items:
                if self._item_expired(it, now):
                    self._drop_item(it, now)
                    dropped_total += 1
                else:
                    live.append(it)
            if not live:
                continue  # whole bucket past deadline: no device call
            try:
                # Load-on-miss + LRU eviction; runs AFTER the take, so a
                # failing loader re-queues the live items untouched (the
                # cache itself mutates nothing on failure).
                entry = self._cache.ensure(scene)
            except Exception:
                self._sched.requeue_front(live)
                raise
            items = live
            break
        if sp.live:
            sp.set(scene=scene, items=tuple(
                (it.rid, it.seq, now - it.t_enqueue) for it in items))

        S, R = self.cfg.slots, self.cfg.slot_rays
        # Padding rays (empty slots / short items) originate far outside
        # the scene box with zero direction: every sample is inactive, so
        # padding consumes neither cull budget nor field compute.
        with spans.span("hero.step.pack"):
            ro = np.full((S, R, 3), 10.0, np.float32)
            rd = np.zeros((S, R, 3), np.float32)
            for slot, it in enumerate(items):
                n = it.stop - it.start
                ro[slot, :n] = it.rays_o
                rd[slot, :n] = it.rays_d

        # The fused stepper's item-aware entry routes each slot through
        # the pose-cache tiers (hit/warp/march); injected 4-arg fakes
        # keep the plain padded-bucket protocol.
        step_items = getattr(self._device_step, "step_items", None)
        if step_items is not None:
            colors = np.asarray(step_items(scene, entry.artifact, items, ro, rd))
        else:
            colors = np.asarray(self._device_step(scene, entry.artifact, ro, rd))
        assert colors.shape == (S, R, 3), colors.shape
        self._steps += 1
        self._event(
            ("bucket", scene, tuple((it.rid, it.seq) for it in items))
        )

        now = self._clock()
        with spans.span("hero.step.scatter"):
            for slot, it in enumerate(items):
                if self._stepper is not None:
                    self._stepper.unpin_pose(it.pose_key)
                req = self._requests[it.rid]
                n = it.stop - it.start
                req.colors[it.start:it.stop] = colors[slot, :n]
                req.done[it.start:it.stop] = True
                req.fresh_spans.append((it.start, it.stop))
                req.items_done += 1
                self._items_rendered += 1
                self._rays_rendered += n
                if req.items_done == req.n_items:
                    req.t_done = now
                    self._t_last_done = now
                    self._requests_completed += 1
                    self._ring.append(CompletedRecord(
                        rid=req.rid, scene=req.scene, n_rays=req.n_rays,
                        t_submit=req.t_submit, t_done=now,
                    ))
                    self._event(("complete", it.rid))
        return dropped_total + len(items)

    def drain(self) -> None:
        """Process every queue until the engine is idle."""
        while self.step():
            pass

    # ------------------------------------------------------------------
    # Results: streaming partials + terminal retrieval
    # ------------------------------------------------------------------
    def poll(self, rid: int) -> List[Tuple[int, int, np.ndarray]]:
        """Completed-but-not-yet-polled spans of a live request, as
        [(start, stop, colors-copy)] — the streaming seam: work items
        surface here as soon as their device step lands, before the full
        request drains. Spans already polled are not repeated. An expired
        request raises `RequestExpired` (terminal for streamers;
        `result()` frees it)."""
        req = self._live(rid)
        if req.expired:
            raise RequestExpired(
                f"request {rid} expired past its deadline "
                f"({req.items_dropped}/{req.n_items} items dropped)"
            )
        spans, req.fresh_spans = req.fresh_spans, []
        return [(s, e, req.colors[s:e].copy()) for (s, e) in spans]

    def partial(self, rid: int) -> Tuple[np.ndarray, np.ndarray]:
        """(colors, done_mask) snapshot of a live request: colors of rays
        with done_mask False are meaningless zeros."""
        req = self._live(rid)
        return req.colors.copy(), req.done.copy()

    def result(self, rid: int) -> np.ndarray:
        """(N, 3) colors of a completed request. RETRIEVAL FREES the
        request (the `_requests`-leak fix): a second call raises KeyError;
        stats survive in the bounded completed ring. An expired request
        raises `RequestExpired` AND frees — no complete result exists."""
        req = self._live(rid)
        if req.expired:
            del self._requests[rid]
            raise RequestExpired(
                f"request {rid} expired past its deadline "
                f"({req.items_dropped}/{req.n_items} items dropped)"
            )
        if req.t_done is None:
            raise ValueError(f"request {rid} is not complete "
                             f"({req.items_done}/{req.n_items} items)")
        del self._requests[rid]
        return req.colors

    def _live(self, rid: int) -> RequestState:
        req = self._requests.get(rid)
        if req is None:
            raise KeyError(
                f"request {rid} unknown (never submitted, or already "
                "retrieved — results are freed on retrieval)"
            )
        return req

    def render(self, rays_o, rays_d, scene: Optional[str] = None) -> np.ndarray:
        """Convenience: submit one request and drain the engine."""
        rid = self.submit(rays_o, rays_d, scene=scene)
        self.drain()
        return self.result(rid)

    # ------------------------------------------------------------------
    def warmup(self) -> None:
        """Render one request per resident scene outside any timed region
        (kernel build, first launches), then reset stats (grown budgets
        persist)."""
        R = self.cfg.slot_rays
        ro = np.zeros((R, 3), np.float32)
        rd = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (R, 1))
        for scene in list(self._cache.scenes()):
            rid = self.submit(ro, rd, scene=scene)
            self.drain()
            self.result(rid)
        self.reset_stats()

    def reset_stats(self) -> None:
        """Zero counters/timers/ring; live requests and budgets persist.
        Conservation (`submitted == completed + pending`) is preserved by
        re-basing the submitted counters on what is still in flight."""
        live_incomplete = [
            r for r in self._requests.values()
            if r.t_done is None and not r.expired
        ]
        self._requests_submitted = len(live_incomplete)
        self._requests_completed = 0
        self._requests_expired = 0
        self._rejected = 0
        self._sched.items_submitted = self._sched.pending()
        self._sched.rays_submitted = self._sched.pending_rays()
        self._items_rendered = 0
        self._rays_rendered = 0
        self._items_dropped = 0
        self._rays_dropped = 0
        self._steps = 0
        self._ring.clear()
        self._t_first_submit = None
        self._t_last_done = None
        self._cache.reset_stats()
        if self._stepper is not None:
            self._stepper.reset_stats()
        if self._events is not None:
            self._events.clear()

    # ------------------------------------------------------------------
    def stats(self) -> Dict:
        """Counters, throughput, and ring-based latency percentiles."""
        ring = list(self._ring)
        lat_ms = np.asarray(
            [(r.t_done - r.t_submit) * 1e3 for r in ring], np.float64
        )
        wall = (
            (self._t_last_done - self._t_first_submit)
            if self._t_last_done is not None
            and self._t_first_submit is not None
            else 0.0
        )
        done = self._requests_completed
        pending_items = self._sched.pending()
        budgets = self._stepper.budgets() if self._stepper is not None else {}
        return {
            "requests_submitted": self._requests_submitted,
            "requests_completed": done,
            "requests_expired": self._requests_expired,
            "requests_pending": (
                self._requests_submitted - done - self._requests_expired
            ),
            "requests_rejected": self._rejected,
            "items_submitted": self._sched.items_submitted,
            "items_rendered": self._items_rendered,
            "items_pending": pending_items,
            "items_dropped": self._items_dropped,
            "rays_submitted": self._sched.rays_submitted,
            "rays_rendered": self._rays_rendered,
            "rays_pending": self._sched.pending_rays(),
            "rays_dropped": self._rays_dropped,
            "device_steps": self._steps,
            "wall_seconds": round(wall, 6),
            "requests_per_sec": round(done / wall, 4) if wall > 0 else None,
            "rays_per_sec": (
                round(self._rays_rendered / wall, 1) if wall > 0 else None
            ),
            "latency_ms": {
                "mean": round(float(lat_ms.mean()), 3) if ring else None,
                "p50": round(float(np.percentile(lat_ms, 50)), 3) if ring else None,
                "p95": round(float(np.percentile(lat_ms, 95)), 3) if ring else None,
                "max": round(float(lat_ms.max()), 3) if ring else None,
            },
            "max_queue_age": self._sched.max_queue_age(),
            "scenes": sorted(self.scenes),
            "sample_budget": {s: budgets[s] for s in sorted(budgets)} or None,
            "budget_retraces": self.retraces,
            "cache": {
                "resident": self._cache.scenes(),
                "resident_bytes": self._cache.resident_bytes,
                "capacity_bytes": self._cache.cache_bytes,
                "loads": self._cache.loads,
                "evictions": self._cache.evictions,
                "hits": self._cache.hits,
                "overflows": self._cache.overflows,
                "load_failures": self._cache.load_failures,
            },
            "slots": self.cfg.slots,
            "slot_rays": self.cfg.slot_rays,
            "pose_cache": (
                self._stepper.pose_stats()
                if self._stepper is not None else None
            ),
            "slot_graphs": (
                self._stepper.graph_stats()
                if self._stepper is not None else None
            ),
        }


def serve_engine(
    artifacts,
    cfg: EngineConfig = EngineConfig(),
    *,
    loader=None,
    warmup: bool = True,
    **kw,
) -> ServeEngine:
    """Stand up a multi-scene serve engine. `warmup=True` renders one
    request per resident scene (building the kernels, settling budgets)
    so first requests are not charged the set-up."""
    eng = ServeEngine(artifacts, cfg, loader=loader, **kw)
    if warmup:
        eng.warmup()
    return eng
