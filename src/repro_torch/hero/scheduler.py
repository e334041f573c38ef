"""Pure scheduling core for the serve engine: no torch, no clocks, no I/O.

The engine (`repro_torch.hero.engine`) is an LLM-inference-engine-shaped serve
loop; this module is the deterministic half it steps on. Requests split
into fixed-size ray work items; items queue per scene (one FIFO per
`QuantArtifact`); every device step the engine asks the scheduler for one
*bucket* — up to `slots` items of a SINGLE scene — so a step renders one
artifact at the engine's fixed padded shapes and mixing scenes across
steps never retraces.

Scene selection is oldest-first: the bucket always comes from the scene
whose head-of-queue item has the globally smallest enqueue order. Two
consequences the tests pin:

  * the globally-oldest queued item is in EVERY bucket (it is, by
    construction, the head of the selected scene's FIFO), so no request
    starves — an item admitted at global order k waits at most k
    unfinished older items, never on later arrivals;
  * buckets are single-scene, deterministic, and independent of wall
    time — the whole scheduler is drivable from a fake clock.

Conservation is bookkept here (items/rays submitted, completed, pending)
so the engine's `stats()` can assert `submitted == completed + pending`
without trusting its own scatter loop.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple, Union

import numpy as np


class AdmissionFull(RuntimeError):
    """`submit()` rejected: the engine's pending-item queue is at
    `max_pending` — the backpressure signal a front-end turns into 429/
    shed-load instead of letting the queue grow without bound."""


class RequestExpired(RuntimeError):
    """The request's deadline passed before all its items rendered; its
    queued items were dropped and no complete result exists."""


class ArtifactLoadError(RuntimeError):
    """The artifact loader (or size function) raised during a cache miss;
    the cache state is unchanged (no partial entry, no skewed stats)."""


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static shape + policy knobs of the serve engine."""

    slots: int = 4  # work items per device step (one scene per step)
    slot_rays: int = 512  # rays per work item; requests split into items
    # Per-scene initial sample budget for the compacting renderer — the
    # same "auto"/None/int semantics as `ServeConfig.budget`; grows on
    # overflow (one retrace), results stay exact. Ignored by injected
    # device-step functions (the budget belongs to the fused stepper).
    budget: Union[str, int, None] = "auto"
    budget_headroom: float = 1.5
    early_stop: bool = True
    # LRU artifact cache: total resident payload bytes allowed; None =
    # unbounded (nothing is ever evicted). Scenes with queued work are
    # never evicted regardless of pressure.
    cache_bytes: Optional[int] = None
    # Completed-request stat records retained after `result()` frees a
    # request's color buffer (the `_requests`-leak fix): latency
    # percentiles are computed over this bounded ring.
    completed_ring: int = 1024
    # >0: record the last N scheduler/cache events ("submit"/"bucket"/
    # "load"/"evict"/"complete"/"drop"/"expire" tuples) for test-harness
    # trace assertions.
    trace_events: int = 0
    # Bounded admission: max queued work items across all scenes; a
    # submit() that would exceed it raises AdmissionFull (and counts in
    # the `rejected` stat). None = unbounded (the historical behavior).
    max_pending: Optional[int] = None
    # Ad-hoc compaction strategy of the fused stepper: "march" (default;
    # the occupancy ray-march kernel's active mask + gather compaction) or
    # "scatter" (the legacy cumsum+scatter path — byte-identical colors,
    # kept as the baseline). "scatter" disables the pose-cache tiers.
    compaction: str = "march"
    # Pose-grid plan cache (`repro_torch.nerf.pose_cache`): ad-hoc requests
    # are keyed to a quantized pose cell; repeat cells get compiled cull
    # plans (hit tier) and nearby poses reuse them conservatively (warp
    # tier). Ignored by injected device-step functions.
    pose_cache: bool = True
    pose_pos_cell: float = 0.05  # world units per position cell
    pose_dir_cell: float = 0.05  # direction units per orientation cell
    pose_margin_cells: float = 1.0  # warp coverage margin, in occ cells
    pose_cache_entries: int = 128  # LRU capacity (pose cells)
    pose_build_after: int = 2  # bake plans on the Nth request visit of a cell


@dataclasses.dataclass
class WorkItem:
    """One slot-sized slice of a request's rays."""

    rid: int
    scene: str
    seq: int  # item index within the request
    start: int  # ray offset within the request
    stop: int
    rays_o: np.ndarray  # (stop - start, 3)
    rays_d: np.ndarray
    order: int  # global enqueue order — the scheduler's age key
    t_enqueue: float
    # Pose-grid cell of the request's bundle ((scene,) + cell tuple),
    # None when the pose cache is off or the stepper doesn't support it.
    pose_key: Optional[tuple] = None


@dataclasses.dataclass
class RequestState:
    """Live request: color buffer being filled as items complete."""

    rid: int
    scene: str
    n_rays: int
    n_items: int
    colors: np.ndarray  # (n_rays, 3)
    done: np.ndarray  # (n_rays,) bool — rays already rendered
    items_done: int = 0
    t_submit: float = 0.0
    t_done: Optional[float] = None
    # Per-request deadline (engine clock domain); queued items of a
    # request whose deadline has passed are dropped at bucket-take time.
    deadline: Optional[float] = None
    items_dropped: int = 0
    expired: bool = False
    # Completed (start, stop) spans not yet surfaced through `poll()` —
    # the streaming seam: partial frames are observable before the
    # request drains.
    fresh_spans: List[Tuple[int, int]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class CompletedRecord:
    """Bounded-ring stat record of a completed request (no ray payload)."""

    rid: int
    scene: str
    n_rays: int
    t_submit: float
    t_done: float


class Scheduler:
    """Per-scene FIFO queues + oldest-first single-scene bucket selection."""

    def __init__(self, slots: int):
        assert slots >= 1, slots
        self.slots = int(slots)
        self._queues: Dict[str, Deque[WorkItem]] = {}
        self._order = 0
        self.items_submitted = 0
        self.rays_submitted = 0

    # ------------------------------------------------------------------
    def next_order(self) -> int:
        o = self._order
        self._order += 1
        return o

    def push(self, item: WorkItem) -> None:
        self._queues.setdefault(item.scene, deque()).append(item)
        self.items_submitted += 1
        self.rays_submitted += item.stop - item.start

    def requeue_front(self, items: List[WorkItem]) -> None:
        """Return taken-but-unrendered items to the head of their queues
        in their original order (engine failure recovery: a raising
        artifact loader must not lose work). Does NOT touch the submitted
        counters — the items were already counted on push."""
        for it in reversed(items):
            self._queues.setdefault(it.scene, deque()).appendleft(it)

    # ------------------------------------------------------------------
    def pending(self, scene: Optional[str] = None) -> int:
        """Queued items (for one scene, or in total)."""
        if scene is not None:
            q = self._queues.get(scene)
            return len(q) if q else 0
        return sum(len(q) for q in self._queues.values())

    def pending_rays(self) -> int:
        return sum(
            it.stop - it.start for q in self._queues.values() for it in q
        )

    def scenes_with_work(self) -> List[str]:
        return [s for s, q in self._queues.items() if q]

    def oldest_scene(self) -> Optional[str]:
        """Scene holding the globally-oldest queued item (None = idle)."""
        best: Optional[str] = None
        best_order = -1
        for scene, q in self._queues.items():
            if q and (best is None or q[0].order < best_order):
                best, best_order = scene, q[0].order
        return best

    def oldest_order(self) -> Optional[int]:
        s = self.oldest_scene()
        return self._queues[s][0].order if s is not None else None

    def max_queue_age(self, now_order: Optional[int] = None) -> int:
        """Age (in enqueue orders) of the oldest queued item — the
        starvation bound the property tests watch."""
        head = self.oldest_order()
        if head is None:
            return 0
        return (self._order if now_order is None else now_order) - head

    # ------------------------------------------------------------------
    def take_bucket(self) -> Tuple[Optional[str], List[WorkItem]]:
        """Pop up to `slots` items from the oldest scene's FIFO head.

        Single-scene by construction; the globally-oldest item is always
        items[0]. Returns (None, []) when idle.
        """
        scene = self.oldest_scene()
        if scene is None:
            return None, []
        q = self._queues[scene]
        items = [q.popleft() for _ in range(min(self.slots, len(q)))]
        return scene, items
