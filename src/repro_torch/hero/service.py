"""`RenderService`: single-artifact compatibility facade over the engine.

The serving machinery lives in `repro_torch.hero.engine` (`ServeEngine`: async
request queues, continuous batching across requests AND scenes, LRU
artifact cache, streaming partial frames). This module keeps the PR-4
single-artifact surface — `submit`/`step`/`drain`/`result`/`render`/
`warmup`/`stats`, plus the `budget`/`retraces`/`pending` properties —
as a thin delegation layer over the scheduler the multi-scene engine
uses. `result(rid)` FREES the request's color buffer; a second
`result()` on the same rid raises KeyError, and throughput/latency stats
survive retrieval in a bounded completed-request ring.

No threads: `step()`/`drain()` are synchronous and deterministic. The
service runs on the card unless `device="cpu"`; the artifact must have
been loaded onto the same device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np

from repro_torch.hero.artifact import QuantArtifact
from repro_torch.hero.engine import ServeEngine
from repro_torch.hero.scheduler import EngineConfig
from repro_torch.kernels.backend import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    slots: int = 4  # concurrent work items per device step
    slot_rays: int = 512  # rays per slot (requests split into items)
    # Initial per-slot sample budget for the compacting renderer:
    #   "auto" — estimate from the grid's occupied fraction (with
    #            headroom); grows on demand, results stay exact;
    #   None   — no compaction cap (B = slot_rays * n_samples, exact and
    #            retrace-free, but no compute saved on empty space);
    #   int    — explicit starting budget (still grows on overflow).
    budget: Union[str, int, None] = "auto"
    budget_headroom: float = 1.5
    early_stop: bool = True
    # Completed-request stat records kept after `result()` frees a
    # request (latency percentiles are computed over this ring).
    completed_ring: int = 1024
    # Bounded admission: max queued work items; submits past the cap
    # raise `AdmissionFull` (None = unbounded).
    max_pending: Optional[int] = None

    def engine_config(self, **overrides) -> EngineConfig:
        """The equivalent `EngineConfig` (single-scene engines share every
        knob; multi-scene extras like `cache_bytes` ride in overrides)."""
        return EngineConfig(
            slots=self.slots, slot_rays=self.slot_rays, budget=self.budget,
            budget_headroom=self.budget_headroom,
            early_stop=self.early_stop, completed_ring=self.completed_ring,
            max_pending=self.max_pending,
            **overrides,
        )


class RenderService:
    """Synchronous batched render service for one compiled artifact."""

    def __init__(self, artifact: QuantArtifact, cfg: ServeConfig = ServeConfig(),
                 device: DeviceLike = None):
        device = resolve_device(device)
        self.artifact = artifact
        self.cfg = cfg
        self._scene = artifact.scene
        self._engine = ServeEngine({self._scene: artifact},
                                   cfg.engine_config(), device=device)

    @property
    def engine(self) -> ServeEngine:
        """The underlying serve engine (shared scheduler machinery)."""
        return self._engine

    # ------------------------------------------------------------------
    def submit(self, rays_o, rays_d, deadline: Optional[float] = None) -> int:
        """Enqueue one render request ((N, 3) rays); returns a request id.
        `deadline` (engine-clock timestamp) makes it droppable — see
        `ServeEngine.submit`."""
        return self._engine.submit(
            rays_o, rays_d, scene=self._scene, deadline=deadline
        )

    @property
    def pending(self) -> int:
        return self._engine.pending

    @property
    def budget(self) -> Optional[int]:
        return self._engine.budget_of(self._scene)

    @property
    def retraces(self) -> int:
        return self._engine.retraces

    # ------------------------------------------------------------------
    def step(self) -> int:
        """Render up to `slots` queued work items in one device call.
        Returns the number of work items completed (0 = queue empty)."""
        return self._engine.step()

    def drain(self) -> None:
        """Process the queue until empty."""
        self._engine.drain()

    # ------------------------------------------------------------------
    def poll(self, rid: int):
        """Streaming: completed-but-not-yet-polled [(start, stop, colors)]
        spans of a live request (see `ServeEngine.poll`)."""
        return self._engine.poll(rid)

    def result(self, rid: int) -> np.ndarray:
        """(N, 3) colors of a completed request. Retrieval frees the
        request; a second call raises KeyError (module docstring)."""
        return self._engine.result(rid)

    def render(self, rays_o, rays_d) -> np.ndarray:
        """Convenience: submit one request and drain the service."""
        rid = self.submit(rays_o, rays_d)
        self.drain()
        return self.result(rid)

    def warmup(self) -> None:
        """Render one request outside any timed region (kernel build, first
        launches). Stats describe served traffic only: the warmup's device
        step and any budget growth it provoked are setup."""
        self._engine.warmup()

    # ------------------------------------------------------------------
    def stats(self) -> Dict:
        """Throughput + latency percentiles over completed requests (the
        engine's counters, with the single-scene scalar budget field)."""
        s = self._engine.stats()
        s["sample_budget"] = self.budget
        return s


def serve(
    artifact: QuantArtifact,
    cfg: ServeConfig = ServeConfig(),
    warmup: bool = True,
    device: DeviceLike = None,
) -> RenderService:
    """Stand up a render service for a compiled artifact. `warmup=True`
    renders one request at once so the first real request is not charged
    the kernel build."""
    svc = RenderService(artifact, cfg, device=device)
    if warmup:
        svc.warmup()
    return svc
