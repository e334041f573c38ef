"""Failure and straggler policy of the cell orchestrator.

Two pieces, both plain Python (the JAX package's, copied):

* `plan_rescale` keeps a global batch (here: the sweep's total lease
  capacity) identical when the number of data-parallel workers changes,
  by recomputing the per-worker accumulation factor. The orchestrator
  calls it when a worker dies or is evicted and the pool shrinks.
* `StepWatchdog` flags steps that exceed a latency SLO against the
  rolling median of completed steps, so the orchestrator can evict a
  hung or straggling worker instead of waiting on it forever.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    """How to keep the global batch/schedule identical across a mesh change."""

    old_dp: int
    new_dp: int
    old_accum: int
    new_accum: int
    microbatch_per_shard: int

    @property
    def global_batch(self) -> int:
        return self.new_dp * self.microbatch_per_shard * self.new_accum


def plan_rescale(
    global_batch: int, microbatch_per_shard: int, old_dp: int, new_dp: int,
    old_accum: Optional[int] = None,
) -> RescalePlan:
    """Recompute the accumulation factor so global batch is preserved when
    the DP world size changes (worker loss or growth)."""
    if global_batch % (new_dp * microbatch_per_shard) != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"new_dp*microbatch = {new_dp * microbatch_per_shard}"
        )
    new_accum = global_batch // (new_dp * microbatch_per_shard)
    return RescalePlan(
        old_dp=old_dp,
        new_dp=new_dp,
        old_accum=old_accum or global_batch // (old_dp * microbatch_per_shard),
        new_accum=new_accum,
        microbatch_per_shard=microbatch_per_shard,
    )


class StepWatchdog:
    """Flags slow steps against a rolling-median SLO (straggler signal).

    Two entry styles share one rolling window:

    * `start()` / `stop(step)` — the wrap-a-step API, measuring with the
      injected `clock` (default `time.monotonic`).
    * `record(dt)` / `is_slow(dt)` — duration-based, for callers that
      already own the timing (the cell orchestrator measures a worker
      lease with ITS injected clock and asks the watchdog for the
      verdict; `is_slow` never mutates the window, so an in-flight hang
      can be probed repeatedly).

    No verdict is issued before `min_samples` completed durations exist —
    a cold median would flag the first real step against noise. The SLO
    boundary is strict: `dt == slo_factor * median` is NOT slow.
    """

    def __init__(self, slo_factor: float = 2.0, window: int = 32,
                 on_slow: Optional[Callable[[int, float, float], None]] = None,
                 min_samples: int = 5,
                 clock: Callable[[], float] = time.monotonic):
        self.slo_factor = slo_factor
        self.window = window
        self.on_slow = on_slow
        self.min_samples = min_samples
        self.clock = clock
        self._durations: list = []
        self._t0: Optional[float] = None
        self.slow_steps: list = []

    def median(self) -> Optional[float]:
        """Rolling median of recorded durations; None before min_samples."""
        if len(self._durations) < self.min_samples:
            return None
        return sorted(self._durations)[len(self._durations) // 2]

    def is_slow(self, dt: float) -> bool:
        """Would a step of duration `dt` violate the SLO? Pure query —
        records nothing, so it can probe a still-running step."""
        med = self.median()
        return med is not None and dt > self.slo_factor * med

    def record(self, dt: float) -> None:
        """Add a completed duration to the rolling window."""
        self._durations.append(float(dt))
        if len(self._durations) > self.window:
            self._durations.pop(0)

    def start(self):
        self._t0 = self.clock()

    def stop(self, step: int) -> bool:
        """Returns True if this step violated the SLO."""
        if self._t0 is None:
            raise RuntimeError("StepWatchdog.stop() before start()")
        dt = self.clock() - self._t0
        self._t0 = None
        slow = self.is_slow(dt)
        if slow:
            self.slow_steps.append(step)
            if self.on_slow:
                med = self.median()
                self.on_slow(step, dt, med)
        self.record(dt)
        return slow
