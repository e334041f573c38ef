"""What one run of a cell leaves for the metric readers and the result."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from bench.lib.trace import Trace


@dataclasses.dataclass
class Check:
    """One number compared with the reference, beside its limit: the run
    is correct where `value <= limit`."""

    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    setup_s: float
    window_s: float
    attempted: int
    failed: int
    memory_peak_bytes: int
    # Host-clock records of the window, by kind: "frame_ms" (one a frame),
    # "step_s", "prefill_s", "decode_s" (one a call or a batch's steps).
    records: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    # Counts the window made: frames, tokens, positions, steps; the
    # program's own counters (pose-cache hits, warps, misses).
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    # Least device seconds of the traced window's work, by kernel group,
    # from the frozen counts (`bench/lib/costs.py`), and the operations
    # of the measured window's model work at their peak rate.
    work: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace: Optional[Trace] = None
    checks: Dict[str, Check] = dataclasses.field(default_factory=dict)
    notes: List[Tuple[str, str]] = dataclasses.field(default_factory=list)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and self.failed == 0 and all(
            c.ok for c in self.checks.values())
