"""Deterministic fault injection for the cell orchestrator.

A fleet sweep must survive dead workers, hung device steps, torn
checkpoint writes, and transient scorer exceptions — and each recovery
path must run in tests with zero real renders and no wall-clock sleeps.
This module provides the seams (the JAX package's, copied, so a seed
faults the same cells with the same kinds in both packages):

* `FaultPlan` — a SEEDED schedule of faults keyed by (cell, attempt).
  The same seed always produces the same plan. Each fault fires at most
  once per plan instance (consumed on injection), mirroring how real
  faults are one-shot events: the retry of a crashed cell runs clean
  unless the plan says otherwise.
* `ChaosWorker` — wraps any worker and intercepts `start`/`poll` to
  realize the plan: a `crash` fault reports the worker dead WITHOUT
  running the cell (no wasted work, no leaked threads), a `hang` makes
  `poll()` return nothing forever (the watchdog path), a `transient`
  surfaces a retryable in-worker exception while the worker survives.
* `tear_checkpoint` — truncates a checkpoint file in place, simulating a
  host killed mid-write on a filesystem without atomic rename (the
  quarantine path in `HeroSearchRun._load_checkpoint` must absorb it).

The orchestrator takes a `chaos=FaultPlan(...)` argument and threads it
through its own worker construction; production runs pass None and no
chaos code executes.
"""
from __future__ import annotations

import dataclasses
import random
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

FAULT_KINDS = ("crash", "hang", "transient", "torn_checkpoint")


class ChaosInterrupt(RuntimeError):
    """Raised by the orchestrator when the fault plan kills the RUN itself
    (torn checkpoint write = the orchestrating host died mid-write). The
    caller relaunches, exactly like a real preemption."""


class TransientWorkerError(RuntimeError):
    """A retryable in-worker failure (e.g. a scorer OOM that clears)."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault: `kind` fires when `cell` is started for the
    `attempt`-th time (0-based)."""

    kind: str
    cell: str
    attempt: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{FAULT_KINDS}"
            )


class FaultPlan:
    """A deterministic, consumable schedule of faults.

    Build explicitly from `Fault`s for surgical tests, or with
    `FaultPlan.seeded(seed, cells)` for randomized-but-reproducible chaos
    (the CLI's `--chaos <seed>`). Faults are consumed on injection: the
    retry of a faulted (cell, attempt) pair never re-fires it.
    """

    def __init__(self, faults: Sequence[Fault] = ()):
        self._pending: Dict[Tuple[str, str, int], Fault] = {}
        for f in faults:
            self._pending[(f.kind, f.cell, f.attempt)] = f
        self.injected: List[Fault] = []

    @staticmethod
    def seeded(
        seed: int,
        cells: Sequence[str],
        kinds: Sequence[str] = ("crash", "transient"),
        n_faults: int = 1,
    ) -> "FaultPlan":
        """Pick `n_faults` (cell, kind) pairs with a dedicated PRNG. Only
        first attempts are faulted — the seeded plan models independent
        one-shot failures, so every faulted cell's retry succeeds and the
        sweep always completes."""
        if not cells:
            return FaultPlan()
        rng = random.Random(seed * 2654435761 % (2**31))
        faults = []
        chosen = rng.sample(list(cells), k=min(n_faults, len(cells)))
        for cell in chosen:
            faults.append(Fault(kind=rng.choice(list(kinds)), cell=cell))
        return FaultPlan(faults)

    def take(self, kind: str, cell: str, attempt: int) -> Optional[Fault]:
        """Consume and return the scheduled fault, if any."""
        f = self._pending.pop((kind, cell, attempt), None)
        if f is not None:
            self.injected.append(f)
        return f

    def peek(self, kind: str, cell: str, attempt: int) -> bool:
        return (kind, cell, attempt) in self._pending

    def pending(self) -> List[Fault]:
        return list(self._pending.values())


def tear_checkpoint(path: str) -> None:
    """Simulate a host killed mid-checkpoint-write: leave a syntactically
    invalid prefix of the file in place (NOT a rename — the torn write is
    the point). The next `_load_checkpoint` must quarantine it."""
    p = Path(path)
    if not p.exists():
        return
    data = p.read_bytes()
    p.write_bytes(data[: max(1, len(data) // 3)])


class ChaosWorker:
    """A worker decorator that realizes a `FaultPlan`.

    Wraps the orchestrator's real worker and intercepts the lease
    lifecycle; with no fault scheduled for the (cell, attempt) being
    started, every call passes straight through.
    """

    def __init__(self, inner, plan: FaultPlan):
        self.inner = inner
        self.plan = plan
        self._mode: Optional[str] = None  # None | crash | hang | transient
        self._spec = None
        self._attempt = 0

    @property
    def name(self) -> str:
        return getattr(self.inner, "name", "worker")

    def start(self, spec, attempt: int) -> None:
        self._spec, self._attempt = spec, attempt
        for kind in ("crash", "hang", "transient"):
            if self.plan.take(kind, spec.name, attempt):
                # The faulted cell never reaches the inner worker: a
                # crashed/hung host does no useful work, and not starting
                # it keeps tests free of leaked threads.
                self._mode = kind
                return
        self._mode = None
        self.inner.start(spec, attempt)

    def poll(self):
        if self._mode == "crash":
            self._mode = None
            return ("crashed", self._spec, self._attempt,
                    RuntimeError(f"worker killed on {self._spec.name}"))
        if self._mode == "hang":
            return None  # forever: only the watchdog can reclaim the cell
        if self._mode == "transient":
            self._mode = None
            return ("error", self._spec, self._attempt,
                    TransientWorkerError(
                        f"transient failure on {self._spec.name}"
                    ))
        return self.inner.poll()

    def alive(self) -> bool:
        if self._mode == "crash":
            return True  # the crash surfaces through poll(), once
        return self.inner.alive()

    def busy(self) -> bool:
        if self._mode is not None:
            return True
        return self.inner.busy()

    def close(self) -> None:
        self._mode = None
        self.inner.close()
