"""Elastic cell-parallel orchestrator for the closed-loop search.

`HeroSearchRun.run()` leases scene×budget cells to ONE process in
canonical order. This module dispatches the same `CellSpec`s to a pool
of workers and survives the failures a fleet sweep meets in practice:

* **worker death** — the cell is re-leased to a surviving worker with
  capped exponential backoff, and the pool shrink is governed by
  `plan_rescale` (the per-worker share of remaining capacity grows the
  way gradient accumulation grows when a data-parallel worker drops out);
* **hung device step** — the `StepWatchdog` compares a lease's elapsed
  time against the rolling median of completed cells (plus an absolute
  `hang_timeout` for the cold-start case where no median exists) and
  evicts the worker;
* **transient in-worker exceptions** — retried in place, the worker
  survives;
* **interruption of the orchestrator itself** — per-cell atomic
  checkpoints (the same schema-v2 file `HeroSearchRun` writes) mean a
  killed-and-resumed sweep replays to EXACTLY the uninterrupted joint
  frontier, because merging happens in canonical cell order at finalize
  time, never in completion order.

Everything time-like is injected (`clock=`, `sleep=`) and every failure
mode is injectable through `repro_torch.distributed.chaos`, so all
recovery paths run in tests with zero real renders and no wall-clock
sleeps. With `workers=1`, inline workers, and no chaos, the orchestrator
is result-identical to the sequential `HeroSearchRun.run()`. The event
trail (`ElasticOrchestrator.events`) and the retry, backoff, eviction
and rescale rules are the JAX package's.

The orchestrator is generic over a `CellProgram` (duck-typed): the
production adapter `SearchCellProgram` wraps a `HeroSearchRun`; tests
inject a fake program that fabricates `CellOutput`s without rendering.

Thread workers share the run's device and its bundles; on one card their
work lands on the same default stream, in the order the threads enqueue
it. Subprocess workers run `python -m repro_torch.distributed.worker_main`,
each pinned to one card by `CUDA_VISIBLE_DEVICES` (or on the CPU, where
the run lives there), with its output drained to a temporary file.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.closed_loop import (
    CellOutput,
    CellSpec,
    ClosedLoopResult,
    HeroSearchRun,
    config_to_json,
)
from repro_torch.distributed.chaos import (
    ChaosInterrupt,
    ChaosWorker,
    FaultPlan,
    tear_checkpoint,
)
from repro_torch.distributed.fault_tolerance import StepWatchdog, plan_rescale
from repro_torch.kernels.backend import DeviceLike, resolve_device


class NoWorkersLeft(RuntimeError):
    """Every worker died/was evicted while cells were still pending."""


class CellRetriesExhausted(RuntimeError):
    """One cell failed `max_attempts` times — the fault is not transient."""


# ---------------------------------------------------------------------------
# Workers: one protocol, three kinds
# ---------------------------------------------------------------------------
# A worker executes ONE leased cell at a time:
#   start(spec, attempt)  lease the cell (non-blocking for real workers)
#   poll()                None while running, else one CellEvent
#   alive()               False once the worker is unusable (dead process)
#   busy()                a lease is outstanding
#   close()               release resources
# CellEvent = (kind, spec, attempt, payload) with kind in
#   "done"    payload = CellOutput
#   "error"   payload = the exception (worker SURVIVES; retryable)
#   "crashed" payload = the exception (worker is DEAD; pool shrinks)
CellEvent = Tuple[str, CellSpec, int, object]


class InlineWorker:
    """Synchronous in-process worker: `start` runs the cell immediately,
    `poll` hands back the buffered event. The deterministic baseline —
    `workers=1` + `InlineWorker` + no chaos IS the sequential run."""

    def __init__(self, run_fn: Callable[[CellSpec], CellOutput],
                 name: str = "inline-0"):
        self.run_fn = run_fn
        self.name = name
        self._event: Optional[CellEvent] = None

    def start(self, spec: CellSpec, attempt: int) -> None:
        try:
            self._event = ("done", spec, attempt, self.run_fn(spec))
        except Exception as e:  # noqa: BLE001 — routed to retry policy
            self._event = ("error", spec, attempt, e)

    def poll(self) -> Optional[CellEvent]:
        ev, self._event = self._event, None
        return ev

    def alive(self) -> bool:
        return True

    def busy(self) -> bool:
        return self._event is not None

    def close(self) -> None:
        self._event = None


class ThreadWorker:
    """One cell on one daemon thread at a time (the default pool kind).

    Cells share the process (and scene bundles — `prepare` builds them on
    the orchestrator thread before leasing), so this overlaps the cells'
    host work and keeps results bit-identical to inline execution. The
    thread starts with grad mode on and the default card current, as
    every new thread does: a cell sets what it needs itself.
    """

    def __init__(self, run_fn: Callable[[CellSpec], CellOutput],
                 name: str = "thread-0"):
        self.run_fn = run_fn
        self.name = name
        self._thread: Optional[threading.Thread] = None
        self._event: Optional[CellEvent] = None
        self._dead = False

    def start(self, spec: CellSpec, attempt: int) -> None:
        if self._thread is not None:
            raise RuntimeError(f"{self.name} already has a lease")
        self._event = None

        def _target():
            try:
                out = self.run_fn(spec)
                self._event = ("done", spec, attempt, out)
            except Exception as e:  # noqa: BLE001 — routed to retry policy
                self._event = ("error", spec, attempt, e)

        self._thread = threading.Thread(
            target=_target, name=f"hero-{self.name}", daemon=True
        )
        self._thread.start()

    def poll(self) -> Optional[CellEvent]:
        if self._thread is not None and not self._thread.is_alive():
            ev, self._event = self._event, None
            self._thread = None
            return ev
        return None

    def alive(self) -> bool:
        return not self._dead

    def busy(self) -> bool:
        return self._thread is not None

    def close(self) -> None:
        # Daemon thread; an evicted hung thread is abandoned, not joined —
        # joining a truly hung device step would hang the orchestrator too.
        self._dead = True


class SubprocessWorker:
    """One cell per OS process (`--worker-kind subprocess`): the strongest
    isolation — a scorer that segfaults or dies of a CUDA error kills the
    worker, not the sweep. The job travels as JSON (config + spec + the
    run's device kind) through a temp file; the result comes back on a
    marker line of the child's output (`repro_torch.distributed.worker_main`),
    which goes to a temp file the child can never fill up.

    On a card the worker `index`-th of a pool is pinned to card
    `index % n_cards` through `CUDA_VISIBLE_DEVICES`; the child then sees
    that card alone, as "cuda". The child loads the kernel library the
    parent built (the same sources hash to the same file) and rebuilds
    nothing.
    """

    MARKER = "HERO_CELL_OUTPUT:"

    def __init__(self, payload_fn: Callable[[CellSpec], Dict],
                 name: str = "proc-0", device: DeviceLike = None,
                 index: int = 0):
        self.payload_fn = payload_fn
        self.name = name
        self.device = resolve_device(device)
        self.card = (index % torch.cuda.device_count()
                     if self.device.type == "cuda" else None)
        self._proc: Optional[subprocess.Popen] = None
        self._lease: Optional[Tuple[CellSpec, int]] = None
        self._job_path: Optional[str] = None
        self._log = None
        self._dead = False

    def _child_env(self) -> Dict[str, str]:
        # The child must import repro_torch exactly as this process does.
        import repro_torch

        src_root = str(Path(next(iter(repro_torch.__path__))).resolve().parent)
        env = dict(os.environ)
        env["PYTHONPATH"] = src_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
        )
        if self.card is not None:
            env["CUDA_VISIBLE_DEVICES"] = str(self.card)
        return env

    def start(self, spec: CellSpec, attempt: int) -> None:
        if self._proc is not None:
            raise RuntimeError(f"{self.name} already has a lease")
        fd, self._job_path = tempfile.mkstemp(
            prefix=f"hero-cell-{spec.scene_idx}-{spec.budget_idx}-",
            suffix=".json",
        )
        with os.fdopen(fd, "w") as f:
            json.dump(self.payload_fn(spec), f)
        self._log = tempfile.TemporaryFile(mode="w+")
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.distributed.worker_main",
             self._job_path],
            stdout=self._log,
            stderr=subprocess.STDOUT,
            text=True,
            env=self._child_env(),
        )
        self._lease = (spec, attempt)

    def poll(self) -> Optional[CellEvent]:
        if self._proc is None or self._proc.poll() is None:
            return None
        spec, attempt = self._lease
        code = self._proc.returncode
        self._log.seek(0)
        out_text = self._log.read()
        self._release()
        if code == 0:
            for line in out_text.splitlines():
                if line.startswith(self.MARKER):
                    out = CellOutput.from_json(
                        json.loads(line[len(self.MARKER):])
                    )
                    return ("done", spec, attempt, out)
        # Non-zero exit or missing marker: the process is gone either way.
        self._dead = True
        return ("crashed", spec, attempt, RuntimeError(
            f"worker process exited {code} on {spec.name}: "
            f"{out_text[-500:]}"
        ))

    def alive(self) -> bool:
        return not self._dead

    def busy(self) -> bool:
        return self._proc is not None

    def close(self) -> None:
        self._dead = True
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        self._release()

    def _release(self) -> None:
        if self._job_path and os.path.exists(self._job_path):
            os.unlink(self._job_path)
        if self._log is not None:
            self._log.close()
        self._job_path, self._log = None, None
        self._proc, self._lease = None, None


# ---------------------------------------------------------------------------
# The program being orchestrated
# ---------------------------------------------------------------------------
class SearchCellProgram:
    """Adapter: `HeroSearchRun` as an orchestratable cell program.

    The orchestrator only speaks this duck-typed surface — tests swap in
    a fake with the same methods and zero renders.
    """

    def __init__(self, run: HeroSearchRun):
        self.run = run

    @property
    def checkpoint_path(self) -> Optional[str]:
        return self.run.cfg.checkpoint_path

    @property
    def device(self):
        return self.run.device

    def cell_specs(self) -> List[CellSpec]:
        return self.run.cell_specs()

    def prepare(self, spec: CellSpec) -> None:
        """Build (or reuse) the scene bundle ON THE ORCHESTRATOR THREAD —
        env training stays serialized exactly like the sequential run,
        and workers of every kind share the trained bundles."""
        self.run.bundle(spec.scene)

    def run_cell(self, spec: CellSpec) -> CellOutput:
        return self.run.run_cell(spec)

    def job_payload(self, spec: CellSpec) -> Dict:
        """Self-contained JSON job for a subprocess worker (the child
        rebuilds the env from config — nothing is pickled). The device
        stays out of the config (it is no part of the run's identity) and
        travels beside it as its kind."""
        return {
            "config": config_to_json(dataclasses.replace(
                self.run.cfg, checkpoint_path=None, verbose=False,
            )),
            "spec": spec.to_json(),
            "device": self.run.device.type,
        }

    def restore(self) -> Tuple[Dict[str, CellOutput], List[str]]:
        return self.run._restore(self.run._load_checkpoint())

    def save(self, outputs: Dict[str, CellOutput],
             order: List[str]) -> Optional[str]:
        return self.run._save_checkpoint(outputs, order)

    def finalize(self, outputs, resumed, t_start, fresh) -> ClosedLoopResult:
        return self.run.finalize(outputs, resumed, t_start, fresh=fresh)


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class OrchestratorConfig:
    workers: int = 1
    worker_kind: str = "thread"  # thread | inline | subprocess
    # Retry policy: a cell may run at most `max_attempts` times in total;
    # re-lease n (1-based) waits backoff_base * 2**(n-1), capped.
    max_attempts: int = 4
    backoff_base: float = 0.05
    backoff_cap: float = 2.0
    # Straggler SLO (StepWatchdog): a lease whose elapsed time exceeds
    # slo_factor x rolling-median completed-cell duration is evicted.
    slo_factor: float = 4.0
    watchdog_min_samples: int = 3
    # Absolute hang cap for the cold start (no median yet); None disables.
    hang_timeout: Optional[float] = None
    # Idle scheduler tick when nothing progressed.
    poll_interval: float = 0.01
    # Per-worker share of the sweep used by plan_rescale bookkeeping.
    lease_depth: int = 1


class ElasticOrchestrator:
    """Dispatch cells to a worker pool; retry, evict, rescale, checkpoint.

    `clock`/`sleep` default to real time; tests inject a fake pair so
    backoff and watchdog behavior is exact and instantaneous. `chaos`
    threads a `FaultPlan` into every worker (and into checkpoint writes);
    None means no chaos code runs. Subprocess workers run on the
    program's `device` (a `SearchCellProgram`'s run's).
    """

    def __init__(
        self,
        program,
        cfg: OrchestratorConfig = OrchestratorConfig(),
        chaos: Optional[FaultPlan] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        verbose: bool = False,
    ):
        if cfg.workers < 1:
            raise ValueError("need at least one worker")
        if cfg.worker_kind not in ("thread", "inline", "subprocess"):
            raise ValueError(f"unknown worker kind {cfg.worker_kind!r}")
        self.program = program
        self.cfg = cfg
        self.chaos = chaos
        self.clock = clock
        self.sleep = sleep
        self.verbose = verbose
        self.watchdog = StepWatchdog(
            slo_factor=cfg.slo_factor,
            min_samples=cfg.watchdog_min_samples,
            clock=clock,
        )
        # Audit trail of everything that happened, in order: tuples of
        # ("lease"|"done"|"error"|"crash"|"evict"|"retry"|"rescale"|
        #  "checkpoint"|"torn", ...details).
        self.events: List[Tuple] = []
        self._lease_depth = cfg.lease_depth

    # -- pool construction ------------------------------------------------
    def _make_workers(self) -> List:
        kind = self.cfg.worker_kind
        workers = []
        for i in range(self.cfg.workers):
            if kind == "inline":
                w = InlineWorker(self.program.run_cell, name=f"inline-{i}")
            elif kind == "thread":
                w = ThreadWorker(self.program.run_cell, name=f"thread-{i}")
            else:
                w = SubprocessWorker(
                    self.program.job_payload, name=f"proc-{i}",
                    device=getattr(self.program, "device", None), index=i,
                )
            if self.chaos is not None:
                w = ChaosWorker(w, self.chaos)
            workers.append(w)
        return workers

    # -- failure handling -------------------------------------------------
    def _requeue(self, spec: CellSpec, failures: Dict[str, int],
                 eligible: Dict[str, float], pending: List[CellSpec]) -> None:
        n = failures.get(spec.name, 0) + 1
        failures[spec.name] = n
        if n >= self.cfg.max_attempts:
            raise CellRetriesExhausted(
                f"cell {spec.name} failed {n} time(s); giving up"
            )
        delay = min(
            self.cfg.backoff_cap, self.cfg.backoff_base * (2 ** (n - 1))
        )
        eligible[spec.name] = self.clock() + delay
        pending.append(spec)
        # Canonical order among the waiting cells keeps re-leases
        # deterministic for a given fault plan.
        pending.sort(key=lambda s: (s.scene_idx, s.budget_idx))
        self.events.append(("retry", spec.name, n, delay))

    def _shrink_pool(self, worker, workers: List) -> None:
        old_n = len(workers)
        workers.remove(worker)
        worker.close()
        new_n = len(workers)
        if new_n == 0:
            return  # the main loop raises NoWorkersLeft with context
        # Redistribute the lost worker's share like a DP rescale: same
        # total capacity, larger per-worker accumulation. Capacity is
        # padded up to a multiple of the surviving pool (cells are
        # indivisible, unlike microbatches).
        capacity = self.cfg.workers * self.cfg.lease_depth
        capacity += (-capacity) % new_n
        plan = plan_rescale(
            global_batch=capacity, microbatch_per_shard=1,
            old_dp=old_n, new_dp=new_n,
            old_accum=self._lease_depth,
        )
        self._lease_depth = plan.new_accum
        self.events.append(
            ("rescale", old_n, new_n, plan.new_accum)
        )
        if self.verbose:
            print(f"[orchestrator] pool {old_n} -> {new_n} workers; "
                  f"per-worker share {plan.old_accum} -> {plan.new_accum}",
                  flush=True)

    def _checkpoint(self, outputs: Dict[str, CellOutput],
                    order: List[str], spec: CellSpec) -> None:
        path = self.program.save(outputs, order)
        if path is not None:
            self.events.append(("checkpoint", spec.name))
        if self.chaos is not None and path is not None:
            if self.chaos.take("torn_checkpoint", spec.name, 0):
                tear_checkpoint(path)
                self.events.append(("torn", spec.name))
                raise ChaosInterrupt(
                    f"orchestrator killed mid-checkpoint-write after "
                    f"{spec.name} (torn file left at {path})"
                )

    # -- main loop --------------------------------------------------------
    def run(self) -> ClosedLoopResult:
        t_start = time.time()
        outputs, order = self.program.restore()
        resumed = len(outputs)
        pending: List[CellSpec] = [
            s for s in self.program.cell_specs() if s.name not in outputs
        ]
        failures: Dict[str, int] = {}
        eligible: Dict[str, float] = {}
        leases: Dict[int, Tuple] = {}  # id(worker) -> (worker, spec, attempt, t0)
        fresh: List[str] = []
        workers = self._make_workers()
        if self.verbose and resumed:
            print(f"[orchestrator] resumed {resumed} completed cell(s)",
                  flush=True)
        try:
            while pending or leases:
                progressed = False

                # 1. Lease eligible cells to idle, living workers.
                now = self.clock()
                for w in workers:
                    if not pending:
                        break
                    if not w.alive() or id(w) in leases:
                        continue
                    i = next(
                        (k for k, s in enumerate(pending)
                         if eligible.get(s.name, 0.0) <= now),
                        None,
                    )
                    if i is None:
                        break  # everything waiting is in backoff
                    spec = pending.pop(i)
                    self.program.prepare(spec)
                    attempt = failures.get(spec.name, 0)
                    w.start(spec, attempt)
                    leases[id(w)] = (w, spec, attempt, self.clock())
                    self.events.append(("lease", spec.name, attempt, w.name))
                    progressed = True

                # 2. Collect events; watchdog the silent leases.
                for key in list(leases):
                    w, spec, attempt, t0 = leases[key]
                    ev = w.poll()
                    if ev is None:
                        elapsed = self.clock() - t0
                        hung = (
                            self.watchdog.is_slow(elapsed)
                            or (self.cfg.hang_timeout is not None
                                and elapsed > self.cfg.hang_timeout)
                        )
                        if hung:
                            del leases[key]
                            self.events.append(
                                ("evict", spec.name, attempt, w.name)
                            )
                            self._shrink_pool(w, workers)
                            self._requeue(spec, failures, eligible, pending)
                            progressed = True
                        continue
                    del leases[key]
                    kind, _, _, payload = ev
                    progressed = True
                    if kind == "done":
                        self.watchdog.record(self.clock() - t0)
                        outputs[spec.name] = payload
                        order.append(spec.name)
                        fresh.append(spec.name)
                        self.events.append(("done", spec.name, attempt, w.name))
                        self._checkpoint(outputs, order, spec)
                    elif kind == "error":
                        self.events.append(
                            ("error", spec.name, attempt, repr(payload))
                        )
                        self._requeue(spec, failures, eligible, pending)
                    elif kind == "crashed":
                        self.events.append(
                            ("crash", spec.name, attempt, w.name)
                        )
                        self._shrink_pool(w, workers)
                        self._requeue(spec, failures, eligible, pending)
                    else:  # pragma: no cover — protocol violation
                        raise RuntimeError(f"unknown worker event {kind!r}")

                # 3. Liveness: a pool with no living workers cannot finish.
                living = [w for w in workers if w.alive()]
                if not living and (pending or leases):
                    raise NoWorkersLeft(
                        f"{len(pending) + len(leases)} cell(s) unfinished "
                        "and no living workers remain"
                    )

                if not progressed and (pending or leases):
                    self.sleep(self.cfg.poll_interval)
        finally:
            for w in workers:
                w.close()
        return self.program.finalize(outputs, resumed, t_start, fresh)


# ---------------------------------------------------------------------------
# Convenience entry point (the CLI)
# ---------------------------------------------------------------------------
def run_orchestrated(
    run: HeroSearchRun,
    workers: int = 1,
    worker_kind: str = "thread",
    chaos_seed: Optional[int] = None,
    chaos_faults: int = 1,
    cfg: Optional[OrchestratorConfig] = None,
    verbose: bool = False,
) -> ClosedLoopResult:
    """Orchestrate a `HeroSearchRun` over a worker pool, on the run's
    device. `chaos_seed` arms a seeded `FaultPlan` over the run's cells
    (for drills)."""
    program = SearchCellProgram(run)
    cfg = cfg or OrchestratorConfig(workers=workers, worker_kind=worker_kind)
    if cfg.workers != workers or cfg.worker_kind != worker_kind:
        cfg = dataclasses.replace(
            cfg, workers=workers, worker_kind=worker_kind
        )
    chaos = None
    if chaos_seed is not None:
        chaos = FaultPlan.seeded(
            chaos_seed,
            [s.name for s in run.cell_specs()],
            n_faults=chaos_faults,
        )
        # A seeded crash with a 1-worker pool would strand the sweep;
        # transient faults retry on the same worker instead.
        if workers == 1:
            chaos = FaultPlan([
                dataclasses.replace(f, kind="transient")
                if f.kind == "crash" else f
                for f in chaos.pending()
            ])
    orch = ElasticOrchestrator(program, cfg, chaos=chaos, verbose=verbose)
    return orch.run()
