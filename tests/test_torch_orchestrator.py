"""The port's elastic cell orchestrator: every recovery path, zero real
renders, and the same decisions as the JAX package's.

The orchestrator is generic over a duck-typed `CellProgram`; these tests
drive it with a fake program (fabricated `CellOutput`s, a checkpoint on
tmp_path) plus the injected clock/sleep pair, so worker crashes, hangs,
transient errors, torn checkpoint writes, backoff timing, and
`plan_rescale` activation are all asserted exactly — no wall-clock
sleeps, no population search, no scenes (`tests/test_orchestrator.py`'s
cases on `repro_torch.distributed`). Across the packages: a seeded
`FaultPlan` picks the same faults, and one fake program under one fault
plan leaves the same event trail in both orchestrators. The real cells
(sequential identity, chaos recovery, a subprocess worker) are in
`tests/test_torch_closed_loop.py`.
"""
import json
from pathlib import Path

import pytest

import repro.core.closed_loop as jcl
import repro.distributed.chaos as jchaos
import repro.distributed.orchestrator as jorch
import repro_torch.core.closed_loop as tcl
import repro_torch.distributed.chaos as tchaos
import repro_torch.distributed.orchestrator as torch_orch
from repro_torch.core.closed_loop import CellSpec
from repro_torch.distributed.chaos import (
    ChaosInterrupt,
    Fault,
    FaultPlan,
    TransientWorkerError,
    tear_checkpoint,
)
from repro_torch.distributed.orchestrator import (
    CellRetriesExhausted,
    ElasticOrchestrator,
    NoWorkersLeft,
    OrchestratorConfig,
    ThreadWorker,
)


# ---------------------------------------------------------------------------
# Harness
# ---------------------------------------------------------------------------
class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class FakeProgram:
    """CellProgram over fabricated outputs: 2 scenes x 2 budgets by
    default, each cell 'runs' instantly (optionally charging the fake
    clock), checkpoints to `chk` as JSON. `cl` is the closed-loop module
    whose `CellSpec`/`CellOutput` it fabricates (the port's by default)."""

    def __init__(self, n_scenes=2, n_budgets=2, chk=None, clock=None,
                 cell_cost=0.0, fail_cells=(), cl=tcl):
        self.cl = cl
        self.specs = [
            cl.CellSpec(scene=f"s{si}", scene_idx=si, budget_idx=bi,
                        budget_frac=round(1.0 - 0.2 * bi, 2),
                        seed=100 + si * n_budgets + bi)
            for si in range(n_scenes) for bi in range(n_budgets)
        ]
        self.chk = chk
        self.clock = clock
        self.cell_cost = cell_cost
        self.fail_cells = dict(fail_cells)  # cell name -> times to raise
        self.runs = []  # execution order (with retries)
        self.prepared = []

    @property
    def checkpoint_path(self):
        return self.chk

    def cell_specs(self):
        return list(self.specs)

    def prepare(self, spec):
        self.prepared.append(spec.scene)

    def run_cell(self, spec):
        self.runs.append(spec.name)
        if self.fail_cells.get(spec.name, 0) > 0:
            self.fail_cells[spec.name] -= 1
            raise TransientWorkerError(f"scorer blew up on {spec.name}")
        if self.clock is not None and self.cell_cost:
            self.clock.advance(self.cell_cost)
        return self.cl.CellOutput(
            cell=spec.name, scene=spec.scene, budget_frac=spec.budget_frac,
            latency_target=100.0 * spec.budget_frac, seed=spec.seed,
            best_reward=float(spec.seed), best_bits=[8, 6],
            policies_evaluated=3, wall_seconds=1.0, sharded=False,
            points=[{"latency": 1.0, "psnr": 30.0, "model_bytes": 10.0,
                     "bits": [8, 6], "reward": 1.0, "t_emit": 0.5}],
        )

    def restore(self):
        if self.chk and Path(self.chk).exists():
            state = json.loads(Path(self.chk).read_text())
            outs = {c: self.cl.CellOutput.from_json(o)
                    for c, o in state["cell_outputs"].items()}
            return outs, list(state["completed"])
        return {}, []

    def save(self, outputs, order):
        if not self.chk:
            return None
        Path(self.chk).write_text(json.dumps({
            "completed": list(order),
            "cell_outputs": {c: o.to_json() for c, o in outputs.items()},
        }))
        return self.chk

    def finalize(self, outputs, resumed, t_start, fresh):
        return {
            "cells": sorted(outputs),
            "order": list(fresh),
            "resumed": resumed,
        }


def make_orch(prog, clk=None, chaos=None, **cfg_kw):
    clk = clk or FakeClock()
    cfg_kw.setdefault("workers", 1)
    cfg_kw.setdefault("worker_kind", "inline")
    orch = ElasticOrchestrator(
        prog, OrchestratorConfig(**cfg_kw), chaos=chaos,
        clock=clk, sleep=clk.advance,
    )
    return orch, clk


def kinds(orch, *want):
    return [e for e in orch.events if e[0] in want]


# ---------------------------------------------------------------------------
# Clean paths
# ---------------------------------------------------------------------------
def test_workers1_inline_executes_canonical_order():
    prog = FakeProgram()
    orch, _ = make_orch(prog)
    res = orch.run()
    canonical = [s.name for s in prog.specs]
    assert prog.runs == canonical  # exactly the sequential loop's order
    assert res["order"] == canonical
    assert res["cells"] == sorted(canonical)
    assert kinds(orch, "retry", "crash", "evict", "rescale") == []


def test_multiworker_leases_all_cells_exactly_once():
    prog = FakeProgram(n_scenes=3, n_budgets=2)
    orch, _ = make_orch(prog, workers=3)
    res = orch.run()
    assert sorted(prog.runs) == sorted(s.name for s in prog.specs)
    assert len(prog.runs) == 6  # no duplicate leases
    leased_workers = {e[3] for e in kinds(orch, "lease")}
    assert leased_workers == {"inline-0", "inline-1", "inline-2"}
    assert res["resumed"] == 0


def test_checkpoint_resume_skips_completed_cells(tmp_path):
    chk = str(tmp_path / "orch.json")
    prog = FakeProgram(chk=chk)
    orch, _ = make_orch(prog)
    orch.run()
    # Second orchestrator over the same checkpoint: nothing re-runs.
    prog2 = FakeProgram(chk=chk)
    orch2, _ = make_orch(prog2)
    res2 = orch2.run()
    assert prog2.runs == []
    assert res2["resumed"] == 4
    assert res2["cells"] == sorted(s.name for s in prog2.specs)


# ---------------------------------------------------------------------------
# Crash -> rescale -> re-lease
# ---------------------------------------------------------------------------
def test_crash_shrinks_pool_via_plan_rescale_and_relesases():
    prog = FakeProgram()
    plan = FaultPlan([Fault("crash", "s0@0.8")])
    orch, _ = make_orch(prog, workers=2, chaos=plan)
    res = orch.run()
    assert res["cells"] == sorted(s.name for s in prog.specs)
    assert kinds(orch, "crash") == [("crash", "s0@0.8", 0, "inline-1")]
    # plan_rescale: 2 workers x depth 1 -> 1 worker absorbing capacity 2.
    assert kinds(orch, "rescale") == [("rescale", 2, 1, 2)]
    # The cell re-leased to the SURVIVOR and completed on attempt 1.
    release = [e for e in kinds(orch, "lease") if e[1] == "s0@0.8"]
    assert release[-1][2] == 1 and release[-1][3] == "inline-0"
    assert ("done", "s0@0.8", 1, "inline-0") in orch.events
    # The crashed attempt never executed (the worker died before work).
    assert prog.runs.count("s0@0.8") == 1


def test_crash_with_single_worker_raises_no_workers_left():
    prog = FakeProgram()
    plan = FaultPlan([Fault("crash", "s0@1")])
    orch, _ = make_orch(prog, workers=1, chaos=plan)
    with pytest.raises(NoWorkersLeft, match="no living workers"):
        orch.run()


# ---------------------------------------------------------------------------
# Transient errors: backoff timing + exhaustion
# ---------------------------------------------------------------------------
def test_transient_error_retries_with_exponential_backoff():
    prog = FakeProgram()
    plan = FaultPlan([
        Fault("transient", "s1@1", attempt=0),
        Fault("transient", "s1@1", attempt=1),
    ])
    orch, clk = make_orch(
        prog, workers=1, chaos=plan, backoff_base=0.5, backoff_cap=10.0,
    )
    res = orch.run()
    assert res["cells"] == sorted(s.name for s in prog.specs)
    # Two failures -> delays 0.5 then 1.0, straight off the fake clock.
    assert kinds(orch, "retry") == [
        ("retry", "s1@1", 1, 0.5), ("retry", "s1@1", 2, 1.0),
    ]
    # While s1@1 backed off, the worker proceeded to other cells rather
    # than idling (continuous leasing around the faulty cell).
    errors = kinds(orch, "error")
    assert len(errors) == 2 and all(e[1] == "s1@1" for e in errors)
    assert ("done", "s1@1", 2, "inline-0") in orch.events


def test_backoff_delay_is_honored_on_the_clock():
    """A cell in backoff is not re-leased before its eligibility time;
    with nothing else to run the orchestrator sleeps forward."""
    prog = FakeProgram(n_scenes=1, n_budgets=1,
                       fail_cells={"s0@1": 1})
    orch, clk = make_orch(
        prog, workers=1, backoff_base=2.0, backoff_cap=10.0,
        poll_interval=0.25,
    )
    orch.run()
    lease_times = [e for e in orch.events if e[0] == "lease"]
    assert len(lease_times) == 2
    # Fake clock only moves via sleep(poll_interval): the re-lease could
    # not happen before t=2.0.
    assert clk.t >= 2.0
    assert prog.runs == ["s0@1", "s0@1"]


def test_retries_exhausted_is_a_typed_failure():
    prog = FakeProgram(fail_cells={"s0@1": 99})
    orch, _ = make_orch(prog, workers=1, max_attempts=3)
    with pytest.raises(CellRetriesExhausted, match="s0@1 failed 3"):
        orch.run()
    assert prog.runs.count("s0@1") == 3


# ---------------------------------------------------------------------------
# Hang -> watchdog eviction
# ---------------------------------------------------------------------------
def test_hang_is_evicted_by_watchdog_median_and_relesased():
    """Completed cells feed the watchdog's rolling median; a hung lease's
    elapsed time crosses slo_factor x median and the worker is evicted,
    the cell re-leased to the survivor."""
    clk = FakeClock()
    prog = FakeProgram(n_scenes=3, n_budgets=2, clock=clk, cell_cost=1.0)
    plan = FaultPlan([Fault("hang", "s2@1")])
    orch, _ = make_orch(
        prog, clk=clk, workers=2, chaos=plan,
        slo_factor=4.0, watchdog_min_samples=3, poll_interval=0.5,
    )
    res = orch.run()
    assert res["cells"] == sorted(s.name for s in prog.specs)
    assert kinds(orch, "evict") == [("evict", "s2@1", 0, "inline-0")]
    assert kinds(orch, "rescale") == [("rescale", 2, 1, 2)]
    assert ("done", "s2@1", 1, "inline-1") in orch.events


def test_cold_start_hang_falls_back_to_hang_timeout():
    """A hang on the very first cell (too few completions for a median)
    is reclaimed by the absolute hang_timeout."""
    prog = FakeProgram(n_scenes=1, n_budgets=2)
    plan = FaultPlan([Fault("hang", "s0@1")])
    orch, clk = make_orch(
        prog, workers=2, chaos=plan, hang_timeout=5.0, poll_interval=1.0,
        watchdog_min_samples=3,  # the lone completed cell is not a median
    )
    res = orch.run()
    assert res["cells"] == sorted(s.name for s in prog.specs)
    assert kinds(orch, "evict") == [("evict", "s0@1", 0, "inline-0")]
    assert clk.t >= 5.0  # could not have fired earlier


# ---------------------------------------------------------------------------
# Torn checkpoint -> ChaosInterrupt -> quarantined resume
# ---------------------------------------------------------------------------
def test_torn_checkpoint_interrupts_and_leaves_invalid_file(tmp_path):
    chk = str(tmp_path / "orch.json")
    prog = FakeProgram(chk=chk)
    plan = FaultPlan([Fault("torn_checkpoint", "s0@0.8")])
    orch, _ = make_orch(prog, chaos=plan)
    with pytest.raises(ChaosInterrupt, match="mid-checkpoint-write"):
        orch.run()
    assert ("torn", "s0@0.8") in orch.events
    # The file on disk is a torn prefix: unparseable JSON.
    with pytest.raises(json.JSONDecodeError):
        json.loads(Path(chk).read_text())


def test_tear_checkpoint_truncates_in_place(tmp_path):
    p = tmp_path / "c.json"
    p.write_text(json.dumps({"completed": ["a", "b"], "x": "y" * 200}))
    full = p.read_bytes()
    tear_checkpoint(str(p))
    torn = p.read_bytes()
    assert 0 < len(torn) < len(full)
    assert torn == full[: len(torn)]  # a prefix, as a real torn write is


# ---------------------------------------------------------------------------
# FaultPlan semantics
# ---------------------------------------------------------------------------
def test_fault_plan_is_seeded_and_consumed_once():
    cells = [f"c{i}" for i in range(8)]
    a = FaultPlan.seeded(7, cells, n_faults=2)
    b = FaultPlan.seeded(7, cells, n_faults=2)
    assert [(f.kind, f.cell) for f in a.pending()] == [
        (f.kind, f.cell) for f in b.pending()
    ]
    c = FaultPlan.seeded(8, cells, n_faults=2)
    assert [(f.kind, f.cell) for f in a.pending()] != [
        (f.kind, f.cell) for f in c.pending()
    ]
    f = a.pending()[0]
    assert a.take(f.kind, f.cell, f.attempt) is not None
    assert a.take(f.kind, f.cell, f.attempt) is None  # consumed
    assert a.injected == [f]


def test_unknown_fault_kind_rejected():
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("meteor", "c0")


# ---------------------------------------------------------------------------
# Real worker kinds (still no renders: the program is fake)
# ---------------------------------------------------------------------------
def test_thread_workers_complete_all_cells():
    """Real daemon threads + real clock, fake cells: the default pool
    kind drains the sweep and every cell ran exactly once."""
    prog = FakeProgram(n_scenes=2, n_budgets=3)
    orch = ElasticOrchestrator(
        prog,
        OrchestratorConfig(workers=3, worker_kind="thread",
                           poll_interval=0.001),
    )
    res = orch.run()
    assert res["cells"] == sorted(s.name for s in prog.specs)
    assert sorted(prog.runs) == sorted(s.name for s in prog.specs)


def test_thread_worker_unit():
    w = ThreadWorker(lambda spec: f"ran {spec.name}", name="t0")
    spec = CellSpec(scene="s", scene_idx=0, budget_idx=0,
                    budget_frac=1.0, seed=1)
    w.start(spec, 0)
    w._thread.join(timeout=10)
    assert not w._thread.is_alive()
    ev = w.poll()
    assert ev == ("done", spec, 0, "ran s@1")
    assert not w.busy()
    w.close()


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_faults", [1, 2, 3])
def test_seeded_fault_plan_equals_reference(n_faults):
    """`FaultPlan.seeded` draws the same (kind, cell, attempt) faults as
    the reference's over a range of seeds and cell lists, so `--chaos
    SEED` drills the same cells in both packages."""
    for n_cells in (1, 2, 4, 9):
        cells = [f"scene{i // 2}@{1.0 - 0.15 * (i % 2):g}"
                 for i in range(n_cells)]
        for seed in range(40):
            got = FaultPlan.seeded(seed, cells, n_faults=n_faults)
            want = jchaos.FaultPlan.seeded(seed, cells, n_faults=n_faults)
            assert [(f.kind, f.cell, f.attempt) for f in got.pending()] \
                == [(f.kind, f.cell, f.attempt) for f in want.pending()]
    assert FaultPlan.seeded(3, []).pending() == []


_PLANS = {
    "crash": dict(faults=[("crash", "s0@0.8", 0)], workers=2),
    "transients": dict(faults=[("transient", "s1@1", 0),
                               ("transient", "s1@1", 1)], workers=1),
    "hang": dict(faults=[("hang", "s2@1", 0)], workers=2, n_scenes=3,
                 cell_cost=1.0, poll_interval=0.5),
    "torn": dict(faults=[("crash", "s0@1", 0),
                         ("torn_checkpoint", "s1@1", 0)], workers=2,
                 chk=True),
}


@pytest.mark.parametrize("case", sorted(_PLANS))
def test_event_trail_equals_reference(case, tmp_path):
    """One fake program under one fault plan, in both orchestrators (fake
    clocks, inline workers): the same leases, completions, errors,
    crashes, evictions, retries with their delays, rescales, checkpoints
    and torn writes, in the same order."""
    spec = dict(_PLANS[case])
    faults = spec.pop("faults")
    workers = spec.pop("workers")
    n_scenes = spec.pop("n_scenes", 2)
    cell_cost = spec.pop("cell_cost", 0.0)
    chk = spec.pop("chk", False)
    trails = []
    for cl, chaos, orch_mod in ((tcl, tchaos, torch_orch),
                                (jcl, jchaos, jorch)):
        clk = FakeClock()
        prog = FakeProgram(
            n_scenes=n_scenes, clock=clk, cell_cost=cell_cost, cl=cl,
            chk=str(tmp_path / f"{cl.__name__}.json") if chk else None)
        plan = chaos.FaultPlan([chaos.Fault(k, c, a) for k, c, a in faults])
        orch = orch_mod.ElasticOrchestrator(
            prog, orch_mod.OrchestratorConfig(
                workers=workers, worker_kind="inline", **spec),
            chaos=plan, clock=clk, sleep=clk.advance)
        try:
            res = orch.run()
        except chaos.ChaosInterrupt:
            res = "interrupted"
        trails.append((orch.events, res, prog.runs, clk.t))
    assert trails[0] == trails[1]
    assert len(trails[0][0]) > 8
