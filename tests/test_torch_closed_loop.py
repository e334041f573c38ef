"""The closed loop and the workload protocol: the port's
`repro_torch.core.closed_loop` and `repro_torch.workloads` against the JAX
package's, at `SceneScale.tiny()`, on the reference's trained chair (its
params and dataset carried across with `convert`):

- pure data, exact: `fingerprint()`, `config_to_json`, `cell_specs()`,
  `list_workloads()`, `policy_shape`; the port's replay of a checkpoint
  the reference wrote (frontiers, cells, policies, seconds to the
  fixed-bit reference, hypervolume) and the checkpoint it writes back;
- a checkpoint resumes across the two packages, both ways;
- a running loop (2 cells, 2 iterations at K = 8, the reference agent's
  initial state carried into the port's agent inside the test): the
  proposals' bits and the elites equal, rewards, PSNR and latency within
  `test_torch_search.py`'s bands;
- inside the port: determinism, resume equal to the uninterrupted run,
  a config mismatch refused, unusable checkpoints quarantined, the
  report's validity flags, and the LM loop over the other block
  families (xlstm runs, whisper fails as the reference does);
- the distributed search (`repro_torch.distributed`): one inline worker,
  a thread pool and a chaos sweep (a worker kill, a torn checkpoint)
  equal to the sequential run; orchestrated checkpoints resumed across
  the packages, both ways; `sharded=True` and a split over two devices
  equal to the plain path exactly; `pad_population` and the one-device
  `shard_population` against the reference's; a real cell through a
  subprocess worker equal to the same cell inline.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import repro.core.closed_loop as jcl
import repro.workloads as jwl
from repro.core import ddpg as jddpg
import repro_torch.core.closed_loop as tcl
import repro_torch.workloads as twl
from repro_torch.convert import (
    dataset_from_numpy,
    ddpg_state_from_numpy,
    params_from_numpy,
)
from repro_torch.core import ddpg as tddpg
from repro_torch.core import search as tsearch
from repro_torch.core.batched_env import BatchedEnvConfig, BatchedQuantEnv
import repro_torch.distributed.chaos as tchaos
import repro_torch.distributed.orchestrator as torch_orch
import repro_torch.distributed.population as tpop
from repro_torch.distributed.chaos import (
    ChaosInterrupt,
    Fault,
    FaultPlan,
    tear_checkpoint,
)

J_TINY, T_TINY = jcl.SceneScale.tiny(), tcl.SceneScale.tiny()
# test_torch_search.py's bands.
PSNR_ATOL_DB = 1e-3
REL = 1e-6
REWARD_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny shapes gain nothing from more, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(pkg, **kw):
    """One scene, two budgets, 2 iterations at K = 8."""
    base = dict(scenes=("chair",), budget_fracs=(1.0, 0.8), seed=7,
                scale=pkg.SceneScale.tiny(), n_iterations=2, population=8,
                verbose=False)
    base.update(kw)
    return pkg.ClosedLoopConfig(**base)


@pytest.fixture(scope="module")
def bundles():
    """(the reference's tiny chair bundle, the port's built from the same
    trained params and dataset)."""
    jb = jcl.build_scene_bundle("chair", J_TINY, seed=0)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jb.env.params),
                           device="cpu")
    te = tcl.scene_env(tp, dataset_from_numpy(jb.env.dataset), T_TINY,
                       seed=0, device="cpu")
    tbenv = BatchedQuantEnv(
        te, BatchedEnvConfig(proxy_rays=T_TINY.proxy_rays, seed=0),
        device="cpu")
    return jb, tcl.scene_bundle(te, tbenv)


@pytest.fixture(scope="module")
def port_bundles(bundles):
    """Two scenes for the port-only tests: the converted chair and a lego
    the port trains itself."""
    return {"chair": bundles[1],
            "lego": tcl.build_scene_bundle("lego", T_TINY, seed=1,
                                           device="cpu")}


@pytest.fixture
def carried_agent(monkeypatch):
    """The port's searches build their agent with the reference agent's
    initial state (a torch generator cannot draw `jax.random`'s)."""
    def make(cfg=None, device=None):
        agent = tddpg.DDPGAgent(cfg, device=device)
        ref = jddpg.DDPGAgent(jddpg.DDPGConfig(**dataclasses.asdict(cfg)))
        agent.state = ddpg_state_from_numpy(ref.state, device=device)
        return agent
    monkeypatch.setattr(tsearch, "DDPGAgent", make)


@pytest.fixture(scope="module")
def reference_run(bundles, tmp_path_factory):
    """The reference's uninterrupted run, its checkpoint and its cell
    outputs."""
    jb, _ = bundles
    ck = tmp_path_factory.mktemp("ref") / "ckpt.json"
    res = jcl.HeroSearchRun(_cfg(jcl, checkpoint_path=str(ck)),
                            {"chair": jb}).run()
    return res, ck


def _anchors(frontier, n_units):
    return [p for p in frontier if p.bits == tuple([8] * n_units)]


def _assert_results_equal(a, b):
    """Frontiers (sets AND sizes), hypervolume, cells' winners, counts."""
    assert a.frontier.objective_set() == b.frontier.objective_set()
    assert len(a.frontier) == len(b.frontier)
    assert a.hypervolume() == b.hypervolume()
    assert set(a.scene_frontiers) == set(b.scene_frontiers)
    for s in a.scene_frontiers:
        assert (a.scene_frontiers[s].objective_set()
                == b.scene_frontiers[s].objective_set())
        assert len(a.scene_frontiers[s]) == len(b.scene_frontiers[s])
    assert [c.best_bits for c in a.cells] == [c.best_bits for c in b.cells]
    assert a.policies_evaluated == b.policies_evaluated


# ---------------------------------------------------------------------------
# Pure data, exact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    {},
    dict(scenes=("chair", "lego"), budget_fracs=(1.0, 0.85, 0.7), seed=3,
         hardware="neurex-edge", sharded=False, checkpoint_path="x.json"),
    dict(workload="lm", scale="quick"),
])
def test_fingerprint_config_json_and_cell_specs_equal_reference(kw):
    kw = dict(kw)
    scale = kw.pop("scale", "tiny")
    j = _cfg(jcl, scale=getattr(jcl.SceneScale, scale)(), **kw)
    t = _cfg(tcl, scale=getattr(tcl.SceneScale, scale)(), **kw)
    assert t.fingerprint() == j.fingerprint()
    assert tcl.config_to_json(t) == jcl.config_to_json(j)
    assert tcl.config_from_json(tcl.config_to_json(t)) == t
    assert json.dumps(tcl.config_to_json(t)) \
        == json.dumps(jcl.config_to_json(j))
    if t.workload == "nerf":
        got = tcl.HeroSearchRun(t, device="cpu").cell_specs()
        want = jcl.HeroSearchRun(j).cell_specs()
        assert [c.to_json() for c in got] == [c.to_json() for c in want]
        assert [c.name for c in got] == [c.name for c in want]


def test_list_workloads_equals_reference():
    assert twl.list_workloads() == jwl.list_workloads()
    assert twl.get_workload("nerf").describe() \
        == jwl.get_workload("nerf").describe()
    with pytest.raises(KeyError, match="unknown workload"):
        twl.get_workload("nope")


@pytest.mark.parametrize("scale", ["tiny", "quick", "standard"])
def test_policy_shape_equals_reference(scale):
    got = twl.get_workload("nerf").policy_shape(
        "chair", getattr(tcl.SceneScale, scale)())
    want = jwl.get_workload("nerf").policy_shape(
        "chair", getattr(jcl.SceneScale, scale)())
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_replay_of_a_reference_checkpoint_equals_reference(
        reference_run, tmp_path):
    """The port restores the reference's checkpoint (no bundle: the scene
    constants ride in it) and replays it to the reference's result, then
    writes the same checkpoint back."""
    want, ck = reference_run
    run = tcl.HeroSearchRun(_cfg(tcl, checkpoint_path=str(ck)),
                            device="cpu")
    got = run.run()
    assert got.resumed_cells == 2 and got.sharded is None
    _assert_results_equal(got, want)
    assert [c.to_json() for c in got.cells] \
        == [c.to_json() for c in want.cells]
    assert got.seconds_to_fixed_bit == want.seconds_to_fixed_bit
    assert got.search_seconds == want.search_seconds

    outputs, order = run._restore(run._load_checkpoint())
    out = tmp_path / "port.json"
    run.cfg = dataclasses.replace(run.cfg, checkpoint_path=str(out))
    run._save_checkpoint(outputs, order)
    assert json.loads(out.read_text()) == json.loads(ck.read_text())
    assert out.read_text() == ck.read_text()


# ---------------------------------------------------------------------------
# Across the two packages
# ---------------------------------------------------------------------------
def test_port_finishes_a_reference_checkpoint(bundles, reference_run,
                                              carried_agent, tmp_path):
    jb, tb = bundles
    want, _ = reference_run
    ck = tmp_path / "ckpt.json"
    jcl.HeroSearchRun(_cfg(jcl, checkpoint_path=str(ck)),
                      {"chair": jb}).run(stop_after_cells=1)
    got = tcl.HeroSearchRun(_cfg(tcl, checkpoint_path=str(ck)),
                            {"chair": tb}, device="cpu").run()
    assert got.resumed_cells == 1 and len(got.cells) == 2
    assert len(_anchors(got.scene_frontiers["chair"], tb.env.n_units)) <= 1
    assert [c.best_bits for c in got.cells] \
        == [c.best_bits for c in want.cells]
    assert got.policies_evaluated == want.policies_evaluated
    assert sorted(json.loads(ck.read_text())["completed"]) \
        == ["chair@0.8", "chair@1"]


def test_reference_finishes_a_port_checkpoint(bundles, reference_run,
                                              carried_agent, tmp_path):
    jb, tb = bundles
    want, _ = reference_run
    ck = tmp_path / "ckpt.json"
    part = tcl.HeroSearchRun(_cfg(tcl, checkpoint_path=str(ck)),
                             {"chair": tb}, device="cpu").run(
                                 stop_after_cells=1)
    assert len(part.cells) == 1
    got = jcl.HeroSearchRun(_cfg(jcl, checkpoint_path=str(ck)),
                            {"chair": jb}).run()
    assert got.resumed_cells == 1 and len(got.cells) == 2
    assert len(_anchors(got.scene_frontiers["chair"], tb.env.n_units)) <= 1
    assert [c.best_bits for c in got.cells] \
        == [c.best_bits for c in want.cells]


def test_running_loop_matches_reference(bundles, carried_agent, monkeypatch):
    """Both loops over the same two cells: every proposal's bits and every
    iteration's elites equal, the points' rewards, PSNR and latency within
    the bands, `model_bytes` exact; the points are plain Python numbers."""
    jb, tb = bundles
    searches = {"j": [], "t": []}

    def recorder(mod, key):
        inner = mod.hero_population_search

        def wrapped(*a, **kw):
            res = inner(*a, **kw)
            searches[key].append(res)
            return res
        monkeypatch.setattr(mod, "hero_population_search", wrapped)

    recorder(jcl, "j")
    recorder(tcl, "t")
    want = jcl.HeroSearchRun(_cfg(jcl), {"chair": jb})
    got = tcl.HeroSearchRun(_cfg(tcl), {"chair": tb}, device="cpu")
    for wspec, gspec in zip(want.cell_specs(), got.cell_specs()):
        w, g = want.run_cell(wspec), got.run_cell(gspec)
        assert g.cell == w.cell and g.seed == w.seed
        assert g.latency_target == pytest.approx(w.latency_target, rel=REL)
        assert len(g.points) == len(w.points) == 16
        for gp, wp in zip(g.points, w.points):
            assert gp["bits"] == wp["bits"]
            assert gp["reward"] == pytest.approx(wp["reward"],
                                                 abs=REWARD_ATOL)
            assert gp["psnr"] == pytest.approx(wp["psnr"], abs=PSNR_ATOL_DB)
            assert gp["latency"] == pytest.approx(wp["latency"], rel=REL)
            assert gp["model_bytes"] == wp["model_bytes"]
            for k, v in gp.items():
                assert type(v) in (float, list), (k, type(v))
            assert all(type(b) is int for b in gp["bits"])
        assert g.best_bits == w.best_bits
        assert g.best_reward == pytest.approx(w.best_reward, abs=REWARD_ATOL)
        assert g.policies_evaluated == w.policies_evaluated
        json.dumps(g.to_json())
    assert len(searches["j"]) == len(searches["t"]) == 2
    for w, g in zip(searches["j"], searches["t"]):
        for wi, gi in zip(w.history, g.history):
            np.testing.assert_array_equal(gi.eval.bits, wi.eval.bits)
            np.testing.assert_array_equal(gi.elite_indices, wi.elite_indices)


def test_injected_target_fingerprint_records_the_device(bundles):
    """An injected target fingerprints by `describe()`: the port's records
    its device where the reference's records its TPU autotune key, so
    injected-target checkpoints of the two packages refuse each other
    (ROADMAP §3); by-name targets fingerprint alike."""
    from repro.hero.targets import NeuRexTarget as JTarget
    from repro_torch.hero.targets import NeuRexTarget as TTarget

    jfp = jcl.HeroSearchRun(_cfg(jcl), target=JTarget())._fingerprint()
    tfp = tcl.HeroSearchRun(_cfg(tcl), target=TTarget(device="cpu"),
                            device="cpu")._fingerprint()
    assert tfp["hardware"]["device"] == "cpu"
    assert "device" not in jfp["hardware"]
    assert tfp != jfp
    strip = lambda d: {k: v for k, v in d.items()
                       if k not in ("device", "kernel_autotune")}
    assert strip(tfp["hardware"]) == strip(jfp["hardware"])
    assert tcl.HeroSearchRun(_cfg(tcl), device="cpu")._fingerprint() \
        == jcl.HeroSearchRun(_cfg(jcl))._fingerprint()


# ---------------------------------------------------------------------------
# Inside the port
# ---------------------------------------------------------------------------
def _port_cfg(**kw):
    return _cfg(tcl, scenes=("chair", "lego"), population=6, **kw)


def test_closed_loop_deterministic_given_seed(port_bundles):
    a = tcl.HeroSearchRun(_port_cfg(), port_bundles, device="cpu").run()
    b = tcl.HeroSearchRun(_port_cfg(), port_bundles, device="cpu").run()
    _assert_results_equal(a, b)
    assert a.seconds_to_fixed_bit is not None
    assert a.sharded is False and a.device == "cpu"


@pytest.mark.parametrize("stop_after", [1, 2])
def test_checkpoint_resume_reproduces_uninterrupted_run(
        port_bundles, tmp_path, stop_after):
    """Resume mid-scene (1: the chair's 8-bit anchor is checkpointed and
    must not duplicate) and at the scene boundary (2)."""
    full = tcl.HeroSearchRun(_port_cfg(), port_bundles, device="cpu").run()
    ck = tmp_path / "ckpt.json"
    cfg = _port_cfg(checkpoint_path=str(ck))
    part = tcl.HeroSearchRun(cfg, port_bundles, device="cpu").run(
        stop_after_cells=stop_after)
    assert len(part.cells) == stop_after
    assert len(json.loads(ck.read_text())["completed"]) == stop_after
    resumed = tcl.HeroSearchRun(cfg, port_bundles, device="cpu").run()
    assert resumed.resumed_cells == stop_after
    assert len(resumed.cells) == len(full.cells) == 4
    _assert_results_equal(resumed, full)


def test_checkpoint_config_mismatch_refused(port_bundles, tmp_path):
    cfg = _port_cfg(checkpoint_path=str(tmp_path / "ckpt.json"))
    tcl.HeroSearchRun(cfg, port_bundles, device="cpu").run(stop_after_cells=1)
    other = dataclasses.replace(cfg, seed=cfg.seed + 1)
    with pytest.raises(ValueError, match="different closed-loop config"):
        tcl.HeroSearchRun(other, port_bundles, device="cpu").run()


@pytest.mark.parametrize("damage", ["truncated", "version"])
def test_unusable_checkpoint_quarantined_and_restarted(port_bundles,
                                                       tmp_path, damage):
    """A torn checkpoint and one of an unknown schema version move to
    `<path>.corrupt` with a RuntimeWarning, and the run restarts cleanly
    to the uninterrupted result."""
    full = tcl.HeroSearchRun(_port_cfg(), port_bundles, device="cpu").run()
    ck = tmp_path / "ckpt.json"
    cfg = _port_cfg(checkpoint_path=str(ck))
    tcl.HeroSearchRun(cfg, port_bundles, device="cpu").run(stop_after_cells=2)
    text = ck.read_text()
    if damage == "truncated":
        ck.write_text(text[: len(text) // 2])
    else:
        state = json.loads(text)
        state["version"] = 1
        ck.write_text(json.dumps(state))
    with pytest.warns(RuntimeWarning, match="quarantined"):
        res = tcl.HeroSearchRun(cfg, port_bundles, device="cpu").run()
    assert res.resumed_cells == 0
    assert (tmp_path / "ckpt.json.corrupt").exists()
    _assert_results_equal(res, full)


def test_bench_report_validity_flags_and_keys(port_bundles, reference_run):
    from repro_torch.core.pareto import ParetoPoint

    cfg = _port_cfg()
    res = tcl.HeroSearchRun(cfg, port_bundles, device="cpu").run()
    anchor = ParetoPoint(latency=1.0, psnr=0.0, model_bytes=1.0)
    assert len(res.frontier) > 0
    assert all(not anchor.dominates(p) for p in res.frontier)
    report = tcl.bench_report(res, cfg)
    assert report["frontier_valid_vs_8bit"]
    assert report["no_point_dominated_by_8bit"]
    assert report["contains_8bit_anchor"] or report["some_point_dominates_8bit"]
    assert report["frontier_hypervolume"] >= 0.0
    assert report["policies_per_sec"] > 0.0
    assert report["n_devices"] == 1 and report["sharded"] is False
    assert report["scene_frontier_sizes"] == {"chair": len(
        res.scene_frontiers["chair"]), "lego": len(res.scene_frontiers["lego"])}
    json.dumps(report)
    want, _ = reference_run
    assert sorted(report) == sorted(jcl.bench_report(want, _cfg(jcl)))


def test_lm_loop_over_the_other_families_runs_or_fails_as_the_reference():
    """The LM closed loop over xlstm-350m's smoke bundle runs to a valid
    frontier; jamba's policy shape is the reference's; whisper's loop
    raises the reference's `KeyError` (its bundle scores token batches,
    its forward wants frames)."""
    lm_cfg = lambda pkg, arch: _cfg(pkg, workload="lm", scenes=(arch,),
                                    hardware="roofline-lm")
    res = tcl.HeroSearchRun(lm_cfg(tcl, "xlstm-350m"), device="cpu").run()
    report = tcl.bench_report(res, lm_cfg(tcl, "xlstm-350m"))
    assert len(res.frontier) > 0 and report["frontier_valid_vs_8bit"]
    assert res.policies_evaluated == 2 * 2 * 8
    assert dataclasses.asdict(twl.get_workload("lm").policy_shape(
        "jamba-v0.1-52b")) == dataclasses.asdict(
        jwl.get_workload("lm").policy_shape("jamba-v0.1-52b"))
    errors = []
    for run in (lambda: jcl.HeroSearchRun(lm_cfg(jcl, "whisper-large-v3"))
                .run(),
                lambda: tcl.HeroSearchRun(lm_cfg(tcl, "whisper-large-v3"),
                                          device="cpu").run()):
        with pytest.raises(KeyError) as e:
            run()
        errors.append(e.value.args)
    assert errors[0] == errors[1] == ("frames",)


def test_scene_bundle_anchors(port_bundles):
    b = port_bundles["chair"]
    base = b.baseline_point()
    assert base.bits == tuple([8] * b.env.n_units) and base.reward == 0.0
    n = b.normalize(base)
    assert (n.latency, n.psnr, n.model_bytes) == (1.0, 0.0, 1.0)
    assert b.baseline_latency == float(b.env.original_cost)
    assert b.env.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# The distributed search: orchestrated sweeps, the population split
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def sequential(port_bundles):
    """The port's sequential run of `_port_cfg()`: what every orchestrated
    sweep below must equal."""
    return tcl.HeroSearchRun(_port_cfg(), port_bundles, device="cpu").run()


def _orchestrate(cfg, bundles, chaos=None, **kw):
    orch = torch_orch.ElasticOrchestrator(
        torch_orch.SearchCellProgram(
            tcl.HeroSearchRun(cfg, bundles, device="cpu")),
        torch_orch.OrchestratorConfig(**kw), chaos=chaos)
    return orch, orch.run


def test_orchestrator_workers1_identical_to_sequential(port_bundles,
                                                       sequential):
    """One inline worker, chaos off: the orchestrator IS the sequential
    `HeroSearchRun.run()`, result for result, its cells done in canonical
    order."""
    orch, run = _orchestrate(_port_cfg(), port_bundles, workers=1,
                             worker_kind="inline")
    res = run()
    _assert_results_equal(res, sequential)
    assert res.resumed_cells == 0 and res.sharded is False
    assert [e for e in orch.events if e[0] == "done"] == [
        ("done", s.name, 0, "inline-0")
        for s in tcl.HeroSearchRun(_port_cfg(), device="cpu").cell_specs()]


def test_orchestrator_thread_pool_identical_to_sequential(port_bundles,
                                                          sequential):
    """Two thread workers run cells of the same bundles at once and
    complete them out of canonical order; the replay at finalize still
    gives the sequential result, bit for bit."""
    orch, run = _orchestrate(_port_cfg(), port_bundles, workers=2,
                             worker_kind="thread", poll_interval=1e-3)
    res = run()
    _assert_results_equal(res, sequential)
    timeless = lambda r: [dict(c.to_json(), search_seconds=None)
                          for c in r.cells]
    assert timeless(res) == timeless(sequential)
    assert {e[3] for e in orch.events if e[0] == "done"} \
        == {"thread-0", "thread-1"}


def test_chaos_sweep_recovers_to_identical_frontier(port_bundles, sequential,
                                                    tmp_path):
    """A 2-scene x 2-budget sweep takes a worker kill on its first cell
    AND a torn checkpoint write (the orchestrator dies mid-write); the
    relaunched sweep quarantines the torn file, restarts clean, and lands
    on the exact uninterrupted frontier."""
    ck = tmp_path / "sweep.json"
    cfg = _port_cfg(checkpoint_path=str(ck))
    names = [s.name for s in tcl.HeroSearchRun(cfg, device="cpu")
             .cell_specs()]
    plan = FaultPlan([Fault("crash", names[0]),
                      Fault("torn_checkpoint", names[2])])
    orch, run = _orchestrate(cfg, port_bundles, chaos=plan, workers=2,
                             worker_kind="inline", backoff_base=1e-4,
                             poll_interval=1e-4)
    with pytest.raises(ChaosInterrupt):
        run()
    ev_kinds = [e[0] for e in orch.events]
    assert "crash" in ev_kinds and "rescale" in ev_kinds
    assert ev_kinds.count("torn") == 1
    with pytest.raises(json.JSONDecodeError):
        json.loads(ck.read_text())
    with pytest.warns(RuntimeWarning, match="quarantined"):
        _, rerun = _orchestrate(cfg, port_bundles, workers=2,
                                worker_kind="inline")
        resumed = rerun()
    assert (tmp_path / "sweep.json.corrupt").exists()
    _assert_results_equal(resumed, sequential)
    assert sorted(json.loads(ck.read_text())["completed"]) == sorted(names)


def test_torn_checkpoint_quarantined_and_restarted(port_bundles, sequential,
                                                   tmp_path):
    """A checkpoint torn by `tear_checkpoint` moves to `<path>.corrupt`
    with a RuntimeWarning, and the sequential run restarts cleanly to the
    full result."""
    ck = tmp_path / "ckpt.json"
    cfg = _port_cfg(checkpoint_path=str(ck))
    tcl.HeroSearchRun(cfg, port_bundles, device="cpu").run(stop_after_cells=2)
    tear_checkpoint(str(ck))
    with pytest.warns(RuntimeWarning, match="quarantined"):
        res = tcl.HeroSearchRun(cfg, port_bundles, device="cpu").run()
    assert res.resumed_cells == 0
    assert (tmp_path / "ckpt.json.corrupt").exists()
    _assert_results_equal(res, sequential)


def _partial_orchestrated_checkpoint(orch_mod, chaos_mod, program, names):
    """Run `program`'s sweep until its second cell fails for good (one
    attempt allowed): the checkpoint then holds the first cell only."""
    plan = chaos_mod.FaultPlan([chaos_mod.Fault("transient", names[1])])
    with pytest.raises(orch_mod.CellRetriesExhausted):
        orch_mod.ElasticOrchestrator(
            program, orch_mod.OrchestratorConfig(workers=1,
                                                 worker_kind="inline",
                                                 max_attempts=1),
            chaos=plan).run()


def test_port_orchestrated_checkpoint_resumes_in_the_reference(
        bundles, reference_run, carried_agent, tmp_path):
    jb, tb = bundles
    want, _ = reference_run
    ck = tmp_path / "ckpt.json"
    run = tcl.HeroSearchRun(_cfg(tcl, checkpoint_path=str(ck)),
                            {"chair": tb}, device="cpu")
    _partial_orchestrated_checkpoint(
        torch_orch, tchaos, torch_orch.SearchCellProgram(run),
        [s.name for s in run.cell_specs()])
    assert json.loads(ck.read_text())["completed"] == ["chair@1"]
    got = jcl.HeroSearchRun(_cfg(jcl, checkpoint_path=str(ck)),
                            {"chair": jb}).run()
    assert got.resumed_cells == 1 and len(got.cells) == 2
    assert [c.best_bits for c in got.cells] \
        == [c.best_bits for c in want.cells]
    assert got.policies_evaluated == want.policies_evaluated


def test_reference_orchestrated_checkpoint_resumes_in_the_port(
        bundles, reference_run, carried_agent, tmp_path):
    import repro.distributed.chaos as jchaos
    import repro.distributed.orchestrator as jorch

    jb, tb = bundles
    want, _ = reference_run
    ck = tmp_path / "ckpt.json"
    run = jcl.HeroSearchRun(_cfg(jcl, checkpoint_path=str(ck)),
                            {"chair": jb})
    _partial_orchestrated_checkpoint(
        jorch, jchaos, jorch.SearchCellProgram(run),
        [s.name for s in run.cell_specs()])
    assert json.loads(ck.read_text())["completed"] == ["chair@1"]
    got = torch_orch.run_orchestrated(
        tcl.HeroSearchRun(_cfg(tcl, checkpoint_path=str(ck)),
                          {"chair": tb}, device="cpu"),
        workers=2, worker_kind="thread")
    assert got.resumed_cells == 1 and len(got.cells) == 2
    assert [c.best_bits for c in got.cells] \
        == [c.best_bits for c in want.cells]
    assert got.policies_evaluated == want.policies_evaluated
    assert sorted(json.loads(ck.read_text())["completed"]) \
        == ["chair@0.8", "chair@1"]


def _assert_evals_identical(a, b):
    for key in ("bits", "psnr", "latency_cycles", "model_bytes", "reward",
                "fqr", "feasible"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key),
                                      err_msg=key)


def _assert_sims_identical(a, b):
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_sharded_flag_matches_default_path_exactly(port_bundles):
    """`sharded=True` (one CPU: the plain call through the split's
    wrapper, latency through the fused `policy_latency`) equals the
    default path exactly, PSNR, latency, bytes and reward."""
    b = port_bundles["chair"]
    split = BatchedQuantEnv(
        b.env, BatchedEnvConfig(proxy_rays=T_TINY.proxy_rays, seed=0),
        sharded=True, device="cpu")
    assert split.sharded and split.n_shards == 1
    assert split.psnr_org_proxy == b.benv.psnr_org_proxy
    bits = np.random.RandomState(5).randint(1, 9, size=(6, b.env.n_units))
    budget = 0.8 * b.env.original_cost
    _assert_evals_identical(split.evaluate_population(bits, budget),
                            b.benv.evaluate_population(bits, budget))
    _assert_sims_identical(split.simulate_batch(bits),
                           b.benv.simulate_batch(bits))


def test_two_device_split_equals_the_plain_path(port_bundles, sequential,
                                               monkeypatch):
    """The population split over two devices (`population_devices`
    patched to [cpu, cpu]) at an odd K = 5, so the last policy pads the
    second shard: every metric equals the unsplit env's; and a closed loop
    over split envs (K = 6) gives the sequential result, reported as
    sharded."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(tpop, "population_devices",
                        lambda n=None, kind="cuda": [cpu, cpu])
    b = port_bundles["lego"]
    split = BatchedQuantEnv(
        b.env, BatchedEnvConfig(proxy_rays=T_TINY.proxy_rays, seed=1),
        sharded=True, device="cpu")
    assert split.n_shards == 2
    bits = np.random.RandomState(9).randint(1, 9, size=(5, b.env.n_units))
    _assert_evals_identical(split.evaluate_population(bits),
                            b.benv.evaluate_population(bits))
    _assert_sims_identical(split.simulate_batch(bits),
                           b.benv.simulate_batch(bits))
    chair = port_bundles["chair"]
    split_chair = BatchedQuantEnv(
        chair.env, BatchedEnvConfig(proxy_rays=T_TINY.proxy_rays, seed=0),
        sharded=True, device="cpu")
    cfg = _port_cfg(sharded=True)
    res = tcl.HeroSearchRun(cfg, device="cpu", bundles={
        "chair": tcl.scene_bundle(chair.env, split_chair),
        "lego": tcl.scene_bundle(b.env, split)}).run()
    _assert_results_equal(res, sequential)
    assert res.sharded is True and tcl.bench_report(res, cfg)["sharded"]


def test_pad_and_single_device_shard_population_equal_reference(bundles):
    """`pad_population` pads as the reference's, and the one-device
    `shard_population` of the fused latency model gives the reference's
    statistics exactly and its cycles within the simulator band."""
    import repro.distributed.population as jpop

    rng = np.random.RandomState(2)
    for k, m in ((5, 2), (4, 2), (1, 3), (7, 4)):
        arr = rng.randint(1, 9, size=(k, 3)).astype(np.float32)
        got, gk = tpop.pad_population(arr, m)
        want, wk = jpop.pad_population(arr, m)
        np.testing.assert_array_equal(got, want)
        assert gk == wk == k
    jb, tb = bundles
    hb, wb, ab = tb.benv.bits_to_arrays(
        rng.randint(1, 9, size=(5, tb.env.n_units)))
    got = tpop.shard_population(tb.benv.bsim.vmappable(),
                                [torch.device("cpu")])(hb, wb, ab)
    call = jpop.shard_population(jax.vmap(jb.benv.bsim.vmappable()))
    assert call.n_shards == 1
    want = call(hb, wb, ab)
    assert sorted(got) == sorted(want)
    for key in ("grid_hits", "grid_misses", "grid_cold_misses"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_array_equal(got["model_bytes"].astype(np.float32),
                                  want["model_bytes"])
    np.testing.assert_allclose(got["total_cycles"], want["total_cycles"],
                               rtol=REL)


def test_subprocess_worker_runs_a_real_cell_equal_to_inline(monkeypatch):
    """A real tiny cell crosses the process boundary through
    `worker_main` on the CPU and comes back as the `CellOutput` the same
    cell gives in this process: the child retrains its scene from the
    config (one intra-op thread, as here) and gets the same field."""
    cfg = tcl.ClosedLoopConfig(
        scenes=("chair",), budget_fracs=(1.0,), seed=3, scale=T_TINY,
        n_iterations=1, population=4, verbose=False, checkpoint_path=None)
    run = tcl.HeroSearchRun(cfg, device="cpu")
    program = torch_orch.SearchCellProgram(run)
    spec = program.cell_specs()[0]
    assert program.job_payload(spec)["device"] == "cpu"
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    w = torch_orch.SubprocessWorker(program.job_payload, name="p0",
                                    device="cpu")
    assert w.card is None
    w.start(spec, 0)
    try:
        w._proc.wait(timeout=600)
    finally:
        ev = w.poll()
        w.close()
    assert ev is not None, "the subprocess worker did not finish"
    kind, espec, attempt, out = ev
    assert kind == "done", (kind, out)
    assert espec == spec and attempt == 0
    assert isinstance(out, tcl.CellOutput) and out.policies_evaluated == 4
    inline = run.run_cell(spec)
    timeless = lambda o: [dict(p, t_emit=None) for p in o.points]
    assert timeless(out) == timeless(inline)
    assert out.best_bits == inline.best_bits
    assert out.best_reward == inline.best_reward
