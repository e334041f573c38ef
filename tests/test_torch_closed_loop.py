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
  report's validity flags, and what is not ported raising.
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


def test_what_is_not_ported_raises():
    with pytest.raises(NotImplementedError, match="item 7"):
        tcl.HeroSearchRun(_port_cfg(sharded=True), device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        tcl.HeroSearchRun(_cfg(tcl, workload="lm"), device="cpu").run()
    with pytest.raises(NotImplementedError, match="item 8"):
        twl.get_workload("lm")


def test_scene_bundle_anchors(port_bundles):
    b = port_bundles["chair"]
    base = b.baseline_point()
    assert base.bits == tuple([8] * b.env.n_units) and base.reward == 0.0
    n = b.normalize(base)
    assert (n.latency, n.psnr, n.model_bytes) == (1.0, 0.0, 1.0)
    assert b.baseline_latency == float(b.env.original_cost)
    assert b.env.device == torch.device("cpu")
