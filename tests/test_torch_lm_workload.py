"""The LM quantization workload (`repro_torch.workloads.lm`) and its closed
loop against the JAX package's, on the reference's qwen2-7b smoke bundle:
its weights carried into the port's env with `lm_params_from_numpy`
(`params=`), the token batches the same bit for bit, and the port's
`roofline-lm` given the reference's TPU v5e rate (`hbm_gbps=819.0`), so
latencies compare in seconds.

- exact: the unit layout and labels, `bits_to_arrays`, observations,
  `enforce_latency_target`, `policy_shape` and `describe()`;
- the 8-bit anchors, `evaluate_bits` and `evaluate_population` on fixed
  bit batches: quality within 1e-4 dB, losses within 1e-5 relative,
  latency and `model_bytes` within 1e-6 relative, rewards within 1e-5;
- the reference's saturation reproduced: on these weights quantizing
  LOWERS the loss, so quality sits at its cap -10 log10(2 * LOSS_FLOOR)
  = 36.98970004336019 dB at both extremes, in both packages (the
  reference's own `test_proxy_and_full_eval_agree_on_extremes[lm]`
  fails on it at `tests/test_workloads.py:146`);
- the population split over [cpu, cpu] equal to the plain path exactly;
- the closed loop: a reference checkpoint replayed by the port to the
  same frontier and hypervolume, resumed both ways, and a running loop
  (the reference agent's initial state carried across) with equal bits
  and elites."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import repro.core.closed_loop as jcl
import repro.workloads as jwl
import repro.workloads.lm as jlw
from repro.core import ddpg as jddpg
import repro_torch.core.closed_loop as tcl
import repro_torch.distributed.population as tpop
import repro_torch.workloads as twl
import repro_torch.workloads.lm as tlw
from repro_torch.convert import ddpg_state_from_numpy, lm_params_from_numpy
from repro_torch.core import ddpg as tddpg
from repro_torch.core import search as tsearch
from repro_torch.hero import targets as ttg

ARCH = "qwen2-7b"
CAP_DB = 36.98970004336019
Q_ATOL = 1e-4
REL = 1e-6
LOSS_REL = 1e-5
REWARD_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny shapes gain nothing from more, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _v5e_target():
    return ttg.make_target("roofline-lm", hbm_gbps=819.0, device="cpu")


def _port_env(jb, ecfg=tlw.LMEnvConfig(), seed=0):
    params = lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jb.env.params), device="cpu")
    return tlw.LMQuantEnv(ARCH, ecfg, seed=seed, target=_v5e_target(),
                          device="cpu", params=params)


@pytest.fixture(scope="module")
def bundles():
    """(the reference's qwen2-7b bundle, the port's on its weights)."""
    jb = jwl.get_workload("lm").build_bundle(ARCH, seed=0)
    env = _port_env(jb)
    return jb, tlw.lm_bundle(env, tlw.LMBatchedEnv(env))


def _bits(env, K, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(env.ecfg.b_min, env.ecfg.b_max + 1,
                       size=(K, env.n_units))


# ---------------------------------------------------------------------------
# Registry, layout, anchors
# ---------------------------------------------------------------------------
def test_registry_policy_shape_and_describe_equal_reference():
    tw, jw = twl.get_workload("lm"), jwl.get_workload("lm")
    assert isinstance(tw, twl.Workload)
    assert (tw.kind, tw.default_hardware) == (jw.kind, jw.default_hardware)
    assert tw.describe() == jw.describe()
    for arch in ("qwen2-7b", "llama3-405b", "granite-34b", "nemotron-4-340b",
                 "arctic-480b", "qwen3-moe-235b-a22b"):
        for tscale, jscale in ((None, None),
                               (tlw.LMEnvConfig(b_min=3),
                                jlw.LMEnvConfig(b_min=3)),
                               (tcl.SceneScale.quick(),
                                jcl.SceneScale.quick())):
            assert dataclasses.asdict(tw.policy_shape(arch, tscale)) \
                == dataclasses.asdict(jw.policy_shape(arch, jscale))
    assert dataclasses.asdict(tlw.LMEnvConfig()) \
        == dataclasses.asdict(jlw.LMEnvConfig())
    assert tlw.LOSS_FLOOR == jlw.LOSS_FLOOR
    losses = np.asarray([6.9, 6.95, 7.3, 6.0], np.float32)
    np.testing.assert_array_equal(tlw.quality_db(losses, 6.9),
                                  jlw.quality_db(losses, 6.9))


def test_env_layout_equals_reference(bundles):
    jb, tb = bundles
    je, te = jb.env, tb.env
    assert (te.n_units, te.n_layers, te.n_bands) == (je.n_units, je.n_layers,
                                                     je.n_bands)
    assert te.unit_labels == je.unit_labels
    bits = _bits(je, 6, seed=1)
    for got, want in zip(tb.benv.bits_to_arrays(bits),
                         jb.benv.bits_to_arrays(bits)):
        np.testing.assert_array_equal(got, want)
    for i in range(je.n_units):
        np.testing.assert_array_equal(te.observation(i, 0.3),
                                      je.observation(i, 0.3))
    actions = np.linspace(0.0, 1.0, je.n_units)
    assert te.actions_to_bits(actions) == je.actions_to_bits(actions)
    np.testing.assert_allclose(te._latency_slopes, je._latency_slopes,
                               rtol=1e-12)


def test_anchors_match_reference(bundles):
    jb, tb = bundles
    je, te = jb.env, tb.env
    assert te.base_loss_proxy == pytest.approx(je.base_loss_proxy,
                                               rel=LOSS_REL)
    assert te.base_loss_full == pytest.approx(je.base_loss_full, rel=LOSS_REL)
    assert te.original_cost == pytest.approx(je.original_cost, rel=REL)
    assert te.psnr_org == pytest.approx(je.psnr_org, abs=Q_ATOL)
    assert tb.baseline_latency == pytest.approx(jb.baseline_latency, rel=REL)
    assert tb.baseline_psnr == pytest.approx(jb.baseline_psnr, abs=Q_ATOL)
    assert tb.baseline_bytes == pytest.approx(jb.baseline_bytes, rel=REL)
    assert tb.scene == jb.scene == ARCH
    norm = tb.normalize(tb.baseline_point())
    assert (norm.latency, norm.psnr, norm.model_bytes) == (1.0, 0.0, 1.0)


@pytest.mark.parametrize("frac", [None, 1.0, 0.85, 0.7, 0.5, 0.2])
def test_enforce_latency_target_exact(bundles, frac):
    jb, tb = bundles
    for bits in _bits(jb.env, 4, seed=2).tolist() + [[8] * jb.env.n_units]:
        target = None if frac is None else jb.baseline_latency * frac
        want = jb.env.enforce_latency_target(list(bits), target=target)
        got = tb.env.enforce_latency_target(list(bits), target=target)
        assert got == want
        assert tb.env.cost_seconds(got) == pytest.approx(
            jb.env.cost_seconds(want), rel=REL)


# ---------------------------------------------------------------------------
# Quality: the full eval and the population
# ---------------------------------------------------------------------------
def test_evaluate_bits_matches_reference(bundles):
    jb, tb = bundles
    n, b_min = jb.env.n_units, jb.env.ecfg.b_min
    for bits in [[8] * n, [b_min] * n] + _bits(jb.env, 3, seed=3).tolist():
        want = jb.env.evaluate_bits(bits)
        got = tb.env.evaluate_bits(bits)
        assert got.bits == want.bits and got.policy is None
        assert got.psnr == pytest.approx(want.psnr, abs=Q_ATOL)
        assert got.latency_cycles == pytest.approx(want.latency_cycles,
                                                   rel=REL)
        assert got.model_bytes == pytest.approx(want.model_bytes, rel=REL)
        assert got.reward == pytest.approx(want.reward, abs=REWARD_ATOL)
        assert got.fqr == want.fqr
        assert tb.env._full_loss(bits) == pytest.approx(
            jb.env._full_loss(bits), rel=LOSS_REL)


def test_evaluate_population_matches_reference(bundles):
    jb, tb = bundles
    bits = _bits(jb.env, 8, seed=4)
    target = 0.8 * jb.baseline_latency
    want = jb.benv.evaluate_population(bits, latency_target=target)
    got = tb.benv.evaluate_population(bits, latency_target=target)
    np.testing.assert_array_equal(got.bits, want.bits)
    np.testing.assert_allclose(got.psnr, want.psnr, rtol=0, atol=Q_ATOL)
    np.testing.assert_allclose(got.latency_cycles, want.latency_cycles,
                               rtol=REL)
    np.testing.assert_allclose(got.model_bytes, want.model_bytes, rtol=REL)
    np.testing.assert_allclose(got.reward, want.reward, rtol=0,
                               atol=REWARD_ATOL)
    np.testing.assert_array_equal(got.fqr, want.fqr)
    np.testing.assert_array_equal(got.feasible, want.feasible)
    assert tb.benv.psnr_org_proxy == pytest.approx(jb.benv.psnr_org_proxy,
                                                   abs=Q_ATOL)
    sim_t, sim_j = tb.benv.simulate_batch(bits), jb.benv.simulate_batch(bits)
    assert set(sim_t) == set(sim_j)
    for k in sim_j:
        np.testing.assert_allclose(sim_t[k], np.asarray(sim_j[k]), rtol=REL)
    ref_losses = jb.benv._loss_batch(
        jb.env.params, *(jax.numpy.asarray(a)
                         for a in jb.benv.bits_to_arrays(bits)))
    np.testing.assert_allclose(tb.benv.proxy_losses(tb.env.params, bits),
                               np.asarray(ref_losses), rtol=LOSS_REL)


def test_quality_saturates_at_both_extremes_as_in_the_reference(bundles):
    """On the reference's random weights every quantized loss lies BELOW
    the full-precision loss, so quality clamps to its cap at 8 bits and
    at b_min alike, on the proxy and on the full eval, in both packages:
    the reference's `assert proxy[0] > proxy[1]` cannot hold."""
    jb, tb = bundles
    n, b_min = jb.env.n_units, jb.env.ecfg.b_min
    extremes = np.asarray([[8] * n, [b_min] * n], np.float32)
    for b in (jb, tb):
        proxy = b.benv.proxy_quality(b.env.params, extremes)
        np.testing.assert_array_equal(proxy, [CAP_DB, CAP_DB])
        assert b.env.evaluate_bits([8] * n).psnr == CAP_DB
        assert b.env.evaluate_bits([b_min] * n).psnr == CAP_DB
    losses = tb.benv.proxy_losses(tb.env.params, extremes)
    assert np.all(losses < tb.env.base_loss_proxy)
    want = np.asarray(jb.benv._loss_batch(jb.env.params, *(
        jax.numpy.asarray(a) for a in jb.benv.bits_to_arrays(extremes))))
    np.testing.assert_allclose(losses, want, rtol=LOSS_REL)
    full = [tb.env._full_loss(list(b)) for b in extremes]
    assert all(f < tb.env.base_loss_full for f in full)
    print(f"proxy losses at 8 and {b_min} bits: port {losses.tolist()}, "
          f"reference {want.tolist()}; full precision port "
          f"{tb.env.base_loss_proxy}, reference {jb.env.base_loss_proxy}; "
          f"full eval port {full} against {tb.env.base_loss_full}")
    assert CAP_DB == -10.0 * np.log10(2 * tlw.LOSS_FLOOR)


def test_population_split_over_two_devices_equals_the_plain_path(
        bundles, monkeypatch):
    jb, tb = bundles
    monkeypatch.setattr(tpop, "population_devices",
                        lambda n=None, kind="cuda": [torch.device("cpu")] * 2)
    split = tlw.LMBatchedEnv(tb.env, sharded=True)
    assert split.sharded and split.n_shards == 2
    assert tb.benv.n_shards == 1 and not tb.benv.sharded
    bits = _bits(tb.env, 5, seed=5)  # odd K: the split pads
    a = split.evaluate_population(bits)
    b = tb.benv.evaluate_population(bits)
    for f in ("bits", "psnr", "latency_cycles", "model_bytes", "reward",
              "fqr"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert split.psnr_org_proxy == tb.benv.psnr_org_proxy
    for k, v in tb.benv.simulate_batch(bits).items():
        np.testing.assert_array_equal(split.simulate_batch(bits)[k], v)


# ---------------------------------------------------------------------------
# The other block families: jamba and xlstm search, whisper and llava fail
# as the reference does
# ---------------------------------------------------------------------------
OTHER = ("jamba-v0.1-52b", "xlstm-350m", "whisper-large-v3",
         "llava-next-mistral-7b")


def test_policy_shape_of_the_other_families_equals_reference():
    tw, jw = twl.get_workload("lm"), jwl.get_workload("lm")
    for arch in OTHER:
        assert dataclasses.asdict(tw.policy_shape(arch)) \
            == dataclasses.asdict(jw.policy_shape(arch))


@pytest.mark.parametrize("gaps,ok", [
    ([0, 0, 0, 0], True), ([0, 0, 0, 9e-4], True), ([0, 0, 2e-5, 9e-4], False),
    ([0, 0, 0, 2e-3], False), ([0, 2e-5], False), ([9e-6, 0], True),
    ([0] * 6 + [5e-4] * 2, True), ([0] * 5 + [5e-4] * 3, False)])
def test_losses_agree_holds_three_in_four_near_and_all_far(gaps, ok):
    want = np.full(len(gaps), 6.9)
    got, d = tlw.losses_agree(want * (1 + np.asarray(gaps)), want)
    assert got is ok
    np.testing.assert_allclose(d, gaps, atol=1e-12)


def _flip_close(got, want):
    """The port's quantized losses against the reference's, under the
    port's own rule for two runs of them (`losses_agree`: most within
    FLIP_NEAR, all within FLIP_FAR)."""
    ok, d = tlw.losses_agree(got, want)
    assert ok, d


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m"])
def test_other_families_proxy_losses_match_reference(arch):
    """The reference's bundle and the port's env on its weights: the
    full-precision base losses within LOSS_REL; 8 policies' proxy losses
    (the 8-bit and b_min extremes among them) and the full eval of the
    two extremes under `_flip_close`; their cost within REL."""
    jb = jwl.get_workload("lm").build_bundle(arch, seed=0)
    params = lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jb.env.params), device="cpu")
    env = tlw.LMQuantEnv(arch, seed=0, target=_v5e_target(), device="cpu",
                         params=params)
    tb = tlw.lm_bundle(env, tlw.LMBatchedEnv(env))
    assert env.unit_labels == jb.env.unit_labels
    assert env.base_loss_proxy == pytest.approx(jb.env.base_loss_proxy,
                                                rel=LOSS_REL)
    assert env.base_loss_full == pytest.approx(jb.env.base_loss_full,
                                               rel=LOSS_REL)
    bits = _bits(env, 8, seed=6)
    bits[0], bits[1] = env.ecfg.b_max, env.ecfg.b_min
    want = np.asarray(jb.benv._loss_batch(jb.env.params, *(
        jax.numpy.asarray(a) for a in jb.benv.bits_to_arrays(bits))))
    got = tb.benv.proxy_losses(env.params, bits)
    print(f"{arch} proxy losses: port {got.tolist()}, reference "
          f"{want.tolist()}")
    _flip_close(got, want)
    sim_t, sim_j = tb.benv.simulate_batch(bits), jb.benv.simulate_batch(bits)
    for k in sim_j:
        np.testing.assert_allclose(sim_t[k], np.asarray(sim_j[k]), rtol=REL)
    full = [(env._full_loss(list(b)), jb.env._full_loss(list(b)))
            for b in bits[:2]]
    print(f"{arch} full evals of the extremes (port, reference): {full}")
    _flip_close(*zip(*full))
    for b in bits[:2]:
        assert env.evaluate_bits(list(b)).latency_cycles == pytest.approx(
            jb.env.evaluate_bits(list(b)).latency_cycles, rel=REL)


@pytest.mark.parametrize("arch,key", [("whisper-large-v3", "frames"),
                                      ("llava-next-mistral-7b", "patches")])
def test_frontend_families_fail_as_the_reference(arch, key):
    """The LM bundle scores token batches only; whisper's forward wants
    frames and llava's patches, so both packages raise the same
    `KeyError` (the port adds no search path the reference lacks)."""
    errors = []
    for build in (lambda: jwl.get_workload("lm").build_bundle(arch),
                  lambda: twl.get_workload("lm").build_bundle(arch,
                                                              device="cpu")):
        with pytest.raises(KeyError) as e:
            build()
        errors.append(e.value.args)
    assert errors[0] == errors[1] == (key,)


def test_renderer_targets_cannot_score_lm():
    with pytest.raises(ValueError, match="cannot score LM"):
        twl.get_workload("lm").build_bundle(ARCH, hardware="neurex",
                                            device="cpu")


def test_port_bundle_of_a_moe_arch_is_seeded():
    """The port's own weights (a torch generator seeded with the bundle's
    seed) for a MoE arch: two builds agree exactly, the proxy is finite."""
    wl = twl.get_workload("lm")
    a = wl.build_bundle("qwen3-moe-235b-a22b", seed=4, device="cpu")
    b = wl.build_bundle("qwen3-moe-235b-a22b", seed=4, device="cpu")
    assert a.env.base_loss_proxy == b.env.base_loss_proxy
    assert a.baseline_psnr == b.baseline_psnr
    bits = _bits(a.env, 3, seed=6)
    ev = a.benv.evaluate_population(bits)
    assert np.all(np.isfinite(ev.psnr)) and np.all(np.isfinite(ev.reward))
    np.testing.assert_array_equal(ev.psnr,
                                  b.benv.evaluate_population(bits).psnr)
    assert a.env.target.describe()["config"]["hbm_gbps"] == 3350.0


# ---------------------------------------------------------------------------
# The closed loop
# ---------------------------------------------------------------------------
def _cfg(pkg, **kw):
    """The reference's LM smoke cell: one arch, two budgets, 2 iterations
    at K = 8."""
    base = dict(scenes=(ARCH,), budget_fracs=(1.0, 0.85), seed=0,
                n_iterations=2, population=8, workload="lm",
                hardware="roofline-lm", verbose=False)
    base.update(kw)
    return pkg.ClosedLoopConfig(**base)


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
    jb, _ = bundles
    ck = tmp_path_factory.mktemp("ref_lm") / "ckpt.json"
    res = jcl.HeroSearchRun(_cfg(jcl, checkpoint_path=str(ck)),
                            {ARCH: jb}).run()
    return res, ck


def _assert_results_equal(a, b):
    assert a.frontier.objective_set() == b.frontier.objective_set()
    assert len(a.frontier) == len(b.frontier)
    assert a.hypervolume() == b.hypervolume()
    for s in a.scene_frontiers:
        assert (a.scene_frontiers[s].objective_set()
                == b.scene_frontiers[s].objective_set())
    assert [c.best_bits for c in a.cells] == [c.best_bits for c in b.cells]
    assert a.policies_evaluated == b.policies_evaluated


def test_fingerprints_equal_reference():
    assert tcl.HeroSearchRun(_cfg(tcl), device="cpu")._fingerprint() \
        == jcl.HeroSearchRun(_cfg(jcl))._fingerprint()
    knobs = dict(seq_len=32, eval_batches=1)
    got = tcl.HeroSearchRun(_cfg(tcl), workload=tlw.LMWorkload(
        tlw.LMEnvConfig(**knobs)), device="cpu")._fingerprint()
    want = jcl.HeroSearchRun(_cfg(jcl), workload=jlw.LMWorkload(
        jlw.LMEnvConfig(**knobs)))._fingerprint()
    assert got == want and got["workload_config"]["config"]["seq_len"] == 32


def test_replay_of_a_reference_lm_checkpoint_equals_reference(
        reference_run, tmp_path):
    want, ck = reference_run
    run = tcl.HeroSearchRun(_cfg(tcl, checkpoint_path=str(ck)), device="cpu")
    got = run.run()
    assert got.resumed_cells == 2
    _assert_results_equal(got, want)
    assert [c.to_json() for c in got.cells] \
        == [c.to_json() for c in want.cells]
    outputs, order = run._restore(run._load_checkpoint())
    out = tmp_path / "port.json"
    run.cfg = dataclasses.replace(run.cfg, checkpoint_path=str(out))
    run._save_checkpoint(outputs, order)
    assert out.read_text() == ck.read_text()


def test_running_lm_loop_matches_reference(bundles, reference_run,
                                           carried_agent):
    """The port's uninterrupted run over the same bundle's weights: every
    cell's points (bits equal; quality, reward and latency within the
    bands; sizes), winners and the frontier's objectives against the
    reference's."""
    jb, tb = bundles
    want, _ = reference_run
    got = tcl.HeroSearchRun(_cfg(tcl), {ARCH: tb}, device="cpu").run()
    assert len(got.cells) == len(want.cells) == 2
    for g, w in zip(got.cells, want.cells):
        assert g.best_bits == w.best_bits
        assert g.best_reward == pytest.approx(w.best_reward, abs=REWARD_ATOL)
        assert g.latency_target == pytest.approx(w.latency_target, rel=REL)
    assert got.policies_evaluated == want.policies_evaluated
    assert len(got.frontier) == len(want.frontier)
    for gp, wp in zip(sorted(got.frontier.points, key=lambda p: p.bits),
                      sorted(want.frontier.points, key=lambda p: p.bits)):
        assert gp.bits == wp.bits
        assert gp.psnr == pytest.approx(wp.psnr, abs=Q_ATOL)
        assert gp.latency == pytest.approx(wp.latency, rel=REL)
        assert gp.model_bytes == pytest.approx(wp.model_bytes, rel=REL)
    assert got.hypervolume() == pytest.approx(want.hypervolume(), rel=REL)
    report = tcl.bench_report(got, _cfg(tcl))
    assert report["workload"] == "lm" and report["frontier_valid_vs_8bit"]
    assert sorted(report) == sorted(jcl.bench_report(want, _cfg(jcl)))
    json.dumps(report)


def test_port_finishes_a_reference_lm_checkpoint(bundles, reference_run,
                                                 carried_agent, tmp_path):
    jb, tb = bundles
    want, _ = reference_run
    ck = tmp_path / "ckpt.json"
    jcl.HeroSearchRun(_cfg(jcl, checkpoint_path=str(ck)),
                      {ARCH: jb}).run(stop_after_cells=1)
    got = tcl.HeroSearchRun(_cfg(tcl, checkpoint_path=str(ck)), {ARCH: tb},
                            device="cpu").run()
    assert got.resumed_cells == 1 and len(got.cells) == 2
    assert [c.best_bits for c in got.cells] \
        == [c.best_bits for c in want.cells]
    assert got.hypervolume() == pytest.approx(want.hypervolume(), rel=REL)
    assert sorted(json.loads(ck.read_text())["completed"]) \
        == sorted(c.name for c in tcl.HeroSearchRun(
            _cfg(tcl), device="cpu").cell_specs())


def test_reference_finishes_a_port_lm_checkpoint(bundles, reference_run,
                                                 carried_agent, tmp_path):
    jb, tb = bundles
    want, _ = reference_run
    ck = tmp_path / "ckpt.json"
    part = tcl.HeroSearchRun(_cfg(tcl, checkpoint_path=str(ck)), {ARCH: tb},
                             device="cpu").run(stop_after_cells=1)
    assert len(part.cells) == 1
    got = jcl.HeroSearchRun(_cfg(jcl, checkpoint_path=str(ck)),
                            {ARCH: jb}).run()
    assert got.resumed_cells == 1 and len(got.cells) == 2
    assert [c.best_bits for c in got.cells] \
        == [c.best_bits for c in want.cells]
    assert got.hypervolume() == pytest.approx(want.hypervolume(), rel=REL)


def test_port_resume_equals_its_uninterrupted_run(bundles, tmp_path):
    _, tb = bundles
    full = tcl.HeroSearchRun(_cfg(tcl), {ARCH: tb}, device="cpu").run()
    ck = tmp_path / "ckpt.json"
    cfg = _cfg(tcl, checkpoint_path=str(ck))
    tcl.HeroSearchRun(cfg, {ARCH: tb}, device="cpu").run(stop_after_cells=1)
    state = json.loads(ck.read_text())
    assert state["config"]["workload"] == "lm"
    assert state["config"]["workload_config"]["kind"] == "lm"
    resumed = tcl.HeroSearchRun(cfg, {ARCH: tb}, device="cpu").run()
    assert resumed.resumed_cells == 1
    _assert_results_equal(resumed, full)
