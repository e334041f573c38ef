"""The HERO search: the port's action mapping, reward, Pareto frontier, DDPG
agent, environments, searches and baselines against the JAX package's,
on the same trained parameters, dataset and agent state (numpy arrays
carried across), at the 4-level test config:

- Eq. 3 and Eq. 8 equal; the frontier and its hypervolume equal;
- DDPG `act()` within 1e-6 (the same bits) and one `_update_step` within
  1e-5 (both losses and every leaf, moments included);
- the env with `finetune_steps=0`: calibration within 1e-6, the 8-bit
  cost and the latency slopes within 1e-6 relative, `psnr_org` within
  1e-3 dB, constraint enforcement giving the same bits under three
  budgets, `evaluate_bits` (PSNR 1e-3 dB, latency 1e-6 relative,
  `model_bytes` and `fqr` exact, reward 1e-4);
- `hero_search` during warm-up walking the reference's bits exactly (both
  draw from the same `RandomState`), and the population at K = 8 (proxy
  PSNR within 1e-3 dB, misses exact), the population search too;
- inside the port: batched equals sequential, seeded determinism, one
  occupancy bake for two envs over the same weights.

The 8-bit baseline's PSNR carries the one known gap: the integer path
clamps the paper-exact grid's -129 weight code to int8's -128, as the
reference's Pallas kernel does, while the reference's CPU float carrier
keeps it (ROADMAP §3): 5.8e-4 dB here, inside the band."""
import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.hwsim as jh
from repro.core import ddpg as jddpg
from repro.core import pareto as jpareto
from repro.nerf import dataset as jd
from repro.nerf import hash_encoding as jhe
from repro.nerf import ngp as jngp
from repro.nerf import render as jr
from repro.nerf import scenes as js
from repro.nerf import train as jt
import repro_torch.core as tcore
import repro_torch.hwsim as th
from repro_torch.convert import (
    dataset_from_numpy,
    ddpg_state_from_numpy,
    params_from_numpy,
)
from repro_torch.core import ddpg as tddpg
from repro_torch.core import pareto as tpareto
from repro_torch.nerf import hash_encoding as the
from repro_torch.nerf import ngp as tngp
from repro_torch.nerf import occupancy as tocc
from repro_torch.nerf import render as tr
from repro_torch.nerf import train as tt
from repro_torch.tree_util import leaves_with_path

HASH = dict(n_levels=4, log2_table_size=9, base_resolution=4,
            max_resolution=32)
MLP = dict(hidden_dim=16, color_hidden_dim=16, geo_feat_dim=7, sh_degree=2)
J_CFG = jngp.NGPConfig(hash=jhe.HashEncodingConfig(**HASH), **MLP)
T_CFG = tngp.NGPConfig(hash=the.HashEncodingConfig(**HASH), **MLP)
J_RCFG, T_RCFG = jr.RenderConfig(n_samples=8), tr.RenderConfig(n_samples=8)
TRAIN = dict(steps=10, batch_rays=64)
ENV = dict(finetune_steps=0, trace_rays=32, calib_points=128)
PSNR_ATOL_DB = 1e-3
REL = 1e-6
REWARD_ATOL = 1e-4
ACT_ATOL = 1e-6
UPDATE_TOL = 1e-5
# 14 units: 4 hash levels, then (activation, weight) of 5 linears.
BITS = [[3, 5, 7, 8, 2, 4, 6, 8, 3, 5, 7, 1, 8, 4],
        [8, 6, 4, 2, 8, 8, 5, 3, 8, 8, 6, 6, 4, 4]]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny shapes gain nothing from more, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """(reference params, reference dataset, the port's params, the port's
    dataset): the chair, briefly trained by the reference."""
    j_ds = jd.make_dataset(js.SceneConfig(image_hw=12, n_train_views=3,
                                          n_test_views=2))
    jp, _ = jt.train_ngp(j_ds, J_CFG, J_RCFG, jt.TrainConfig(**TRAIN))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jp, j_ds, tp, dataset_from_numpy(j_ds)


@pytest.fixture(scope="module")
def envs(scene):
    """(reference env, port env): the same scene, trace rays, calibration
    rays and 2-coarse-level NeuRex timing."""
    jp, j_ds, tp, t_ds = scene
    je = jcore.NGPQuantEnv(jp, j_ds, J_CFG, J_RCFG, jt.TrainConfig(**TRAIN),
                           jcore.EnvConfig(**ENV),
                           jh.HWConfig(coarse_levels=2))
    te = tcore.NGPQuantEnv(tp, t_ds, T_CFG, T_RCFG, tt.TrainConfig(**TRAIN),
                           tcore.EnvConfig(**ENV),
                           th.HWConfig(coarse_levels=2), device="cpu")
    return je, te


# ---------------------------------------------------------------------------
# Action, reward, Pareto
# ---------------------------------------------------------------------------
def test_action_to_bits_and_reward_equal_reference():
    for a in np.linspace(-0.1, 1.1, 241):
        for b_min, b_max in ((1, 8), (2, 6)):
            assert tcore.action_to_bits(float(a), b_min, b_max) \
                == jcore.action_to_bits(float(a), b_min, b_max)
    for b in range(1, 9):
        assert tcore.bits_to_action(b) == jcore.bits_to_action(b)
    rng = np.random.RandomState(0)
    for _ in range(50):
        p, q, c, o = rng.rand(4) * [40, 40, 1e6, 1e6]
        assert tcore.hero_reward(p, q, c, o) == jcore.hero_reward(p, q, c, o)
        assert tcore.cost_ratio(c, o) == jcore.cost_ratio(c, o)


def test_pareto_frontier_and_hypervolume_equal_reference():
    rng = np.random.RandomState(3)
    pts = rng.rand(60, 3) * [1e6, 30, 1e4]
    pts[::7] = pts[1::7][: len(pts[::7])]  # ties
    mk = lambda m: [m.ParetoPoint(latency=float(a), psnr=float(b),
                                  model_bytes=float(c), bits=(i,))
                    for i, (a, b, c) in enumerate(pts)]
    cons = dict(max_latency=9e5, min_psnr=2.0)
    jf = jpareto.ParetoFrontier(mk(jpareto), jpareto.ConstraintSet(**cons))
    tf = tpareto.ParetoFrontier(mk(tpareto), tpareto.ConstraintSet(**cons))
    assert tf.objective_set() == jf.objective_set()
    assert [p.bits for p in tf] == [p.bits for p in jf]
    assert tf.hypervolume() == jf.hypervolume()
    assert tf.hypervolume((1e6, 0.0, 1e4)) == jf.hypervolume((1e6, 0.0, 1e4))
    assert tpareto.ParetoFrontier.from_json(tf.to_json()).objective_set() \
        == tf.objective_set()
    assert len(tpareto.pareto_filter(mk(tpareto))) \
        == len(jpareto.pareto_filter(mk(jpareto)))


# ---------------------------------------------------------------------------
# DDPG
# ---------------------------------------------------------------------------
def _agents(cfg_kw=None):
    """(reference agent, port agent carrying the reference's state)."""
    cfg_kw = cfg_kw or {}
    ja = jddpg.DDPGAgent(jddpg.DDPGConfig(**cfg_kw))
    ta = tddpg.DDPGAgent(tddpg.DDPGConfig(**cfg_kw), device="cpu")
    ta.state = ddpg_state_from_numpy(ja.state, device="cpu")
    return ja, ta


def test_ddpg_act_matches_reference():
    """Warm-up draws, then the actor's output with and without noise: the
    same `RandomState` stream, outputs within 1e-6, the same bits."""
    ja, ta = _agents(dict(warmup_episodes=1))
    obs = np.random.RandomState(1).rand(20, 7).astype(np.float32)
    for o in obs[:5]:  # warm-up: uniform draws
        assert ta.act(o) == ja.act(o)
    for agent in (ja, ta):
        agent._episodes_seen = 1
    for o in obs:
        for explore in (False, True):
            a, b = ja.act(o, explore=explore), ta.act(o, explore=explore)
            assert abs(a - b) <= ACT_ATOL
            assert tcore.action_to_bits(b) == jcore.action_to_bits(a)


def _leaf_gaps(jstate, tstate):
    """Largest |port - reference| of every leaf of the train state."""
    want = dict(leaves_with_path(jax.tree_util.tree_map(
        np.asarray, {"actor": jstate.actor, "critic": jstate.critic,
                     "target_actor": jstate.target_actor,
                     "target_critic": jstate.target_critic,
                     "actor_mu": jstate.actor_opt.mu,
                     "actor_nu": jstate.actor_opt.nu,
                     "critic_mu": jstate.critic_opt.mu,
                     "critic_nu": jstate.critic_opt.nu})))
    got = dict(leaves_with_path(
        {"actor": tstate.actor, "critic": tstate.critic,
         "target_actor": tstate.target_actor,
         "target_critic": tstate.target_critic,
         "actor_mu": tstate.actor_opt.mu, "actor_nu": tstate.actor_opt.nu,
         "critic_mu": tstate.critic_opt.mu,
         "critic_nu": tstate.critic_opt.nu}))
    assert sorted(got) == sorted(want) and len(got) == 48
    return {k: float(np.abs(got[k].numpy() - want[k]).max()) for k in want}


def test_ddpg_update_step_matches_reference():
    """One critic + actor step and the soft target updates on the same
    batch: both losses within 1e-5 relative, every leaf within 1e-5."""
    ja, ta = _agents()
    cfg = ja.cfg
    rng = np.random.RandomState(2)
    batch = (rng.rand(64, 7).astype(np.float32),
             rng.rand(64, 1).astype(np.float32),
             rng.randn(64, 1).astype(np.float32),
             rng.rand(64, 7).astype(np.float32),
             (rng.rand(64, 1) < 0.1).astype(np.float32))
    baseline = np.float32(0.37)
    jstate, jcl, jal = jddpg._update_step(
        ja.state, tuple(jnp.asarray(b) for b in batch), jnp.float32(baseline),
        cfg)
    tstate, tcl, tal = tddpg._update_step(
        ta.state, tuple(torch.from_numpy(b) for b in batch), float(baseline),
        tddpg.DDPGConfig())
    assert float(tcl) == pytest.approx(float(jcl), rel=UPDATE_TOL)
    assert float(tal) == pytest.approx(float(jal), rel=UPDATE_TOL)
    gaps = _leaf_gaps(jstate, tstate)
    assert max(gaps.values()) <= UPDATE_TOL, gaps
    assert int(tstate.actor_opt.step) == int(jstate.actor_opt.step) == 1


def test_ddpg_init_and_update_are_seeded():
    """The port's own agent: one seed, one network and one update; another
    seed, another network."""
    def run(seed):
        agent = tddpg.DDPGAgent(tddpg.DDPGConfig(seed=seed, batch_size=8,
                                                 updates_per_episode=2),
                                device="cpu")
        obs = np.random.RandomState(0).rand(10, 7).astype(np.float32)
        agent.observe_episode([(o, [0.5], o, False) for o in obs], 0.3)
        losses = agent.update()
        return dict(leaves_with_path(agent.state.actor)), losses

    (a, la), (b, lb), (c, _) = run(3), run(3), run(4)
    assert la == lb and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["w0"], c["w0"])


# ---------------------------------------------------------------------------
# The scalar env
# ---------------------------------------------------------------------------
def test_env_construction_matches_reference(envs):
    je, te = envs
    assert te.device.type == "cpu" and te.n_units == je.n_units == 14
    np.testing.assert_allclose(te.act_ranges.numpy(),
                               np.asarray(je.act_ranges), atol=1e-6)
    assert te.original_cost == pytest.approx(je.original_cost, rel=REL)
    np.testing.assert_allclose(te._latency_slopes, je._latency_slopes,
                               rtol=REL)
    assert te._latency_slopes.max() > 0
    assert abs(te.psnr_org - je.psnr_org) <= PSNR_ATOL_DB
    for i in range(te.n_units):
        np.testing.assert_array_equal(te.observation(i, 0.3),
                                      je.observation(i, 0.3))
    for a, b in zip(te.trace.level_indices, je.trace.level_indices):
        np.testing.assert_array_equal(a, b)
    assert te.occ.occupied_fraction == je.occ.occupied_fraction


@pytest.mark.parametrize("share", [None, 0.8, 0.5])
def test_enforce_latency_target_matches_reference(envs, share):
    je, te = envs
    budget = None if share is None else share * je.original_cost
    for bits in BITS:
        want = je.enforce_latency_target(bits, target=budget)
        assert te.enforce_latency_target(bits, target=budget) == want
        if share is not None and share < 0.6:
            assert want != bits


@pytest.mark.parametrize("bits", BITS)
def test_evaluate_bits_matches_reference(envs, bits):
    je, te = envs
    want, got = je.evaluate_bits(bits), te.evaluate_bits(bits)
    assert abs(got.psnr - want.psnr) <= PSNR_ATOL_DB
    assert got.latency_cycles == pytest.approx(want.latency_cycles, rel=REL)
    assert got.model_bytes == want.model_bytes
    assert got.fqr == want.fqr
    assert abs(got.reward - want.reward) <= REWARD_ATOL
    assert got.bits == want.bits


def test_finetuned_episode_is_seeded(envs):
    """Two episodes of the port with a 2-step finetune: the same numbers."""
    _, te = envs
    a = te.evaluate_bits(BITS[0], finetune_steps=2)
    b = te.evaluate_bits(BITS[0], finetune_steps=2)
    assert (a.psnr, a.latency_cycles, a.reward) == (b.psnr, b.latency_cycles,
                                                    b.reward)
    assert np.isfinite(a.psnr)


def test_baselines_match_reference(envs):
    je, te = envs
    for want, got in ((jcore.ptq_baseline(je, 6), tcore.ptq_baseline(te, 6)),
                      (jcore.qat_baseline(je, 5),
                       tcore.qat_baseline(te, 5))):
        assert got.name == want.name and got.bits == want.bits
        assert abs(got.psnr - want.psnr) <= PSNR_ATOL_DB
        assert got.latency_cycles == pytest.approx(want.latency_cycles,
                                                   rel=REL)
        assert got.model_bytes == want.model_bytes


def test_caq_proxy_allocates_like_caq(envs):
    """The content-aware proxy on the port: uniform hash bits, every MLP
    unit at the high or the low width, half of them high."""
    _, te = envs
    res = tcore.caq_proxy_baseline(te, "MDL")
    hash_bits = res.bits[:4]
    mlp = res.bits[4:]
    assert set(hash_bits) == {8}
    assert set(mlp) <= {8, 6} and mlp.count(8) == len(mlp) // 2
    assert np.isfinite(res.psnr) and res.latency_cycles > 0


def test_occupancy_registry_bakes_once_for_two_envs(scene, monkeypatch):
    """Two envs over the same weights share one grid, baked once; changed
    weights bake another."""
    _, _, tp, t_ds = scene
    calls = []
    bake = tocc.bake_occupancy
    monkeypatch.setattr(tocc, "bake_occupancy",
                        lambda *a, **k: calls.append(1) or bake(*a, **k))
    tocc.clear_occupancy_registry()
    mk = lambda p: tcore.NGPQuantEnv(p, t_ds, T_CFG, T_RCFG,
                                     tt.TrainConfig(**TRAIN),
                                     tcore.EnvConfig(**ENV),
                                     th.HWConfig(coarse_levels=2),
                                     device="cpu")
    a, b = mk(tp), mk(dict(tp))
    assert a.occ is b.occ and len(calls) == 1
    assert tocc.occupancy_registry_size() == 1
    moved = dict(tp, **{"sigma/0": {"w": tp["sigma/0"]["w"] + 1e-3,
                                    "b": tp["sigma/0"]["b"]}})
    assert tocc.params_fingerprint(moved) != tocc.params_fingerprint(tp)
    c = mk(moved)
    assert c.occ is not a.occ and len(calls) == 2
    assert tocc.occupancy_registry_size() == 2


# ---------------------------------------------------------------------------
# Searches and the batched env
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("share", [None, 0.6])
def test_warmup_search_walks_the_reference_bits(envs, share):
    """Two warm-up episodes: both agents draw their actions from the same
    `RandomState`, so the bits (after the same constraint enforcement)
    are the reference's, and the episodes score alike."""
    je, te = envs
    budget = None if share is None else share * je.original_cost
    scfg = dict(n_episodes=2, verbose=False, seed=5)
    want = jcore.hero_search(je, jcore.SearchConfig(**scfg),
                             latency_target=budget)
    got = tcore.hero_search(te, tcore.SearchConfig(**scfg),
                            latency_target=budget, device="cpu")
    assert [h.bits for h in got.history] == [h.bits for h in want.history]
    for g, w in zip(got.history, want.history):
        assert abs(g.psnr - w.psnr) <= PSNR_ATOL_DB
        assert g.latency_cycles == pytest.approx(w.latency_cycles, rel=REL)
    assert got.best.bits == want.best.bits


@pytest.fixture(scope="module")
def benvs(envs):
    je, te = envs
    return (jcore.BatchedQuantEnv(je, jcore.BatchedEnvConfig(proxy_rays=64)),
            tcore.BatchedQuantEnv(te, tcore.BatchedEnvConfig(proxy_rays=64),
                                  device="cpu"))


def test_evaluate_population_matches_reference(benvs):
    jb, tb = benvs
    assert tb.sharded is False
    bits = np.random.RandomState(0).randint(1, 9, size=(8, 14))
    budget = 0.7 * jb.env.original_cost
    want = jb.evaluate_population(bits, latency_target=budget)
    got = tb.evaluate_population(bits, latency_target=budget)
    assert abs(tb.psnr_org_proxy - jb.psnr_org_proxy) <= PSNR_ATOL_DB
    np.testing.assert_allclose(got.psnr, want.psnr, rtol=0,
                               atol=PSNR_ATOL_DB)
    np.testing.assert_allclose(got.latency_cycles, want.latency_cycles,
                               rtol=REL)
    np.testing.assert_array_equal(got.model_bytes, want.model_bytes)
    np.testing.assert_array_equal(got.fqr, want.fqr)
    np.testing.assert_array_equal(got.feasible, want.feasible)
    np.testing.assert_allclose(got.reward, want.reward, atol=REWARD_ATOL)
    sim_t, sim_j = tb.simulate_batch(bits), jb.simulate_batch(bits)
    np.testing.assert_array_equal(sim_t["grid_misses"], sim_j["grid_misses"])


def test_population_equals_sequential_evaluations(benvs):
    """Inside the port: the batch's latencies equal the scalar env's, and
    its proxy PSNRs equal the policies scored one at a time."""
    _, tb = benvs
    bits = np.random.RandomState(4).randint(1, 9, size=(5, 14))
    ev = tb.evaluate_population(bits)
    for i in range(5):
        one = tb.evaluate_population(bits[i:i + 1])
        assert one.psnr[0] == ev.psnr[i] and one.reward[0] == ev.reward[i]
        policy = tcore.env.QuantPolicy.uniform(tb.env.units, 8) \
            .with_bits(list(bits[i]))
        lat = tb.env.simulate_policy(policy)
        assert ev.latency_cycles[i] == lat.total_cycles
        assert ev.model_bytes[i] == lat.model_bytes


def test_population_search_matches_reference(benvs):
    """Two iterations of K = 8 with the actor still in warm-up: the CEM
    draws and the agent's walks come from the same streams, so the
    proposals and the elites are the reference's; rewards within 1e-4."""
    jb, tb = benvs
    scfg = dict(n_iterations=2, population=8, verbose=False, seed=1)
    dcfg = dict(warmup_episodes=100, updates_per_episode=2)
    want = jcore.hero_population_search(
        jb, jcore.PopulationSearchConfig(**scfg), jddpg.DDPGConfig(**dcfg))
    got = tcore.hero_population_search(
        tb, tcore.PopulationSearchConfig(**scfg), tddpg.DDPGConfig(**dcfg),
        device="cpu")
    assert got.policies_evaluated == want.policies_evaluated == 16
    for g, w in zip(got.history, want.history):
        np.testing.assert_array_equal(g.eval.bits, w.eval.bits)
        np.testing.assert_array_equal(g.elite_indices, w.elite_indices)
        np.testing.assert_allclose(g.eval.reward, w.eval.reward,
                                   atol=REWARD_ATOL)
    assert got.best_bits == want.best_bits
    assert got.best_reward == pytest.approx(want.best_reward,
                                            abs=REWARD_ATOL)


def test_sharded_population_raises_instead_of_running_unsharded(envs):
    """`sharded=True` splits the population (here over the one CPU) and
    never quietly runs on one device: a target whose batched form has no
    `vmappable()` cannot be split, so asking for the split raises, while
    `sharded=None` stays on one device there."""
    _, te = envs
    tb = tcore.BatchedQuantEnv(te, tcore.BatchedEnvConfig(proxy_rays=16),
                               sharded=True, device="cpu")
    assert tb.sharded is True and tb.n_shards == 1

    class NoSplitTarget:
        def __init__(self, inner):
            self.inner = inner

        def batched(self, *a, **kw):
            return SimpleNamespace(
                simulate_batch=self.inner.batched(*a, **kw).simulate_batch)

    unsplittable = copy.copy(te)
    unsplittable.target = NoSplitTarget(te.target)
    with pytest.raises(ValueError, match="vmappable"):
        tcore.BatchedQuantEnv(unsplittable, sharded=True, device="cpu")
    tb = tcore.BatchedQuantEnv(unsplittable,
                               tcore.BatchedEnvConfig(proxy_rays=16),
                               device="cpu")
    assert tb.sharded is False and tb.n_shards == 1
