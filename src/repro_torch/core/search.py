"""The HERO search loop: episodic DDPG over the quantization design space.

Per episode (Sec. III-E):
  1. walk every unit, agent picks a continuous action (obs Eqs. 1-2, noise);
  2. map actions -> bits (Eq. 3), enforce the latency target if configured;
  3. retrain briefly + evaluate PSNR + simulate latency -> reward (Eq. 8);
  4. push the episode's transitions (each carrying the final reward) into
     the replay buffer and run critic/actor updates (Eqs. 10-11).

Returns the best policy by reward plus the full search log.

`hero_population_search` is the batched variant: each iteration proposes a
population of K candidate policies (half from DDPG actor walks with
exploration noise, half from a CEM-style Gaussian over bit vectors), scores
all K in one `BatchedQuantEnv.evaluate_population` call, refines the
CEM distribution towards the elites, and seeds the DDPG replay buffer with
the elite episodes so the actor and the population estimator bootstrap each
other. The single-policy `hero_search` below is unchanged.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.core.action import bits_to_action
from repro_torch.core.ddpg import DDPGAgent, DDPGConfig
from repro_torch.core.env import EpisodeResult, NGPQuantEnv
from repro_torch.kernels.backend import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    n_episodes: int = 40
    finetune_steps: Optional[int] = None  # None -> env default
    verbose: bool = True
    seed: int = 0


@dataclasses.dataclass
class SearchResult:
    best: EpisodeResult
    history: List[EpisodeResult]
    wall_seconds: float

    def reward_curve(self) -> List[float]:
        return [h.reward for h in self.history]


def _search_device(env: NGPQuantEnv, device: DeviceLike):
    """The search's device (the card unless "cpu"), which the env's must
    be: the agent is built there."""
    dev = resolve_device(device)
    if env.device.type != dev.type:
        raise ValueError(f"the env runs on {env.device}, the search was "
                         f"asked for {dev}")
    return dev


def hero_search(
    env: NGPQuantEnv,
    scfg: SearchConfig = SearchConfig(),
    dcfg: Optional[DDPGConfig] = None,
    latency_target: Optional[float] = None,
    device: DeviceLike = None,
) -> SearchResult:
    """Episodic DDPG search on `device` (the card unless "cpu").
    `latency_target` is per-call search state (None falls back to the
    env-configured budget) — the replacement for the deprecated
    `env.set_latency_target` mutation."""
    dev = _search_device(env, device)
    t_start = time.time()
    agent = DDPGAgent(dcfg or DDPGConfig(seed=scfg.seed), device=dev)
    if latency_target is None:
        latency_target = env.ecfg.latency_target

    best: Optional[EpisodeResult] = None
    history: List[EpisodeResult] = []

    for ep in range(scfg.n_episodes):
        # --- act over the unit walk -------------------------------------
        observations, actions = _agent_walk(env, agent)

        # --- bits + constraints -----------------------------------------
        bits = env.actions_to_bits(actions)
        bits = env.enforce_latency_target(bits, target=latency_target)
        # The executed actions are the (possibly constraint-clamped) bits —
        # feed those back so the critic sees what actually ran.
        executed = [bits_to_action(b, env.ecfg.b_min, env.ecfg.b_max) for b in bits]

        # --- evaluate ------------------------------------------------------
        result = env.evaluate_bits(bits, scfg.finetune_steps)
        history.append(result)
        if best is None or result.reward > best.reward:
            best = result

        # --- learn ---------------------------------------------------------
        agent.observe_episode(
            _episode_transitions(env, observations, executed), result.reward
        )
        closs, aloss = agent.update()

        if scfg.verbose:
            print(
                f"[hero] ep {ep:3d} reward={result.reward:+.4f} "
                f"psnr={result.psnr:.2f} lat={result.latency_cycles:.3e} "
                f"fqr={result.fqr:.2f} closs={closs:.4f} "
                f"sigma={agent.noise_sigma:.3f} ({result.wall_seconds:.1f}s)",
                flush=True,
            )

    return SearchResult(
        best=best, history=history, wall_seconds=time.time() - t_start
    )


# ---------------------------------------------------------------------------
# Population-based search over the batched environment
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PopulationSearchConfig:
    n_iterations: int = 12
    population: int = 16  # K policies scored per iteration
    elite_frac: float = 0.25  # top-k fraction kept as elites
    agent_fraction: float = 0.5  # share of K proposed by DDPG actor walks
    cem_alpha: float = 0.7  # distribution smoothing (old weight)
    init_std: float = 2.0  # initial per-unit bit stddev
    min_std: float = 0.3  # exploration floor
    # Re-score this many of the best (distinct) proxy policies through the
    # scalar env (per-policy finetune + full PSNR) at the end. 0 = proxy
    # numbers only.
    exact_rescore_top: int = 0
    verbose: bool = True
    seed: int = 0


@dataclasses.dataclass
class PopulationIteration:
    """One iteration's summary: the full (K,) evaluation plus elite stats."""

    eval: "PopulationEval"
    elite_indices: np.ndarray
    mean_reward: float
    max_reward: float


@dataclasses.dataclass
class PopulationSearchResult:
    best_bits: List[int]
    best_reward: float  # proxy reward (see BatchedQuantEnv docstring)
    best_psnr: float  # proxy PSNR — NOT comparable to EpisodeResult.psnr
    best_latency_cycles: float
    best_model_bytes: float
    best_fqr: float
    history: List[PopulationIteration]
    policies_evaluated: int
    wall_seconds: float
    # Exact scalar-env re-evaluation of the top proxy policies (finetuned
    # PSNR, Eq. 8 reward) — populated when exact_rescore_top > 0.
    best_exact: Optional[EpisodeResult] = None

    def reward_curve(self) -> List[float]:
        return [h.max_reward for h in self.history]


def _agent_walk(env: NGPQuantEnv, agent: DDPGAgent, explore: bool = True):
    """One episode walk of the unit sequence: (observations, actions)."""
    observations, actions = [], []
    prev_action = 1.0  # convention: "full precision so far"
    for i in range(env.n_units):
        obs = env.observation(i, prev_action)
        a = agent.act(obs, explore=explore)
        observations.append(obs)
        actions.append(a)
        prev_action = a
    return observations, actions


def _episode_transitions(env: NGPQuantEnv, observations, executed):
    """Transition tuples for one episode: next-obs under the executed
    actions, zero next-obs + done flag on the terminal step."""
    transitions = []
    for i in range(env.n_units):
        nobs = (
            env.observation(i + 1, executed[i])
            if i + 1 < env.n_units
            else np.zeros_like(observations[i])
        )
        transitions.append(
            (observations[i], [executed[i]], nobs, i + 1 == env.n_units)
        )
    return transitions


def _replay_episode(env: NGPQuantEnv, agent: DDPGAgent, bits, reward: float):
    """Push one bit vector into the replay buffer as an episode whose
    executed actions are the bin centres of its bits (Eq. 3 inverse)."""
    executed = [bits_to_action(int(b), env.ecfg.b_min, env.ecfg.b_max) for b in bits]
    observations = []
    prev = 1.0
    for i in range(env.n_units):
        observations.append(env.observation(i, prev))
        prev = executed[i]
    agent.observe_episode(
        _episode_transitions(env, observations, executed), float(reward)
    )


def hero_population_search(
    benv,  # BatchedQuantEnv (typed loosely to avoid an import cycle)
    scfg: PopulationSearchConfig = PopulationSearchConfig(),
    dcfg: Optional[DDPGConfig] = None,
    latency_target: Optional[float] = None,
    device: DeviceLike = None,
) -> PopulationSearchResult:
    """Population-based HERO on `device` (the card unless "cpu"): CEM over
    bit vectors + DDPG proposals, scored K-at-a-time through the batched
    simulator and PSNR proxy.

    `latency_target` overrides the env-configured budget for this search
    only (None falls back to `env.ecfg.latency_target`): a closed loop
    runs the SAME env under several hardware budgets without mutating
    it."""
    env = benv.env
    dev = _search_device(env, device)
    t_start = time.time()
    rng = np.random.RandomState(scfg.seed)
    agent = DDPGAgent(dcfg or DDPGConfig(seed=scfg.seed), device=dev)
    if latency_target is None:
        latency_target = env.ecfg.latency_target

    b_min, b_max = env.ecfg.b_min, env.ecfg.b_max
    mean = np.full(env.n_units, 0.5 * (b_min + b_max))
    std = np.full(env.n_units, scfg.init_std)
    n_elite = max(1, int(round(scfg.population * scfg.elite_frac)))

    best = None  # (reward, member index data)
    history: List[PopulationIteration] = []
    n_evaluated = 0

    for it in range(scfg.n_iterations):
        # --- propose K candidates ---------------------------------------
        n_agent = int(round(scfg.population * scfg.agent_fraction))
        proposals: List[List[int]] = []
        for _ in range(n_agent):
            _, actions = _agent_walk(env, agent)
            proposals.append(env.actions_to_bits(actions))
        for _ in range(scfg.population - n_agent):
            sample = np.clip(np.round(rng.normal(mean, std)), b_min, b_max)
            proposals.append([int(b) for b in sample])
        if latency_target is not None:
            proposals = [
                env.enforce_latency_target(p, target=latency_target)
                for p in proposals
            ]

        # --- score the whole population in one call ----------------------
        ev = benv.evaluate_population(proposals, latency_target=latency_target)
        n_evaluated += ev.k
        elites = ev.topk(n_elite)

        # --- CEM refinement ----------------------------------------------
        elite_bits = ev.bits[elites].astype(np.float64)
        mean = scfg.cem_alpha * mean + (1 - scfg.cem_alpha) * elite_bits.mean(axis=0)
        std = scfg.cem_alpha * std + (1 - scfg.cem_alpha) * elite_bits.std(axis=0)
        std = np.maximum(std, scfg.min_std)

        # --- seed the DDPG replay buffer with the elites ------------------
        for j in elites:
            _replay_episode(env, agent, ev.bits[j], ev.reward[j])
        agent.update()

        # --- bookkeeping --------------------------------------------------
        bi = ev.best_index()
        if best is None or ev.reward[bi] > best[0]:
            best = (float(ev.reward[bi]), ev, bi)
        history.append(
            PopulationIteration(
                eval=ev,
                elite_indices=elites,
                mean_reward=float(ev.reward.mean()),
                max_reward=float(ev.reward.max()),
            )
        )
        if scfg.verbose:
            print(
                f"[hero-pop] it {it:3d} K={ev.k} "
                f"reward max={ev.reward.max():+.4f} mean={ev.reward.mean():+.4f} "
                f"psnr_best={ev.psnr[bi]:.2f} lat_best={ev.latency_cycles[bi]:.3e} "
                f"std={std.mean():.2f} ({ev.wall_seconds:.2f}s)",
                flush=True,
            )

    _, ev, bi = best

    # Optional exact pass: re-score the top distinct proxy policies through
    # the scalar env (per-policy finetune + full-view PSNR, Eq. 8 reward).
    best_exact: Optional[EpisodeResult] = None
    if scfg.exact_rescore_top > 0:
        ranked = sorted(
            ((float(h.eval.reward[j]), tuple(int(b) for b in h.eval.bits[j]))
             for h in history for j in range(h.eval.k)),
            key=lambda t: -t[0],
        )
        seen, candidates = set(), []
        for _, bits in ranked:
            if bits not in seen:
                seen.add(bits)
                candidates.append(bits)
            if len(candidates) >= scfg.exact_rescore_top:
                break
        for bits in candidates:
            r = env.evaluate_bits(list(bits))
            if best_exact is None or r.reward > best_exact.reward:
                best_exact = r
            if scfg.verbose:
                print(
                    f"[hero-pop] exact rescore: reward={r.reward:+.4f} "
                    f"psnr={r.psnr:.2f} lat={r.latency_cycles:.3e}",
                    flush=True,
                )

    return PopulationSearchResult(
        best_bits=[int(b) for b in ev.bits[bi]],
        best_reward=float(ev.reward[bi]),
        best_psnr=float(ev.psnr[bi]),
        best_latency_cycles=float(ev.latency_cycles[bi]),
        best_model_bytes=float(ev.model_bytes[bi]),
        best_fqr=float(ev.fqr[bi]),
        history=history,
        policies_evaluated=n_evaluated,
        wall_seconds=time.time() - t_start,
        best_exact=best_exact,
    )
