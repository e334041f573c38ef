"""DDPG agent (paper Sec. III-E) in PyTorch.

Actor: obs(7) -> tanh MLP -> sigmoid -> action in [0,1].
Critic: (obs, action) -> Q.
Off-policy with a replay buffer, soft target updates, and the paper's
variance-reduced target (Eq. 10):

    Q_hat_i = R + gamma * Q'(S_{i+1}, mu'(S_{i+1})) - eps

where eps is an exponential moving average of previous episode rewards
("to mitigate variance in gradient estimation") and the critic loss is the
mean squared Bellman error over the K_a decisions of an episode (Eq. 11).

Exploration: truncated-normal noise around the actor output with a decaying
sigma (HAQ-style), matching the paper's HAQ lineage ([13]).

The networks are dicts of tensors (`w{i}` (d_in, d_out), `b{i}`) on the
agent's device, trained by `torch.autograd` and the port's AdamW. The
replay buffer and the exploration noise draw from
`np.random.RandomState(seed)`, so warm-up walks are the same numbers
wherever the agent runs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import AdamWState
from repro_torch.tree_util import tree_map


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    obs_dim: int = 7
    hidden: int = 64
    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    gamma: float = 0.99
    tau: float = 0.01  # soft target update rate
    batch_size: int = 64
    buffer_size: int = 4096
    noise_sigma0: float = 0.5
    noise_decay: float = 0.99  # per episode
    reward_ema: float = 0.95  # eps in Eq. 10
    warmup_episodes: int = 4  # pure-random episodes before the actor drives
    updates_per_episode: int = 32
    seed: int = 0


def _mlp_init(gen: torch.Generator, sizes, device: torch.device):
    """He-normal weights drawn on the CPU from `gen` (so a seed gives the
    same network on any device), zero biases."""
    params = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = torch.randn((a, b), generator=gen) * float(np.sqrt(2.0 / a))
        params[f"w{i}"] = w.to(device)
        params[f"b{i}"] = torch.zeros((b,), device=device)
    return params


def _mlp_apply(params, x, n_layers, final_act=None):
    for i in range(n_layers):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            x = torch.tanh(x)
    if final_act is not None:
        x = final_act(x)
    return x


def actor_apply(params, obs):
    return _mlp_apply(params, obs, 3, torch.sigmoid)  # (..., 1) in [0,1]


def critic_apply(params, obs, act):
    x = torch.cat([obs, act], dim=-1)
    return _mlp_apply(params, x, 3)  # (..., 1)


class ReplayBuffer:
    """Circular transition store (host-side numpy)."""

    def __init__(self, capacity: int, obs_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.act = np.zeros((capacity, 1), np.float32)
        self.rew = np.zeros((capacity, 1), np.float32)
        self.nobs = np.zeros((capacity, obs_dim), np.float32)
        self.done = np.zeros((capacity, 1), np.float32)
        self.size = 0
        self.ptr = 0

    def push(self, obs, act, rew, nobs, done):
        i = self.ptr
        self.obs[i] = obs
        self.act[i] = act
        self.rew[i] = rew
        self.nobs[i] = nobs
        self.done[i] = float(done)
        self.ptr = (i + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def sample(self, rng: np.random.RandomState, batch: int):
        idx = rng.randint(0, self.size, size=batch)
        return (
            self.obs[idx],
            self.act[idx],
            self.rew[idx],
            self.nobs[idx],
            self.done[idx],
        )


class _TrainState(NamedTuple):
    actor: Dict
    critic: Dict
    target_actor: Dict
    target_critic: Dict
    actor_opt: AdamWState
    critic_opt: AdamWState


def _value_and_grad(loss_fn, params: Dict):
    """(loss, grads) of `loss_fn(params)` by autograd; params are leaves."""
    live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(live)
    grads = torch.autograd.grad(loss, list(live.values()))
    return loss.detach(), dict(zip(live, grads))


def _update_step(state: _TrainState, batch, reward_baseline: float,
                 cfg: DDPGConfig):
    """One critic and one actor step on a batch of (obs, act, rew, nobs,
    done) tensors, then the soft target updates. Returns (new state,
    critic loss, actor loss), the losses as device scalars."""
    obs, act, rew, nobs, done = batch

    # Critic: MSBE against the Eq. 10 target.
    with torch.no_grad():
        next_a = actor_apply(state.target_actor, nobs)
        next_q = critic_apply(state.target_critic, nobs, next_a)
        target = (rew - reward_baseline) + cfg.gamma * (1.0 - done) * next_q

    def critic_loss(cp):
        q = critic_apply(cp, obs, act)
        return torch.mean((q - target) ** 2)

    closs, cgrad = _value_and_grad(critic_loss, state.critic)
    critic, critic_opt = adamw_update(
        cgrad, state.critic_opt, state.critic, AdamWConfig(lr=cfg.critic_lr)
    )

    # Actor: deterministic policy gradient (maximize Q) through the
    # updated critic, which the actor's step leaves as it is.
    def actor_loss(ap):
        a = actor_apply(ap, obs)
        return -torch.mean(critic_apply(critic, obs, a))

    aloss, agrad = _value_and_grad(actor_loss, state.actor)
    actor, actor_opt = adamw_update(
        agrad, state.actor_opt, state.actor, AdamWConfig(lr=cfg.actor_lr)
    )

    # Soft target updates.
    tau = cfg.tau
    target_actor = tree_map(lambda t, s: (1 - tau) * t + tau * s,
                            state.target_actor, actor)
    target_critic = tree_map(lambda t, s: (1 - tau) * t + tau * s,
                             state.target_critic, critic)
    new_state = _TrainState(
        actor, critic, target_actor, target_critic, actor_opt, critic_opt
    )
    return new_state, closs, aloss


class DDPGAgent:
    """The agent on `device` (the card unless `device="cpu"`)."""

    def __init__(self, cfg: DDPGConfig = DDPGConfig(),
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(cfg.seed)
        actor = _mlp_init(gen, [cfg.obs_dim, cfg.hidden, cfg.hidden, 1],
                          self.device)
        critic = _mlp_init(gen, [cfg.obs_dim + 1, cfg.hidden, cfg.hidden, 1],
                           self.device)
        self.state = _TrainState(
            actor=actor,
            critic=critic,
            target_actor=tree_map(torch.clone, actor),
            target_critic=tree_map(torch.clone, critic),
            actor_opt=adamw_init(actor),
            critic_opt=adamw_init(critic),
        )
        self.buffer = ReplayBuffer(cfg.buffer_size, cfg.obs_dim)
        self.rng = np.random.RandomState(cfg.seed)
        self.noise_sigma = cfg.noise_sigma0
        self.reward_baseline = 0.0  # eps in Eq. 10 (EMA of episode rewards)
        self._episodes_seen = 0

    # ------------------------------------------------------------------
    @torch.no_grad()
    def act(self, obs: np.ndarray, explore: bool = True) -> float:
        """Single action in [0,1] with optional truncated-normal noise. The
        actor's output reaches the host as one scalar (a device sync on the
        card)."""
        if explore and self._episodes_seen < self.cfg.warmup_episodes:
            return float(self.rng.uniform(0.0, 1.0))
        x = torch.from_numpy(np.asarray(obs, np.float32)).to(self.device)
        a = float(actor_apply(self.state.actor, x)[0])
        if explore:
            # Truncated normal around a, clipped into [0,1].
            noise = self.rng.normal(0.0, self.noise_sigma)
            a = float(np.clip(a + noise, 0.0, 1.0))
        return a

    # ------------------------------------------------------------------
    def observe_episode(self, transitions, episode_reward: float):
        """Store an episode's transitions; every transition carries the final
        episode reward (the paper's sparse episodic reward, HAQ-style)."""
        for obs, act, nobs, done in transitions:
            self.buffer.push(obs, act, episode_reward, nobs, done)
        # Eq. 10 baseline: EMA over observed episode rewards.
        ema = self.cfg.reward_ema
        if self._episodes_seen == 0:
            self.reward_baseline = episode_reward
        else:
            self.reward_baseline = ema * self.reward_baseline + (1 - ema) * episode_reward
        self._episodes_seen += 1
        self.noise_sigma = self.cfg.noise_sigma0 * (
            self.cfg.noise_decay**self._episodes_seen
        )

    # ------------------------------------------------------------------
    def update(self) -> Tuple[float, float]:
        """Run cfg.updates_per_episode gradient steps. Returns mean losses."""
        if self.buffer.size < self.cfg.batch_size:
            return 0.0, 0.0
        closs_sum, aloss_sum = 0.0, 0.0
        for _ in range(self.cfg.updates_per_episode):
            batch = self.buffer.sample(self.rng, self.cfg.batch_size)
            batch = tuple(torch.from_numpy(b).to(self.device) for b in batch)
            self.state, closs, aloss = _update_step(
                self.state, batch, float(np.float32(self.reward_baseline)),
                self.cfg,
            )
            closs_sum += float(closs)
            aloss_sum += float(aloss)
        n = self.cfg.updates_per_episode
        return closs_sum / n, aloss_sum / n
