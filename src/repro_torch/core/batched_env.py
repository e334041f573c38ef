"""Batched quantization environment: score K candidate policies per step.

The scalar `NGPQuantEnv` evaluates one policy per episode (finetune + full
PSNR + scalar simulator walk); the DDPG search therefore explores the
accuracy/latency/size space one point at a time. `BatchedQuantEnv` wraps an
existing env and evaluates a (K, n_units) batch of bit assignments:

  - latency / model size: the env's `HardwareTarget.batched` evaluator
    (for the default target, `BatchedNeuRexSimulator` — the NeuRex analytic
    model over K, same trace, same numbers as the scalar path);
  - reconstruction quality: a *PSNR proxy* — render a fixed subset of
    held-out rays under each policy's fake-quant spec with shared weights,
    one policy after another, with empty-space samples culled against the
    scalar env's occupancy grid (`repro_torch.nerf.fast_render`; the grid
    and sample budget are policy-independent, so the cull plan is built
    once). Optionally the shared weights are first QAT-finetuned under the
    batch-mean policy (`shared_finetune_steps`), a middle ground between
    no retraining (pure PTQ proxy) and the scalar env's per-policy
    finetune.

The proxy PSNR is cheaper and slightly pessimistic versus the scalar env's
finetuned PSNR: it is a *ranking* signal. `PopulationEval.psnr` and the
rewards derived from it are proxy numbers, not comparable to the scalar
env's `EpisodeResult.psnr`; set
`PopulationSearchConfig.exact_rescore_top > 0` to re-score the final
elites through the scalar env (per-policy finetune + full-view PSNR) when
exact numbers matter. Rewards are Eq. 8 against a proxy-consistent 8-bit
baseline so the PSNR difference term compares like with like.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.env import NGPQuantEnv
from repro_torch.core.reward import hero_reward
from repro_torch.distributed import population
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.nerf.fast_render import build_cull_plan, fast_render_rays
from repro_torch.nerf.ngp import NGPQuantSpec, spec_from_policy
from repro_torch.nerf.train import finetune_ngp
from repro_torch.quant.policy import QuantPolicy


@dataclasses.dataclass(frozen=True)
class BatchedEnvConfig:
    proxy_rays: int = 512  # held-out rays rendered per policy for the proxy
    shared_finetune_steps: int = 0  # 0 = pure PTQ proxy (fastest)
    seed: int = 0


@dataclasses.dataclass
class PopulationEval:
    """Vectorized evaluation of K policies: all fields are (K,) arrays
    except `bits` which is (K, n_units)."""

    bits: np.ndarray
    psnr: np.ndarray
    latency_cycles: np.ndarray
    model_bytes: np.ndarray
    reward: np.ndarray
    fqr: np.ndarray
    wall_seconds: float
    # Latency-budget feasibility (latency <= the target passed to
    # `evaluate_population`); None when no target was given.
    feasible: Optional[np.ndarray] = None

    @property
    def k(self) -> int:
        return self.bits.shape[0]

    def topk(self, k: int) -> np.ndarray:
        """Indices of the k highest-reward policies, best first."""
        order = np.argsort(-self.reward)
        return order[: min(k, order.size)]

    def best_index(self) -> int:
        return int(np.argmax(self.reward))


class BatchedQuantEnv:
    """Population-evaluation facade over an `NGPQuantEnv`.

    Shares the scalar env's trace, calibration, units, and 8-bit latency
    baseline, so scalar and batched rewards live on the same cost scale.
    """

    def __init__(
        self,
        env: NGPQuantEnv,
        bcfg: BatchedEnvConfig = BatchedEnvConfig(),
        sharded: Optional[bool] = None,
        device: DeviceLike = None,
    ):
        """Runs on the env's device, which `device` (the card unless
        "cpu") must name. `sharded=True` splits the K policies of every
        evaluation over the population devices (`repro_torch.distributed.
        population`: the visible cards, or the CPU), each device rendering
        and simulating its shard; `sharded=None` does so when the env is
        on a card and the host has several (`auto_shard`), never on the
        CPU. Split and single-device paths give identical metrics: each
        policy's arithmetic is unchanged and the cache statistics are
        integers. A target whose batched form has no `vmappable()` cannot
        be split: `sharded=True` raises there, `None` stays on one
        device."""
        self.device = resolve_device(device)
        if env.device.type != self.device.type:
            raise ValueError(f"the env runs on {env.device}, the batched "
                             f"env was asked for {self.device}")
        self.env = env
        self.bcfg = bcfg
        cfg = env.cfg

        # Population-rate evaluator from the env's hardware target.
        self.bsim = env.target.batched(
            env.trace,
            n_features=cfg.hash.n_features,
            resolutions=cfg.hash.resolutions(),
        )

        # Unit index -> (hash | weight | activation) position maps: shared
        # with the scalar env so the two paths can't drift.
        self._maps = env.unit_index_maps()

        # --- fixed proxy ray subset from the held-out views -----------------
        ds = env.dataset
        rng = np.random.RandomState(bcfg.seed)
        ro = ds.test_rays_o.reshape(-1, 3)
        rd = ds.test_rays_d.reshape(-1, 3)
        gt = ds.test_rgb.reshape(-1, 3)
        sel = rng.choice(ro.shape[0], size=min(bcfg.proxy_rays, ro.shape[0]),
                         replace=False)
        to_dev = lambda a: torch.from_numpy(
            np.ascontiguousarray(a, np.float32)).to(self.device)
        self._proxy_rays = (to_dev(ro[sel]), to_dev(rd[sel]), to_dev(gt[sel]))
        self._rcfg = dataclasses.replace(env.rcfg, stratified=False)

        # Empty-space culling for the proxy render: the proxy rays and the
        # occupancy grid are both fixed, so the compaction is precomputed
        # once (`CullPlan`, policy-independent). The field query is
        # fake-quant `ngp_apply` (reference mode): the integer fused mode
        # stays a scalar-env affair, as in the reference.
        self._proxy_plan = (
            build_cull_plan(
                env.occ, ro[sel][None], rd[sel][None], None, self._rcfg, cfg,
            )
            if env.occ is not None
            else None
        )

        # --- single-device vs device-split evaluation -----------------------
        lat_fn = getattr(self.bsim, "vmappable", lambda: None)()
        if sharded and lat_fn is None:
            raise ValueError(
                f"the {type(self.bsim).__name__} of this env's target has "
                "no vmappable() form, so its population cannot be split "
                "over devices")
        if sharded is None:
            sharded = (self.device.type == "cuda" and lat_fn is not None
                       and population.auto_shard())
        self.sharded = bool(sharded)
        if self.sharded:
            devices = population.population_devices(kind=self.device.type)
            self._mse_split = population.shard_population(
                functools.partial(_proxy_mse, cfg=cfg, rcfg=self._rcfg),
                devices, broadcast_argnums=(0, 1, 2, 3, 4))
            # The fused latency model (no host memo), so the whole
            # per-policy evaluation lives on its shard; its statistics are
            # the memoized path's integers and its composition the same
            # f32 arithmetic.
            self._lat_split = population.shard_population(lat_fn, devices)
        else:
            self._mse_split = self._lat_split = None

        # Proxy-consistent Eq. 8 baseline: 8-bit PSNR through the SAME proxy
        # (no finetune) so psnr - psnr_org compares like with like.
        eight = np.full((1, env.n_units), 8.0, np.float32)
        self.psnr_org_proxy = float(self._psnr(env.params, eight)[0])

    # ------------------------------------------------------------------
    @property
    def n_units(self) -> int:
        return self.env.n_units

    def bits_to_arrays(
        self, bits_batch: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(K, n_units) walk-order bits -> (hash (K,L), weight (K,M),
        activation (K,M)) simulator arrays. Unassigned slots default to 8."""
        bb = np.asarray(bits_batch, np.float32)
        assert bb.ndim == 2 and bb.shape[1] == self.n_units, bb.shape
        out = []
        for key in ("h", "w", "a"):
            unit_idx, pos, width = self._maps[key]
            arr = np.full((bb.shape[0], width), 8.0, np.float32)
            arr[:, pos] = bb[:, unit_idx]
            out.append(arr)
        return tuple(out)

    @property
    def n_shards(self) -> int:
        """Devices each evaluation splits over (1 when not split)."""
        return self._mse_split.n_shards if self.sharded else 1

    # ------------------------------------------------------------------
    def _mse_batch(self, params, hb: np.ndarray, wb: np.ndarray,
                   ab: np.ndarray) -> np.ndarray:
        """(K,) proxy MSE, one render per policy on the device that holds
        it; one copy back for the batch (a shard)."""
        # Everything a render reads besides the bits: the split path
        # copies each to every population device once and keeps the copy.
        shared = (params, self.env.occ, self._proxy_plan, self._proxy_rays,
                  self.env.act_ranges)
        if self._mse_split is not None:
            return self._mse_split(*shared, hb, wb, ab)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return _proxy_mse(*shared, t(hb), t(wb), t(ab), cfg=self.env.cfg,
                          rcfg=self._rcfg).cpu().numpy()

    def _psnr(self, params, bits_batch: np.ndarray) -> np.ndarray:
        hb, wb, ab = self.bits_to_arrays(bits_batch)
        mse = self._mse_batch(params, hb, wb, ab)
        mse = np.maximum(np.asarray(mse, np.float64), 1e-12)
        return -10.0 * np.log10(mse)

    def proxy_quality(self, params, bits_batch: np.ndarray) -> np.ndarray:
        """(K,) proxy quality in dB — the workload-protocol name for the
        proxy PSNR."""
        return self._psnr(params, bits_batch)

    def simulate_batch(self, bits_batch: np.ndarray) -> Dict[str, np.ndarray]:
        """Latency/size metrics only ((K,) arrays), no rendering. Goes
        through the device-split fused model when the env splits."""
        hb, wb, ab = self.bits_to_arrays(bits_batch)
        if self._lat_split is not None:
            return self._lat_split(hb, wb, ab)
        return self.bsim.simulate_batch(hb, wb, ab)

    # ------------------------------------------------------------------
    def evaluate_population(
        self,
        bits_batch: Sequence[Sequence[int]],
        latency_target: Optional[float] = None,
    ) -> PopulationEval:
        """Score K policies: batched simulator + PSNR proxy + Eq. 8.

        `latency_target` is per-call search state (the active hardware
        budget): it does not change any metric, it only fills the
        `feasible` mask so callers (frontier constraints, constrained
        selection) can reuse one env across budgets."""
        t0 = time.time()
        bb = np.asarray(bits_batch, np.int32)
        env = self.env

        params = env.params
        if self.bcfg.shared_finetune_steps > 0:
            # One QAT finetune under the batch-mean policy, shared by all K
            # proxy renders (the "shared finetune" middle ground).
            mean_bits = np.clip(
                np.round(bb.mean(axis=0)), env.ecfg.b_min, env.ecfg.b_max
            ).astype(int)
            policy = QuantPolicy.uniform(env.units, 8).with_bits(list(mean_bits))
            spec = spec_from_policy(env.cfg, policy, env.act_ranges)
            params, _ = finetune_ngp(
                dict(env.params), env.dataset, env.cfg, env.rcfg, env.tcfg,
                spec, self.bcfg.shared_finetune_steps, device=self.device,
            )

        sim = self.simulate_batch(bb)
        psnr = self._psnr(params, bb)
        if params is not self.env.params:
            # Shared finetune shifted the weights: re-anchor the Eq. 8 PSNR
            # baseline under the SAME params so rewards stay comparable
            # across iterations (otherwise a lucky batch-mean finetune
            # inflates every candidate of that iteration).
            eight = np.full((1, env.n_units), 8.0, np.float32)
            psnr_org = float(self._psnr(params, eight)[0])
        else:
            psnr_org = self.psnr_org_proxy
        latency = np.asarray(sim["total_cycles"], np.float64)
        reward = np.asarray(
            [
                hero_reward(
                    float(psnr[i]), psnr_org, float(latency[i]),
                    env.original_cost, lam=env.ecfg.lam,
                )
                for i in range(bb.shape[0])
            ]
        )
        return PopulationEval(
            bits=bb,
            psnr=psnr,
            latency_cycles=latency,
            model_bytes=np.asarray(sim["model_bytes"], np.float64),
            reward=reward,
            fqr=bb.mean(axis=1).astype(np.float64),
            wall_seconds=time.time() - t0,
            feasible=(
                latency <= latency_target if latency_target is not None else None
            ),
        )


@torch.no_grad()
def _proxy_mse(params, occ, plan, rays, act_ranges, hb: torch.Tensor,
               wb: torch.Tensor, ab: torch.Tensor, *, cfg, rcfg
               ) -> torch.Tensor:
    """(K,) proxy MSE of the (K, ·) bit tensors on their device: each
    policy's fake-quant render of the proxy `rays` (rays_o, rays_d, rgb;
    reference mode, under the cull `plan`) against their ground truth, one
    after another. Every tensor argument lives on that device."""
    ro, rd, gt = rays
    mse = []
    for k in range(hb.shape[0]):
        spec = NGPQuantSpec(hash_bits=hb[k], weight_bits=wb[k],
                            act_bits=ab[k], act_ranges=act_ranges)
        color, _ = fast_render_rays(
            params, ro, rd, cfg, rcfg, spec, occ=occ, mode="reference",
            plan=plan,
        )
        mse.append(torch.mean((color - gt) ** 2))
    return torch.stack(mse)
