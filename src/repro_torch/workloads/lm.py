"""LM quantization workload: HERO's closed loop on transformer decode.

The counterpart of `repro/workloads/lm.py`. The search space is
per-embedding-band bits (the hash-level analogue: geometric Zipf
row-bands, hot tokens first) plus per-layer (weight, activation) bits
broadcast over the layer's `N_GROUPS` quant groups:

  walk order:  [band_0 .. band_{B-1}, (w_0, a_0), .., (w_{L-1}, a_{L-1})]
  n_units   =  n_embed_bands + 2 * total_layers

Quality is a real forward pass: next-token cross entropy (plus the MoE
aux term) from `repro_torch.models.lm.loss_fn` over deterministic
`TokenPipeline` batches, fake-quantized under the policy's `LMQuantSpec`.
The proxy scores one fixed batch under each of the population's policies,
one forward after another (each policy's activation ranges are its own);
the full-fidelity eval averages `eval_batches` held-out batches. Both map
to a dB-like scale, `-10*log10(excess loss)` against the full-precision
loss on the same tokens, so Eq. 8 rewards and the frontier's quality
axis read like the NeRF PSNR deltas.

Cost comes from the registered `roofline-lm` `HardwareTarget`
(`repro_torch.hero.targets.LMRooflineTarget`): weight-bound decode,
seconds/token = streamed bytes over HBM bandwidth, batched over the
population on the env's device, so `distributed.population` splits and
the elastic orchestrator drive this workload unchanged.

Everything lives on one torch device, the env's (the card unless
`device="cpu"`). The reference draws its weights from
`jax.random.PRNGKey(seed)`, which a torch generator cannot reproduce:
`LMQuantEnv` draws them from a `torch.Generator` seeded with `seed`, or
takes them as `params=` (tests pass the reference's, converted). The
token batches are the reference's bit for bit (`TokenPipeline` is a
numpy hash).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.action import action_to_bits
from repro_torch.core.batched_env import PopulationEval
from repro_torch.core.env import EpisodeResult
from repro_torch.core.reward import hero_reward
from repro_torch.data import TokenPipeline, TokenPipelineConfig
from repro_torch.distributed import population
from repro_torch.hero.targets import resolve_target
from repro_torch.kernels.backend import DeviceLike, check_device, resolve_device
from repro_torch.models import lm
from repro_torch.workloads.base import PolicyShape, WorkloadBundle

# Excess-loss floor of the dB mapping: quality saturates at
# -10*log10(2*LOSS_FLOOR) ~ 37 dB when the quantized loss meets the
# full-precision loss (or, as on the smoke configs' random weights, falls
# below it).
LOSS_FLOOR = 1e-4


def quality_db(loss, base_loss):
    """Excess next-token loss -> dB-like quality (vectorized)."""
    excess = np.maximum(np.asarray(loss, np.float64) - base_loss, LOSS_FLOOR)
    return -10.0 * np.log10(excess + LOSS_FLOOR)


# Two runs of the same quantized losses (card and CPU, port and reference)
# agree to FLIP_NEAR relative except where an activation code or a top-2
# expert choice flips: its input crosses a boundary in one run's float32
# rounding and not in the other's. The largest such gaps read on jamba's
# smoke config: 2.5e-4 (port against reference, CPU) and 3.3e-4 (an H100
# against the CPU).
FLIP_NEAR, FLIP_FAR = 1e-5, 1e-3


def losses_agree(got, want, near: float = FLIP_NEAR, far: float = FLIP_FAR):
    """(ok, relative gaps) of two runs' losses: ok when at least three in
    four are within `near` and every one within `far`."""
    d = np.abs(np.asarray(got, np.float64) / np.asarray(want, np.float64)
               - 1)
    return bool(d.max() <= far and (d <= near).sum() >= -(-3 * d.size // 4)), d


@dataclasses.dataclass(frozen=True)
class LMEnvConfig:
    """Env-building knobs of the LM workload (the `SceneScale` analogue;
    rides in the checkpoint fingerprint via `LMWorkload.describe`)."""

    seq_len: int = 64
    global_batch: int = 4
    eval_batches: int = 2  # full-fidelity eval averages this many batches
    latency_target: Optional[float] = None  # seconds/token; None = free
    b_min: int = 2
    b_max: int = 8
    lam: float = 0.1  # Eq. 8 reward scale


def _unit_labels(n_bands: int, n_layers: int) -> Tuple[str, ...]:
    return tuple([f"embed_band{i}" for i in range(n_bands)]
                 + [f"layer{l}:{k}" for l in range(n_layers)
                    for k in ("w", "a")])


@torch.no_grad()
def _loss(params: Dict, batch: Dict, cfg, spec=None) -> torch.Tensor:
    return lm.loss_fn(params, batch, cfg, spec=spec)[0]


class LMQuantEnv:
    """Scalar LM quantization env: the `NGPQuantEnv` surface
    (`hero_population_search`'s duck-typed contract) over real LM forward
    passes and the roofline decode cost model."""

    def __init__(
        self,
        arch: str,
        ecfg: LMEnvConfig = LMEnvConfig(),
        seed: int = 0,
        target=None,
        device: DeviceLike = None,
        params: Optional[Dict] = None,
    ):
        """The env lives on `device` (the card unless "cpu"); `target` is
        a registered target name or an instance on that device (None:
        "roofline-lm"); `params` are the smoke config's weights on that
        device (None: drawn from a generator seeded with `seed`)."""
        self.device = resolve_device(device)
        self.arch = arch
        self.scene_name = arch
        self.cfg = get_arch(arch).smoke
        self.ecfg = ecfg
        self.seed = seed
        if target is None or isinstance(target, str):
            target = resolve_target(target or "roofline-lm",
                                    device=self.device)
        if target.device.type != self.device.type:
            raise ValueError(f"the hardware target runs on {target.device}, "
                             f"the env on {self.device}")
        self.target = target
        try:
            self.workload = self.target.build_workload(self.cfg)
        except TypeError:
            raise ValueError(
                f"hardware target {self.target.name!r} cannot score LM "
                "workloads (its build_workload wants a renderer trace); "
                "use 'roofline-lm' or another LM-family target"
            ) from None

        self.n_layers = lm.total_layers(self.cfg)
        self.n_bands = self.cfg.n_embed_bands
        self.unit_labels: Tuple[str, ...] = _unit_labels(self.n_bands,
                                                         self.n_layers)

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = lm.init_params(self.cfg, gen, device=self.device)
        else:
            check_device(params["embed"], self.device, "the parameters")
        self.params = params
        pipe = TokenPipeline(TokenPipelineConfig(
            vocab_size=self.cfg.vocab_size, seq_len=ecfg.seq_len,
            global_batch=ecfg.global_batch, seed=seed,
        ))
        tokens = lambda: {"tokens": torch.from_numpy(pipe.batch()).long()
                          .to(self.device)}
        # Batch 0 is the proxy's fixed scoring batch; the next
        # `eval_batches` are the held-out full-fidelity set.
        self.proxy_batch = tokens()
        self._eval_batches = [tokens() for _ in range(ecfg.eval_batches)]

        self.base_loss_proxy = float(_loss(self.params, self.proxy_batch,
                                           self.cfg))
        self.base_loss_full = float(np.mean([
            float(_loss(self.params, b, self.cfg))
            for b in self._eval_batches
        ]))

        # 8-bit anchors through the target (Eq. 8 cost denominator) and
        # the full eval (Eq. 8 quality reference for evaluate_bits).
        base = self.target.baseline(self.workload, 8)
        self.original_cost = float(base["total_cycles"])
        self.psnr_org = float(quality_db(
            self._full_loss(np.full(self.n_units, 8)), self.base_loss_full
        ))

        # Exact seconds/bit per unit: the roofline is linear in the bits
        # (weight stream only; activation units are cost-free), so greedy
        # budget enforcement predicts its own outcome exactly.
        d = self.workload.d_model
        w_slope = float(np.sum(self.workload.group_elems)) / 8.0
        slopes = np.zeros(self.n_units, np.float64)
        slopes[: self.n_bands] = (
            np.asarray(self.workload.band_rows, np.float64) * d / 8.0
        )
        slopes[self.n_bands :: 2] = w_slope
        self._latency_slopes = slopes / self.target.hw.hbm_bw

    # ------------------------------------------------------------------
    # Policy layout
    # ------------------------------------------------------------------
    @property
    def n_units(self) -> int:
        return self.n_bands + 2 * self.n_layers

    def bits_to_arrays(
        self, bits_batch: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(K, n_units) walk-order bits -> (embed (K,B), weight (K,L,G),
        activation (K,L,G)) spec arrays; per-layer bits broadcast over the
        layer's quant groups."""
        bb = np.asarray(bits_batch, np.float32)
        assert bb.ndim == 2 and bb.shape[1] == self.n_units, bb.shape
        G = lm.N_GROUPS
        eb = bb[:, : self.n_bands]
        rest = bb[:, self.n_bands :].reshape(bb.shape[0], self.n_layers, 2)
        wb = np.repeat(rest[:, :, 0:1], G, axis=2)
        ab = np.repeat(rest[:, :, 1:2], G, axis=2)
        return eb, wb, ab

    def _spec(self, bits: Sequence[int]):
        eb, wb, ab = self.bits_to_arrays(np.asarray(bits)[None, :])
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return lm.LMQuantSpec(embed_bits=t(eb[0]), w_bits=t(wb[0]),
                              a_bits=t(ab[0]))

    # ------------------------------------------------------------------
    # Observations (7-dim, DDPGConfig.obs_dim)
    # ------------------------------------------------------------------
    def observation(self, unit_index: int, prev_action: float) -> np.ndarray:
        i = unit_index
        if i < self.n_bands:
            kind, depth = 0, i / max(self.n_bands, 1)
        else:
            j = i - self.n_bands
            kind = 1 if j % 2 == 0 else 2
            depth = (j // 2) / max(self.n_layers, 1)
        return np.asarray([
            1.0, i / self.n_units, float(prev_action),
            float(kind == 0), float(kind == 1), float(kind == 2),
            depth,
        ], np.float32)

    def actions_to_bits(self, actions: Sequence[float]) -> List[int]:
        return [
            action_to_bits(a, self.ecfg.b_min, self.ecfg.b_max)
            for a in actions
        ]

    # ------------------------------------------------------------------
    # Cost + constraint enforcement
    # ------------------------------------------------------------------
    def cost_seconds(self, bits: Sequence[int]) -> float:
        """Seconds/token of one policy through the target (scalar path)."""
        eb, wb, ab = self.bits_to_arrays(np.asarray(bits)[None, :])
        r = self.target.simulate(self.workload, eb[0], wb[0], ab[0])
        return float(r["total_cycles"])

    _UNSET = object()

    def enforce_latency_target(
        self, bits: List[int], target=_UNSET
    ) -> List[int]:
        """Greedy bit reduction until the budget is met: biggest
        seconds/bit first (same shape as the NGP env's enforcement; here
        the slopes are exact, so one predicted sweep is one real sweep)."""
        if target is LMQuantEnv._UNSET:
            target = self.ecfg.latency_target
        if target is None:
            return list(bits)
        bits = list(bits)
        lat = self.cost_seconds(bits)
        guard = 0
        while lat > target and guard < 8 * len(bits):
            order = np.argsort(-self._latency_slopes)
            changed = False
            predicted = lat
            for i in order:
                if predicted <= target:
                    break
                if bits[i] > self.ecfg.b_min and self._latency_slopes[i] > 0:
                    bits[i] -= 1
                    predicted -= self._latency_slopes[i]
                    changed = True
            if not changed:
                break
            lat = self.cost_seconds(bits)
            guard += 1
        return bits

    # ------------------------------------------------------------------
    # Full-fidelity evaluation
    # ------------------------------------------------------------------
    def _full_loss(self, bits: Sequence[int]) -> float:
        spec = self._spec(bits)
        return float(np.mean([
            float(_loss(self.params, b, self.cfg, spec))
            for b in self._eval_batches
        ]))

    def evaluate_bits(
        self, bits: Sequence[int], finetune_steps: Optional[int] = None
    ) -> EpisodeResult:
        """Exact quality over the held-out eval batches (`finetune_steps`
        is accepted for interface parity and ignored — there is no QAT
        pass in this workload)."""
        t0 = time.time()
        bits = list(bits)
        loss = self._full_loss(bits)
        psnr = float(quality_db(loss, self.base_loss_full))
        eb, wb, ab = self.bits_to_arrays(np.asarray(bits)[None, :])
        sim = self.target.simulate(self.workload, eb[0], wb[0], ab[0])
        lat = float(sim["total_cycles"])
        reward = hero_reward(psnr, float(self.psnr_org), lat,
                             self.original_cost, lam=self.ecfg.lam)
        return EpisodeResult(
            policy=None,
            bits=bits,
            psnr=psnr,
            latency_cycles=lat,
            model_bytes=float(sim["model_bytes"]),
            reward=reward,
            fqr=float(np.mean(bits)),
            wall_seconds=time.time() - t0,
        )


@torch.no_grad()
def _proxy_losses(params: Dict, batch: Dict, eb: torch.Tensor,
                  wb: torch.Tensor, ab: torch.Tensor, *, cfg
                  ) -> torch.Tensor:
    """(K,) proxy losses of the (K, ·) bit tensors on their device: the
    fixed batch's `loss_fn` under each policy's spec, one forward after
    another. Every tensor argument lives on that device."""
    return torch.stack([
        lm.loss_fn(params, batch, cfg, spec=lm.LMQuantSpec(
            embed_bits=eb[k], w_bits=wb[k], a_bits=ab[k]))[0]
        for k in range(eb.shape[0])
    ])


class LMBatchedEnv:
    """Population-evaluation facade over an `LMQuantEnv` — the
    `BatchedQuantEnv` surface: the K policies' proxy losses and the
    target's batched cost model, on the env's device or split over the
    population devices."""

    def __init__(self, env: LMQuantEnv, sharded: Optional[bool] = None):
        """`sharded=True` splits the K policies of every evaluation over
        the population devices (the visible cards, or the CPU);
        `sharded=None` does so when the env is on a card and the host has
        several, never on the CPU. Both paths give the same numbers."""
        self.env = env
        self.device = env.device
        self.bsim = env.target.batched(env.workload)
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
        self._loss_fn = functools.partial(_proxy_losses, cfg=env.cfg)
        if self.sharded:
            devices = population.population_devices(kind=self.device.type)
            self._loss_split = population.shard_population(
                self._loss_fn, devices, broadcast_argnums=(0, 1))
            self._lat_split = population.shard_population(lat_fn, devices)
        else:
            self._loss_split = self._lat_split = None

        eight = np.full((1, env.n_units), 8.0, np.float32)
        self.psnr_org_proxy = float(self.proxy_quality(env.params, eight)[0])

    # ------------------------------------------------------------------
    @property
    def n_units(self) -> int:
        return self.env.n_units

    @property
    def n_shards(self) -> int:
        """Devices each evaluation splits over (1 when not split)."""
        return self._loss_split.n_shards if self.sharded else 1

    def bits_to_arrays(self, bits_batch):
        return self.env.bits_to_arrays(bits_batch)

    def proxy_losses(self, params, bits_batch: np.ndarray) -> np.ndarray:
        """(K,) f32 proxy losses, one copy back for the batch (a shard)."""
        eb, wb, ab = self.bits_to_arrays(bits_batch)
        if self._loss_split is not None:
            return self._loss_split(params, self.env.proxy_batch, eb, wb, ab)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return self._loss_fn(params, self.env.proxy_batch, t(eb), t(wb),
                             t(ab)).cpu().numpy()

    def proxy_quality(self, params, bits_batch: np.ndarray) -> np.ndarray:
        """(K,) dB-like quality of the proxy batch under each policy."""
        return quality_db(self.proxy_losses(params, bits_batch),
                          self.env.base_loss_proxy)

    def simulate_batch(self, bits_batch: np.ndarray) -> Dict[str, np.ndarray]:
        """Cost metrics only ((K,) arrays), no forward passes."""
        eb, wb, ab = self.bits_to_arrays(bits_batch)
        if self._lat_split is not None:
            return self._lat_split(eb, wb, ab)
        return self.bsim.simulate_batch(eb, wb, ab)

    # ------------------------------------------------------------------
    def evaluate_population(
        self,
        bits_batch: Sequence[Sequence[int]],
        latency_target: Optional[float] = None,
    ) -> PopulationEval:
        t0 = time.time()
        bb = np.asarray(bits_batch, np.int32)
        env = self.env
        sim = self.simulate_batch(bb)
        psnr = self.proxy_quality(env.params, bb)
        latency = np.asarray(sim["total_cycles"], np.float64)
        reward = np.asarray([
            hero_reward(
                float(psnr[i]), self.psnr_org_proxy, float(latency[i]),
                env.original_cost, lam=env.ecfg.lam,
            )
            for i in range(bb.shape[0])
        ])
        return PopulationEval(
            bits=bb,
            psnr=psnr,
            latency_cycles=latency,
            model_bytes=np.asarray(sim["model_bytes"], np.float64),
            reward=reward,
            fqr=bb.mean(axis=1).astype(np.float64),
            wall_seconds=time.time() - t0,
            feasible=(
                latency <= latency_target
                if latency_target is not None else None
            ),
        )


def lm_bundle(env: LMQuantEnv, benv: LMBatchedEnv) -> WorkloadBundle:
    """Wrap an arch's env and batched env with their 8-bit anchors."""
    eight = benv.simulate_batch(np.full((1, env.n_units), 8, np.int32))
    return WorkloadBundle(
        scene=env.arch,
        env=env,
        benv=benv,
        baseline_latency=float(env.original_cost),
        baseline_psnr=float(benv.psnr_org_proxy),
        baseline_bytes=float(eight["model_bytes"][0]),
    )


class LMWorkload:
    kind = "lm"
    default_hardware = "roofline-lm"

    def __init__(self, ecfg: Optional[LMEnvConfig] = None):
        self.ecfg = ecfg if ecfg is not None else LMEnvConfig()

    def _resolve_ecfg(self, scale) -> LMEnvConfig:
        # `scale` arrives as whatever ClosedLoopConfig.scale holds; a
        # SceneScale (the NeRF-shaped default) means "use the workload's
        # own knobs", an LMEnvConfig overrides them.
        return scale if isinstance(scale, LMEnvConfig) else self.ecfg

    def policy_shape(self, case: str, scale=None) -> PolicyShape:
        cfg = get_arch(case).smoke
        n_layers = lm.total_layers(cfg)
        ecfg = self._resolve_ecfg(scale)
        return PolicyShape(
            n_units=cfg.n_embed_bands + 2 * n_layers,
            b_min=ecfg.b_min, b_max=ecfg.b_max,
            labels=_unit_labels(cfg.n_embed_bands, n_layers),
        )

    def build_bundle(
        self,
        case: str,
        *,
        scale=None,
        seed: int = 0,
        sharded: Optional[bool] = None,
        hardware=None,
        device: DeviceLike = None,
    ) -> WorkloadBundle:
        env = LMQuantEnv(
            case, self._resolve_ecfg(scale), seed=seed,
            target=hardware if hardware is not None else self.default_hardware,
            device=device,
        )
        return lm_bundle(env, LMBatchedEnv(env, sharded=sharded))

    def describe(self) -> dict:
        return {"kind": self.kind, "config": dataclasses.asdict(self.ecfg)}
