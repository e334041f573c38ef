"""Baselines reproduced from the paper's evaluation (Sec. IV-A):

- NGP-PTQ: uniform bits applied to the pretrained model, no retraining.
- NGP-QAT: uniform bits + quantization-aware finetuning.
  (Following the paper: 6-bit at MDL, 5-bit at MGL; PTQ and QAT share bit
   widths, hence identical latency — exactly as Table II notes.)
- NGP-CAQ (proxy): content-aware learned bit allocation that optimizes
  reconstruction quality WITHOUT hardware feedback. Our proxy reproduces the
  behaviours the HERO paper attributes to CAQ [7]:
    * scene-dependent per-layer bit widths from quantization sensitivity;
    * PSNR-first objective (no latency term);
    * uniform bits across all hash-table levels;
    * MDL (high fidelity) and MGL(target_loss) (resource constrained)
      operating points;
    * the W/A imbalance (one of weights/activations kept high) emerges from
      sensitivity-greedy allocation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.env import NGPQuantEnv
from repro_torch.nerf.ngp import spec_from_policy
from repro_torch.quant.policy import QuantPolicy, UnitKind


@dataclasses.dataclass
class BaselineResult:
    name: str
    bits: List[int]
    psnr: float
    latency_cycles: float
    model_bytes: float
    fqr: float
    cost_efficiency: float  # Eq. 12: PSNR / latency

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _result(env: NGPQuantEnv, name: str, bits: List[int], psnr: float) -> BaselineResult:
    policy = QuantPolicy.uniform(env.units, 8).with_bits(bits)
    lat = env.simulate_policy(policy)
    return BaselineResult(
        name=name,
        bits=list(bits),
        psnr=psnr,
        latency_cycles=lat.total_cycles,
        model_bytes=lat.model_bytes,
        fqr=policy.fqr(),
        cost_efficiency=psnr / lat.total_cycles,
    )


# ---------------------------------------------------------------------------
def ptq_baseline(env: NGPQuantEnv, bits: int) -> BaselineResult:
    """Uniform post-training quantization: no finetune (Sec. IV-A)."""
    uniform = [bits] * env.n_units
    policy = QuantPolicy.uniform(env.units, bits)
    spec = spec_from_policy(env.cfg, policy, env.act_ranges)
    psnr = env.eval_psnr(env.params, spec)
    return _result(env, f"NGP-PTQ({bits}b)", uniform, psnr)


def qat_baseline(
    env: NGPQuantEnv, bits: int, finetune_steps: Optional[int] = None
) -> BaselineResult:
    """Uniform quantization-aware training: same bits as PTQ + finetune."""
    uniform = [bits] * env.n_units
    res = env.evaluate_bits(uniform, finetune_steps)
    return BaselineResult(
        name=f"NGP-QAT({bits}b)",
        bits=uniform,
        psnr=res.psnr,
        latency_cycles=res.latency_cycles,
        model_bytes=res.model_bytes,
        fqr=res.fqr,
        cost_efficiency=res.psnr / res.latency_cycles,
    )


# ---------------------------------------------------------------------------
def _unit_sensitivities(env: NGPQuantEnv, probe_bits: int = 4) -> np.ndarray:
    """PSNR drop when quantizing each unit alone to probe_bits (no finetune).

    This is the "content-aware" signal: it depends on the trained scene.
    """
    base = env.eval_psnr(env.params, None)
    sens = np.zeros(env.n_units)
    full = [32] * env.n_units  # 32 = full-precision sentinel (>=16)
    for i in range(env.n_units):
        bits = list(full)
        bits[i] = probe_bits
        policy = QuantPolicy.uniform(env.units, 8).with_bits(bits)
        spec = spec_from_policy(env.cfg, policy, env.act_ranges)
        p = env.eval_psnr(env.params, spec)
        sens[i] = max(base - p, 0.0)
    return sens


def caq_proxy_baseline(
    env: NGPQuantEnv,
    mode: str = "MDL",
    target_loss: float = 10 ** (-3.2),
    finetune_steps: Optional[int] = None,
    probe_bits: int = 4,
) -> BaselineResult:
    """Content-aware (no-hardware-feedback) bit allocation.

    MDL: high fidelity — allocate generous bits where sensitive; budget
         FQR ~ uniform-7-bit equivalent.
    MGL: resource constrained — tighter budget (FQR ~ uniform-5.5),
         scaled by target_loss (smaller target -> more conservative).

    Allocation: uniform hash bits (CAQ behaviour), per-unit MLP bits via
    sensitivity ranking: most sensitive units get b_hi, least get b_lo.
    """
    sens = _unit_sensitivities(env, probe_bits)

    if mode == "MDL":
        b_hash, b_hi, b_lo = 8, 8, 6
    elif mode == "MGL":
        # More aggressive as target_loss grows. target 1e-3.2 ~ CAQ paper.
        aggress = np.clip(np.log10(max(target_loss, 1e-6)) + 4.2, 0.0, 2.0)
        b_hash = 7 if aggress < 1.5 else 6
        b_hi, b_lo = 8, max(3, int(6 - aggress))
    else:
        raise ValueError(mode)

    bits = [0] * env.n_units
    mlp_idx = [
        i for i, u in enumerate(env.units) if u.kind != UnitKind.HASH_LEVEL
    ]
    order = sorted(mlp_idx, key=lambda i: -sens[i])
    # Top-half sensitive units keep b_hi; bottom half get b_lo — this is the
    # W/A imbalance the HERO paper criticizes (Sec. IV-C).
    for rank, i in enumerate(order):
        bits[i] = b_hi if rank < len(order) // 2 else b_lo
    for i, u in enumerate(env.units):
        if u.kind == UnitKind.HASH_LEVEL:
            bits[i] = b_hash

    res = env.evaluate_bits(bits, finetune_steps)
    return BaselineResult(
        name=f"NGP-CAQ({mode})",
        bits=bits,
        psnr=res.psnr,
        latency_cycles=res.latency_cycles,
        model_bytes=res.model_bytes,
        fqr=res.fqr,
        cost_efficiency=res.psnr / res.latency_cycles,
    )
