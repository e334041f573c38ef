"""HERO reward (paper Eqs. 8-9, Sec. III-D).

  R = lambda * (PSNR_cur - PSNR_org + 1 / cost_ratio)
  cost_ratio = current_cost / original_cost

original_cost / PSNR_org = the all-8-bit baseline (Sec. III-D: "the baseline
hardware latency and reconstruction quality obtained with all layers
configured to maximum 8-bit precision"). lambda = 0.1.
"""
from __future__ import annotations

LAMBDA = 0.1


def cost_ratio(current_cost: float, original_cost: float) -> float:
    """Eq. 9."""
    return current_cost / max(original_cost, 1e-12)


def hero_reward(
    psnr_cur: float,
    psnr_org: float,
    current_cost: float,
    original_cost: float,
    lam: float = LAMBDA,
) -> float:
    """Eq. 8."""
    cr = cost_ratio(current_cost, original_cost)
    return lam * (psnr_cur - psnr_org + 1.0 / max(cr, 1e-12))
