"""Continuous action <-> discrete bit width (paper Eq. 3).

  b_i = round(b_min - 0.5 + a_i * ((b_max + 0.5) - (b_min - 0.5)))

with b_min = 1, b_max = 8. The half-open bins give every bit width an equal
slice of [0, 1], preserving "the relative ordering of quantization
aggressiveness" the paper cites from HAQ.
"""
from __future__ import annotations

import numpy as np

B_MIN = 1
B_MAX = 8


def action_to_bits(a: float, b_min: int = B_MIN, b_max: int = B_MAX) -> int:
    """Eq. 3."""
    a = float(np.clip(a, 0.0, 1.0))
    b = round(b_min - 0.5 + a * ((b_max + 0.5) - (b_min - 0.5)))
    return int(np.clip(b, b_min, b_max))


def bits_to_action(b: int, b_min: int = B_MIN, b_max: int = B_MAX) -> float:
    """Centre of b's action bin (inverse of Eq. 3 up to rounding)."""
    return (b - (b_min - 0.5)) / ((b_max + 0.5) - (b_min - 0.5))
