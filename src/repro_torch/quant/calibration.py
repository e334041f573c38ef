"""Range calibration for quantization.

The paper determines r_v "through calibration" (Sec. III-C): min/max and
percentile calibrators, plus a streaming `Calibrator` that accumulates
ranges over batches (used to calibrate activations by running a few
forward passes).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def calibrate_minmax(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.min(x), torch.max(x)


def calibrate_percentile(x: torch.Tensor, pct: float = 99.9
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (100 - pct)th and pct-th percentiles of all of `x`, linearly
    interpolated (as `jnp.percentile`)."""
    flat = x.reshape(-1).to(torch.float32)
    return (torch.quantile(flat, (100.0 - pct) / 100.0),
            torch.quantile(flat, pct / 100.0))


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Calibrator:
    """Streaming min/max (or percentile-of-batch EMA) range tracker.

    Host-side utility: collects ranges for named tensors over calibration
    batches; `ranges()` returns {name: (v_min, v_max)} as python floats.
    """

    def __init__(self, mode: str = "minmax", pct: float = 99.9,
                 ema: float = 0.9):
        if mode not in ("minmax", "percentile"):
            raise ValueError(f"unknown calibration mode {mode!r}")
        self.mode = mode
        self.pct = pct
        self.ema = ema
        self._lo: Dict[str, float] = {}
        self._hi: Dict[str, float] = {}

    def observe(self, name: str, x) -> None:
        x = _host(x)
        if self.mode == "minmax":
            lo, hi = float(x.min()), float(x.max())
            if name in self._lo:
                self._lo[name] = min(self._lo[name], lo)
                self._hi[name] = max(self._hi[name], hi)
            else:
                self._lo[name], self._hi[name] = lo, hi
        else:
            lo = float(np.percentile(x, 100.0 - self.pct))
            hi = float(np.percentile(x, self.pct))
            if name in self._lo:
                self._lo[name] = self.ema * self._lo[name] \
                    + (1 - self.ema) * lo
                self._hi[name] = self.ema * self._hi[name] \
                    + (1 - self.ema) * hi
            else:
                self._lo[name], self._hi[name] = lo, hi

    def ranges(self) -> Dict[str, Tuple[float, float]]:
        return {k: (self._lo[k], self._hi[k]) for k in self._lo}
