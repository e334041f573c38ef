#!/usr/bin/env python3
"""How far float32 rounding alone moves the LM workload's quantized losses.

A quantized `loss_fn` is discontinuous: an activation code, or a top-2
expert choice, flips when its input crosses a boundary, so two correct
implementations that round one intermediate differently can give losses
further apart than their float32 arithmetic is. This script measures
that spread on the port's own smoke bundles (CPU, seed 0, one thread):

1. noise of `--act-noise` relative (about one float32 ulp) on the
   inputs of every activation quantizer (`lm._maybe_quant_a`), over
   `--trials` draws, for 16 policies (the 8-bit and b_min extremes and
   14 from a fixed numpy seed): the largest relative change of each
   arch's proxy losses, and the range one policy's loss takes;
2. for xlstm, noise of `--exp-noise` relative on every `exp` of the
   xLSTM cells (one ulp of a card's `expf` against a CPU's), on the same
   policies and on the full-precision loss.

    PYTHONPATH=src python scripts/torch_lm_flip_sensitivity.py
"""
from __future__ import annotations

import argparse
import types

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models import xlstm_blocks as xl
from repro_torch.workloads.lm import LMWorkload


def policies(env, k: int = 16, seed: int = 12) -> np.ndarray:
    rng = np.random.default_rng(seed)
    bits = rng.integers(env.ecfg.b_min, env.ecfg.b_max + 1, (k, env.n_units))
    bits[0], bits[1] = env.ecfg.b_max, env.ecfg.b_min
    return bits


def act_noise(arch: str, rel: float, trials: int) -> None:
    bundle = LMWorkload().build_bundle(arch, device="cpu")
    env, benv = bundle.env, bundle.benv
    bits = policies(env)
    base = benv.proxy_losses(env.params, bits).astype(np.float64)
    inner = lm._maybe_quant_a
    gen = torch.Generator().manual_seed(0)

    def noisy(x, b):
        return inner(x * (1 + rel * torch.randn(x.shape, generator=gen)), b)

    runs = []
    lm._maybe_quant_a = noisy
    try:
        for _ in range(trials):
            runs.append(benv.proxy_losses(env.params, bits)
                        .astype(np.float64))
    finally:
        lm._maybe_quant_a = inner
    runs = np.stack(runs)
    change = np.abs(runs / base - 1).max(axis=0)
    worst = int(np.argmax(change))
    print(f"{arch}: activation-quantizer input noise {rel:g} relative, "
          f"{trials} draws, 16 policies: largest relative loss change "
          f"{change.max():.3g} (policy {worst}: {float(base[worst])!r} moves "
          f"over {float(runs[:, worst].min())!r}.."
          f"{float(runs[:, worst].max())!r}); policies "
          f"unmoved: {int((change == 0).sum())}; the full-precision loss "
          f"{env.base_loss_proxy!r}")


def exp_noise(rel: float) -> None:
    bundle = LMWorkload().build_bundle("xlstm-350m", device="cpu")
    env, benv = bundle.env, bundle.benv
    bits = policies(env)
    base = benv.proxy_losses(env.params, bits).astype(np.float64)
    full = float(lm.loss_fn(env.params, env.proxy_batch, env.cfg)[0])
    gen = torch.Generator().manual_seed(0)
    noisy_torch = types.SimpleNamespace(**{
        n: getattr(torch, n) for n in dir(torch) if not n.startswith("__")})
    noisy_torch.exp = lambda x: torch.exp(x) * (
        1 + rel * torch.randn(x.shape, generator=gen))
    xl.torch = noisy_torch
    try:
        moved = benv.proxy_losses(env.params, bits).astype(np.float64)
        full_moved = float(lm.loss_fn(env.params, env.proxy_batch,
                                      env.cfg)[0])
    finally:
        xl.torch = torch
    print(f"xlstm-350m: noise {rel:g} relative on the xLSTM cells' exp: "
          f"quantized proxy losses move by up to "
          f"{np.abs(moved / base - 1).max():.3g} relative, the "
          f"full-precision loss by {abs(full_moved / full - 1):.3g}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--act-noise", type=float, default=6e-8)
    ap.add_argument("--exp-noise", type=float, default=1.2e-7)
    ap.add_argument("--trials", type=int, default=12)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    with torch.no_grad():
        for arch in ("jamba-v0.1-52b", "xlstm-350m", "qwen2-7b"):
            act_noise(arch, args.act_noise, args.trials)
        exp_noise(args.exp_noise)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
