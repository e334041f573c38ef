#!/usr/bin/env python3
"""How far float32 rounding alone moves a train step's loss and grad norm.

A gradient can be discontinuous where the loss is not: a top-2 expert
choice (the MoE archs) or the sLSTM's max stabilizer (xlstm) routes the
gradient through one branch or the other, so two correct implementations
that round one intermediate differently can give grad norms further
apart than their float32 arithmetic is. This script scales each smoke
config's weights by (1 + `--rel` * N(0, 1)), about one float32 ulp, over
`--trials` draws, runs one `make_train_step` step (4 microbatches of 2 x
32 tokens, f32 moments) on the CPU, and prints the largest relative
change of the loss and of the grad norm against the unperturbed step,
and of the first moments (0.1 times the clipped gradient) leaf by leaf:
the largest change over the leaf's largest entry, and which leaf.

    PYTHONPATH=src python scripts/torch_train_grad_sensitivity.py
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree_util import leaves_with_path, tree_map


def batch(cfg, rng, accum: int = 4, mb: int = 2, seq: int = 32):
    """(accum, mb, ...) tokens, and llava's patches or whisper's frames."""
    b = {"tokens": rng.integers(0, cfg.vocab_size, (accum, mb, seq))}
    if cfg.embed_frontend == "prefix_patches":
        b["patches"] = rng.normal(
            size=(accum, mb, cfg.n_prefix_patches, cfg.d_model)) * 0.02
    if cfg.embed_frontend == "stub_frames":
        b["frames"] = rng.normal(
            size=(accum, mb, cfg.max_source_len - 4, cfg.d_model)) * 0.02
    return {k: torch.from_numpy(v.astype(np.float32 if k != "tokens"
                                         else np.int64))
            for k, v in b.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rel", type=float, default=1e-7)
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--arch", action="append", help="default: all ten")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    for arch in args.arch or ARCH_IDS:
        cfg = get_arch(arch).smoke
        b = batch(cfg, np.random.default_rng(31))
        p0 = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
        step = make_train_step(cfg, AdamWConfig(lr=3e-4, weight_decay=0.1),
                               moment_dtype="float32")
        gen = torch.Generator().manual_seed(1)
        out, mus = [], []
        for i in range(args.trials + 1):
            p = p0 if i == 0 else tree_map(
                lambda t: t * (1 + args.rel * torch.randn(t.shape,
                                                          generator=gen)),
                p0)
            _, opt, m = step(p, adamw_init(p, "float32"), b)
            out.append((float(m["loss"]), float(m["grad_norm"])))
            mus.append(dict(leaves_with_path(opt.mu)))
        base = np.asarray(out[0])
        rel = np.abs(np.asarray(out[1:]) / base - 1).max(axis=0)
        leaf = {k: max(float((mu[k] - t).abs().max() / t.abs().max())
                       for mu in mus[1:])
                for k, t in mus[0].items()}
        worst = max(leaf, key=leaf.get)
        print(f"{arch}: loss {base[0]:.6f}, grad norm {base[1]:.6f}; "
              f"largest relative change under {args.rel:g} weight noise "
              f"({args.trials} draws): loss {rel[0]:.3g}, grad norm "
              f"{rel[1]:.3g}, first moments {leaf[worst]:.3g} ({worst}; "
              f"{sum(v <= 1e-5 for v in leaf.values())} of {len(leaf)} "
              f"leaves within 1e-5)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
