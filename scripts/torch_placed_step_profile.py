#!/usr/bin/env python3
"""Profile the train step placed over a one-rank NCCL mesh (1, 1) beside
the unplaced step, as `chip_smoke.py` phase 14 runs them: qwen2-7b at its
published width cut to 2 layers, bf16 weights, f32 moments, 2 microbatches
of 4 x 1,024 tokens, on one CUDA card.

Run from the repository root:
``python3 scripts/torch_placed_step_profile.py [--root DIR] [--steps N]``.
`--root` takes the port (its `src/` and `chip_smoke.py`) from another
checkout, so that two trees are compared within one call: run the script
once per tree, alternating which goes first.

For each way (unplaced, then placed, from the same seeded weights and
batches): one warm-up step, N timed steps (each synchronised), then one
step under `torch.profiler` with host and device activity. Printed: the
wall and device time (without the ranges that `record_function`
annotates on the device's timeline, which span work counted already);
the device events by kind (NCCL's ranges, `nccl:*`, and the
device-to-device copies by name, the rest together); the host calls of
each collective operator (`c10d`, `_c10d_functional`), also per parameter
leaf and per microbatch; and the host time (inclusive) of the placed
step's parts, each wrapped in a `record_function` range: the parameters'
whole-tree gather where the tree still has one (`full_tensor`; since the
gathers moved into the model, a layer at a time, no step has), the
reductions onto the accumulator
(`reduce_to_block`), the placed outputs (`_placed_like`, or
`from_blocks` in a tree that has no `_placed_like`), the norm's and the
loss's all-reduces (`sum_over_shards`, `all_reduce`). Then the card's
name and power limit, and a last line of JSON with every reading.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

PARTS = ("full_tensor", "reduce_to_block", "_placed_like", "from_blocks",
         "sum_over_shards", "all_reduce")


def timed_steps(step, p, o, batches, n):
    """One warm-up step, then n synchronised steps: (params, state, ms)."""
    p, o, _ = step(p, o, batches[0])
    ms = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, m = step(p, o, batches[(i + 1) % len(batches)])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        float(m["loss"])
    return p, o, ms


def profiled(step, p, o, batch, n_leaves, n_micro):
    """One step under the profiler: the readings described above."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(p, o, batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    kinds = {"nccl": {}, "dtod": {}, "other": [0, 0.0]}
    for e in dev:
        t = e.time_range.elapsed_us() / 1e3
        low = e.name.lower()
        kind = "nccl" if "nccl" in low else "dtod" if "dtod" in low else None
        if getattr(e, "is_user_annotation", False) and kind != "nccl":
            continue  # a range over work counted already
        if kind is None:
            kinds["other"][0] += 1
            kinds["other"][1] += t
            continue
        n, s = kinds[kind].get(e.name, (0, 0.0))
        kinds[kind][e.name] = (n + 1, s + t)
    host = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        if "c10d" in e.name or e.name.startswith("nccl:"):
            host[e.name] = host.get(e.name, 0) + 1
    parts = {k.key[len("placed:"):]: (k.count, k.cpu_time_total / 1e3)
             for k in prof.key_averages() if k.key.startswith("placed:")}
    work = [e for e in dev if not getattr(e, "is_user_annotation", False)]
    busy = sum(e.time_range.elapsed_us() for e in work) / 1e3
    return {"wall_ms": wall, "device_ms": busy, "device_events": len(work),
            "nccl": {n: list(v) for n, v in kinds["nccl"].items()},
            "dtod": {n: list(v) for n, v in kinds["dtod"].items()},
            "other": kinds["other"], "host_collectives": host,
            "per_leaf_per_microbatch": {
                n: c / (n_leaves * n_micro) for n, c in host.items()},
            "parts_ms": {n: list(v) for n, v in parts.items()}}


def wrap_parts(steps_mod):
    """Wrap the placed step's helpers in `record_function` ranges."""
    from torch.profiler import record_function

    for name in PARTS:
        fn = getattr(steps_mod, name, None)
        if fn is None:
            continue

        def wrapped(*a, _fn=fn, _name=name, **kw):
            with record_function(f"placed:{_name}"):
                return _fn(*a, **kw)

        setattr(steps_mod, name, wrapped)


def report(label, r, ms):
    print(f"{label}: ms a step " + ", ".join(f"{t:.2f}" for t in ms)
          + f" (median {float(np.median(ms)):.2f}); profiled: wall "
          f"{r['wall_ms']:.2f} ms, device {r['device_ms']:.2f} ms over "
          f"{r['device_events']} events")
    for kind in ("nccl", "dtod"):
        for n, (c, t) in sorted(r[kind].items(), key=lambda kv: -kv[1][1]):
            print(f"  {kind} {t:8.3f} ms {c:5d}x {n[:90]}")
    print(f"  other device events: {r['other'][0]}, {r['other'][1]:.3f} ms")
    for n, c in sorted(r["host_collectives"].items()):
        print(f"  host {c:5d}x {n} "
              f"({r['per_leaf_per_microbatch'][n]:.3f} a leaf a microbatch)")
    for n, (c, t) in sorted(r["parts_ms"].items(), key=lambda kv: -kv[1][1]):
        print(f"  host part {n}: {t:.3f} ms over {c} calls")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline, TokenPipelineConfig
    from repro_torch.kernels.backend import power_limit
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree_util import leaves_with_path

    dev = torch.device("cuda")
    model = dataclasses.replace(get_arch("qwen2-7b").model,
                                n_layers=cs.QWEN_TRAIN_LAYERS)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=model.vocab_size, seq_len=cs.QWEN_SEQ,
        global_batch=cs.QWEN_MB))
    batches = [{"tokens": torch.from_numpy(np.stack(
        [pipe.batch() for _ in range(cs.QWEN_ACCUM)])).to(dev)}
        for _ in range(3)]
    weights = lambda: lm.init_params(  # noqa: E731
        model, torch.Generator(device=dev).manual_seed(0), device=dev)
    out = {"root": str(root)}

    p = weights()
    n_leaves = len(leaves_with_path(p))
    step = steps_mod.make_train_step(
        model, AdamWConfig(lr=cs.TRAIN_LR, weight_decay=0.1),
        moment_dtype="float32")
    p, o, ms = timed_steps(step, p, adamw_init(p, "float32"), batches,
                           args.steps)
    r = profiled(step, p, o, batches[0], n_leaves, cs.QWEN_ACCUM)
    report("unplaced", r, ms)
    out["unplaced"] = dict(r, ms=ms)
    del p, o, step
    torch.cuda.empty_cache()

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(dev, rank=0, world_size=1,
                         store=dist.FileStore(str(Path(tmp) / "store"), 1))
        try:
            mesh = make_mesh((1, 1), ("data", "model"))
            wrap_parts(steps_mod)
            p, o, step = cs.placed_state(model, mesh, "float32", weights())
            p, o, ms = timed_steps(step, p, o, batches, args.steps)
            r = profiled(step, p, o, batches[0], n_leaves, cs.QWEN_ACCUM)
            report(f"placed over {mesh.shape}", r, ms)
            out["placed"] = dict(r, ms=ms)
            del p, o, step
        finally:
            dist.destroy_process_group()
    out["leaves"], out["microbatches"] = n_leaves, cs.QWEN_ACCUM
    out["card"] = power_limit()
    print(out["card"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
