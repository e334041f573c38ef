"""End-to-end LM training launcher.

The counterpart of `repro/launch/train.py`: config registry -> data
pipeline -> init -> train step (gradient accumulation, global-norm clip,
AdamW with the arch's moment dtype) -> checkpoints (atomic, async, exact
data resume) -> the loop, with the reference's flags and per-step line.
It runs on the card unless `--device cpu` asks for the CPU. Run alone it
trains on one device: the sharding layer gives every spec that device.
Under `torchrun --nproc-per-node N` (NCCL between cards, gloo on the CPU)
it trains over the host mesh (1, N): the same weights on every rank,
placed by the parameter specs, moments by theirs (ZeRO-1), the gradient
reduced onto the parameters' blocks (ZeRO-2); each rank builds the same
global batch and keeps its block; rank 0 prints and writes checkpoints.
The `model` axis places but splits no computation (ROADMAP item 9c).

Checkpoints are written in the reference's layout and files
(`to_reference_layout`), so a run of either package resumes from the
other's checkpoint. Parameters are drawn from a torch generator, so a
fresh port run starts from other weights than the reference's.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
      --smoke --device cpu --steps 20 --ckpt-dir build/train_ckpt --resume
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.train --arch qwen2-7b --smoke --device cpu

`--resume` picks up the newest checkpoint in `--ckpt-dir`, whichever run
wrote it: give a fresh run an empty directory.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
)
from repro_torch.checkpoint.checkpoint import to_host
from repro_torch.configs import get_arch
from repro_torch.data import TokenPipeline, TokenPipelineConfig
from repro_torch.distributed.sharding import (
    ShardingConfig,
    blocks,
    from_blocks,
    named,
    param_pspecs,
    place,
)
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.mesh import (
    init_distributed,
    make_host_mesh,
    make_production_mesh,
)
from repro_torch.launch.steps import make_train_step, opt_state_pspecs
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.optim import AdamWConfig, AdamWState, adamw_init
from repro_torch.tree_util import tree_map


def build_batch_fn(model: ModelConfig, pipe: TokenPipeline, accum: int,
                   microbatch: int, device: torch.device):
    """Host-side batch assembly: (A, mb, S) token stacks on `device`, plus
    the frontend stubs' zeros (llava's patches lead the sequence and take
    its last positions from the text; whisper's frames)."""

    def next_batch() -> Dict[str, torch.Tensor]:
        toks = np.stack([pipe.batch() for _ in range(accum)])  # (A, mb, S)
        batch = {"tokens": torch.from_numpy(toks).to(device)}
        if model.embed_frontend == "prefix_patches":
            p = model.n_prefix_patches
            batch["patches"] = torch.zeros(
                (accum, microbatch, p, model.d_model),
                dtype=model.param_dtype, device=device)
            batch["tokens"] = batch["tokens"][..., : toks.shape[-1] - p]
        elif model.embed_frontend == "stub_frames":
            batch["frames"] = torch.zeros(
                (accum, microbatch, model.max_source_len, model.d_model),
                dtype=model.param_dtype, device=device)
        return batch

    return next_batch


def _ref_state(params, opt_state: AdamWState, model: ModelConfig):
    """(params, opt_state) in the reference's layout."""
    ref = lambda t: lm.to_reference_layout(t, model)  # noqa: E731
    return (ref(params),
            AdamWState(opt_state.step, ref(opt_state.mu), ref(opt_state.nu)))


def checkpoint_state(params, opt_state: AdamWState, model: ModelConfig):
    """The tree a checkpoint holds: a host copy of (params, opt_state),
    stacked into the reference's layout on the host."""
    return _ref_state(*to_host((params, opt_state)), model)


def restore_state(directory, params, opt_state: AdamWState,
                  model: ModelConfig, device, step: Optional[int] = None,
                  placement=None):
    """((params, opt_state), extra) from the checkpoint in `directory`
    (the newest, or `step`), structured like `params` and `opt_state`, on
    `device`, or placed by `placement` (a pair of `named` trees for the
    parameters and the optimizer state: each rank keeps its block,
    whatever mesh wrote the checkpoint). The stacked leaves are read into
    host memory and unstacked there; each layer's leaf then goes to its
    device as a tensor of its own, as a fresh run allocates it (a view
    into a stacked tensor could take another matmul route, and the
    resumed run would not repeat the uninterrupted one bit for bit)."""
    meta = lambda t: torch.empty(t.shape, dtype=t.dtype,  # noqa: E731
                                 device="meta")
    like = _ref_state(*tree_map(meta, (params, opt_state)), model)
    (p, o), extra = restore_checkpoint(directory, step=step, like=like)
    state = (lm.from_reference_layout(p, model),
             AdamWState(o.step, lm.from_reference_layout(o.mu, model),
                        lm.from_reference_layout(o.nu, model)))
    if placement is None:
        placement = tree_map(lambda _: device, state)
    return tuple(place(t, w) for t, w in zip(state, placement)), extra


def main(argv=None, log: Optional[List[Dict]] = None):
    """Train; returns the final params. `log`, when given, receives one
    dict a step: step, loss and grad_norm (floats) and seconds."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the 16x16 pod mesh (needs 256 devices)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    ranked = not dist.is_initialized() and "WORLD_SIZE" in os.environ
    dev = init_distributed(args.device) if ranked \
        else resolve_device(args.device)
    writer = not dist.is_initialized() or dist.get_rank() == 0
    try:
        return _train(args, dev, writer, log)
    finally:
        if ranked:
            dist.destroy_process_group()


def _train(args, dev: torch.device, writer: bool, log: Optional[List[Dict]]):
    spec = get_arch(args.arch)
    model = spec.smoke if args.smoke else spec.model
    mesh = make_production_mesh() if args.production_mesh \
        else make_host_mesh(dev)
    scfg = ShardingConfig()
    if args.global_batch % args.accum:
        raise ValueError(f"--global-batch {args.global_batch} is not a "
                         f"multiple of --accum {args.accum}")
    microbatch = args.global_batch // args.accum

    pipe_cfg = TokenPipelineConfig(vocab_size=model.vocab_size,
                                   seq_len=args.seq_len,
                                   global_batch=microbatch, seed=0)
    pipe = TokenPipeline(pipe_cfg)

    # --- init (the same weights on every rank), placed by the specs ----
    params = lm.init_params(model, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    pspec = param_pspecs(params, scfg, mesh)
    placement = (named(mesh, pspec),
                 named(mesh, opt_state_pspecs(pspec, spec.moment_dtype)))
    params = place(params, placement[0])
    opt_state = from_blocks(adamw_init(blocks(params),
                                       moment_dtype=spec.moment_dtype),
                            placement[1])

    opt_cfg = AdamWConfig(lr=args.lr, weight_decay=0.1)
    step_fn = make_train_step(model, opt_cfg, moment_dtype=spec.moment_dtype,
                              grad_pspecs=pspec, mesh=mesh)

    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3, async_write=True)
        if args.resume and latest_step(args.ckpt_dir) is not None:
            (params, opt_state), extra = restore_state(
                args.ckpt_dir, params, opt_state, model, dev,
                placement=placement)
            pipe = TokenPipeline.from_state(pipe_cfg, extra)
            start = int(extra["train_step"])
            if writer:
                print(f"resumed at step {start} (data step {pipe.step})")

    next_batch = build_batch_fn(model, pipe, args.accum, microbatch, dev)
    for step in range(start, args.steps):
        t0 = time.time()
        batch = next_batch()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        gnorm = float(metrics["grad_norm"])
        dt = time.time() - t0
        if writer:
            print(f"step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                  f"dt {dt:.2f}s")
        if log is not None:
            log.append({"step": step, "loss": loss, "grad_norm": gnorm,
                        "seconds": dt})
        if not np.isfinite(loss):
            raise FloatingPointError(f"training diverged: loss {loss} at "
                                     f"step {step}")
        if mgr and (step + 1) % args.ckpt_every == 0:
            extra = {**pipe.state(), "train_step": step + 1}
            mgr.save(step + 1, checkpoint_state(params, opt_state, model),
                     extra)
    if mgr:
        mgr.close()
    return params


if __name__ == "__main__":
    main()
