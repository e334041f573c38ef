"""Training placed over a mesh of ranks against the one-process step.

One spawn of four gloo ranks on the CPU (one thread each, rendezvous
through a `FileStore` under the test's temporary directory) runs every
scenario, on the meshes (4, 1), (2, 2) and (1, 4) over ("data",
"model"): two steps of two microbatches of qwen2-7b's smoke config with
float32 and with int8 moments, of llama3-405b's (int8 moments) and of
qwen3-moe's (float32; its routing over a split batch is the whole
microbatch's), from the seed-0 weights placed by their pruned specs;
whisper's (cross-attention split over `model`) on (2, 2); jamba's (Mamba
split by its inner channels, attention and MoE split) and xlstm's (mLSTM
and sLSTM split by their heads) on (2, 2) and (1, 4); two head layouts
whose `model` split falls inside a head, and xlstm's with 2 heads on
(1, 4) (its cells compute whole); the compute of one step at (1, 4)
counted (`FlopCounterMode`), and the model-side calls of each Mamba and
xLSTM mixer at two sequence lengths; and a checkpoint written on (2, 2)
after two steps, then two more steps there (the uninterrupted run), the
same checkpoint restored on (4, 1) and trained two steps, and restored
by `restore_checkpoint` onto (4, 1)'s blocks directly. Every rank counts
the gathered parameter bytes alive at once (`gather_on_use`'s outputs).
With Megatron sequence parallelism (`act_pspec` naming `model` on the
sequence) qwen2-7b and jamba train on (2, 2) and (1, 4), and one step of
qwen2-7b at (1, 4) each way is recorded (`hlo_counters.Recorder`: its
collectives, and the residual each period's checkpoint keeps); the
dry-run's cells of qwen2-7b and qwen3-moe (smoke configs) run on (2, 2)
and are recorded as `launch.dryrun` records them on a fake mesh.

Against the one-process step (`make_train_step` without a mesh) from the
same weights and batches: loss and grad norm within 1e-5 relative (equal
on every rank), both moments within 1e-5 of each leaf's largest entry
(int8: codes within one code step, scales within 1e-5), parameters within
1e-5 where the gradient exceeds 100 eps and within 2 lr elsewhere (AdamW
divides the rounding of a near-zero gradient by eps), as
`tests/test_torch_train_lm.py` holds them. Each rank's parameters,
moments and gradient accumulator are its block of the spec pruned for
its mesh. The checkpoint resumes on (4, 1) and in one process with the
next two steps within 1e-5 of the uninterrupted run, and the reference's
`repro.checkpoint.restore_checkpoint` reads it. The launcher trains over
two ranks under torchrun as it does alone.

Against the reference: a fifth process beside the ranks runs the
reference's own train step (`repro.launch.steps.make_train_step` with
`grad_pspecs`, jitted with `train_shardings`: GSPMD) over the meshes
(2, 2), (4, 1) and (1, 4) of four forced host devices (qwen3-moe's on
the first two), from the port's seed-0 weights in the reference's layout
and the same batches. The placed steps equal it at the limits above, the
parameters held
within 1e-5 where the reference's gradient exceeds 100 eps at both steps
and its int8 codes agree with the port's after the first. qwen2-7b's
smoke config with bfloat16 parameters runs placed on both meshes too:
every gradient the ranks reduce is bfloat16, and the step is the
reference's within bfloat16's rounding (the limits are in
`test_placed_bf16_step_against_the_reference_gspmd_step`).

Run as a script, this file is one rank of the spawn,
`python tests/test_torch_placement.py <rank> <store file> <out dir>`, or
the reference's runs, `python tests/test_torch_placement.py reference
<out dir>`.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import weakref
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
MESHES = ((4, 1), (2, 2), (1, 4))
AXES = ("data", "model")
CASES = (("qwen2-7b", "float32"), ("qwen2-7b", "int8"),
         ("llama3-405b", "int8"))
MOE = ("qwen3-moe-235b-a22b", "float32")
# The other block families: cross-attention split over `model` (whisper,
# on (2, 2)); Mamba split by its inner channels beside split attention and
# MoE (jamba), mLSTM and sLSTM by their heads (xlstm), on (2, 2) and (1, 4)
FAMILIES = (("whisper-large-v3", "float32", (2, 2)),
            ("jamba-v0.1-52b", "float32", (2, 2)),
            ("jamba-v0.1-52b", "float32", (1, 4)),
            ("xlstm-350m", "float32", (2, 2)),
            ("xlstm-350m", "float32", (1, 4)))
# xlstm's smoke config with 2 heads on (1, 4): `model` does not divide the
# heads, so both cells compute whole on weights gathered over `model`
MIXER_WHOLE = ("xlstm-whole", (1, 4), 2, 2, "xlstm-350m")
# The block families whose compute a step at (1, 4) counts, and whose
# model-side calls a mixer are counted at two sequence lengths
SPLIT = (("jamba-v0.1-52b", "float32"), ("xlstm-350m", "float32"))
GUARD_SEQS = (16, 32)
# Head layouts whose `model` split falls inside a head (qwen2-7b's smoke
# config with other head counts): (name, mesh, n_heads, n_kv_heads). Two
# query heads on four `model` ranks (wq's columns split mid-head: the
# attention computes whole on every rank); six query heads over three KV
# heads on two (each rank's three query heads read two KV heads unevenly:
# one KV head a query head).
INSIDE_HEADS = (("mid-head", (1, 4), 2, 1), ("uneven-kv", (2, 2), 6, 3))
CKPT_MESH, RESUME_MESH = (2, 2), (4, 1)
# Megatron sequence parallelism (`act_pspec` names `model` on the
# sequence): qwen2-7b and jamba on these meshes; one recorded step of
# qwen2-7b each way at (1, 4); and the dry-run's fake (2, 2) step against
# the ranks' recorded ones (DRY: smoke configs, 2 microbatches of 4
# sequences of 32 tokens)
SP = ("data", "model", None)
SP_ARCHS = ("qwen2-7b", "jamba-v0.1-52b")
SP_MESHES = ((2, 2), (1, 4))
DRY = ("qwen2-7b", "qwen3-moe-235b-a22b")
DRY_SEQ, DRY_MB, DRY_BATCH = 32, 4, 8
# The reference's GSPMD step runs CASES and BF16 (qwen2-7b's smoke config
# with bfloat16 parameters, f32 moments) on these meshes of four forced
# host devices, and MOE on the first two; the ranks run BF16 on them too.
REF_MESHES = ((2, 2), (4, 1), (1, 4))
REF_MOE_MESHES = REF_MESHES[:2]
BF16 = ("qwen2-7b", "float32")
BF16_EPS = 2.0 ** -7  # bfloat16's spacing at 1 (8 significand bits)
STEPS, ACCUM, MB, SEQ = 2, 2, 4, 32
LR = 3e-4  # the launcher's default, weight decay 0.1
REL = 1e-5
EPS = 1e-8  # AdamWConfig().eps
# xlstm's moments are held leaf by leaf to twice what SENS_DRAWS draws of
# SENS_REL relative weight noise (about one float32 ulp) move them in the
# one-process step, and to no less than REL, as `chip_smoke.py` holds
# them card against CPU (`moment_spread`)
SENS_REL, SENS_DRAWS = 1e-7, 4


def key(shape, arch, md) -> str:
    return f"{shape[0]}x{shape[1]}/{arch}/{md}"


def batches(cfg, n: int, seed: int = 0, seq: int = SEQ):
    """n (A, MB, seq) token stacks (and whisper's (A, MB, S_src, d)
    frames), the same in every process."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (ACCUM, MB, seq)).astype(np.int32))}
        if cfg.embed_frontend == "stub_frames":
            b["frames"] = torch.from_numpy((rng.normal(size=(
                ACCUM, MB, cfg.max_source_len, cfg.d_model)) * 0.02)
                .astype(np.float32))
        out.append(b)
    return out


def smoke(arch: str, dtype: str = "float32", heads=None, remat=True,
          act=None):
    """The smoke config, its parameters in `dtype`; `heads` (n_heads,
    n_kv_heads) replaces its head counts, `remat` its own and `act` its
    `act_pspec`."""
    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(arch).smoke, dtype=dtype)
    if heads is not None:
        cfg = dataclasses.replace(cfg, n_heads=heads[0], n_kv_heads=heads[1])
    return dataclasses.replace(cfg, remat=remat, act_pspec=act)


def init(arch: str, dtype: str = "float32", heads=None, remat=True,
         act=None):
    """The smoke config (its parameters in `dtype`, `heads`, `remat` and
    `act` as `smoke` takes them) and its seed-0 weights."""
    from repro_torch.models import lm

    cfg = smoke(arch, dtype, heads, remat, act)
    return cfg, lm.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")


def opt_cfg():
    from repro_torch.optim import AdamWConfig

    return AdamWConfig(lr=LR, weight_decay=0.1)


def train(step, p, o, bs, each=None):
    """Steps over `bs`; `each(p, o)` after every step but the last."""
    rows = []
    for i, b in enumerate(bs):
        p, o, m = step(p, o, b)
        rows.append((float(m["loss"]), float(m["grad_norm"])))
        if each is not None and i + 1 < len(bs):
            each(p, o)
    return p, o, rows


# ---------------------------------------------------------------------------
# One rank of the spawn
# ---------------------------------------------------------------------------
def placed_run(mesh, arch, md, bs, record, grad_pspecs=True,
               dtype="float32", each=None, heads=None, remat=True, act=None):
    """Train `bs` placed over `mesh` from the seed-0 weights (in `dtype`;
    `heads`, `remat` and `act` as `smoke` takes them), the accumulator placed
    like the parameters (or, `grad_pspecs=False`, whole on every rank);
    `each` as `train` takes it. Returns (params, opt state, rows, the
    pruned specs, {path: local shape})."""
    from repro_torch.distributed.sharding import (
        ShardingConfig,
        blocks,
        from_blocks,
        named,
        param_pspecs,
        place,
    )
    from repro_torch.launch.steps import make_train_step, opt_state_pspecs
    from repro_torch.optim import adamw_init
    from repro_torch.tree_util import leaves_with_path

    cfg, params = init(arch, dtype, heads, remat, act)
    pspec = param_pspecs(params, ShardingConfig(), mesh)
    p = place(params, named(mesh, pspec))
    o = from_blocks(adamw_init(blocks(p), md),
                    named(mesh, opt_state_pspecs(pspec, md)))
    step = make_train_step(cfg, opt_cfg(), moment_dtype=md,
                           grad_pspecs=pspec if grad_pspecs else None,
                           mesh=mesh)
    del record[:]
    p, o, rows = train(step, p, o, bs, each)
    local = {k: tuple(t.to_local().shape)
             for k, t in leaves_with_path((p, o))}
    specs = {k: tuple(s) for k, s in leaves_with_path(pspec)}
    return p, o, rows, specs, local


_COLLECTIVE = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def recorded_step(mesh, arch, act, remat):
    """One placed step of `arch` (f32 moments, one batch of ACCUM x MB x
    SEQ tokens, `remat` its own) recorded (`hlo_counters.Recorder`): its
    collectives (kind, output bytes, input bytes, group, calls) and the
    shape of the residual each period's checkpoint keeps."""
    from repro_torch.distributed.hlo_counters import Recorder
    from repro_torch.models import lm

    saved, ck = [], lm.checkpoint

    def keeping(fn, lo, x, aux, **kw):
        saved.append(tuple(x.shape))
        return ck(fn, lo, x, aux, **kw)

    lm.checkpoint = keeping
    try:
        with Recorder() as rec:
            placed_run(mesh, arch, "float32", batches(init(arch)[0], 1), [],
                       act=act, remat=remat)
    finally:
        lm.checkpoint = ck
    return {"colls": [(r.kind, r.out_bytes, r.in_bytes, r.group, r.calls)
                      for r in rec.trace.records if r.kind in _COLLECTIVE],
            "saved": saved}


def dry_cell(arch: str):
    """(ArchSpec, ShapeSpec) of the dry-run cell the ranks and the fake
    mesh both run: `arch`'s smoke config, DRY_BATCH sequences of DRY_SEQ
    tokens a step in microbatches of DRY_MB."""
    from repro_torch.configs import SHAPES, get_arch

    spec = get_arch(arch)
    return (dataclasses.replace(spec, model=spec.smoke,
                                microbatch={"train_4k": DRY_MB}),
            dataclasses.replace(SHAPES["train_4k"], seq_len=DRY_SEQ,
                                global_batch=DRY_BATCH))


def rank_main(rank: int, store: str, out: str) -> None:
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.train import checkpoint_state, restore_state
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import lm
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import xlstm_blocks as xl
    from repro_torch.tree_util import leaves_with_path

    torch.set_num_threads(1)
    init_distributed("cpu", rank=rank, world_size=WORLD,
                     store=dist.FileStore(store, WORLD))
    record = []  # (gradient block shape, accumulator block, dtype) a call
    reduce = steps_mod.reduce_to_block

    def recording(g, src, dst, over):
        b = reduce(g, src, dst, over)
        record.append((tuple(g.shape), tuple(b.shape), str(g.dtype)))
        return b

    steps_mod.reduce_to_block = recording
    alive = [0, 0]  # gathered parameter bytes alive, the most since reset
    gather = sharding.gather_on_use

    def tracking(t, spec, placement):
        g = gather(t, spec, placement)
        if g is not t:
            n = g.numel() * g.element_size()
            alive[0] += n
            alive[1] = max(alive[1], alive[0])
            weakref.finalize(g, lambda: alive.__setitem__(0, alive[0] - n))
        return g

    sharding.gather_on_use = tracking
    heads = []  # the query shapes handed to ops.flash_attention
    flash = attn_mod.ops.flash_attention

    def counting(q, k, v, causal=True):
        heads.append(tuple(q.shape))
        return flash(q, k, v, causal)

    attn_mod.ops.flash_attention = counting
    channels, cells = [], []  # the scans' d_inner, the xLSTM cells' heads
    scan, rms = ssm_mod._selective_scan_chunked, xl._headwise_rms

    def scanning(delta, *a):
        channels.append(delta.shape[-1])
        return scan(delta, *a)

    def norming(h, *a):
        cells.append(h.shape[-2])
        return rms(h, *a)

    ssm_mod._selective_scan_chunked, xl._headwise_rms = scanning, norming

    def run(mesh, arch, md, bs, **kw):
        """`placed_run`, the most gathered bytes alive during it, the
        query head counts its flash calls took, the channels its scans
        ran on and the heads its xLSTM cells ran on."""
        alive[1] = alive[0]
        del heads[:], channels[:], cells[:]
        p, o, rows, specs, local = placed_run(mesh, arch, md, bs, record,
                                              **kw)
        return p, o, rows, specs, local, {
            "peak": alive[1], "heads": sorted({q[1] * q[3] for q in heads}),
            "channels": sorted(set(channels)), "cells": sorted(set(cells))}

    gathered = lambda t: sharding.gather(t) if rank == 0 \
        else sharding.gather(t) and None  # noqa: E731
    res = {}
    for shape in MESHES:
        mesh = make_mesh(shape, AXES, "cpu")
        for arch, md in CASES + (MOE,):
            cfg, mids = init(arch)[0], []
            p, o, rows, specs, local, seen = run(
                mesh, arch, md, batches(cfg, STEPS),
                each=lambda p, o: mids.append(gathered(o)))
            res[key(shape, arch, md)] = {
                "rows": rows, "specs": specs, "local": local,
                "accumulator": list(record), "state": gathered((p, o)),
                "mids": mids, **seen}
        # without grad_pspecs the accumulator is whole on every rank
        arch, md = CASES[0]
        p, o, rows, _, _, _ = run(mesh, arch, md,
                                  batches(init(arch)[0], STEPS),
                                  grad_pspecs=False)
        res[key(shape, arch, md) + "/whole"] = {
            "rows": rows, "accumulator": list(record),
            "state": gathered((p, o))}

    for arch, md, shape in FAMILIES:
        mids = []
        _, _, rows, _, _, seen = run(
            make_mesh(shape, AXES, "cpu"), arch, md,
            batches(init(arch)[0], STEPS),
            each=lambda p, o: mids.append(gathered((p, o))))
        res[key(shape, arch, md)] = {"rows": rows, "mids": mids, **seen}

    for name, shape, h, kv, arch in [c + (CASES[0][0],) for c in INSIDE_HEADS
                                     ] + [MIXER_WHOLE]:
        md, mids = "float32", []
        _, _, rows, _, _, seen = run(
            make_mesh(shape, AXES, "cpu"), arch, md,
            batches(init(arch)[0], STEPS), heads=(h, kv),
            each=lambda p, o: mids.append(gathered((p, o))))
        res[name] = {"rows": rows, "mids": mids, **seen}

    # one step's compute at (1, 4), counted
    mesh = make_mesh((1, 4), AXES, "cpu")
    for arch, md in (CASES[0], MOE) + SPLIT:
        with FlopCounterMode(display=False) as fc:
            *_, seen = run(mesh, arch, md, batches(init(arch)[0], 1))
        res["flops/" + arch] = {"flops": fc.get_total_flops(), **seen}

    # One step at (1, 4) at each of GUARD_SEQS, remat off (a recompute
    # stops once it has what backward saved, so it may skip a period's
    # last calls): each mixer's calls of Placement's operators over
    # `model` (attributed to the mixer running them) and every collective
    # the step issues
    made, site = {}, [None]

    def counted(owner, name, fn):
        def call(*a, **kw):
            for at in ("step",) if owner is dist else (site[0],):
                if at is not None:
                    n = made.setdefault(at, {})
                    n[name] = n.get(name, 0) + 1
            return fn(*a, **kw)
        return call

    mixer = lm._mixer

    def attributed(bp, h, cfg, kind, *a):
        site[0] = kind
        n = made.setdefault(kind, {})
        n["calls"] = n.get("calls", 0) + 1
        try:
            return mixer(bp, h, cfg, kind, *a)
        finally:
            site[0] = None

    saved = [(sharding.Placement, n, getattr(sharding.Placement, n))
             for n in ("copy_to_model", "reduce_from_model",
                       "sum_over_model", "gather_model", "max_over_model")]
    saved += [(dist, n, getattr(dist, n)) for n in (
        "all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")]
    for owner, name, fn in saved:
        setattr(owner, name, counted(owner, name, fn))
    lm._mixer = attributed
    for arch, md in SPLIT:
        for seq in GUARD_SEQS:
            made.clear()
            run(mesh, arch, md, batches(init(arch)[0], 1, seq=seq),
                remat=False)
            res[f"guard/{arch}/{seq}"] = {k: dict(v) for k, v in made.items()}
    lm._mixer = mixer
    for owner, name, fn in saved:
        setattr(owner, name, fn)

    # bfloat16 parameters, against the reference's GSPMD step
    for shape in REF_MESHES:
        arch, md = BF16
        mesh = make_mesh(shape, AXES, "cpu")
        p, o, rows, _, _, _ = run(mesh, arch, md,
                                  batches(init(arch)[0], STEPS),
                                  dtype="bfloat16")
        res[key(shape, arch, md) + "/bf16"] = {
            "rows": rows, "accumulator": list(record),
            "state": gathered((p, o))}

    # The checkpoint: written on CKPT_MESH after STEPS steps, then STEPS
    # more steps there; restored on RESUME_MESH and trained the same.
    arch, md = CASES[0]
    cfg = init(arch)[0]
    bs = batches(cfg, 2 * STEPS)
    ckpt = os.path.join(out, "ckpt")
    mesh = make_mesh(CKPT_MESH, AXES, "cpu")
    p, o, _, _, _ = placed_run(mesh, arch, md, bs[:STEPS], record)
    mgr = CheckpointManager(ckpt, async_write=True)
    mgr.save(STEPS, checkpoint_state(p, o, cfg), {"train_step": STEPS})
    mgr.close()
    step = steps_mod.make_train_step(cfg, opt_cfg(), moment_dtype=md,
                                     grad_pspecs=sharding.param_pspecs(
                                         p, mesh=mesh), mesh=mesh)
    p, o, rows = train(step, p, o, bs[STEPS:])
    res["uninterrupted"] = {"rows": rows, "state": gathered((p, o))}

    mesh = make_mesh(RESUME_MESH, AXES, "cpu")
    like_p = init(arch)[1]
    pspec = sharding.param_pspecs(like_p, mesh=mesh)
    ospec = steps_mod.opt_state_pspecs(pspec, md)
    placement = (sharding.named(mesh, pspec), sharding.named(mesh, ospec))
    like_o = steps_mod.AdamWState(
        torch.zeros((), dtype=torch.int32), like_p, like_p)
    (p, o), extra = restore_state(ckpt, like_p, like_o, cfg, "cpu",
                                  placement=placement)
    local = {k: tuple(t.to_local().shape)
             for k, t in leaves_with_path((p, o))}
    step = steps_mod.make_train_step(cfg, opt_cfg(), moment_dtype=md,
                                     grad_pspecs=pspec, mesh=mesh)
    p, o, rows = train(step, p, o, bs[STEPS:])
    res["resumed"] = {"rows": rows, "state": gathered((p, o)),
                      "extra": extra, "local": local,
                      "specs": {k: tuple(s)
                                for k, s in leaves_with_path(pspec)}}

    # restore_checkpoint onto blocks, in the file's (stacked) layout
    ref = lm.to_reference_layout(like_p, cfg)
    rspec = sharding.param_pspecs(ref, mesh=mesh)
    got, _ = restore_checkpoint(ckpt, like=(ref, steps_mod.AdamWState(
        like_o.step, ref, ref)), shardings=(
        sharding.named(mesh, rspec), sharding.named(
            mesh, steps_mod.opt_state_pspecs(rspec, md))))
    res["restored_blocks"] = {
        "local": {k: tuple(t.to_local().shape)
                  for k, t in leaves_with_path(got)},
        "specs": {k: tuple(s) for k, s in leaves_with_path(rspec)},
        "state": gathered(got)}
    # Megatron sequence parallelism: one step of each (its state after it
    # held as the others' first steps are), then one recorded step of
    # qwen2-7b at (1, 4) with and without it
    for shape in SP_MESHES:
        mesh = make_mesh(shape, AXES, "cpu")
        for arch in SP_ARCHS:
            p, o, rows, _, _, seen = run(
                mesh, arch, "float32", batches(init(arch)[0], 1), act=SP)
            res[key(shape, arch, "float32") + "/sp"] = {
                "rows": rows, "mids": [gathered((p, o))], **seen}
    # two query heads on four `model` ranks: the attention computes whole
    # (its input gathered, its output cut back to the block)
    name, shape, h, kv = INSIDE_HEADS[0]
    p, o, rows, _, _, seen = run(
        make_mesh(shape, AXES, "cpu"), CASES[0][0], "float32",
        batches(init(CASES[0][0])[0], 1), heads=(h, kv), act=SP)
    res[name + "/sp"] = {"rows": rows, "mids": [gathered((p, o))], **seen}
    mesh = make_mesh((1, 4), AXES, "cpu")
    for act in (None, SP):
        for remat in (False, True):
            res[f"recorded/{act is not None}/{remat}"] = recorded_step(
                mesh, CASES[0][0], act, remat)

    # the dry-run's cell on the real ranks: its step recorded as
    # `launch.dryrun.trace_cell` records it on the fake mesh
    from repro_torch.distributed.hlo_counters import Recorder, analyze
    from repro_torch.launch import dryrun

    mesh = make_mesh((2, 2), AXES, "cpu")
    for arch in DRY:
        step, (p, o, one), accum = dryrun.build_cell(*dry_cell(arch), mesh)
        batch = {k: v.expand((accum,) + tuple(v.shape[1:])).contiguous()
                 for k, v in one.items()}
        with Recorder() as rec:
            step(p, o, batch)
        c = analyze(rec.trace)
        res["dry/" + arch] = {"flops": c.flops, "dot_flops": c.dot_flops,
                              "bytes": c.bytes, "counts": c.coll_counts,
                              "link": c.link_bytes}

    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def reference_main(out: str) -> None:
    """The reference's train step (`repro.launch.steps.make_train_step`
    with `grad_pspecs` = its pruned parameter specs, jitted with the
    shardings of `train_shardings`, as its launcher runs it) over each of
    REF_MESHES of four forced host devices, on CASES and BF16 (and MOE on
    REF_MOE_MESHES) from the
    port's seed-0 weights in the reference's layout and the same batches.
    Saves {key: {"rows", "state"}} with each state a (params, AdamWState)
    tree in the reference's layout, as tensors."""
    os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                               f"{WORLD} " + os.environ.get("XLA_FLAGS", ""))
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as j_get_arch
    from repro.distributed.sharding import ShardingConfig as JShardingConfig
    from repro.distributed.sharding import param_pspecs as j_param_pspecs
    from repro.launch.mesh import make_mesh_compat
    from repro.launch.steps import make_train_step as j_make_train_step
    from repro.launch.steps import train_shardings
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.optim import adamw_init as j_adamw_init
    from repro.optim.state_codec import Quantized as JQuantized
    from repro_torch.models import lm
    from repro_torch.optim import AdamWState
    from repro_torch.optim.state_codec import Quantized

    assert len(jax.devices()) == WORLD, jax.devices()

    def to_jax(t):
        dt = jnp.bfloat16 if t.dtype == torch.bfloat16 else None
        return jnp.asarray(t.float().numpy() if dt else t.numpy(), dtype=dt)

    def to_torch(node):
        if isinstance(node, dict):
            return {k: to_torch(v) for k, v in node.items()}
        if isinstance(node, JQuantized):
            return Quantized(codes=to_torch(node.codes),
                             scale=to_torch(node.scale))
        a = np.asarray(node)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())

    res = {}
    for shape in REF_MESHES:
        mesh = make_mesh_compat(shape, AXES)
        runs = [(c, "float32", "") for c in CASES] \
            + [(BF16, "bfloat16", "/bf16")]
        if shape in REF_MOE_MESHES:
            runs.append((MOE, "float32", ""))
        for (arch, md), dtype, tag in runs:
            cfg, params = init(arch, dtype)
            model = dataclasses.replace(j_get_arch(arch).smoke, dtype=dtype)
            jp = {k: v for k, v in lm.to_reference_layout(params, cfg).items()}
            jp = jax.tree_util.tree_map(to_jax, jp)
            jo = j_adamw_init(jp, moment_dtype=md)
            bs = [{k: v.numpy() for k, v in b.items()}
                  for b in batches(cfg, STEPS)]
            scfg = JShardingConfig()
            ins, outs = train_shardings(jp, jo, bs[0], mesh, scfg, md)
            step = jax.jit(j_make_train_step(
                model, JAdamWConfig(lr=LR, weight_decay=0.1),
                moment_dtype=md,
                grad_pspecs=j_param_pspecs(jp, scfg, mesh)),
                in_shardings=ins, out_shardings=outs)
            rows, opts = [], []
            with mesh:
                p, o = jax.device_put(jp, ins[0]), jax.device_put(jo, ins[1])
                for b in bs:
                    p, o, m = step(p, o, b)
                    rows.append((float(m["loss"]), float(m["grad_norm"])))
                    opts.append(AdamWState(to_torch(o.step), to_torch(o.mu),
                                           to_torch(o.nu)))
            res[key(shape, arch, md) + tag] = {
                "rows": rows, "opts": opts,
                "state": (to_torch(p), opts[-1])}
    torch.save(res, os.path.join(out, "reference.pt"))


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        reference_main(sys.argv[2])
    else:
        rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
    sys.exit(0)


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as each rank has."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Spawn(NamedTuple):
    ranks: dict  # rank -> its results
    ckpt: Path  # the checkpoint written on CKPT_MESH
    reference: dict  # the reference's GSPMD runs (`reference_main`)


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    """Every scenario, run once by four ranks, and the reference's runs in
    a fifth process beside them."""
    tmp = tmp_path_factory.mktemp("placement")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    args = [[str(r), str(tmp / "store"), str(tmp)] for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, __file__] + a, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for a in args + [["reference", str(tmp)]]]
    logs = []
    try:
        for p in procs:  # a hang guard: the ranks take ~70 s alone and
            # up to ~200 s beside six busy test workers
            logs.append(p.communicate(timeout=360)[0])
    finally:
        for p in procs:
            p.kill()
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log)
           in enumerate(zip(procs, logs)) if p.returncode]
    assert not bad, bad
    return Spawn({r: torch.load(tmp / f"rank{r}.pt", weights_only=False)
                  for r in range(WORLD)}, tmp / "ckpt",
                 torch.load(tmp / "reference.pt", weights_only=False))


def one_process(arch, md, bs, p=None, o=None, heads=None, each=None):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init

    cfg, params = init(arch, heads=heads)
    p = params if p is None else p
    o = adamw_init(p, md) if o is None else o
    step = make_train_step(cfg, opt_cfg(), moment_dtype=md)
    return train(step, p, o, bs, each)


def _decoded(m, md):
    return m.codes.float() * m.scale if md == "int8" else m


def moment_spread(arch, heads=None) -> dict:
    """{moment leaf ("1/mu/...", "1/nu/..."): the largest change over its
    largest entry} that SENS_DRAWS draws of SENS_REL relative weight
    noise make in the one-process first step: what float32 rounding
    alone moves them (`scripts/torch_train_grad_sensitivity.py`)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.tree_util import leaves_with_path, tree_map

    cfg, params = init(arch, heads=heads)
    step = make_train_step(cfg, opt_cfg(), moment_dtype="float32")
    b = batches(cfg, 1)[0]
    moments = lambda p: {  # noqa: E731
        "1/" + k: t for k, t in leaves_with_path(step(
            p, adamw_init(p, "float32"), b)[1]) if k != "step"}
    base, gen = moments(params), torch.Generator().manual_seed(1)
    spread = dict.fromkeys(base, 0.0)
    for _ in range(SENS_DRAWS):
        got = moments(tree_map(lambda t: t * (1 + SENS_REL * torch.randn(
            t.shape, generator=gen)), params))
        for k, t in base.items():
            top = float(t.abs().max())
            if top:
                spread[k] = max(spread[k],
                                float((got[k] - t).abs().max()) / top)
    return spread


def assert_states_close(got, want, md, mus=None, flipped=None,
                        spread=None):
    """(params, opt state) trees: moments within REL of each leaf's
    largest entry (int8: codes within one step, scales within REL; given
    `spread`, `moment_spread`'s, within max(REL, 2 x the leaf's spread));
    parameters as `tests/test_torch_train_lm.py` holds them, within REL
    where the gradient exceeds 100 eps and within 2 lr elsewhere (the
    key biases' gradient is rounding noise: softmax ignores the shift
    q . bk of every key, and AdamW divides that noise by eps). Given
    `mus`, `want`'s first-moment trees after each step, the gradient must
    exceed 100 eps at every step (each step's 0.1 x gradient is
    mu - 0.9 x the previous mu): an entry whose first gradient was noise
    keeps the difference that step made. `flipped` (param path -> mask)
    marks the entries whose int8 moment codes differed after an earlier
    step, one code step apart: held like noise entries, since the next
    update divides that code step by sqrt(nu) as it divides noise."""
    from repro_torch.tree_util import leaves_with_path, map_with_path

    g, w = dict(leaves_with_path(got)), dict(leaves_with_path(want))
    assert g.keys() == w.keys()
    steps = [want[1].mu] if mus is None else mus
    grads = {}  # param path -> 0.1 x its gradient at each step
    for i, tree in enumerate(steps):
        map_with_path(lambda k, _, m: grads.setdefault(k, []).append(
            _decoded(m, md)), want[0], tree)
    for k in w:
        a, b = g[k], w[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k.endswith("/codes"):
            assert int((a.int() - b.int()).abs().max()) <= 1, k
            continue
        diff = (a.double() - b.double()).abs()
        if k.startswith("0/"):
            ms = grads[k[2:]]
            if mus is not None:  # each step's 0.1 x gradient
                ms = [ms[0]] + [m - 0.9 * p for p, m in zip(ms, ms[1:])]
            steady = torch.stack([m.abs() / 0.1 > 100 * EPS
                                  for m in ms]).all(0)
            if flipped is not None and k[2:] in flipped:
                steady &= ~flipped[k[2:]]
            assert float(diff.max()) <= 2 * LR, k
            assert float(torch.where(steady, diff, 0.0).max()) <= REL, k
            continue
        top = float(b.double().abs().max())
        bound = REL if spread is None else max(REL, 2 * spread.get(k, 0.0))
        assert float(diff.max()) <= bound * top, (k, float(diff.max()), top)


def expected_block(shape, spec, mesh_shape):
    sizes = dict(zip(AXES, mesh_shape))
    out = []
    for d, n in enumerate(shape):
        ax = spec[d] if d < len(spec) else None
        axes = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        ways = int(np.prod([sizes[a] for a in axes]))
        assert n % ways == 0
        out.append(n // ways)
    return tuple(out)


def pruned_specs(arch, mesh_shape, heads=None):
    from repro_torch.distributed.sharding import param_pspecs, prune_pspecs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.tree_util import leaves_with_path

    params = init(arch, heads=heads)[1]
    mesh = Mesh(mesh_shape, AXES, np.empty(mesh_shape, dtype=object))
    return {k: tuple(s) for k, s in leaves_with_path(prune_pspecs(
        param_pspecs(params), params, mesh))}, params


def assert_equals_one_process(ranks, name, arch, md, heads=None,
                              first=False):
    """The placed run `name`: metrics equal on every rank, and the
    one-process step's at the limits above; its state after the last
    step, or (`first`) after the first one. An entry whose first gradient
    is rounding noise (below eps) takes a first AdamW update of up to lr
    either way; in the deeper or odder layouts (`first`) those entries
    move the second step's gradients by more than REL of a leaf, while
    the metrics of every step still agree. xlstm's moments are held to
    `moment_spread`'s band: the gradient of the mLSTM's input-gate bias
    is near rounding noise (a shift of every log input gate of a head
    shifts the stabilizer m with it and cancels, unless exp(-m) is the
    normaliser), and one ulp of weight noise moves its moments by up to
    9e-2 of their largest entry in the one-process step alone; the
    metrics and parameters keep their limits."""
    got = ranks[0][name]
    for r in range(1, WORLD):  # the metrics are equal on every rank
        assert ranks[r][name]["rows"] == got["rows"]
    after = []
    p, o, rows = one_process(arch, md, batches(init(arch)[0], STEPS),
                             heads=heads,
                             each=lambda p, o: after.append((p, o)))
    for (l1, g1), (l2, g2) in zip(got["rows"], rows):
        assert abs(l1 / l2 - 1) <= REL and abs(g1 / g2 - 1) <= REL
    spread = moment_spread(arch, heads) \
        if smoke(arch).pattern == "xlstm" else None
    if first:
        assert_states_close(got["mids"][0], after[0], md, spread=spread)
    else:
        assert_states_close(got["state"], (p, o), md, spread=spread)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_placed_steps_equal_the_one_process_step(spawn, shape, case):
    assert_equals_one_process(spawn.ranks, key(shape, *case), *case)


def reference_layout(state, arch, dtype="float32"):
    """A (params, AdamWState) tree of the port, or an AdamWState, in the
    reference's layout (blocks stacked under `pos<i>`), as the
    reference's runs are saved."""
    from repro_torch.models import lm
    from repro_torch.optim import AdamWState

    cfg = smoke(arch, dtype)
    if isinstance(state, AdamWState):
        return AdamWState(state.step, lm.to_reference_layout(state.mu, cfg),
                          lm.to_reference_layout(state.nu, cfg))
    p, o = state
    return lm.to_reference_layout(p, cfg), reference_layout(o, arch, dtype)


def code_flips(got_opts, want_opts):
    """param path -> the entries whose int8 mu or nu code differs between
    two runs' AdamW states after any of the steps given."""
    from repro_torch.tree_util import leaves_with_path

    out = {}
    for go, wo in zip(got_opts, want_opts):
        g = dict(leaves_with_path(go))
        for k, w in leaves_with_path(wo):
            if k.endswith("/codes"):
                path = k.split("/", 1)[1][:-len("/codes")]
                out[path] = out.get(path, False) | (g[k] != w)
    return out


def assert_equals_the_reference(spawn, shape, case):
    """The placed step against the reference's own step over the same
    mesh (GSPMD over four forced host devices, `reference_main`), from
    the same weights and batches, at the limits of the one-process
    comparison."""
    arch, md = case
    got = spawn.ranks[0][key(shape, arch, md)]
    want = spawn.reference[key(shape, arch, md)]
    assert len(got["rows"]) == len(want["rows"]) == STEPS
    for (l1, g1), (l2, g2) in zip(got["rows"], want["rows"]):
        assert abs(l1 / l2 - 1) <= REL and abs(g1 / g2 - 1) <= REL
    flips = code_flips([reference_layout(o, arch) for o in got["mids"]],
                       want["opts"][:-1])
    assert_states_close(reference_layout(got["state"], arch), want["state"],
                        md, [o.mu for o in want["opts"]], flips)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
@pytest.mark.parametrize("shape", REF_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_placed_steps_equal_the_reference_gspmd_step(spawn, shape, case):
    assert_equals_the_reference(spawn, shape, case)


@pytest.mark.parametrize("shape", REF_MOE_MESHES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_placed_moe_equals_the_reference_gspmd_step(spawn, shape):
    """qwen3-moe over a split batch against the reference's GSPMD step,
    whose routing is the whole microbatch's: the aux loss, the capacity
    and each pair's position in its expert."""
    assert_equals_the_reference(spawn, shape, MOE)


def bf16_spacing(x: torch.Tensor) -> torch.Tensor:
    """The distance from |x| to the next bfloat16 above it."""
    e = torch.floor(torch.log2(x.double().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("shape", REF_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_placed_bf16_step_against_the_reference_gspmd_step(spawn, shape):
    """bfloat16 parameters (qwen2-7b's smoke config, f32 moments): every
    gradient the ranks reduce is bfloat16, the parameters' dtype (the sum
    rounds to it before the f32 accumulator), and the placed step is the
    reference's GSPMD step within bfloat16's rounding. The loss and grad
    norm within BF16_EPS relative; mu within 4 BF16_EPS and nu (a square)
    within 8 BF16_EPS of each leaf's largest entry (the gradients pass
    through a few bf16 roundings each way). Parameters: every entry
    within 2 lr a step (1 % more: the second step's bias-corrected ratio
    may exceed 1 by 0.14 %) plus two bf16 spacings, the most two runs of
    STEPS updates can differ; and 99 % of the entries whose gradient
    exceeds BF16_EPS of that step's largest entry at every step within
    two bf16 spacings (each update may round the other way) plus
    8 BF16_EPS of the updates (lr times m/sqrt(v), whose error is mu's
    plus half nu's). The rest are noise: a gradient below bf16's
    resolution of the step's largest, or the key biases' (softmax ignores
    q . bk: their gradient is rounding noise at any size), which AdamW
    scales to +-lr with a sign unrelated between the runs; and where m
    changes sign between the steps m/sqrt(v) divides a difference of
    nearly equal terms."""
    from repro_torch.tree_util import leaves_with_path, map_with_path

    arch, md = BF16
    k = key(shape, arch, md) + "/bf16"
    for r in range(WORLD):
        acc = spawn.ranks[r][k]["accumulator"]
        assert acc and {dt for _, _, dt in acc} == {"torch.bfloat16"}
    got, want = spawn.ranks[0][k], spawn.reference[k]
    assert len(got["rows"]) == len(want["rows"]) == STEPS
    for (l1, g1), (l2, g2) in zip(got["rows"], want["rows"]):
        assert abs(l1 / l2 - 1) <= BF16_EPS and abs(g1 / g2 - 1) <= BF16_EPS
    g = dict(leaves_with_path(reference_layout(got["state"], arch,
                                               "bfloat16")))
    w = dict(leaves_with_path(want["state"]))
    assert g.keys() == w.keys()
    grads = {}  # param path -> 0.1 x its gradient at each step
    for o in want["opts"]:
        map_with_path(lambda p, _, m: grads.setdefault(p, []).append(m),
                      want["state"][0], o.mu)
    for p in grads:
        ms = grads[p]
        grads[p] = [ms[0]] + [m - 0.9 * q for q, m in zip(ms, ms[1:])]
    tops = [max(float(ms[i].abs().max()) for ms in grads.values())
            for i in range(STEPS)]  # each step's largest entry
    n_near = n_resolved = 0
    for name in w:
        a, b = g[name], w[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        diff = (a.double() - b.double()).abs()
        if name.startswith("0/"):
            resolved = torch.stack([
                m.abs() > BF16_EPS * top for m, top
                in zip(grads[name[2:]], tops)]).all(0)
            resolved &= not name.endswith("/bk")
            ceiling = 2 * bf16_spacing(b) + 2 * STEPS * LR * 1.01
            near = 2 * bf16_spacing(b) + 8 * BF16_EPS * STEPS * LR
            assert bool((diff <= ceiling).all()), name
            n_near += int((diff <= near)[resolved].sum())
            n_resolved += int(resolved.sum())
            continue
        if name == "1/step":
            assert torch.equal(a, b)
            continue
        n = 4 if name.startswith("1/mu/") else 8
        assert float(diff.max()) <= n * BF16_EPS * float(b.abs().max()), \
            name
    assert n_near >= 0.99 * n_resolved > 0, (n_near, n_resolved)


def assert_blocks(local, specs, params, mesh_shape):
    """Each local shape of a (params, opt state) tree is the block of its
    spec: a parameter's and its moments' (int8 codes) the parameter's
    spec, int8 row scales that spec without its last axis."""
    from repro_torch.tree_util import leaves_with_path

    full = dict(leaves_with_path(params))
    assert len(local) > len(full)
    for k, shape in local.items():
        if k == "1/step":
            assert shape == ()
            continue
        path = k[2:] if k.startswith("0/") else k.split("/", 2)[2]
        spec = None
        if path.endswith("/scale"):
            path = path[:-len("/scale")]
            spec = specs[path][:-1] + (None,)
        elif path.endswith("/codes"):
            path = path[:-len("/codes")]
        whole = tuple(full[path].shape)
        if spec is not None:
            whole = whole[:-1] + (1,)
        spec = specs[path] if spec is None else spec
        assert shape == expected_block(whole, spec, mesh_shape), k


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_each_rank_holds_its_blocks(spawn, shape):
    """Parameters, moments (int8 codes and row scales) and the gradient
    accumulator: each rank's local shape is the block of its pruned
    spec, and every microbatch's gradient came out of autograd on the
    parameter's block (never the whole tensor) and was reduced onto the
    accumulator's."""
    from repro_torch.tree_util import leaves_with_path

    ranks = spawn.ranks
    for arch, md in CASES:
        want, params = pruned_specs(arch, shape)
        full = dict(leaves_with_path(params))
        paths = list(full)
        for r in range(WORLD):
            got = ranks[r][key(shape, arch, md)]
            assert got["specs"] == want
            assert_blocks(got["local"], want, params, shape)
            acc = got["accumulator"]
            assert len(acc) == len(paths) * ACCUM * STEPS
            for i, (g, b, dt) in enumerate(acc):
                assert dt == "torch.float32"
                path = paths[i % len(paths)]
                block = expected_block(tuple(full[path].shape), want[path],
                                       shape)
                assert g == b == block, path


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_a_whole_accumulator_gives_the_same_step(spawn, shape):
    """`grad_pspecs=None`, as in the reference: the accumulator is whole
    on every rank (each block's gradient gathered and summed over the
    batch a microbatch), the update still runs on the parameters'
    blocks, and the step is the one-process step."""
    from repro_torch.tree_util import leaves_with_path

    ranks = spawn.ranks
    arch, md = CASES[0]
    got = ranks[0][key(shape, arch, md) + "/whole"]
    whole = [tuple(t.shape) for _, t in leaves_with_path(init(arch)[1])]
    assert [b for _, b, _ in got["accumulator"]] \
        == whole * (ACCUM * STEPS)
    p, o, rows = one_process(arch, md, batches(init(arch)[0], STEPS))
    for (l1, g1), (l2, g2) in zip(got["rows"], rows):
        assert abs(l1 / l2 - 1) <= REL and abs(g1 / g2 - 1) <= REL
    assert_states_close(got["state"], (p, o), md)


def test_moe_on_a_model_mesh_equals_one_process(spawn):
    """qwen3-moe over (1, 4): expert parallelism, one expert a rank."""
    assert_equals_one_process(spawn.ranks, key((1, 4), *MOE), *MOE)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_over_a_split_batch_equals_one_process(spawn, shape):
    """qwen3-moe over a batch split 4 and 2 ways: the routing is the whole
    microbatch's (aux loss, capacity, positions), and the aux term's
    gradient counts once under the ranks' loss weights."""
    assert_equals_one_process(spawn.ranks, key(shape, *MOE), *MOE)


@pytest.mark.parametrize("case", FAMILIES,
                         ids=lambda c: f"{c[0]}-{c[2][0]}x{c[2][1]}")
def test_placed_families_equal_the_one_process_step(spawn, case):
    """whisper (its encoder, and its decoder's cross-attention, split over
    `model`) on (2, 2); jamba (Mamba split by its inner channels,
    attention and MoE split) and xlstm (mLSTM and sLSTM split by their
    heads) on (2, 2) and (1, 4)."""
    arch, md, shape = case
    assert_equals_one_process(spawn.ranks, key(shape, arch, md), arch, md,
                              first=True)


def test_a_mixer_whose_heads_model_does_not_divide_computes_whole(spawn):
    """xlstm's smoke config with 2 heads on (1, 4): `prune_pspecs` keeps
    `W` split (two gate-heads a rank) and `out_proj` split inside a head
    and replicates `R`; `model` does not divide the heads, so both cells
    run every head on every rank, on weights gathered over `model`, and
    the step equals the one-process step."""
    name, shape, h, kv, arch = MIXER_WHOLE
    specs = pruned_specs(arch, shape, (h, kv))[0]
    assert "model" in specs["blocks/1/slstm/W"]
    assert "model" in specs["blocks/0/mlstm/out_proj"]
    assert "model" not in specs["blocks/1/slstm/R"]
    for r in range(WORLD):
        assert spawn.ranks[r][name]["cells"] == [h]
    assert_equals_one_process(spawn.ranks, name, arch, "float32", (h, kv),
                              first=True)


@pytest.mark.parametrize("case", INSIDE_HEADS, ids=lambda c: c[0])
def test_splits_inside_a_head(spawn, case):
    """`prune_pspecs` keeps a `model` split of wq, wk or wv that falls
    inside a head (qwen2-7b's 28 heads on the production mesh's 16 do
    this). Two query heads on four `model` ranks: the attention computes
    on weights gathered over `model`, every head on every rank. Six query
    heads over three KV heads on two: each rank its three query heads,
    their KV heads gathered, one a query head. Both equal the
    one-process step."""
    name, shape, h, kv = case
    arch, md = CASES[0]
    specs = pruned_specs(arch, shape, (h, kv))[0]
    assert "model" in specs["blocks/0/attn/wq"]
    assert "model" in specs["blocks/0/attn/wk"]
    tp = shape[1]
    for r in range(WORLD):
        want = h if h % tp else h // tp
        assert spawn.ranks[r][name]["heads"] == [want]
    assert_equals_one_process(spawn.ranks, name, arch, md, (h, kv),
                              first=True)


def replicated_flops(cfg, tokens: int, tp: int) -> int:
    """The matmul FLOPs a `model` rank computes beyond its 1/tp share in
    `tokens` tokens of training (forward, the checkpoint's recompute and
    the two backward products: 4 x the forward): the KV heads it keeps
    in an attention layer where `model` does not divide them (each
    rank's query heads read a whole KV head), and the router of every
    MoE layer (every rank routes every token). The Mamba and xLSTM
    mixers add nothing: x_proj's contraction, the scan and the sLSTM's
    `R` split with the channels and heads."""
    from repro_torch.models import lm

    d, hd, H, Hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    extra = 0.0
    for l in range(cfg.n_layers):
        if Hkv % tp and lm._layer_kind(cfg, l) == "attn":
            kept = len({i // (H // Hkv) for i in range(H // tp)})
            extra += 2 * d * hd * (kept - Hkv / tp)  # wk and wv
        if lm._layer_has_moe(cfg, l):
            extra += d * cfg.moe.n_experts * (1 - 1 / tp)
    return int(4 * 2 * tokens * extra)


@pytest.mark.parametrize("case", (CASES[0], MOE) + SPLIT,
                         ids=lambda c: c[0])
def test_the_model_axis_splits_the_compute(spawn, case):
    """One step at (1, 4): each rank's matmul FLOPs (`FlopCounterMode`:
    attention projections and kernel 6's plain version, FFN, experts,
    head; Mamba's projections and scan, the xLSTM cells' projections,
    contractions and recurrent products) are at least a quarter of the
    one-process step's and at most a quarter plus the parts computed
    replicated (`replicated_flops`, none in a Mamba or xLSTM mixer);
    every flash call took H / 4 query heads, every scan d_inner / 4
    channels and every xLSTM cell H / 4 heads."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models.ssm import ssm_dims

    arch, md = case
    cfg = init(arch)[0]
    with FlopCounterMode(display=False) as fc:
        one_process(arch, md, batches(cfg, 1))
    full = fc.get_total_flops()
    extra = replicated_flops(cfg, ACCUM * MB * SEQ, 4)
    attn = cfg.pattern != "xlstm"
    for r in range(WORLD):
        got = spawn.ranks[r]["flops/" + arch]
        assert full <= 4 * got["flops"] <= full + 4 * extra, (
            r, got["flops"], full, extra)
        assert got["heads"] == ([cfg.n_heads // 4] if attn else [])
        assert got["channels"] == ([ssm_dims(cfg)[0] // 4]
                                   if cfg.pattern == "jamba" else [])
        assert got["cells"] == ([cfg.n_heads // 4]
                                if cfg.pattern == "xlstm" else [])


# Each mixer's calls of Placement's operators over `model`, a call of the
# mixer at (1, 4): the input and the output (`copy_to_model`,
# `reduce_from_model`); Mamba's `in_proj` gathered, its x_proj product
# summed; mLSTM's replicated gate weights, gate biases and norm scale cut
# after `copy_to_model`; the sLSTM's gate-major `W` gathered, `b` and its
# norm scale cut after `copy_to_model`.
MIXER_CALLS = {
    "mamba": {"copy_to_model": 1, "gather_model": 1, "sum_over_model": 1,
              "reduce_from_model": 1},
    "mlstm": {"copy_to_model": 6, "reduce_from_model": 1},
    "slstm": {"copy_to_model": 3, "gather_model": 1,
              "reduce_from_model": 1},
}


@pytest.mark.parametrize("case", SPLIT, ids=lambda c: c[0])
def test_model_side_calls_do_not_grow_with_the_sequence(spawn, case):
    """One step at (1, 4) at two sequence lengths: each Mamba and xLSTM
    mixer call makes the same model-side calls (`MIXER_CALLS`), and the
    step the same collectives (all-reduces, all-gathers,
    reduce-scatters), so none runs inside the sLSTM's time loop or the
    Mamba scan's chunk loop (one there would cost a collective a
    position or a chunk)."""
    arch, _ = case
    for r in range(WORLD):
        runs = [spawn.ranks[r][f"guard/{arch}/{seq}"] for seq in GUARD_SEQS]
        assert runs[0]["step"] == runs[1]["step"] and runs[0]["step"]
        for run in runs:
            kinds = {k: v for k, v in run.items() if k in MIXER_CALLS}
            assert kinds, run
            for kind, n in kinds.items():
                calls = n.pop("calls")
                assert {op: c / calls for op, c in n.items()} \
                    == MIXER_CALLS[kind], (kind, n, calls)


def gathered_bound(arch, shape) -> tuple:
    """(the bound, the whole tree) in bytes of the parameters gathered
    over `data` (their `model` blocks): the largest period of blocks (a
    whisper encoder layer is a period) plus every leaf outside the
    blocks (embedding, head, norms, position tables)."""
    from repro_torch.models import lm
    from repro_torch.tree_util import leaves_with_path

    cfg, params = init(arch)
    specs = pruned_specs(arch, shape)[0]

    def size(path, t):
        ways = shape[1] if "model" in specs[path] else 1
        return t.numel() * t.element_size() // ways

    per = {"blocks": lm.period(cfg), "enc_blocks": 1}
    periods, top = {}, 0
    for path, t in leaves_with_path(params):
        part = path.split("/")
        if part[0] in per:
            at = (part[0], int(part[1]) // per[part[0]])
            periods[at] = periods.get(at, 0) + size(path, t)
        else:
            top += size(path, t)
    return max(periods.values()) + top, sum(periods.values()) + top


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_gathered_parameters_stay_within_a_period(spawn, shape):
    """`gather_on_use` counted on every rank: the gathered parameter bytes
    alive at once never exceed one period's plus the leaves outside the
    blocks, which is less than the whole tree (remat: backward gathers
    each period again); at (1, 4) nothing is gathered over `data`."""
    runs = [(key(shape, *c), c[0]) for c in CASES + (MOE,)]
    runs += [(key(shape, arch, md), arch) for arch, md, mesh in FAMILIES
             if mesh == shape]
    for name, arch in runs:
        bound, tree = gathered_bound(arch, shape)
        assert bound < tree
        for r in range(WORLD):
            peak = spawn.ranks[r][name]["peak"]
            assert peak <= bound, (name, r, peak, bound)
            assert (peak == 0) == (shape[0] == 1), (name, r, peak)


def _resumed_one_process(ckpt):
    from repro_torch.launch.train import restore_state
    from repro_torch.optim import AdamWState

    arch, md = CASES[0]
    cfg, like = init(arch)
    (p, o), extra = restore_state(
        ckpt, like, AdamWState(torch.zeros((), dtype=torch.int32), like,
                               like), cfg, "cpu")
    assert extra == {"train_step": STEPS}
    return one_process(arch, md, batches(cfg, 2 * STEPS)[STEPS:], p, o)


@pytest.mark.parametrize("where", ["4x1", "one_process"])
def test_a_2x2_checkpoint_resumes_elsewhere(spawn, where):
    ranks, ckpt = spawn.ranks, spawn.ckpt
    want = ranks[0]["uninterrupted"]
    if where == "4x1":
        got = ranks[0]["resumed"]
        assert got["extra"] == {"train_step": STEPS}
        rows, state = got["rows"], got["state"]
        specs, params = pruned_specs(CASES[0][0], RESUME_MESH)
        for r in range(WORLD):  # each rank keeps its block of (4, 1)
            mine = ranks[r]["resumed"]
            assert mine["rows"] == rows and mine["specs"] == specs
            assert_blocks(mine["local"], specs, params, RESUME_MESH)
    else:
        p, o, rows = _resumed_one_process(ckpt)
        state = (p, o)
    for (l1, g1), (l2, g2) in zip(rows, want["rows"]):
        assert abs(l1 / l2 - 1) <= REL and abs(g1 / g2 - 1) <= REL
    assert_states_close(state, want["state"], CASES[0][1])


def test_restore_checkpoint_keeps_each_ranks_block(spawn):
    """`restore_checkpoint(shardings=)` in the file's stacked layout: each
    rank holds the block of the pruned stacked spec, and the blocks make
    the tensors a host restore reads."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.tree_util import leaves_with_path

    ranks, ckpt = spawn.ranks, spawn.ckpt
    host, _ = restore_checkpoint(ckpt)
    for r in range(WORLD):
        got = ranks[r]["restored_blocks"]
        specs = got["specs"]
        for k, local in got["local"].items():
            part, rest = k.split("/", 1)
            if part == "0":
                assert local == expected_block(tuple(host[k].shape),
                                               specs[rest], RESUME_MESH), k
    state = dict(leaves_with_path(ranks[0]["restored_blocks"]["state"]))
    assert state.keys() == host.keys()
    for k, t in host.items():
        assert torch.equal(state[k], t), k


def test_the_reference_restores_a_placed_checkpoint(spawn):
    from repro.checkpoint import restore_checkpoint as j_restore
    from repro_torch.checkpoint import restore_checkpoint

    ckpt = spawn.ckpt
    ref, extra = j_restore(ckpt)
    port, _ = restore_checkpoint(ckpt)
    assert extra == {"train_step": STEPS} and ref.keys() == port.keys()
    for k, t in port.items():
        np.testing.assert_array_equal(np.asarray(ref[k]), t.numpy())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _torchrun(args, tmp):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc-per-node", "2", "--rdzv-backend", "c10d",
           "--rdzv-endpoint", f"localhost:{_free_port()}",
           "-m", "repro_torch.launch.train"] + args
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=240, cwd=tmp)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_the_launcher_trains_over_two_ranks_under_torchrun(tmp_path):
    """torchrun --nproc-per-node 2: rank 0 alone prints the step lines,
    the losses are the one-process launcher's, and --resume picks up the
    placed run's checkpoint; the checkpoints agree within 1e-5."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.launch import train as ttrain

    base = ["--arch", "qwen2-7b", "--smoke", "--device", "cpu",
            "--ckpt-every", "2", "--resume"]
    ranked = tmp_path / "ranked"
    first = _torchrun(base + ["--steps", "2", "--ckpt-dir", str(ranked)],
                      tmp_path)
    again = _torchrun(base + ["--steps", "4", "--ckpt-dir", str(ranked)],
                      tmp_path)
    lines = [l for l in (first + again).splitlines()
             if l.startswith("step ")]
    assert [int(l.split()[1]) for l in lines] == [0, 1, 2, 3]
    assert "resumed at step 2 (data step 4)" in again
    assert "resumed" not in first

    alone = tmp_path / "alone"
    log = []
    ttrain.main(base + ["--steps", "4", "--ckpt-dir", str(alone)], log=log)
    for line, row in zip(lines, log):
        loss = float(line.split()[3])
        assert abs(loss - row["loss"]) <= 5e-5 + REL * abs(row["loss"])
    got, _ = restore_checkpoint(ranked)
    want, _ = restore_checkpoint(alone)
    assert got.keys() == want.keys()
    for k, t in want.items():  # assert_states_close's rule
        gap = (got[k].double() - t.double()).abs()
        if k.startswith("0/"):
            steady = want["1/mu/" + k[2:]].abs() / 0.1 > 100 * EPS
            assert float(gap.max()) <= 2 * LR, k
            assert float(torch.where(steady, gap, 0.0).max()) <= REL, k
        else:
            assert float(gap.max()) <= REL * float(t.double().abs().max()), k


# ---------------------------------------------------------------------------
# Megatron sequence parallelism, and the dry-run against the ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", SP_ARCHS)
@pytest.mark.parametrize("shape", SP_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sequence_parallel_steps_equal_the_one_process_step(spawn, shape,
                                                            arch):
    """With `act_pspec` naming `model` on the sequence, the residual
    stream between blocks is each rank's quarter (1, 4) or half (2, 2) of
    the sequence; the mixers, MoE and the FFNs gather it and scatter
    their outputs back. One step: its metrics and state are the
    one-process step's at the limits above."""
    assert_equals_one_process(spawn.ranks, key(shape, arch, "float32")
                              + "/sp", arch, "float32", first=True)


def test_a_whole_mixer_under_sequence_parallelism(spawn):
    """Two query heads on (1, 4) with sequence parallelism: every rank
    runs both heads on the gathered sequence and keeps its block of the
    output (no sum over `model`); one step equals the one-process
    step."""
    name, shape, h, kv = INSIDE_HEADS[0]
    for r in range(WORLD):
        assert spawn.ranks[r][name + "/sp"]["heads"] == [h]
    assert_equals_one_process(spawn.ranks, name + "/sp", CASES[0][0],
                              "float32", (h, kv), first=True)


def _activation_bytes() -> float:
    """Bytes of qwen2-7b's (MB, SEQ, d) f32 residual at one rank of
    (1, 4)."""
    return MB * SEQ * smoke(CASES[0][0]).d_model * 4.0


def test_sequence_parallelism_gathers_and_scatters_in_place_of_all_reduces(
        spawn):
    """qwen2-7b at (1, 4), remat off (a recompute stops once it has what
    backward saved, and where depends on the operators): without
    sequence parallelism every collective
    over the residual's size is an all-reduce (the embedding's, each
    mixer's and FFN's output and, backward, their inputs' and the head's);
    with it none is, and the all-gathers and reduce-scatters of that size
    take their place with the same link bytes (an all-reduce's 2(N-1)/N
    is a gather's (N-1)/N and a scatter's). The all-reduces left are the
    norms' parameters' gradients (d values) and the loss's statistics."""
    from repro_torch.distributed.hlo_counters import link_bytes

    act = _activation_bytes()
    for r in range(WORLD):
        off = spawn.ranks[r]["recorded/False/False"]["colls"]
        on = spawn.ranks[r]["recorded/True/False"]["colls"]

        def link(colls, kinds, size):
            return sum(link_bytes(k, o, i, n) for k, o, i, n, _ in colls
                       if k in kinds and max(o, i) == size)

        assert link(off, ("all-reduce",), act) > 0
        assert link(on, ("all-reduce",), act) == 0
        assert not [c for c in off if c[0] in ("all-gather", "reduce-scatter")
                    and max(c[1], c[2]) == act]
        assert link(on, ("all-gather", "reduce-scatter"), act) == \
            link(off, ("all-reduce",), act)
        assert all(max(o, i) < act for k, o, i, _, _ in on
                   if k == "all-reduce")


def test_a_sequence_parallel_period_keeps_a_quarter_of_the_residual(spawn):
    """Under remat each period keeps its input for the backward: at (1, 4)
    with sequence parallelism that is this rank's quarter of the
    sequence."""
    for r in range(WORLD):
        off = spawn.ranks[r]["recorded/False/True"]["saved"]
        on = spawn.ranks[r]["recorded/True/True"]["saved"]
        assert len(on) == len(off) > 0
        assert all(a == (MB, SEQ, smoke(CASES[0][0]).d_model) for a in off)
        assert all(np.prod(b) * 4 == np.prod(a) and b[1] * 4 == a[1]
                   for a, b in zip(off, on))


@pytest.mark.parametrize("arch", DRY)
def test_the_fake_mesh_counts_what_the_ranks_run(spawn, arch, tmp_path):
    """`launch.dryrun.run_cell` at (2, 2), rank 0 of a fake process group
    on tensors without data, counts the FLOPs, device-memory bytes,
    collectives and link bytes that the recorder counts on the real gloo
    ranks running the same cell's step (each kernel counted by its cost
    both ways)."""
    from repro_torch.launch import dryrun

    spec, shape = dry_cell(arch)
    r = dryrun.run_cell(spec, shape, False, tmp_path, mesh=((2, 2), AXES))
    got = spawn.ranks[0]["dry/" + arch]
    assert r["flops_per_device"] == got["flops"]
    assert r["dot_flops_per_device"] == got["dot_flops"]
    assert r["bytes_per_device"] == got["bytes"]
    assert r["collectives"]["counts"] == got["counts"]
    assert r["collectives"]["per_device_link_bytes"] == got["link"]
