"""Multi-pod dry-run: trace every cell's step at rank 0 of a fake 256- or
512-rank mesh.

The counterpart of `repro/launch/dryrun.py`. The reference lowers and
compiles each (arch x shape x mesh) cell's jitted step on 512 fake host
devices and reads the post-SPMD HLO. The port runs eagerly, so it runs
the placed train step itself, at rank 0 of a `fake` process group
(`launch.mesh.fake_mesh`: collectives move nothing), on tensors without
data (`FakeTensorMode`, on the CPU) placed by the parameters' pruned
specs, and records what that rank runs (`distributed.hlo_counters`): the
card's route, each hand-written kernel counted by its cost. For each cell
this shows, without the cards:

  - the placement is coherent (every rank's blocks, collectives and
    shapes line up: the step runs),
  - the per-rank memory fits (the peak of live tensor bytes at rank 0),
  - and the roofline's inputs: per-rank FLOPs, device-memory bytes and
    collective link bytes, loop-aware (the time loops and the microbatch
    loop counted by their trip counts), against `ChipSpec`'s H100 rates.

The train cells trace the placed train step, its microbatch loop
extrapolated from steps of one and two microbatches. The prefill and
decode cells trace one call of the placed serve step
(`launch.steps.make_prefill_step` / `make_decode_step`): parameters by
their specs, the batch over the data axes where it divides them (else
whole), the cache by `cache_pspecs` with its positions over `model`
(flash decoding). A decode cell is traced at pos = seq_len - 1, the
cache full: every `model` rank's block of positions is full, the
reference's traced worst case (its step takes `pos` as data and reads
the whole cache at any position). Its `alias_size_in_bytes` is the
cache, which the step updates in place where the reference donates it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xlstm-350m \\
      --shape train_4k --mesh both --out experiments/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import (
    ARCH_IDS,
    SHAPES,
    get_arch,
    prefill_input_specs,
    train_input_specs,
)
from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.distributed.hlo_analysis import ChipSpec, RooflineTerms
from repro_torch.distributed.hlo_counters import (
    Recorder,
    Trace,
    analyze,
    extrapolate,
)
from repro_torch.distributed.sharding import (
    Placement,
    ShardingConfig,
    blocks,
    from_blocks,
    named,
    param_pspecs,
    place,
)
from repro_torch.launch.mesh import Mesh, fake_mesh
from repro_torch.launch.steps import (
    make_decode_step,
    make_prefill_step,
    make_train_step,
    opt_state_pspecs,
    serve_pspecs,
)
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree_util import tree_leaves


def _model_flops(spec: ArchSpec, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference), N = active params."""
    n = active_params(spec.model)
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def active_params(cfg: ModelConfig) -> float:
    """Params touched per token: MoE counts top_k experts, not all."""
    total = cfg.n_params()
    if cfg.moe is None:
        return float(total)
    m = cfg.moe
    dffe = m.d_ff_expert or cfg.d_ff
    glu = cfg.ffn_type in ("swiglu", "geglu")
    per_expert = cfg.d_model * dffe * (3 if glu else 2)
    n_moe_layers = sum(
        1
        for l in range(cfg.n_layers)
        if l % m.every_n_layers == m.every_n_layers - 1
    )
    inactive = n_moe_layers * (m.n_experts - m.top_k) * per_expert
    return float(total - inactive)


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------
def _act_pspec(multi_pod: bool):
    dp = ("pod", "data") if multi_pod else "data"
    return (dp, "model", None)  # Megatron-SP: residuals sharded over seq


def production_mesh(multi_pod: bool) -> Tuple[Tuple[int, ...],
                                              Tuple[str, ...]]:
    """(shape, axes) of `launch.mesh.make_production_mesh`."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def mesh_name(shape) -> str:
    return "x".join(str(s) for s in shape)


def build_cell(spec: ArchSpec, shape: ShapeSpec, mesh: Mesh,
               device="cpu"):
    """(the cell's placed step, its arguments, the microbatches a step
    accumulates) on `mesh`: a fake one under a `FakeTensorMode` for the
    dry-run, or a real one (the parameters drawn whole on `device`, then
    placed by their pruned specs). A train cell's arguments are (params,
    opt state, one microbatch of zero tokens), the reference's train
    cell: its `act_pspec` (Megatron-SP; the sequence left whole under
    `no_tp`), one MoE dispatch group a data-parallel rank, the
    microbatch at least one sequence a data-parallel rank, the arch's
    moment dtype. A prefill or decode cell (`_serve_cell`) accumulates
    one."""
    if shape.kind != "train":
        return _serve_cell(spec, shape, mesh, device)
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    dp_total = int(np.prod([sizes[a] for a in ("pod", "data")
                            if a in sizes]))
    scfg = ShardingConfig(tp_axis=None) if spec.no_tp else ShardingConfig()
    ap = _act_pspec("pod" in sizes)
    if spec.no_tp:
        ap = (ap[0], None, None)  # no seq/TP sharding for small models
    model = dataclasses.replace(spec.model, act_pspec=ap)
    if model.moe is not None:
        # per-rank capacity: one dispatch group per DP shard
        model = dataclasses.replace(model, moe=dataclasses.replace(
            model.moe, dispatch_groups=dp_total))
    mb = max(spec.microbatch.get(shape.name, 32), dp_total)
    accum = max(shape.global_batch // mb, 1)
    micro = train_input_specs(model, shape, mb)
    batch = {k: torch.zeros((1,) + tuple(v.shape), dtype=v.dtype,
                            device=mesh.device) for k, v in micro.items()}
    params = lm.init_params(model, torch.Generator(device=device)
                            .manual_seed(0), device=device)
    pspec = param_pspecs(params, scfg, mesh)
    p = place(params, named(mesh, pspec))
    del params
    o = from_blocks(adamw_init(blocks(p), spec.moment_dtype),
                    named(mesh, opt_state_pspecs(pspec, spec.moment_dtype)))
    step = make_train_step(model, AdamWConfig(lr=1e-4, weight_decay=0.1),
                           moment_dtype=spec.moment_dtype,
                           grad_pspecs=pspec, mesh=mesh)
    return step, (p, o, batch), accum


def _serve_cell(spec: ArchSpec, shape: ShapeSpec, mesh: Mesh, device):
    """The reference's prefill or decode cell (neither `act_pspec` nor
    MoE dispatch groups set): (the placed serve step, its arguments, 1).
    Prefill takes (params, a batch of zero tokens, frames or patches);
    decode (params, a zero cache placed by its pruned specs, zero tokens,
    pos = seq_len - 1)."""
    model = spec.model
    B, S = shape.global_batch, shape.seq_len
    scfg = ShardingConfig(tp_axis=None) if spec.no_tp else ShardingConfig()
    params = lm.init_params(model, torch.Generator(device=device)
                            .manual_seed(0), device=device)
    p = place(params, named(mesh, param_pspecs(params, scfg, mesh)))
    del params
    sp = serve_pspecs(model, B, S, mesh, scfg)
    if shape.kind == "prefill":
        batch = {k: torch.zeros(tuple(v.shape), dtype=v.dtype,
                                device=mesh.device)
                 for k, v in prefill_input_specs(model, shape).items()}
        return make_prefill_step(model, S, mesh, sp.cache), (p, batch), 1
    cache = from_blocks(lm.init_cache(model, B, S, mesh.device, Placement(
        mesh, None, cache=sp.cache)), named(mesh, sp.cache))
    tokens = torch.zeros((B, 1), dtype=torch.int32, device=mesh.device)
    return (make_decode_step(model, mesh, sp.cache),
            (p, cache, tokens, S - 1), 1)


def _bytes(tree) -> int:
    return int(sum(getattr(t, "_local_tensor", t).numel()
                   * t.element_size() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor)))


def trace_cell(spec: ArchSpec, shape: ShapeSpec, mesh_shape, axes
               ) -> Tuple[Trace, dict]:
    """Rank 0's step of the cell on a fake mesh of `mesh_shape`: the trace
    of the whole step (a train step's microbatch loop extrapolated from
    steps of one and two microbatches; one call of a serve step) and its
    memory at rank 0 in the reference's `memory_analysis` keys."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with fake_mesh(mesh_shape, axes) as mesh, FakeTensorMode():
        if shape.kind != "train":
            return _trace_serve(*build_cell(spec, shape, mesh)[:2],
                                shape.kind)
        step, (p, o, one), accum = build_cell(spec, shape, mesh)
        traces, mem = [], {}
        for a in (1, 2):
            batch = {k: v.expand((a,) + tuple(v.shape[1:])).contiguous()
                     for k, v in one.items()}
            with Recorder() as rec:
                rec.hold((p, o, batch))
                out = step(p, o, batch)
            traces.append(rec.trace)
            args = _bytes((p, o, batch))
            state = _bytes((p, o))
            mem = {"argument_size_in_bytes": args,
                   "output_size_in_bytes": _bytes(out),
                   "temp_size_in_bytes": int(rec.trace.peak_bytes) - args,
                   "alias_size_in_bytes": state,
                   "peak_size_in_bytes": int(rec.trace.peak_bytes)}
            del out
    return extrapolate(traces[0], traces[1], 1, 2, accum), mem


def _trace_serve(step, args, kind: str) -> Tuple[Trace, dict]:
    """One call of a serve step, recorded, and its memory: a decode
    step's cache is updated in place (`alias_size_in_bytes`)."""
    with Recorder() as rec:
        rec.hold(args)
        out = step(*args)
    nargs, peak = _bytes(args), int(rec.trace.peak_bytes)
    return rec.trace, {
        "argument_size_in_bytes": nargs,
        "output_size_in_bytes": _bytes(out),
        "temp_size_in_bytes": peak - nargs,
        "alias_size_in_bytes": _bytes(args[1]) if kind == "decode" else 0,
        "peak_size_in_bytes": peak}


def run_cell(spec: ArchSpec, shape: ShapeSpec, multi_pod: bool,
             out_dir: Path, chip: ChipSpec = ChipSpec(),
             mesh: Optional[Tuple[Tuple[int, ...], Tuple[str, ...]]] = None
             ) -> dict:
    """Trace the cell, write its JSON to `out_dir` and return it. `mesh`
    ((shape, axes)) replaces the production mesh `multi_pod` names."""
    mesh_shape, axes = mesh or production_mesh(multi_pod)
    name = mesh_name(mesh_shape)
    cell = f"{spec.arch_id} x {shape.name} x {name}"
    t0 = time.time()
    trace, mem = trace_cell(spec, shape, mesh_shape, axes)
    t_trace = time.time() - t0
    n_dev = int(np.prod(mesh_shape))
    counters = analyze(trace, n_dev)
    terms = RooflineTerms(
        compute_s=counters.flops / chip.peak_flops_bf16,
        memory_s=counters.bytes / chip.hbm_bw,
        collective_s=counters.link_bytes / chip.ici_bw,
        hlo_flops=counters.flops * n_dev,
        hlo_bytes=counters.bytes * n_dev,
        collective_bytes=counters.link_bytes,
        model_flops=_model_flops(spec, shape),
    )
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(lm.param_specs(spec.model)))
    result = {
        "cell": cell,
        "arch": spec.arch_id,
        "shape": shape.name,
        "mesh": name,
        "n_devices": n_dev,
        "ok": True,
        "trace_s": round(t_trace, 1),
        "memory_analysis": mem,
        "fits_hbm": mem["peak_size_in_bytes"] <= chip.hbm_bytes,
        "param_bytes_global": param_bytes,
        "param_bytes_per_device": param_bytes / n_dev,
        "dot_flops_per_device": counters.dot_flops,
        "flops_per_device": counters.flops,
        "bytes_per_device": counters.bytes,
        "kernels": {op.split(".", 1)[1]: trace.calls(op) for op in sorted(
            {r.op for r in trace.records if r.kind == "kernel"})},
        "collectives": {
            "counts": counters.coll_counts,
            "bytes_by_kind": counters.coll_bytes,
            "per_device_link_bytes": counters.link_bytes,
        },
        "roofline": {**terms.as_dict(), "step_time_s": terms.step_time_s},
        "chip": dataclasses.asdict(chip),
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    fname = f"{spec.arch_id}__{shape.name}__{name.replace('x', '_')}.json"
    (out_dir / fname).write_text(json.dumps(result, indent=2))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    out_dir = Path(args.out)

    n_ok = n_skip = n_fail = 0
    for aid in archs:
        spec = get_arch(aid)
        for sname in shapes:
            shape = SHAPES[sname]
            if not spec.runs(sname):
                print(f"SKIP {aid} x {sname}: {spec.skips[sname]}")
                n_skip += 1
                continue
            for mp in meshes:
                tag = "2pod" if mp else "1pod"
                try:
                    r = run_cell(spec, shape, mp, out_dir)
                    rf = r["roofline"]
                    print(
                        f"OK   {aid} x {sname} x {tag}: "
                        f"trace={r['trace_s']}s "
                        f"compute={rf['compute_s']:.3e}s "
                        f"memory={rf['memory_s']:.3e}s "
                        f"coll={rf['collective_s']:.3e}s "
                        f"dom={rf['dominant']} "
                        f"peak={r['memory_analysis']['peak_size_in_bytes'] / 2 ** 30:.2f}GiB",
                        flush=True)
                    n_ok += 1
                except Exception:
                    print(f"FAIL {aid} x {sname} x {tag}:")
                    traceback.print_exc()
                    n_fail += 1
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped (recorded), {n_fail} "
          f"failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
