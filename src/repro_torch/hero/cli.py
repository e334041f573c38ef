"""Console entry points: `hero-search-torch` and `hero-serve-torch`.

Installed via `[project.scripts]` in pyproject.toml; also reachable as
`python -m repro_torch.hero.cli <search|serve> ...`. Both run on the card
unless given `--device cpu`, and raise where there is none.

    hero-search-torch --quick --scenes chair --budgets 1.0,0.85
    hero-serve-torch --quick --scene chair --bits 6 --device cpu

The reports default to `BENCH_search_torch.json` and
`BENCH_serve_torch.json`; checkpoints and artifacts default to paths under
`experiments/`. `--workers N` (N > 1) or `--chaos SEED` runs the sweep's
cells through the elastic orchestrator (`repro_torch.distributed.
orchestrator`): thread, inline or subprocess workers (`--worker-kind`),
the same frontier as one worker. `--workload lm` searches an LM arch's
embed-band and per-layer bits (`--arch`, default qwen2-7b) against the
`roofline-lm` target (any of the ten archs whose LM bundle builds from
tokens alone: whisper and llava need frames or patches and raise the
reference's `KeyError`); an unknown arch id exits with code 2.

    hero-search-torch --quick --workers 2 --worker-kind subprocess --chaos 3
    hero-search-torch --workload lm --arch qwen2-7b --quick --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from repro_torch.kernels.backend import DeviceLike


def _n_devices(device: torch.device) -> int:
    """Devices of the run's kind: the visible cards, or 1 on the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


# ---------------------------------------------------------------------------
# hero-search-torch
# ---------------------------------------------------------------------------
def search_main(argv=None) -> int:
    """Closed-loop multi-scene HERO search: scenes x hardware budgets in,
    a Pareto frontier (+ BENCH_search_torch.json) out."""
    from repro_torch.core.closed_loop import (
        ClosedLoopConfig,
        HeroSearchRun,
        SceneScale,
        bench_report,
    )
    from repro_torch.hero.targets import list_targets
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.workloads import list_workloads

    ap = argparse.ArgumentParser(
        prog="hero-search-torch",
        description="Closed-loop multi-scene HERO quantization search",
    )
    ap.add_argument("--workload", default="nerf",
                    choices=sorted(list_workloads()),
                    help="registered task family the loop searches over: "
                         "'nerf' scenes (default) or 'lm' arch ids")
    ap.add_argument("--scenes", default=None,
                    help="comma-separated cases: procedural scenes for "
                         "--workload nerf (default chair,lego), arch ids "
                         "for --workload lm (default qwen2-7b)")
    ap.add_argument("--arch", default=None,
                    help="shorthand for --scenes with a single LM arch id "
                         "(--workload lm)")
    ap.add_argument("--budgets", default="1.0,0.85",
                    help="latency budgets as fractions of 8-bit latency")
    ap.add_argument("--hardware", default=None,
                    choices=sorted(list_targets()),
                    help="registered hardware target the search optimizes "
                         "for (default: neurex for nerf, roofline-lm for lm)")
    ap.add_argument("--iterations", type=int, default=4,
                    help="population-search iterations per cell")
    ap.add_argument("--population", type=int, default=8,
                    help="policies scored per iteration")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="small-scale end-to-end run")
    ap.add_argument("--out", default="BENCH_search_torch.json")
    ap.add_argument("--checkpoint", default=None,
                    help="cell-granular checkpoint path ('' disables; "
                         "default: a per-config file under experiments/, so "
                         "changing flags starts fresh instead of clashing "
                         "with an old checkpoint)")
    ap.add_argument("--workers", type=int, default=1,
                    help="cell-parallel worker pool size (>1 routes the "
                         "sweep through the elastic orchestrator; results "
                         "are identical to the sequential run)")
    ap.add_argument("--worker-kind", default="thread",
                    choices=("thread", "inline", "subprocess"),
                    help="worker isolation: threads share the process "
                         "(default), subprocess survives crashing cells "
                         "(one card each, round robin)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="fault-injection drill: seed a FaultPlan over the "
                         "sweep's cells (worker kills / transient errors) "
                         "and prove the recovery paths on this very config")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.arch is not None:
        if args.workload != "lm":
            ap.error("--arch is shorthand for --workload lm")
        if args.scenes is not None:
            ap.error("pass either --arch or --scenes, not both")
        args.scenes = args.arch
    if args.scenes is None:
        args.scenes = "qwen2-7b" if args.workload == "lm" else "chair,lego"
    hardware = args.hardware or (
        "roofline-lm" if args.workload == "lm" else "neurex"
    )
    device = resolve_device(args.device)

    scenes = tuple(s for s in args.scenes.split(",") if s)
    if args.workload == "lm":
        from repro_torch.configs import get_arch

        for arch in scenes:
            try:
                get_arch(arch)
            except KeyError as e:
                print(f"[hero-search-torch] {e.args[0]}", file=sys.stderr)
                return 2
    budgets = tuple(float(b) for b in args.budgets.split(",") if b)
    scale = SceneScale.quick() if args.quick else SceneScale.standard()
    n_iter = min(args.iterations, 3) if args.quick else args.iterations

    n_dev = _n_devices(device)
    label = "scene" if args.workload == "nerf" else "arch"
    print(f"[hero-search-torch] workload={args.workload}: {len(scenes)} "
          f"{label}(s) x {len(budgets)} "
          f"budget(s), {n_iter} iteration(s) x {args.population} policies "
          f"per cell, target={hardware}, on {device} "
          f"({n_dev} device(s){' (sharded)' if n_dev > 1 else ''})")

    cfg = ClosedLoopConfig(
        scenes=scenes,
        budget_fracs=budgets,
        seed=args.seed,
        scale=scale,
        n_iterations=n_iter,
        population=args.population,
        hardware=hardware,
        workload=args.workload,
    )
    if args.checkpoint is None:
        # Key the default checkpoint on the config fingerprint: different
        # flags get different files, so re-invocations never collide with
        # a checkpoint written under other settings.
        tag = hashlib.sha256(
            json.dumps(cfg.fingerprint(), sort_keys=True).encode()
        ).hexdigest()[:10]
        ckpt = f"experiments/hero_search_torch_ckpt_{tag}.json"
    else:
        ckpt = args.checkpoint or None
    cfg = dataclasses.replace(cfg, checkpoint_path=ckpt)
    if cfg.checkpoint_path:
        Path(cfg.checkpoint_path).parent.mkdir(parents=True, exist_ok=True)
    try:
        run = HeroSearchRun(cfg, device=device)
        if args.workers > 1 or args.chaos is not None:
            from repro_torch.distributed.orchestrator import run_orchestrated

            result = run_orchestrated(
                run, workers=args.workers, worker_kind=args.worker_kind,
                chaos_seed=args.chaos, verbose=True,
            )
        else:
            result = run.run()
    except ValueError as e:
        if "closed-loop config" not in str(e):
            raise
        print(f"[hero-search-torch] {e}", file=sys.stderr)
        return 2

    report = bench_report(result, cfg)
    Path(args.out).write_text(json.dumps(report, indent=2))

    print(f"\n[hero-search-torch] {result.policies_evaluated} policies in "
          f"{result.search_seconds:.1f}s search "
          f"({result.policies_per_sec:.2f} policies/s), "
          f"{result.wall_seconds:.1f}s wall")
    print(f"[hero-search-torch] joint frontier: {len(result.frontier)} "
          f"points, hypervolume {result.hypervolume():.4f}")
    if result.seconds_to_fixed_bit is not None:
        print(f"[hero-search-torch] beat uniform "
              f"{result.fixed_bit_reference}-bit after "
              f"{result.seconds_to_fixed_bit:.1f}s of search")
    print(f"\n  {label:8s} {'budget':>6s} {'lat ratio':>9s} "
          f"{'dQ dB':>9s} {'size ratio':>10s}")
    for p in sorted(result.frontier.points, key=lambda p: (p.scene, p.latency)):
        budget = f"{p.budget:g}" if p.budget is not None else "-"
        print(f"  {p.scene:8s} {budget:>6s} {p.latency:9.3f} "
              f"{p.psnr:+9.2f} {p.model_bytes:10.3f}")
    print(f"\n[hero-search-torch] wrote {args.out}"
          + (f" (checkpoint: {cfg.checkpoint_path})" if cfg.checkpoint_path
             else ""))

    ok = report["frontier_size"] > 0 and report["frontier_valid_vs_8bit"]
    if not ok:
        print("[hero-search-torch] frontier failed the fixed-8-bit validity "
              "check", file=sys.stderr)
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# hero-serve-torch
# ---------------------------------------------------------------------------
def run_serve(
    artifact,
    dataset,
    n_requests: int = 32,
    slots: int = 4,
    slot_rays: int = 512,
    budget="auto",
    roundtrip_dir: Optional[str] = None,
    device: DeviceLike = None,
) -> Dict:
    """Serve `n_requests` view renders from the artifact on `device` (the
    card unless "cpu") and report throughput, latency percentiles, and
    PSNR parity vs the in-process fused path (the number recorded at
    compile time).

    `roundtrip_dir` forces a save -> load through disk before serving, so
    the measured service runs on the exact bytes a deployment would.
    """
    import numpy as np

    from repro_torch.hero.artifact import QuantArtifact
    from repro_torch.hero.service import ServeConfig, serve

    if roundtrip_dir is not None:
        artifact.save(roundtrip_dir)
        artifact = QuantArtifact.load(roundtrip_dir, device=device)

    scfg = ServeConfig(slots=slots, slot_rays=slot_rays, budget=budget)
    svc = serve(artifact, scfg, device=device)  # warmed up

    views = dataset.test_rays_o.shape[0]
    rids = []
    t0 = time.perf_counter()
    for i in range(n_requests):
        v = i % views
        rids.append(svc.submit(dataset.test_rays_o[v], dataset.test_rays_d[v]))
    svc.drain()
    wall = time.perf_counter() - t0
    stats = svc.stats()  # snapshot BEFORE any untimed parity fill-in

    # PSNR over ONE full pass of the distinct views (the in-process
    # reference covers the whole test set, so the parity comparison must
    # too): views the timed run did not touch render untimed here.
    view_colors = {i % views: rids[i] for i in range(n_requests)}
    se, px = 0.0, 0
    for v in range(views):
        rid = view_colors.get(v)
        colors = (
            svc.result(rid) if rid is not None
            else svc.render(dataset.test_rays_o[v], dataset.test_rays_d[v])
        )
        gt = dataset.test_rgb[v].reshape(-1, 3)
        se += float(((colors - gt) ** 2).sum())
        px += gt.size
    psnr_serve = float(-10.0 * np.log10(max(se / px, 1e-12)))
    psnr_inproc = float(artifact.metrics["psnr"])
    return {
        "scene": artifact.scene,
        "bits": list(artifact.bits),
        "hardware": artifact.hardware.get("name"),
        "requests": n_requests,
        "rays_per_request": int(dataset.test_rays_o.shape[1]),
        "roundtrip_through_disk": roundtrip_dir is not None,
        "submit_to_drain_seconds": round(wall, 4),
        "requests_per_sec": stats["requests_per_sec"],
        "rays_per_sec": stats["rays_per_sec"],
        "latency_ms": stats["latency_ms"],
        "device_steps": stats["device_steps"],
        "sample_budget": stats["sample_budget"],
        "budget_retraces": stats["budget_retraces"],
        "slots": slots,
        "slot_rays": slot_rays,
        "psnr_serve": round(psnr_serve, 4),
        "psnr_inprocess": round(psnr_inproc, 4),
        "psnr_delta_db": round(abs(psnr_serve - psnr_inproc), 4),
    }


def run_serve_mixed(
    artifact_dirs: Dict[str, str],
    datasets: Dict[str, object],
    metrics_psnr: Dict[str, float],
    n_requests: int = 32,
    slots: int = 4,
    slot_rays: int = 512,
    budget="auto",
    cache_mb: Optional[float] = None,
    device: DeviceLike = None,
) -> Dict:
    """Serve a round-robin mixed-scene request stream through the
    multi-scene engine on `device` (artifacts load on miss from
    `artifact_dirs` through the LRU cache) and report throughput, latency
    percentiles, cache behavior, and per-scene PSNR parity vs compile
    time."""
    import numpy as np

    from repro_torch.hero.artifact import QuantArtifact
    from repro_torch.hero.engine import serve_engine
    from repro_torch.hero.service import ServeConfig
    from repro_torch.kernels.backend import resolve_device

    dev = resolve_device(device)
    scenes = sorted(artifact_dirs)
    ecfg = ServeConfig(
        slots=slots, slot_rays=slot_rays, budget=budget
    ).engine_config(
        cache_bytes=int(cache_mb * 2**20) if cache_mb is not None else None
    )
    eng = serve_engine(
        {}, ecfg,
        loader=lambda s: QuantArtifact.load(artifact_dirs[s], device=dev),
        warmup=False, device=dev,
    )
    # Touch every scene once so set-up stays out of the timed region
    # (under a tight cache budget later misses still reload, by design).
    for s in scenes:
        eng.render(
            datasets[s].test_rays_o[0], datasets[s].test_rays_d[0], scene=s
        )
    eng.reset_stats()

    rids = []  # (rid, scene, view)
    t0 = time.perf_counter()
    for i in range(n_requests):
        s = scenes[i % len(scenes)]
        v = (i // len(scenes)) % datasets[s].test_rays_o.shape[0]
        rids.append(
            (eng.submit(datasets[s].test_rays_o[v],
                        datasets[s].test_rays_d[v], scene=s), s, v)
        )
    eng.drain()
    wall = time.perf_counter() - t0
    stats = eng.stats()

    # Per-scene PSNR parity over one full pass of each scene's views
    # (untimed fill-in for views the stream did not touch).
    per_scene = {}
    for s in scenes:
        ds = datasets[s]
        views = ds.test_rays_o.shape[0]
        seen = {v: rid for rid, s2, v in rids if s2 == s}
        se, px = 0.0, 0
        for v in range(views):
            colors = (
                eng.result(seen[v]) if v in seen
                else eng.render(ds.test_rays_o[v], ds.test_rays_d[v], scene=s)
            )
            gt = ds.test_rgb[v].reshape(-1, 3)
            se += float(((colors - gt) ** 2).sum())
            px += gt.size
        psnr_serve = float(-10.0 * np.log10(max(se / px, 1e-12)))
        per_scene[s] = {
            "psnr_serve": round(psnr_serve, 4),
            "psnr_inprocess": round(float(metrics_psnr[s]), 4),
            "psnr_delta_db": round(
                abs(psnr_serve - float(metrics_psnr[s])), 4
            ),
        }
    for rid, _, _ in rids:  # duplicate-view rids were never retrieved
        try:
            eng.result(rid)
        except KeyError:
            pass  # already freed by the parity loop
    return {
        "scenes": scenes,
        "requests": n_requests,
        "submit_to_drain_seconds": round(wall, 4),
        "requests_per_sec": stats["requests_per_sec"],
        "rays_per_sec": stats["rays_per_sec"],
        "latency_ms": stats["latency_ms"],
        "device_steps": stats["device_steps"],
        "sample_budget": stats["sample_budget"],
        "budget_retraces": stats["budget_retraces"],
        "cache": stats["cache"],
        "slots": slots,
        "slot_rays": slot_rays,
        "per_scene": per_scene,
        "psnr_delta_db": round(
            max(p["psnr_delta_db"] for p in per_scene.values()), 4
        ),
    }


def _parse_bits(s: Optional[str], n_units: int) -> Optional[Sequence[int]]:
    if not s:
        return None
    parts = [int(b) for b in s.split(",") if b]
    if len(parts) == 1:
        return [parts[0]] * n_units
    if len(parts) != n_units:
        raise SystemExit(
            f"--bits needs 1 or {n_units} comma-separated values, got "
            f"{len(parts)}"
        )
    return parts


def serve_main(argv=None) -> int:
    """Compile (or load) a QuantArtifact and drive the batched render
    service against it."""
    from repro_torch.core.closed_loop import SceneScale, build_scene_env
    from repro_torch.hero.artifact import QuantArtifact, compile_artifact
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.nerf.dataset import make_dataset
    from repro_torch.nerf.scenes import SceneConfig

    ap = argparse.ArgumentParser(
        prog="hero-serve-torch",
        description="Request-batching NeRF render service over a compiled "
                    "QuantArtifact",
    )
    ap.add_argument("--artifact", default=None,
                    help="load this saved artifact directory instead of "
                         "compiling from scratch")
    ap.add_argument("--scene", default="chair")
    ap.add_argument("--scenes", default=None,
                    help="comma-separated scenes -> the multi-scene engine "
                         "(continuous batching across scenes, LRU artifact "
                         "cache); overrides --scene")
    ap.add_argument("--cache-mb", type=float, default=None,
                    help="LRU artifact-cache budget in MiB for --scenes; "
                         "evicted artifacts reload from disk on miss "
                         "(default: unbounded)")
    ap.add_argument("--bits", default=None,
                    help="policy bits: one value (uniform) or a full "
                         "comma-separated vector; default uniform 8")
    ap.add_argument("--quick", action="store_true",
                    help="quick scene scale (smoke run)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--slot-rays", type=int, default=512)
    ap.add_argument("--save", default=None,
                    help="also save the compiled artifact to this directory")
    ap.add_argument("--out", default="BENCH_serve_torch.json")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    scale = SceneScale.quick() if args.quick else SceneScale.standard()
    scale_name = "quick" if args.quick else "standard"
    scenes = [s for s in (args.scenes or "").split(",") if s]
    if len(scenes) >= 2:
        if args.artifact:
            raise SystemExit("--scenes compiles from scratch; it cannot be "
                             "combined with --artifact")
        dirs, datasets, psnrs = {}, {}, {}
        for scene in scenes:
            print(f"[hero-serve-torch] compiling {scene!r} at {scale_name} "
                  f"scale on {device} ...", flush=True)
            env = build_scene_env(scene, scale, seed=args.seed, device=device)
            art = compile_artifact(env, _parse_bits(args.bits, env.n_units))
            dirs[scene] = art.save(
                f"{args.save or 'experiments/artifacts_torch'}/{scene}"
            )
            datasets[scene] = env.dataset
            psnrs[scene] = art.metrics["psnr"]
        report = run_serve_mixed(
            {s: str(p) for s, p in dirs.items()}, datasets, psnrs,
            n_requests=args.requests, slots=args.slots,
            slot_rays=args.slot_rays, cache_mb=args.cache_mb, device=device,
        )
        Path(args.out).write_text(json.dumps(report, indent=2))
        lat = report["latency_ms"]
        cache = report["cache"]
        print(f"\n== hero-serve-torch: {report['requests']} mixed requests "
              f"over {'+'.join(scenes)} ==")
        print(f"  requests/sec:   {report['requests_per_sec']}")
        print(f"  latency ms:     p50={lat['p50']} p95={lat['p95']}")
        print(f"  cache:          loads={cache['loads']} "
              f"evictions={cache['evictions']} hits={cache['hits']} "
              f"resident={cache['resident']}")
        print(f"  PSNR delta:     {report['psnr_delta_db']:.4f} dB (worst "
              f"scene)")
        print(f"  wrote {args.out}")
        return 0

    if args.artifact:
        artifact = QuantArtifact.load(args.artifact, device=device)
        # Rebuild the EXACT eval set the compile metrics were measured on
        # (procedural scenes are deterministic) — parity vs
        # metrics["psnr"] is meaningless on any other view set.
        sc = dict(artifact.scene_cfg)
        sc["light_dir"] = tuple(sc.get("light_dir", (0.5, -1.0, 0.6)))
        ds = make_dataset(SceneConfig(**sc), device=device)
        roundtrip = None  # already deployed bytes
    else:
        print(f"[hero-serve-torch] compiling {args.scene!r} at {scale_name} "
              f"scale on {device} ...", flush=True)
        env = build_scene_env(args.scene, scale, seed=args.seed,
                              device=device)
        artifact = compile_artifact(
            env, _parse_bits(args.bits, env.n_units)
        )
        ds = env.dataset
        roundtrip = args.save or f"experiments/artifacts_torch/{args.scene}"

    report = run_serve(
        artifact, ds, n_requests=args.requests, slots=args.slots,
        slot_rays=args.slot_rays, roundtrip_dir=roundtrip, device=device,
    )
    Path(args.out).write_text(json.dumps(report, indent=2))

    lat = report["latency_ms"]
    print(f"\n== hero-serve-torch: {report['requests']} requests x "
          f"{report['rays_per_request']} rays, scene={report['scene']} ==")
    print(f"  requests/sec:   {report['requests_per_sec']}")
    print(f"  rays/sec:       {report['rays_per_sec']}")
    print(f"  latency ms:     p50={lat['p50']} p95={lat['p95']} "
          f"mean={lat['mean']}")
    print(f"  sample budget:  {report['sample_budget']} "
          f"({report['budget_retraces']} retraces)")
    print(f"  PSNR serve/in-process: {report['psnr_serve']:.4f} / "
          f"{report['psnr_inprocess']:.4f} "
          f"(delta {report['psnr_delta_db']:.4f} dB)")
    print(f"  wrote {args.out}")
    if roundtrip:
        print(f"  artifact at {roundtrip}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "search":
        return search_main(argv[1:])
    if argv and argv[0] == "serve":
        return serve_main(argv[1:])
    print("usage: python -m repro_torch.hero.cli <search|serve> [args...]",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
