#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, and exits non-zero, printing no result, without
one (or without the rest of the repository beside it).

Phases, each of which raises on failure:

1. Build the four CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together) and print the build time.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the serve path gives it, and time kernel, plain version and,
   where one exists, the one PyTorch call that computes the same function
   (median of 20 CUDA-event-timed runs after warm-up).
3. The main path at ``paper()`` width: random weights from a seed,
   activation ranges calibrated from the field's taps, occupancy baked,
   a mixed int policy packed into a ``QuantArtifact``, saved, loaded
   (``tile:128``) and served by ``RenderService`` (8 requests of 64x64
   camera rays). Every kernel's launch count is zeroed just before the
   requests and read just after; each must have risen.
4. One request served again on the CPU from the same directory (the plain
   versions) must match the card's colours to 1e-5.

The last lines are the kernels JSON line, the card's name and power limit
(``nvidia-smi``), and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core rate
PEAK_F32_OPS = 67e12  # float32 outside the tensor cores
QMM_SHAPES = ((32, 64), (64, 16), (40, 64), (64, 64), (64, 3))  # paper (K, N)
SERVE_ROWS = 512 * 32  # slot_rays * n_samples: the M of one slot's linears


SPIN_CYCLES = 5_000_000  # ~2.5 ms of device spin: longer than any enqueue


def median_ms(fn, iters: int = 20, warmup: int = 3, hide_host: bool = True
              ) -> float:
    """Median of `iters` CUDA-event-timed calls of `fn`, after warm-up.

    With `hide_host`, each timed call is queued behind a spin kernel, so
    the events bracket only the device's work for `fn` (the host enqueues
    it while the device spins). Without, the device is idle when the
    first event is recorded, and the time includes the host's launch
    overhead: what one call costs a caller."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(nbytes: float, ops: float, peak_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def entry(name, source, replaces, err, ms, plain_ms, bnd, library_ms,
          call_ms):
    """One kernel's record. `ms`, `plain_ms` and `library_ms` are device
    times; `call_ms` is one kernel call with the host's launch overhead."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None,
            "max_abs_err": float(err), "ms": float(ms),
            "plain_ms": float(plain_ms), "bound_ms": float(bnd[0]),
            "bound_by": bnd[1],
            "library_ms": None if library_ms is None else float(library_ms),
            "call_ms": float(call_ms)}


# ---------------------------------------------------------------------------
# Kernel phases: kernel == plain version on the card, then timed.
# ---------------------------------------------------------------------------
def phase_quant_matmul(rng, dev):
    from repro_torch.kernels.quant_matmul import (
        quant_matmul_packed_cuda as kernel,
        quant_matmul_packed_plain as plain,
    )
    from repro_torch.kernels.repack import repack_tile_native
    from repro_torch.quant.packing import pack_codes

    M = SERVE_ROWS
    worst = 0.0
    for K, N in QMM_SHAPES:
        x = torch.from_numpy(rng.integers(-128, 128, (M, K), dtype=np.int8)).to(dev)
        for bits in (2, 4, 6, 8):
            # The paper-exact grid [-2^(b-1) - 1, 2^(b-1) - 1], full span.
            q = rng.integers(-(2 ** (bits - 1)) - 1, 2 ** (bits - 1), (K, N))
            pt = pack_codes(q, bits, scale=float(rng.uniform(1e-3, 1e-1)),
                            device=dev)
            for wq in (pt, repack_tile_native(pt)):
                sx = torch.tensor(float(rng.uniform(1e-3, 1e-1)), device=dev)
                for zx_v in (17, -128, int(rng.integers(-128, 128))):
                    zx = torch.tensor(zx_v, dtype=torch.int32, device=dev)
                    a = kernel(x, wq, sx, wq.scale, zx)
                    b = plain(x, wq, sx, wq.scale, zx)
                    torch.cuda.synchronize()
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"quant_matmul_packed K={K} N={N} bits={bits} "
                            f"{wq.layout} zx={zx_v}: max |diff| "
                            f"{(a - b).abs().max().item()}")
                    worst = max(worst, (a - b).abs().max().item())
    print(f"quant_matmul_packed: exact on {len(QMM_SHAPES)} shapes x bits "
          "{2,4,6,8} x {planar, tile:128} x 3 zero points, M=16384")

    # Time the five linears of one slot (4-bit weights, tile:128, as served).
    ms = plain_ms = lib_ms = call_ms = nbytes = ops = 0.0
    for K, N in QMM_SHAPES:
        x = torch.from_numpy(rng.integers(-128, 128, (M, K), dtype=np.int8)).to(dev)
        q = rng.integers(-9, 8, (K, N))
        wq = repack_tile_native(pack_codes(q, 4, scale=0.01, device=dev))
        sx = torch.tensor(0.02, device=dev)
        zx = torch.tensor(-3, dtype=torch.int32, device=dev)
        xf = x.to(torch.float32)
        wf = wq.dequantize()
        t_k = median_ms(lambda: kernel(x, wq, sx, wq.scale, zx))
        t_p = median_ms(lambda: plain(x, wq, sx, wq.scale, zx))
        t_l = median_ms(lambda: torch.matmul(xf, wf))
        t_c = median_ms(lambda: kernel(x, wq, sx, wq.scale, zx),
                        hide_host=False)
        print(f"  K={K:3d} N={N:3d}: kernel {t_k:.4f} ms (one call {t_c:.4f} "
              f"ms), plain {t_p:.4f} ms, torch.matmul(f32) {t_l:.4f} ms")
        ms, plain_ms, lib_ms = ms + t_k, plain_ms + t_p, lib_ms + t_l
        call_ms += t_c
        nbytes += M * K + wq.words.numel() * 4 + M * N * 4 + 16
        ops += 2.0 * M * N * K
    e = entry("quant_matmul_packed", "src/repro_torch/csrc/quant_matmul_packed.cu",
              "src/repro/kernels/quant_matmul.py:199", worst, ms, plain_ms,
              bound(nbytes, ops, PEAK_INT8_OPS), lib_ms, call_ms)
    e["timed_as"] = "sum of the five paper linears, M=16384, 4-bit tile:128"
    return e


def serve_points(n_rays: int, dev):
    """Sample points (unit cube) and directions of `n_rays` camera rays of
    the first scene pose, at the render config's deterministic depths."""
    from repro_torch.nerf.occupancy import ray_t_samples
    from repro_torch.nerf.render import RenderConfig
    from repro_torch.nerf.scenes import SceneConfig, camera_poses, camera_rays

    sc = SceneConfig()
    train, _ = camera_poses(sc)
    ro, rd = camera_rays(train[0], sc.image_hw, sc.focal_mult * sc.image_hw)
    step = max(1, ro.shape[0] // n_rays)
    ro, rd = ro[::step][:n_rays], rd[::step][:n_rays]
    t = torch.from_numpy(ray_t_samples(RenderConfig()))
    pts = ro[:, None, :] + rd[:, None, :] * t[None, :, None]
    dirs = rd[:, None, :].expand(pts.shape)
    return (torch.clamp(pts + 0.5, 0.0, 1.0).reshape(-1, 3).to(dev),
            dirs.reshape(-1, 3).to(dev), ro, rd)


def phase_hash_gather(rng, dev, cfg):
    from repro_torch.kernels.hash_encoding_kernel import (
        hash_gather_cuda as kernel,
        hash_gather_plain as plain,
    )
    from repro_torch.nerf.hash_encoding import level_corner_data

    hc = cfg.hash
    rows = [hc.level_entries(l) for l in range(hc.n_levels)]
    T, F = sum(rows), hc.n_features
    table = torch.from_numpy(
        rng.uniform(-1e-4, 1e-4, (T, F)).astype(np.float32)).to(dev)
    # The corner rows one slot's samples gather (16 levels x 16384 x 8).
    pts, _, _, _ = serve_points(512, dev)
    offs = np.cumsum([0] + rows[:-1])
    idx = torch.cat([level_corner_data(pts, l, hc)[0].reshape(-1) + int(offs[l])
                     for l in range(hc.n_levels)]).to(torch.int32)
    P = idx.numel()
    bad = torch.from_numpy(rng.choice(P, P // 100, replace=False)).to(dev)
    junk = rng.choice([-1, -7, T, T + 5, 2 ** 31 - 1], bad.numel())
    idx[bad] = torch.from_numpy(junk.astype(np.int32)).to(dev)
    a = kernel(idx, table)
    b = plain(idx, table)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError("hash_gather: kernel != plain version")
    print(f"hash_gather: exact, P={P} indices ({bad.numel()} out of range) "
          f"over a ({T}, {F}) f32 table")
    ok = (idx >= 0) & (idx < T)
    idx_lib = torch.where(ok, idx, 0).to(torch.int64)
    t_k = median_ms(lambda: kernel(idx, table))
    t_p = median_ms(lambda: plain(idx, table))
    t_l = median_ms(lambda: table[idx_lib])
    t_c = median_ms(lambda: kernel(idx, table), hide_host=False)
    uniq = int(torch.unique(idx[ok]).numel())
    nbytes = P * 4 + P * F * 4 + uniq * F * 4
    return entry("hash_gather", "src/repro_torch/csrc/hash_gather.cu",
                 "src/repro/kernels/hash_encoding_kernel.py:50",
                 (a - b).abs().max().item(), t_k, t_p,
                 bound(nbytes, 0.0, PEAK_F32_OPS), t_l, t_c)


def march_rays(rng, R: int = 512):
    """Camera-like rays plus the edge cases: coordinates held exactly on
    cell faces and on box faces (zero direction on that axis), axis-aligned
    rays, rays starting inside the box, and zero-direction rays."""
    o = np.empty((R, 3), np.float32)
    d = np.empty((R, 3), np.float32)
    n_cam = R // 2
    theta = rng.uniform(0, 2 * np.pi, n_cam)
    phi = rng.uniform(-0.6, 0.6, n_cam)
    o[:n_cam] = 1.3 * np.stack([np.cos(theta) * np.cos(phi), np.sin(phi),
                                np.sin(theta) * np.cos(phi)], -1)
    aim = rng.uniform(-0.4, 0.4, (n_cam, 3))
    d[:n_cam] = aim - o[:n_cam]
    i = n_cam
    faces = (np.arange(33) / 32.0 - 0.5).astype(np.float32)  # cell + box faces
    while i < R - 64:
        ax = rng.integers(0, 3)
        sign = rng.choice([-1.0, 1.0])
        o[i] = rng.choice(faces, 3)
        o[i, ax] = -1.5 * sign
        d[i] = 0.0
        d[i, ax] = sign
        i += 1
    for j in range(i, R):  # inside the box; half with zero direction
        o[j] = rng.uniform(-0.45, 0.45, 3)
        d[j] = 0.0 if j % 2 else rng.normal(size=3)
    n = np.linalg.norm(d, axis=-1, keepdims=True)
    d = np.where(n > 0, d / np.where(n > 0, n, 1.0), 0.0).astype(np.float32)
    return o, d


def phase_ray_march(rng, dev):
    from repro_torch.kernels.ray_march import (
        ray_march_cuda as kernel,
        ray_march_plain as plain,
    )
    from repro_torch.nerf.occupancy import (
        OccupancyGrid,
        ray_t_samples,
        sample_active_mask,
    )
    from repro_torch.nerf.render import RenderConfig

    G = 32
    occ_np = (rng.uniform(size=(G, G, G)) < 0.5).astype(np.float32)
    occ = torch.from_numpy(occ_np).to(dev)
    o_np, d_np = march_rays(rng)
    ro, rd = torch.from_numpy(o_np).to(dev), torch.from_numpy(d_np).to(dev)
    rcfg = RenderConfig()
    t = torch.from_numpy(ray_t_samples(rcfg)).to(dev)
    a = kernel(occ, ro, rd, t, True)
    b = plain(occ, ro, rd, t)
    grid = OccupancyGrid(occ=occ, resolution=G, threshold=0.5,
                         occupied_fraction=float(occ_np.mean()))
    host, pts = sample_active_mask(grid, o_np, d_np, rcfg)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError("ray_march: kernel != plain version")
    if not np.array_equal(a.cpu().numpy() > 0.5, host):
        raise AssertionError("ray_march: kernel != host sample_active_mask")
    print(f"ray_march: exact against the plain version and the host oracle "
          f"on {o_np.shape[0]} rays ({int(host.sum())} active samples)")
    t_k = median_ms(lambda: kernel(occ, ro, rd, t, True))
    t_p = median_ms(lambda: plain(occ, ro, rd, t))
    t_c = median_ms(lambda: kernel(occ, ro, rd, t, True), hide_host=False)
    inside = np.all((pts > -0.5) & (pts < 0.5), axis=-1)
    cells = np.clip(((pts[inside] + 0.5) * G).astype(np.int64), 0, G - 1)
    uniq = np.unique(cells[:, 0] * G * G + cells[:, 1] * G + cells[:, 2]).size
    R, S = o_np.shape[0], t.numel()
    nbytes = R * 6 * 4 + S * 4 + R * S * 4 + uniq * 4
    return entry("ray_march", "src/repro_torch/csrc/ray_march.cu",
                 "src/repro/kernels/ray_march.py:134",
                 (a - b).abs().max().item(), t_k, t_p,
                 bound(nbytes, 9.0 * R * S, PEAK_F32_OPS), None, t_c)


def phase_alpha_composite(rng, dev):
    from repro_torch.kernels.alpha_composite import (
        alpha_composite_cuda as kernel,
        alpha_composite_plain as plain,
    )
    from repro_torch.nerf.occupancy import ray_t_samples
    from repro_torch.nerf.render import RenderConfig

    R, S, t_eps = 512, 32, 1e-6
    t = ray_t_samples(RenderConfig())
    delta_np = np.tile(np.append(np.diff(t), np.float32(1e10)),
                       (R, 1)).astype(np.float32)
    scale = rng.choice([0.0, 0.5, 5.0, 200.0], (R, 1))  # empty ... opaque
    sigma_np = (rng.exponential(1.0, (R, S)) * scale).astype(np.float32)
    sigma = torch.from_numpy(sigma_np).to(dev)
    delta = torch.from_numpy(delta_np).to(dev)
    rgb = torch.from_numpy(rng.uniform(size=(R, S, 3)).astype(np.float32)).to(dev)
    worst = 0.0
    for early in (False, True):
        c, acc = kernel(sigma, rgb, delta, early, t_eps)
        pc, pa = plain(sigma, rgb, delta)
        torch.cuda.synchronize()
        err = max((c - pc).abs().max().item(), (acc - pa).abs().max().item())
        if not err <= 1e-5:
            raise AssertionError(f"alpha_composite early_stop={early}: "
                                 f"max |diff| {err} > 1e-5")
        worst = max(worst, err) if early else worst
    print(f"alpha_composite: within 1e-5 of the dense plain walk "
          f"(early stop {worst:.3g}), R={R} S={S}")
    t_k = median_ms(lambda: kernel(sigma, rgb, delta, True, t_eps))
    t_p = median_ms(lambda: plain(sigma, rgb, delta))
    t_c = median_ms(lambda: kernel(sigma, rgb, delta, True, t_eps),
                    hide_host=False)
    # Samples the early exit leaves unread: after the one where T < t_eps.
    alpha = 1.0 - np.exp(-sigma_np.astype(np.float64) * delta_np)
    T_after = np.cumprod(1.0 - alpha, axis=1)
    below = T_after < t_eps
    walked = np.where(below.any(1), below.argmax(1) + 1, S).sum()
    nbytes = walked * 5 * 4 + R * 4 * 4
    return entry("alpha_composite", "src/repro_torch/csrc/alpha_composite.cu",
                 "src/repro/kernels/alpha_composite.py:77", worst, t_k, t_p,
                 bound(nbytes, 12.0 * walked, PEAK_F32_OPS), None, t_c)


# ---------------------------------------------------------------------------
# The main path.
# ---------------------------------------------------------------------------
def build_artifact(cfg, device, seed: int = 0, occ_resolution: int = 32):
    """Random `cfg`-width weights from `seed`, activation ranges from the
    field's taps on camera-ray samples, a baked occupancy grid, and a mixed
    policy (6-bit hash, 4-bit weights, 8-bit activations: every linear in
    the `int` mode) packed into a `QuantArtifact`."""
    from repro_torch.hero.artifact import QuantArtifact
    from repro_torch.nerf.fast_render import build_fused_pack
    from repro_torch.nerf.ngp import (
        init_ngp,
        make_quant_units,
        ngp_apply,
        ngp_linear_names,
        spec_from_policy,
    )
    from repro_torch.nerf.occupancy import bake_occupancy
    from repro_torch.nerf.render import RenderConfig
    from repro_torch.nerf.scenes import SceneConfig
    from repro_torch.quant.policy import QuantPolicy, UnitKind

    params = init_ngp(torch.Generator().manual_seed(seed), cfg, device=device)
    pts, dirs, _, _ = serve_points(4096, device)
    pick = torch.from_numpy(
        np.random.default_rng(seed).choice(pts.shape[0] // 32, 64,
                                           replace=False))
    sel = ((pick[:, None] * 32) + torch.arange(32)[None]).reshape(-1).to(device)
    with torch.no_grad():
        _, _, taps = ngp_apply(params, pts[sel], dirs[sel], cfg,
                               return_taps=True)
    names = ngp_linear_names(cfg)
    act_ranges = torch.tensor(
        [[float(taps[n].min()), float(taps[n].max())] for n in names],
        dtype=torch.float32, device=device)
    occ = bake_occupancy(params, cfg, resolution=occ_resolution)
    units = make_quant_units(cfg)
    kind_bits = {UnitKind.HASH_LEVEL: 6, UnitKind.WEIGHT: 4,
                 UnitKind.ACTIVATION: 8}
    bits = [kind_bits[u.kind] for u in units]
    spec = spec_from_policy(cfg, QuantPolicy.uniform(units, 8).with_bits(bits),
                            act_ranges)
    pack = build_fused_pack(params, cfg, spec)
    if pack.modes != ("int",) * len(names):
        raise AssertionError(f"expected every linear in int mode: {pack.modes}")
    return QuantArtifact(
        scene="chair", bits=bits, cfg=cfg, rcfg=RenderConfig(),
        scene_cfg=dataclasses.asdict(SceneConfig()), params=params,
        act_ranges=act_ranges, pack=pack, occ=occ,
        hardware={"name": "random-weights"}, metrics={})


def request_rays(n_requests: int, hw: int):
    """(rays_o, rays_d) numpy pairs: hw x hw camera rays of successive
    scene poses."""
    from repro_torch.nerf.scenes import SceneConfig, camera_poses, camera_rays

    sc = SceneConfig(image_hw=hw, n_train_views=n_requests)
    train, _ = camera_poses(sc)
    return [tuple(a.numpy() for a in camera_rays(c2w, hw, sc.focal_mult * hw))
            for c2w in train]


def serve(path, device, serve_cfg=None):
    """Load the artifact at `path` onto `device` and stand up a warmed-up
    `RenderService` for it. Returns (service, artifact)."""
    from repro_torch.hero.artifact import QuantArtifact
    from repro_torch.hero.service import RenderService, ServeConfig

    art = QuantArtifact.load(path, layout="tile:128", device=device)
    svc = RenderService(art, serve_cfg or ServeConfig(), device=device)
    svc.warmup()
    return svc, art


def answer(svc, requests):
    """Submit every (rays_o, rays_d) request, drain, return the colours."""
    rids = [svc.submit(ro, rd) for ro, rd in requests]
    svc.drain()
    return [svc.result(r) for r in rids]


def profile_request(svc, request) -> None:
    """Serve one more request under `torch.profiler` and print where its
    time went: wall time, device kernel time (busy share), launches, and
    the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        answer(svc, [request])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3  # ms
    print(f"profiled request: wall {wall * 1e3:.2f} ms, device kernel time "
          f"{busy:.2f} ms ({100.0 * busy / (wall * 1e3):.1f} % busy), "
          f"{len(kernels)} device events")
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"  {t:8.3f} ms {n:5d}x {name[:90]}")


def counters():
    from repro_torch.kernels.alpha_composite import alpha_composite_cuda
    from repro_torch.kernels.hash_encoding_kernel import hash_gather_cuda
    from repro_torch.kernels.quant_matmul import quant_matmul_packed_cuda
    from repro_torch.kernels.ray_march import ray_march_cuda

    return {"quant_matmul_packed": quant_matmul_packed_cuda,
            "hash_gather": hash_gather_cuda,
            "alpha_composite": alpha_composite_cuda,
            "ray_march": ray_march_cuda}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs.ngp import paper
    from repro_torch.kernels import build
    from repro_torch.kernels.backend import power_limit

    card = power_limit()
    if card is None:
        raise RuntimeError("nvidia-smi did not report the card")
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    res = build.build()
    print(f"kernel build: {res.seconds:.2f} s ({res.path.name})")
    for line in res.log.splitlines():
        if "registers" in line or line.startswith("=="):
            print(f"  {line.strip()}")
    build.library()

    dev = torch.device("cuda")
    cfg = paper()
    rng = np.random.default_rng(0)
    entries = [phase_quant_matmul(rng, dev), phase_hash_gather(rng, dev, cfg),
               phase_alpha_composite(rng, dev), phase_ray_march(rng, dev)]
    for e in entries:
        print(f"{e['name']}: max_abs_err {e['max_abs_err']:.3g}, kernel "
              f"{e['ms']:.4f} ms (one call with launch {e['call_ms']:.4f} "
              f"ms), plain {e['plain_ms']:.4f} ms, bound "
              f"{e['bound_ms']:.4f} ms ({e['bound_by']}), library "
              f"{e['library_ms']}")

    t0 = time.perf_counter()
    art = build_artifact(cfg, dev)
    requests = request_rays(8, 64)
    with tempfile.TemporaryDirectory() as tmp:
        art.save(tmp)
        svc, loaded = serve(tmp, dev)
        print(f"main path set-up (init, calibrate, bake, pack, save, load, "
              f"warm-up): {time.perf_counter() - t0:.2f} s")
        kern = counters()
        for fn in kern.values():
            fn.launches = 0
        colors = answer(svc, requests)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in kern.items()}
        stats = svc.stats()
        for (ro, _), c in zip(requests, colors):
            if c.shape != (ro.shape[0], 3) or not np.isfinite(c).all():
                raise AssertionError(f"bad result: shape {c.shape}")
        print(f"launches during the 8 served requests: {launches}")
        if min(launches.values()) <= 0:
            raise AssertionError(f"a kernel was never launched: {launches}")

        profile_request(svc, requests[0])
        cpu_svc, _ = serve(tmp, "cpu")
        ref = answer(cpu_svc, requests[:1])[0]
    diff = float(np.abs(ref - colors[0]).max())
    print(f"card vs CPU plain versions, one request: max |diff| {diff:.3g}")
    if not diff <= 1e-5:
        raise AssertionError(f"served colours differ from the CPU by {diff}")
    lat = stats["latency_ms"]
    print(f"served {stats['requests_completed']} requests "
          f"({stats['rays_rendered']} rays) in {stats['wall_seconds']} s: "
          f"{stats['requests_per_sec']} req/s, {stats['rays_per_sec']} rays/s, "
          f"latency p50 {lat['p50']} ms p95 {lat['p95']} ms")
    print(f"sample budget {stats['sample_budget']}, grows "
          f"{stats['budget_retraces']}, resident_bytes "
          f"{loaded.resident_bytes()}, stored_model_bytes "
          f"{loaded.stored_model_bytes()}, occupied fraction "
          f"{loaded.occ.occupied_fraction:.4f}")

    for e in entries:
        e["launches"] = launches[e["name"]]
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
