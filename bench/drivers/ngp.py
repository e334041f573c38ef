"""Quantized Instant-NGP frames through the port's serve engine.

The system under test is `repro_torch.hero.engine.ServeEngine` over a
`QuantArtifact` packed by `repro_torch.nerf.fast_render.build_fused_pack`:
the path search -> compile -> serve ends in. The benchmark makes the
inputs: float weights from the seed on the card, activation ranges from
the unquantized field's inputs at points of the chair, the occupancy grid
from the chair's geometry (`bench/lib/chair.py`), and the rays.

Traffic (`kind: ngp_closed_loop`): V viewers in a closed loop, each asking
for its next frame as soon as its last one is back on the host. Poses come
from `orbits` (each viewer on its own rising orbit; a pose whose cell any
frame of the run has used is skipped, so every slot misses the pose cache)
or from a `hotset` (a deck of the hot poses in Zipf proportions, half of
each pose's cards exact and half with the origin jittered inside its
cell, shuffled by the seed; their plans built in set-up).
"""
from __future__ import annotations

import collections
import gc
import math
import resource
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from bench.lib import cameras, costs
from bench.lib.chair import occupancy
from bench.lib.device import peak_bytes, release, sync
from bench.lib.outcome import Check, Outcome
from bench.lib.trace import traced
from bench.reference import ngp as ref



def weights_like(cfg: Dict, gen: torch.Generator, device) -> Dict:
    """Seeded float weights of the configuration's shapes, drawn on
    `device` by `gen` (the benchmark's inputs): tables uniform in
    [-1e-4, 1e-4] as Instant-NGP initializes them, linears N(0, 2 / d_in),
    biases zero."""
    out: Dict = {"hash": []}
    F = cfg["hash"]["n_features"]
    n = ref.level_entries(cfg["hash"])
    flat = torch.rand(sum(n) * F, generator=gen, device=device)
    flat.mul_(2e-4).sub_(1e-4)
    off = 0
    for e in n:
        out["hash"].append(flat[off:off + e * F].view(e, F))
        off += e * F
    for name, (d_in, d_out) in ref.linear_dims(cfg).items():
        w = torch.randn((d_in, d_out), generator=gen, device=device)
        out[name] = {"w": w.mul_(math.sqrt(2.0 / d_in)),
                     "b": torch.zeros(d_out, device=device)}
    return out


def make_inputs(config: Dict, seed: int, device) -> Dict:
    """The benchmark's inputs: float weights, activation ranges and the
    occupancy grid, all from the seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    weights = weights_like(config, gen, device)
    grid = occupancy(config["occupancy"], device)
    # Calibration points: in occupied cells, with unit view directions.
    cells = torch.nonzero(grid > 0.5).to(torch.float32)
    n = config["calibration"]["points"]
    pick = torch.randint(0, cells.shape[0], (n,), generator=gen,
                         device=device)
    u = torch.rand((n, 3), generator=gen, device=device)
    pts = (cells[pick] + u) / grid.shape[0]
    dirs = torch.randn((n, 3), generator=gen, device=device)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    ranges = ref.float_taps(weights, config, pts, dirs)
    return {"weights": weights, "grid": grid, "act_ranges": ranges}


def build_engine(config: Dict, traffic: Dict, inputs: Dict, device):
    """The port's artifact and serve engine over copies of the inputs."""
    from repro_torch.hero.artifact import QuantArtifact
    from repro_torch.hero.engine import ServeEngine
    from repro_torch.hero.scheduler import EngineConfig
    from repro_torch.nerf.fast_render import build_fused_pack
    from repro_torch.nerf.hash_encoding import HashEncodingConfig
    from repro_torch.nerf.ngp import (
        NGPConfig,
        make_quant_units,
        spec_from_policy,
    )
    from repro_torch.nerf.occupancy import OccupancyGrid
    from repro_torch.nerf.render import RenderConfig
    from repro_torch.quant.policy import QuantPolicy

    cfg = NGPConfig(hash=HashEncodingConfig(**config["hash"]),
                    hidden_dim=config["hidden_dim"],
                    geo_feat_dim=config["geo_feat_dim"],
                    color_hidden_dim=config["color_hidden_dim"],
                    sh_degree=config["sh_degree"],
                    density_activation=config["density_activation"])
    w = inputs["weights"]
    params = {"hash": {f"level_{l}": t.clone()
                       for l, t in enumerate(w["hash"])}}
    for name in ref.LINEARS:
        params[name] = {k: v.clone() for k, v in w[name].items()}
    ranges = torch.from_numpy(inputs["act_ranges"]).to(device)
    units = make_quant_units(cfg)
    by_kind = {"HASH_LEVEL": "hash_level", "WEIGHT": "weight",
               "ACTIVATION": "activation"}
    bits = [config["bits"][by_kind[u.kind.name]] for u in units]
    spec = spec_from_policy(
        cfg, QuantPolicy.uniform(units, 8).with_bits(bits), ranges)
    grid = inputs["grid"].clone()
    occ = OccupancyGrid(occ=grid, resolution=grid.shape[0],
                        threshold=0.0,
                        occupied_fraction=float(grid.mean()))
    art = QuantArtifact(
        scene="chair", bits=bits, cfg=cfg,
        rcfg=RenderConfig(**config["render"], stratified=False),
        scene_cfg={}, params=params, act_ranges=ranges,
        pack=build_fused_pack(params, cfg, spec), occ=occ,
        hardware={}, metrics={})
    engine = ServeEngine({"chair": art},
                         EngineConfig(**traffic["engine"]), device=device)
    engine.warmup()
    return engine


class Poses:
    """The traffic's pose source: `next(viewer)` -> (c2w, shift, ro, rd)."""

    def __init__(self, traffic: Dict, seed: int, pos_cell: float,
                 dir_cell: float):
        p = traffic["poses"]
        self.p, self.V = p, traffic["viewers"]
        hw = traffic["image_hw"]
        self.dirs = cameras.pixel_dirs(hw, traffic["focal_mult"] * hw)
        self.cell = (pos_cell, dir_cell)
        rng = np.random.default_rng(seed)
        # The viewers' first asks in the seed's order.
        self.first = rng.permutation(self.V).tolist()
        if p["source"] == "orbits":
            self.frame = [0] * self.V
            self.used = set()
        elif p["source"] == "hotset":
            self.rng = rng
            self.hot = []
            for theta in p["thetas"]:
                c2w = cameras.look_at(theta, p["elevation"], p["radius"])
                ro, rd = cameras.frame_rays(c2w, self.dirs)
                shift = cameras.jitter_shift(c2w, self.dirs, *self.cell)
                if shift is None:
                    raise ValueError(f"no jitter keeps the cell of {theta}")
                self.hot.append((c2w, rd, shift))
            self.deck: collections.deque = collections.deque()
        else:
            raise ValueError(p["source"])

    def next(self, v: int):
        if self.p["source"] == "orbits":
            p = self.p
            while True:
                f = self.frame[v]
                self.frame[v] += 1
                c2w = cameras.look_at(
                    p["phases"][v] + f * p["theta_step"],
                    p["elevations"][v] + f * p["elevation_step"],
                    p["radius"])
                ro, rd = cameras.frame_rays(c2w, self.dirs)
                key = cameras.eye_cell_key(c2w, rd, *self.cell)
                if key not in self.used:
                    self.used.add(key)
                    return c2w, 0.0, ro, rd
        if not self.deck:
            self.deck.extend(self._shuffled_deck())
        k, jit = self.deck.popleft()
        c2w, rd, shift = self.hot[k]
        shift = shift if jit else 0.0
        return c2w, shift, cameras.frame_rays(c2w, self.dirs, shift)[0], rd

    def _shuffled_deck(self) -> List:
        """Cards (pose, jittered) in Zipf proportions by the largest
        remainder, exact and jittered in turn down the deck sorted by
        pose (half each), in the seed's order."""
        n, s = self.p["deck"], self.p["zipf_s"]
        w = 1.0 / np.arange(1, len(self.hot) + 1) ** s
        share = n * w / w.sum()
        count = np.floor(share).astype(int)
        for i in np.argsort(-(share - count))[:n - count.sum()]:
            count[i] += 1
        ranks = [k for k in range(len(self.hot)) for _ in range(count[k])]
        cards = [(k, j % 2 == 1) for j, k in enumerate(ranks)]
        return [cards[i] for i in self.rng.permutation(len(cards))]

    def hot_visits(self):
        """(c2w, shift, ro, rd) of each hot pose, exact and jittered."""
        for c2w, rd, shift in self.hot:
            for s in (0.0, shift):
                yield c2w, s, cameras.frame_rays(c2w, self.dirs, s)[0], rd


class Reservoir:
    """A uniform sample of `k` items of a stream of unknown length, drawn
    by `rng` (Vitter's algorithm R): each item answered over the whole
    run is kept with the same chance."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = item


class Loop:
    """The closed loop of viewers over one engine. `sample` maps "exact"
    and "jittered" (frames whose origin was moved inside its cell) to a
    reservoir that keeps (c2w, shift, colours) of a seeded sample of the
    frames answered."""

    def __init__(self, engine, poses: Poses,
                 sample: Optional[Dict[str, Reservoir]] = None):
        self.engine, self.poses, self.sample = engine, poses, sample or {}
        self.asked = 0
        self.out: collections.deque = collections.deque()
        self.items: collections.deque = collections.deque()
        self.latency_ms: List[float] = []
        self.step_s: List[float] = []
        self.done_frames: List[tuple] = []  # (c2w, shift) of each frame done

    def ask(self, v: int) -> None:
        with record_function("bench.rays"):
            c2w, shift, ro, rd = self.poses.next(v)
        t = time.perf_counter()
        with record_function("engine.submit"):
            rid = self.engine.submit(ro, rd, scene="chair")
        n_items = -(-ro.shape[0] // self.engine.cfg.slot_rays)
        for i in range(n_items):
            self.items.append((c2w, shift, i))
        self.out.append((rid, v, t, c2w, shift))
        self.asked += 1

    def step(self, ask_more: bool = True) -> int:
        t0 = time.perf_counter()
        with record_function("engine.step"):
            n = self.engine.step()
        t1 = time.perf_counter()
        self.step_s.append(t1 - t0)
        done_items = [self.items.popleft() for _ in range(n)]
        while self.out:
            rid, v, t_ask, c2w, shift = self.out[0]
            try:
                colors = self.engine.result(rid)
            except ValueError:
                break
            self.out.popleft()
            self.latency_ms.append((t1 - t_ask) * 1e3)
            self.done_frames.append((c2w, shift))
            group = self.sample.get("jittered" if shift else "exact")
            if group is not None:  # the engine has freed the request
                group.offer((c2w, shift, colors))
            if ask_more:
                self.ask(v)
        return done_items

    def drain(self) -> int:
        """Step until every asked frame is answered; the number of frames
        that never will be (the engine went idle without them)."""
        while self.out:
            if not self.step(ask_more=False) and not self.engine.pending:
                return len(self.out)
        return 0


def item_work(inputs: Dict, config: Dict, poses: Poses, items, tiers,
              slot_rays: int, device) -> float:
    """Least device seconds of the field work of `items` ((c2w, shift,
    seq) with their `tiers`) by the frozen counts: the samples these rays
    need, the distinct table rows and grid cells they touch."""
    grid = inputs["grid"]
    t = ref.depths(config["render"], device)
    L, F = config["hash"]["n_levels"], config["hash"]["n_features"]
    res, entries = ref.level_resolutions(config["hash"]), \
        ref.level_entries(config["hash"])
    T = 1 << config["hash"]["log2_table_size"]
    dims = ref.linear_dims(config)
    wbits = config["bits"]["weight"]
    G = grid.shape[0]
    total = 0.0
    for (c2w, shift, seq), tier in zip(items, tiers):
        ro, rd = cameras.frame_rays(c2w, poses.dirs, shift)
        sl = slice(seq * slot_rays, (seq + 1) * slot_rays)
        o = torch.from_numpy(np.ascontiguousarray(ro[sl])).to(device)
        d = torch.from_numpy(np.ascontiguousarray(rd[sl])).to(device)
        active, pts = ref.active_samples(grid, o, d, t)
        R, S = active.shape
        n = int(active.sum())
        p = torch.clamp(pts[active] + 0.5, 0.0, 1.0)
        rows = sum(int(torch.unique(ref.corners(p, res[l], entries[l],
                                                (res[l] + 1) ** 3 <= T)[0])
                       .numel()) for l in range(L))
        work = []
        if tier == "hit":
            work.append(costs.hash_encode_corners(L, n, F, rows))
        else:
            inside = ((pts > -0.5) & (pts < 0.5)).all(dim=-1)
            cell = torch.clamp(((pts[inside] + 0.5) * G).to(torch.int64), 0,
                               G - 1)
            cells = int(torch.unique(cell[:, 0] * G * G + cell[:, 1] * G
                                     + cell[:, 2]).numel())
            work += [costs.ray_march(R, S, cells),
                     costs.hash_encode_points(n, L, F, rows)]
        for K, N in dims.values():
            work.append(costs.quant_matmul_packed(n, K, N,
                                                  -(-K // 32) * wbits * N))
        work.append(costs.gather_composite(R, S, 8 if tier == "march" else 4,
                                           n))
        total += sum(costs.least_s(*w) for w in work)
    return total


def field_ops(inputs: Dict, config: Dict, poses: Poses, frames,
              device) -> float:
    """Integer operations of the five linears over the active samples of
    `frames` ((c2w, shift) of each)."""
    grid = inputs["grid"]
    t = ref.depths(config["render"], device)
    macs = sum(K * N for K, N in ref.linear_dims(config).values())
    counts: Dict[tuple, int] = {}
    total = 0
    for c2w, shift in frames:
        key = (c2w.tobytes(), shift)
        if key not in counts:
            ro, rd = cameras.frame_rays(c2w, poses.dirs, shift)
            o = torch.from_numpy(np.ascontiguousarray(ro)).to(device)
            d = torch.from_numpy(rd).to(device)
            counts[key] = int(ref.active_samples(grid, o, d, t)[0].sum())
        total += counts[key]
    return 2.0 * macs * total


def run(config: Dict, traffic: Dict, limits: Dict, seed: int,
        seconds: float, trace: bool, device, control: bool = False
        ) -> Outcome:
    """One run of a cell. `control` adds the control's readings (the
    reference in bfloat16 in the port's place) as `control_*` counters:
    `bench/control.py` reads them; the benchmark's runs do not."""
    t_setup = time.perf_counter()
    inputs = make_inputs(config, seed, device)
    engine = build_engine(config, traffic, inputs, device)
    ecfg = engine.cfg
    poses = Poses(traffic, seed, ecfg.pose_pos_cell, ecfg.pose_dir_cell)
    chk = traffic["check"]
    if poses.p["source"] == "hotset":
        # Each hot pose twice exact (the second visit builds its plans),
        # then once exact (hit) and once jittered (warp).
        visits = list(poses.hot_visits())
        for _ in range(2):
            for _, shift, ro, rd in visits:
                if shift == 0.0:
                    engine.render(ro, rd, scene="chair")
        for _, _, ro, rd in visits:
            engine.render(ro, rd, scene="chair")
    else:
        warm = Loop(engine, poses)
        for v in poses.first:
            warm.ask(v)
        while warm.asked < traffic["warmup_frames"]:
            warm.step()
        warm.drain()
    sync(device)
    st0 = engine.stats()
    pc0 = dict(st0["pose_cache"])
    gc.freeze()  # set-up's objects leave the collector's young generations
    setup_s = time.perf_counter() - t_setup

    rng = np.random.default_rng([seed, 1])
    loop = Loop(engine, poses,
                {g: Reservoir(k, rng) for g, k in chk.items()})
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    for v in poses.first:
        loop.ask(v)
    while True:
        loop.step()
        t1 = time.perf_counter()
        if t1 - t0 >= seconds:
            break
    window_s = t1 - t0
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    frames = len(loop.latency_ms)
    latency = list(loop.latency_ms)
    steps = list(loop.step_s)
    done_frames = list(loop.done_frames)
    st1 = engine.stats()
    pc1 = dict(st1["pose_cache"])
    out = Outcome(setup_s=setup_s, window_s=window_s,
                  attempted=loop.asked, failed=0,
                  memory_peak_bytes=0,
                  records={"frame_ms": latency, "step_s": steps},
                  counters={"frames": frames})
    for k in ("hits", "warps", "misses"):
        out.counters[f"pose_{k}"] = pc1[k] - pc0[k]
    q = np.percentile(np.array(steps) * 1e3, [50, 90, 99, 100])
    out.notes += [
        ("budget", f"{st1['sample_budget']}, grown {st1['budget_retraces'] - st0['budget_retraces']} times in the window; plan builds {pc1['builds'] - pc0['builds']}"),
        ("host", f"page faults {ru1.ru_minflt - ru0.ru_minflt}, context switches {ru1.ru_nvcsw - ru0.ru_nvcsw} / {ru1.ru_nivcsw - ru0.ru_nivcsw} involuntary, cpu {ru1.ru_utime - ru0.ru_utime:.2f} user {ru1.ru_stime - ru0.ru_stime:.2f} sys"),
        ("steps", f"{len(steps)}, ms p50 {q[0]:.2f} p90 {q[1]:.2f} p99 {q[2]:.2f} max {q[3]:.2f}; frames {frames}, frame ms p50 {np.percentile(latency, 50):.1f}")]
    if trace:
        n0 = len(loop.step_s)
        items: List = []
        pcs = dict(engine.stats()["pose_cache"])

        def traced_steps():
            for _ in range(traffic["trace_steps"]):
                items.extend(loop.step())
        out.trace = traced(traced_steps, device)
        pce = engine.stats()["pose_cache"]
        tiers = [("hit" if s == 0.0 else "warp")
                 if poses.p["source"] == "hotset" else "march"
                 for _, s, _ in items]
        want = {"hits": tiers.count("hit"), "warps": tiers.count("warp"),
                "misses": tiers.count("march")}
        got = {k: pce[k] - pcs[k] for k in want}
        if got != want:
            out.notes.append(("tiers", f"traced items {want}, engine {got}"))
        else:
            out.work["ngp_field_s"] = item_work(
                inputs, config, poses, items, tiers, ecfg.slot_rays, device)
        out.work["ngp_field_ops"] = field_ops(inputs, config, poses,
                                              done_frames, device)
        del loop.step_s[n0:]
    out.failed += loop.drain()
    sync(device)
    out.memory_peak_bytes = peak_bytes(device)
    del engine, loop.engine
    release(device)

    # The reference: the seeded sample of the frames answered from the
    # window's start to the drain, rendered again.
    keep = [item for group in loop.sample.values() for item in group.items]
    ref.matmul_precision_f32()
    qf = ref.quantize_field(inputs["weights"], config, config["bits"],
                            inputs["act_ranges"])
    worst, mean_sum, n = 0.0, 0.0, 0
    if not keep:
        out.failed += 1  # no frame was answered: nothing to judge
    for c2w, shift, served in keep:
        ro, rd = cameras.frame_rays(c2w, poses.dirs, shift)
        want = ref.render_rays(
            qf, inputs["grid"],
            torch.from_numpy(np.ascontiguousarray(ro)).to(device),
            torch.from_numpy(np.ascontiguousarray(rd)).to(device),
            config["render"]).cpu().numpy()
        big, mean = ref.pixel_errors(served, want)
        worst, mean_sum, n = max(worst, big), mean_sum + mean, n + 1
        if control:
            low = ref.render_rays(
                qf, inputs["grid"],
                torch.from_numpy(np.ascontiguousarray(ro)).to(device),
                torch.from_numpy(np.ascontiguousarray(rd)).to(device),
                config["render"], dtype=torch.bfloat16).cpu().numpy()
            big, mean = ref.pixel_errors(low, want)
            c = out.counters
            c["control_rgb_max_abs"] = max(c.get("control_rgb_max_abs", 0.0),
                                           big)
            c["control_rgb_mean_abs"] = c.get("control_rgb_mean_abs", 0.0) \
                + mean / len(keep)
    out.checks = {"rgb_max_abs": Check(worst, limits["rgb_max_abs"]),
                  "rgb_mean_abs": Check(mean_sum / max(n, 1),
                                        limits["rgb_mean_abs"])}
    return out
