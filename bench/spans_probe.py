"""Read the program's own spans in traced windows of one cell.

    python3 bench/spans_probe.py --workload ngp-fresh-800 --seed 12345 \\
        --seconds 20 --pairs 3 [--out chiprun_out/probe.json]

Sets the cell up as its driver does (`bench/drivers/<kind>.py`: the same
inputs from the seed, the same warm-up, the same closed loop of viewers
or stream of batches, the benchmark's own `record_function` ranges) and
runs it for `--seconds`. Then come windows of the cell's `trace_steps`
engine steps or `trace_batches` batches (the same batches in each LM
window, the loop's next frames in each NeRF one):

- `reading`: the process's first profile with the program's span
  recording (`repro_torch.spans`) open inside it, as a benchmark's
  traced run would hold it: the eight metrics of `bench.lib.spans`;
- `traced`: `--pairs` pairs of profiled windows, recording off then on;
- `plain`: `--pairs` pairs without the profiler, recording off then on;
- `queue` (NeRF): one recorded window without the profiler, ten times
  as long, whose `ngp.queue_wait_ms` holds whole waits (a wait longer
  than half a window reads None: `bench.lib.spans.queue_wait_ms`).

The last line of standard output is JSON. For each window: whether it
was recorded, its length and mean step (NeRF) or batch (LM)
milliseconds; profiled, the device's busy seconds, idle share and op
count; recorded, the program's metrics (without the profiler only
those of the host's clock), and profiled and recorded, the
window's idle time split by the cell's two outer spans, the count of
spans lying outside the benchmark's range around the same call, and the
least and most margin by which spans enclose their profiler ranges.
Then the device ops whose counts differ between profiled windows
(`ops_differ`), the median step or batch time and idle share of each
kind of window (`cost`), and each span name's count, total and self
milliseconds in the reading (`spans`, also `note spans:` lines on
standard error). `--out` writes the same JSON with each profiled
window's device-op counts by name. Without a card it exits 2 and prints
no result, as `bench/run.py` does; the harness's tests call `probe` on
the CPU at small sizes.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]

# Per kind: the outer spans whose idle time is split, and each span with
# the benchmark's range around the same call.
OUTER = {"ngp": ("hero.submit", "hero.step"),
         "lm": ("lm.prefill", "lm.decode")}
# The metrics a window without the profiler still gives.
QUEUE_SCALE = 10  # the `queue` window's length in traced windows
HOST_ONLY = ("ngp.submit_ms", "ngp.queue_wait_ms", "ngp.syncs_per_step",
             "lm.decode_host_ms")
NESTED = {"ngp": (("hero.submit", "engine.submit"),
                  ("hero.step", "engine.step")),
          "lm": (("lm.prefill", "lm.generate"),
                 ("lm.decode", "lm.generate"))}


def ngp_cell(config: Dict, traffic: Dict, seed: int, seconds: float, device):
    """(a window's call, steps a window) of the NeRF cell, after its
    set-up and `seconds` of the closed loop; the call takes the steps to
    run, one window's by default."""
    from bench.drivers import ngp

    inputs = ngp.make_inputs(config, seed, device)
    engine = ngp.build_engine(config, traffic, inputs, device)
    poses = ngp.Poses(traffic, seed, engine.cfg.pose_pos_cell,
                      engine.cfg.pose_dir_cell)
    warm = ngp.Loop(engine, poses)
    for v in poses.first:
        warm.ask(v)
    while warm.asked < traffic["warmup_frames"]:
        warm.step()
    warm.drain()
    gc.freeze()
    loop = ngp.Loop(engine, poses)
    for v in poses.first:
        loop.ask(v)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        loop.step()
    n = traffic["trace_steps"]

    def window(steps: int = n):
        for _ in range(steps):
            loop.step()
    return window, n


def lm_cell(config: Dict, traffic: Dict, seed: int, seconds: float, device):
    """(one traced window's call, batches a window) of the LM cell, after
    its set-up and `seconds` of batches."""
    from torch.profiler import record_function

    from bench.drivers import lm
    from bench.lib.device import sync
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    model = lm.model_config(config)
    params = lm.make_weights(model, seed, device)
    B, gen = traffic["batch"], traffic["gen_tokens"]
    P = model.n_prefix_patches
    steps = {L: make_prefill_step(model, P + L + gen)
             for L in traffic["text_lengths"]}
    decode = make_decode_step(model)
    order = lm.lengths(traffic, seed, 100_000)

    def serve(b: int):  # the driver's `serve`: syncs, marks and ranges
        with record_function("bench.inputs"):
            tokens, patches = lm.batch_inputs(model, seed, b, B, order[b],
                                              device)
        sync(device)
        marks = [time.perf_counter()]
        with record_function("lm.generate"):
            generate(steps[order[b]], decode, params, tokens, gen, marks,
                     {"patches": patches}).cpu()

    longest = max(traffic["text_lengths"])
    for L in traffic["text_lengths"]:
        tokens, patches = lm.batch_inputs(model, seed, -1, B, L, device)
        generate(steps[L], decode, params, tokens,
                 gen if L == longest else 2, None,
                 {"patches": patches}).cpu()
    gc.freeze()
    b, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        serve(b)
        b += 1
    n = traffic["trace_batches"]

    def window():  # the same batches in every window
        for i in range(n):
            serve(b + i)
    return window, n


def probe(kind: str, config: Dict, traffic: Dict, seed: int,
          seconds: float, pairs: int, device) -> Dict:
    """The probe's result (module docstring), with each profiled window's
    device-op counts under `op_counts`. The LM cell runs under inference
    mode, as its driver does."""
    import torch

    with torch.inference_mode(kind == "lm"):
        return _probe(kind, config, traffic, seed, seconds, pairs, device)


def _probe(kind, config, traffic, seed, seconds, pairs, device) -> Dict:
    from bench.lib import spans as sl

    window, n = (ngp_cell if kind == "ngp" else lm_cell)(
        config, traffic, seed, seconds, device)
    plan = [("reading", True)]
    plan += [("traced", k % 2 == 1) for k in range(2 * pairs)]
    plan += [("plain", k % 2 == 1) for k in range(2 * pairs)]
    if kind == "ngp":
        plan.append(("queue", True))
    rows: List[Dict] = []
    summary = None
    for what, record in plan:
        if what == "plain":
            w = plain_window(window, device, record)
        elif what == "queue":
            w = plain_window(lambda: window(QUEUE_SCALE * n), device, True)
        else:
            w = sl.traced_spans(window, device, record=record)
        units = QUEUE_SCALE * n if what == "queue" else n
        row = {"window": what, "recorded": w.rec is not None,
               "window_s": w.wall, "unit_ms": 1e3 * w.wall / units}
        if w.trace is not None:
            t = w.trace
            row.update(busy_s=t.busy_s, idle_pct=t.idle_pct(),
                       device_ops=sum(c for c, _ in t.by_name.values()),
                       op_counts={name: c
                                  for name, (c, _) in t.by_name.items()})
        if w.rec is not None:
            row["dropped"] = w.rec.dropped
            if w.trace is None:
                row["metrics"] = {k: v for k in HOST_ONLY
                                  if (v := sl.READERS[k](w)) is not None}
            else:
                row.update(
                    metrics=sl.metrics(w),
                    idle_split=sl.idle_split(w, OUTER[kind]),
                    idle_closed_ms=1e-3 * (w.hi - w.lo) - 1e3 * t.busy_s,
                    unnested={f"{a} in {b}": sl.unnested(w, a, b)
                              for a, b in NESTED[kind]},
                    clock_margins_us=sl.clock_margins_us(w))
            if summary is None:
                summary = w.rec.summary()
        rows.append(row)
    counts = [r["op_counts"] for r in rows if "op_counts" in r]
    names = sorted({k for c in counts for k in c})
    differ = {k: [c.get(k, 0) for c in counts] for k in names
              if len({c.get(k, 0) for c in counts}) > 1}
    cost = {}
    for what in ("traced", "plain"):
        for on in (True, False):
            rs = [r for r in rows if r["window"] == what
                  and r["recorded"] == on]
            if rs:
                cost[f"{what}.{'on' if on else 'off'}"] = {
                    k: statistics.median(r[k] for r in rs)
                    for k in ("unit_ms", "idle_pct") if k in rs[0]}
    return {"kind": kind, "seed": seed, "steps_or_batches": n,
            "windows": rows, "ops_differ": differ, "cost": cost,
            "spans": {name: [c, 1e3 * tot, 1e3 * own]
                      for name, (c, tot, own) in (summary or {}).items()}}


def plain_window(fn, device, record: bool):
    """`fn` with no profiler, the program's recording open when `record`:
    a `bench.lib.spans.Window` without a trace."""
    from bench.lib.device import sync
    from bench.lib.spans import Window

    try:
        from repro_torch import spans as program
    except ImportError:  # a program without spans records nothing
        program = None
    rec = None
    sync(device)
    t0, lo = time.perf_counter(), time.time_ns() * 1e-3
    if record and program is not None:
        with program.recording() as rec:
            fn()
    else:
        fn()
    sync(device)
    return Window(trace=None, lo=lo, hi=time.time_ns() * 1e-3, idle=[],
                  host=[], rec=rec, wall=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    # The environment of a benchmark run (`bench/run.py`).
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print(f"{args.workload}: the probe needs a CUDA card; found none",
              file=sys.stderr)
        return 2
    from bench import run

    manifest = run.load_json(ROOT / "BENCHMARK.json")
    _, _, config, traffic, _ = run.cell(manifest, args.workload)
    device = torch.device("cuda", 0)
    res = probe(config["kind"], config, traffic, args.seed, args.seconds,
                args.pairs, device)
    res["workload"] = args.workload
    res["device"] = torch.cuda.get_device_name(device)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    for name, (c, tot, own) in sorted(res["spans"].items()):
        print(f"note spans: {name} {c} spans, {tot:.3f} ms, self {own:.3f} ms",
              file=sys.stderr)
    for row in res["windows"]:
        row.pop("op_counts", None)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
