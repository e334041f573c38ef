"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `BENCHMARK.json`'s `workloads`: its configuration
file (`bench/configs/<config>.json`, whose `kind` names the driver
`bench/drivers/<kind>.py`), its traffic (`bench/traffic/<traffic>.json`)
and its check limits (`bench/checks/<workload>.json`). Each metric is
read by `bench/metrics/<metric>.py` (`read(outcome)` -> a number or
None). With `--trace 0` the line carries the cell's end-to-end metrics,
with `--trace 1` its per-layer metrics, the device's busy and window
seconds and a breakdown of the traced window.

The run needs a CUDA card (it exits with 2 and prints no result without
one), builds or loads the port's kernel library under `build/` in this
checkout, and exits with 3 and no result if a module of JAX or of the
JAX package (`repro`) is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, name: str):
    """(workload, configuration entry, configuration, traffic, limits)."""
    work = {w["name"]: w for w in manifest["workloads"]}[name]
    entry = {c["name"]: c for c in manifest["configs"]}[work["config"]]
    return (work, entry, load_json(ROOT / entry["file"]),
            load_json(ROOT / "bench" / "traffic" / f"{work['traffic']}.json"),
            load_json(ROOT / "bench" / "checks" / f"{name}.json"))


def metrics_of(manifest: dict, workload: str, trace: bool):
    """The cell's metric entries: end-to-end without trace, per-layer with."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}",
        ROOT / "bench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def result_line(manifest: dict, workload: str, trace: bool, out, device,
                chips: int) -> dict:
    import torch

    values = {}
    for m in metrics_of(manifest, workload, trace):
        v = reader(m["name"])(out)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": chips, "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": values, "device": dev}
    if trace and out.trace is not None:
        dev["busy_s"] = out.trace.busy_s
        dev["window_s"] = out.trace.window_s
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {k: {"value": c.value, "limit": c.limit}
                      for k, c in out.checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # One thread a host pool: the load is one process's, and a pool's
    # threads only contend with the thread that launches.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    # Caches inside the checkout, at fixed paths.
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    manifest = load_json(ROOT / "BENCHMARK.json")
    work, _, config, traffic, limits = cell(manifest, args.workload)
    chips = int(work["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    driver = importlib.import_module(f"bench.drivers.{config['kind']}")
    out = driver.run(config, traffic, limits, args.seed, args.seconds,
                     bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    line = result_line(manifest, args.workload, bool(args.trace), out,
                       device, chips)
    for name, value in out.notes:
        print(f"note {name}: {value}", file=sys.stderr)
    for name, c in out.checks.items():
        print(f"check {name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
