"""The controls of the cells' correctness checks, on the card at the
cells' own sizes: for each seed one run of the cell (a short window)
reads the program's numbers beside the control's, the reference computed
in the precision below the configuration's (NeRF: its float arithmetic in
bfloat16; LM: float8 e4m3 products) in the program's place. Each
control's numbers go through the cell's own checks (`bench/checks/`), as
the program's do, and have to come out not correct.

    python3 bench/control.py --workload <name> --seeds 11,12,13 --seconds 5

One JSON line a seed, each seed in a process of its own: each number
with its limit, `correct` (the program's) and `control_correct`. Exits
with 1 where a seed's program is not correct or its control is. The
benchmark's runs never run this; the limits in `bench/checks/` were set
from what it prints (`PERF.md`).
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from bench.lib.outcome import Check  # noqa: E402
from bench.run import cell, load_json  # noqa: E402


def control_checks(out, limits: Dict[str, float]) -> Dict[str, Check]:
    """The control's reading of each of the cell's numbers beside its
    limit; a number the control did not give is NaN, which no limit
    passes, so a control that gives nothing has failed."""
    return {k: Check(float(out.counters.get(f"control_{k}", math.nan)), lim)
            for k, lim in limits.items()}


def pairs(checks: Dict[str, Check]) -> Dict[str, list]:
    return {k: [c.value, c.limit] for k, c in checks.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    _, _, config, traffic, limits = cell(load_json(ROOT / "BENCHMARK.json"),
                                         args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    if len(seeds) > 1:  # a process a seed: each run's weights go with it
        rcs = [subprocess.run([sys.executable, __file__, "--workload",
                               args.workload, "--seeds", str(seed),
                               "--seconds", str(args.seconds)],
                              check=False).returncode for seed in seeds]
        return int(any(rcs))
    driver = importlib.import_module(f"bench.drivers.{config['kind']}")
    t0 = time.perf_counter()
    out = driver.run(config, traffic, limits, seeds[0], args.seconds, False,
                     torch.device("cuda", 0), control=True)
    ctl = control_checks(out, limits)
    control_correct = all(c.ok for c in ctl.values())
    print(json.dumps({
        "workload": args.workload, "seed": seeds[0],
        "program": pairs(out.checks), "control": pairs(ctl),
        "correct": out.correct, "control_correct": control_correct,
        "seconds": time.perf_counter() - t0}), flush=True)
    return int(control_correct or not out.correct)


if __name__ == "__main__":
    sys.exit(main())
