"""Subprocess cell worker: `python -m repro_torch.distributed.worker_main job.json`.

The job file carries a JSON `ClosedLoopConfig`, one `CellSpec` and the
device kind the run lives on ("cuda" or "cpu"). The worker rebuilds the
scene env from the config (nothing is pickled — the same seeded training
the orchestrator would run) on that device, executes the single cell,
and prints the `CellOutput` on a marker line for `SubprocessWorker.poll()`
to parse. Exit code 0 + marker line = done; anything else is reported as
a worker crash. A child on a card sees the one its parent pinned it to
(`CUDA_VISIBLE_DEVICES`) as "cuda".
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

from repro_torch.core.closed_loop import CellSpec, HeroSearchRun, config_from_json

MARKER = "HERO_CELL_OUTPUT:"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m repro_torch.distributed.worker_main "
              "<job.json>", file=sys.stderr)
        return 2
    job = json.loads(Path(argv[0]).read_text())
    cfg = config_from_json(job["config"])
    spec = CellSpec.from_json(job["spec"])
    run = HeroSearchRun(cfg, device=job["device"])
    out = run.run_cell(spec)
    # Marker line LAST: training chatter above it never confuses the parse.
    print(MARKER + json.dumps(out.to_json()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
