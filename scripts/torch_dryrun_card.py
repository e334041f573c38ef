#!/usr/bin/env python3
"""Phase 15 of `chip_smoke.py` alone: the dry-run's prediction of phase
14's one-rank qwen2-7b step (2 of 28 layers, f32 moments, 2 x 4 x 1,024
tokens, traced on the CPU in a child process) against the same step on
the card: kernel 6's and its backward's launches, the peak of allocated
memory, the device time against the roofline's step time; and the full
qwen2-7b x train_4k x 16x16 cell traced meanwhile.

Needs one CUDA card (the kernels are built first, as `chip_smoke.py`
builds them). Run from the repository root:

    python3 scripts/torch_dryrun_card.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_dryrun_card: no CUDA device is available",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.backend import power_limit

    print(f"card: {power_limit()}")
    res = build.build()
    print(f"kernel build: {res.seconds:.2f} s")
    build.library()
    chip_smoke.dryrun_phase(torch.device("cuda"), chip_smoke.counters())
    return 0


if __name__ == "__main__":
    sys.exit(main())
