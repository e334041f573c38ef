#!/usr/bin/env python3
"""Phase 16 of `chip_smoke.py` alone: kernel 7's partial form (the f32
output and the log-sum-exp, length 0 included) against its plain
version; the flash-decoding combine of 2, 4 and 16 blocks of one cache
against kernel 7 over the whole cache; qwen2-7b at its published width
and depth served placed over a one-rank NCCL mesh (a prefill of 4 x
1,024 tokens, 32 greedy decode steps), bit-equal to the unplaced serve;
and the dry-run's one-rank prefill and decode cells of that serve
(traced on the CPU in child processes) against the card: kernel 6's and
7's launches, the decode step's peak and device time.

Needs one CUDA card (the kernels are built first, as `chip_smoke.py`
builds them). Run from the repository root:

    python3 scripts/torch_serve_card.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_serve_card: no CUDA device is available",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.backend import power_limit

    print(f"card: {power_limit()}")
    res = build.build()
    print(f"kernel build: {res.seconds:.2f} s")
    build.library()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    entry = chip_smoke.phase_decode_attention(dev)
    chip_smoke.serve_phase(dev, chip_smoke.counters(), entry)
    print({k: v for k, v in entry.items() if k != "name"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
