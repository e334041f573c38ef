#!/usr/bin/env python3
"""Time the port's two quantized-matmul kernels with other tile constants
than the ones `src/repro_torch/csrc/qmm_tile.cuh` holds, at the five paper
linears of one NeRF slot (M = 16,384, as `chip_smoke.py` times them), on
one CUDA card.

Run from the repository root: ``python3 scripts/torch_qmm_tune.py``.

A variant sets the header's three tuned constants: BM (rows a tile),
BLOCKS_PER_SM (blocks an SM the grid aims for) and STAGES (x tiles in
flight). Each is a copy of the header with those constants replaced,
built with the two quantized-matmul sources into a library of its own
under `build/repro_torch_kernels/tune/` (every `nvcc` started together).
The wrappers are pointed at each library in turn, and at the kernels'
own library first. Both kernels are checked bit-equal to their plain
versions at the five shapes, then timed as `chip_smoke.py` times them:
the sum of the five linears each in its own bracket (device time, the
median of 20 CUDA-event-timed calls queued behind a spin kernel) and the
five back to back in one bracket (`seq`). The variants run twice, the
second time in reverse order. Prints one line per reading, the card's
name and power limit, and a last line of JSON with every reading.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (median_ms, qmm_inputs: the same timing)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import quant_matmul as qm  # noqa: E402
from repro_torch.kernels.backend import power_limit  # noqa: E402

CONSTANTS = ("BM", "BLOCKS_PER_SM", "STAGES")
VARIANTS = list(itertools.product((32, 64, 128), (1, 2, 4), (1, 2, 3)))
SOURCES = ("quant_matmul_packed.cu", "quant_matmul.cu")
ENTRIES = ("repro_quant_matmul_packed", "repro_quant_matmul")


def variant_header(header: str, values) -> str:
    for name, v in zip(CONSTANTS, values):
        header, n = re.subn(rf"constexpr int {name} = \d+;",
                            f"constexpr int {name} = {v};", header)
        if n != 1:
            raise RuntimeError(f"qmm_tile.cuh defines {name} {n} times")
    return header


def build_variants() -> dict:
    """{values: loaded library} of every variant."""
    out = build.build_dir() / "tune"
    header = (build.CSRC / "qmm_tile.cuh").read_text()
    procs = []
    for values in VARIANTS:
        d = out / "bm{}-bps{}-st{}".format(*values)
        d.mkdir(parents=True, exist_ok=True)
        (d / "qmm_tile.cuh").write_text(variant_header(header, values))
        for name in SOURCES:
            shutil.copy(build.CSRC / name, d / name)
        lib = d / "libqmm.so"
        procs.append((values, lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
             *(str(d / name) for name in SOURCES), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for values, lib, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {values}:\n{log}")
        libs[values] = ctypes.CDLL(str(lib))
        for fn in ENTRIES:
            f = getattr(libs[values], fn)
            f.argtypes, f.restype = build.SIGNATURES[fn], ctypes.c_int
    return libs


def time_kernel(cases, kernel, plain):
    """(sum of the five bracketed linears, the five in one bracket), ms."""
    for c in cases:
        if not torch.equal(kernel(*c[:5]), plain(*c[:5])):
            raise AssertionError(f"{kernel.__name__} != plain at "
                                 f"{tuple(c[0].shape)} x {tuple(c[6].shape)}")
    alone = sum(chip_smoke.median_ms(lambda c=c: kernel(*c[:5]))
                for c in cases)
    seq = chip_smoke.median_ms(lambda: [kernel(*c[:5]) for c in cases])
    return alone, seq


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_qmm_tune: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    packed = chip_smoke.qmm_inputs(rng, dev, packed=True)
    unpacked = chip_smoke.qmm_inputs(rng, dev, packed=False)
    own = build.library()
    libs = {"as built": own, **build_variants()}
    order = list(libs) + ["as built"] + list(libs)[:0:-1]
    rows = []
    try:
        for key in order:
            build.library = lambda lib=libs[key]: lib
            p_alone, p_seq = time_kernel(packed, qm.quant_matmul_packed_cuda,
                                         qm.quant_matmul_packed_plain)
            u_alone, u_seq = time_kernel(unpacked, qm.quant_matmul_cuda,
                                         qm.quant_matmul_plain)
            row = {"variant": key if isinstance(key, str) else
                   dict(zip(CONSTANTS, key)),
                   "packed_ms": p_alone, "packed_seq_ms": p_seq,
                   "unpacked_ms": u_alone, "unpacked_seq_ms": u_seq}
            rows.append(row)
            print(" ".join(f"{k} {v:.4f}" if isinstance(v, float)
                           else f"{k} {v}" for k, v in row.items()))
    finally:
        build.library = lambda: own
    print(f"card: {power_limit()}")
    print(json.dumps({"readings": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
