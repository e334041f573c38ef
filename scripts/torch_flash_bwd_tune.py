#!/usr/bin/env python3
"""Time the tensor-core route of kernel 6's backward
(`src/repro_torch/csrc/flash_attention_bwd.cu`, bfloat16) with other tile
constants than the ones the source holds, at the four bf16 training shapes
`chip_smoke.py` times it at (qwen2-7b's, whisper's encoder, cross and
decoder), on one CUDA card.

Run from the repository root: ``python3 scripts/torch_flash_bwd_tune.py``.

A variant sets KV_WARPGROUPS (warpgroups of 64 keys a dK/dV block, sharing
the Q / dO ring) and Q_WARPGROUPS (warpgroups of 64 rows a dQ block,
sharing the K / V ring). Each is a copy of the source with those constants
replaced, built with `wgmma_tile.cuh` into a library of its own under
`build/repro_torch_kernels/tune_bwd/` (every `nvcc` started together). The
forward's output and log-sum-exp come from the kernels' own library; the
backward wrapper is then pointed at each library in turn, the own library
first. Each variant is checked against the plain version (within
`chip_smoke.BWD_TOL`, a rerun bit-equal) and timed as `chip_smoke.py`
times the kernel (device time, the median of 10 CUDA-event-timed calls
queued behind a spin kernel). The variants run twice, the second time in
reverse order. Prints one line per reading, each kernel's registers and
spills, the card's name and power limit, and a last line of JSON with
every reading.
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

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (train_shapes, bwd_inputs, median_ms)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention_kernel as fk  # noqa: E402
from repro_torch.kernels.backend import power_limit  # noqa: E402

CONSTANTS = ("KV_WARPGROUPS", "Q_WARPGROUPS")
VARIANTS = list(itertools.product((1, 2), (1, 2)))
SOURCE, HEADER = "flash_attention_bwd.cu", "wgmma_tile.cuh"
ENTRY = "repro_flash_attention_bwd"


def variant_source(src: str, values) -> str:
    for name, v in zip(CONSTANTS, values):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {v};", src)
        if n != 1:
            raise RuntimeError(f"{SOURCE} defines {name} {n} times")
    return src


def build_variants() -> dict:
    """{values: loaded library} of every variant; prints ptxas's lines."""
    out = build.build_dir() / "tune_bwd"
    src = (build.CSRC / SOURCE).read_text()
    procs = []
    for values in VARIANTS:
        d = out / "kv{}-q{}".format(*values)
        d.mkdir(parents=True, exist_ok=True)
        (d / SOURCE).write_text(variant_source(src, values))
        shutil.copy(build.CSRC / HEADER, d / HEADER)
        lib = d / "libbwd.so"
        procs.append((values, lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
             str(d / SOURCE), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for values, lib, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {values}:\n{log}")
        for line in log.splitlines():
            if "tc_kernel" in line or "registers" in line or "spill" in line:
                print(f"  {values}: {line.strip()[:150]}")
        libs[values] = ctypes.CDLL(str(lib))
        f = getattr(libs[values], ENTRY)
        f.argtypes, f.restype = build.SIGNATURES[ENTRY], ctypes.c_int
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_bwd_tune: no CUDA device is available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    cases = []
    for name, B, Hkv, G, hd, Sq, Sk, causal, dtype in \
            chip_smoke.train_shapes():
        if dtype != torch.bfloat16:
            continue
        q, k, v, do = chip_smoke.bwd_inputs(gen, dev, B, Hkv, G, hd, Sq, Sk,
                                            dtype)
        lse = torch.empty((B, Hkv, Sq, G), device=dev)
        out = fk.flash_attention_cuda(q, k, v, causal, lse)
        want = fk.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
        cases.append((name, (q, k, v, out, lse, do, causal), want))
    own = build.library()
    libs = {"as built": own, **build_variants()}
    order = list(libs) + ["as built"] + list(libs)[:0:-1]
    tol = chip_smoke.BWD_TOL[torch.bfloat16]
    rows = []
    try:
        for key in order:
            build.library = lambda lib=libs[key]: lib
            row = {"variant": key if isinstance(key, str) else
                   dict(zip(CONSTANTS, key))}
            for name, args, want in cases:
                got = fk.flash_attention_bwd_cuda(*args)
                again = fk.flash_attention_bwd_cuda(*args)
                err = max(((a.float() - w.float()).abs().max()
                           / w.float().abs().max()).item()
                          for a, w in zip(got, want))
                if not (err <= tol and all(torch.equal(a, b)
                                           for a, b in zip(got, again))):
                    raise AssertionError(f"{key} at {name}: error {err}")
                row[f"{name}_ms"] = chip_smoke.median_ms(
                    lambda a=args: fk.flash_attention_bwd_cuda(*a), iters=10)
                row[f"{name}_err"] = err
            rows.append(row)
            print(" ".join(f"{k} {v:.4g}" if isinstance(v, float)
                           else f"{k} {v}" for k, v in row.items()))
    finally:
        build.library = lambda: own
    print(f"card: {power_limit()}")
    print(json.dumps({"readings": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
