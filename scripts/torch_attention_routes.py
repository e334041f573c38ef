#!/usr/bin/env python3
"""Time both routes of kernel 6's bfloat16 forward at head dim 64 and both
routes of kernel 7, on one CUDA card, beside the library call and the
bound of each shape.

Run from the repository root: ``python3 scripts/torch_attention_routes.py``.
``--variants NAME=V1,V2`` (repeatable) also builds
`csrc/flash_attention.cu` with its constant NAME set to each value (say
``TCP_STAGES=3,4``, the pipelined kernel's ring depth, or
``TC128_PIPELINED=0,1``, the hd-128 route's kernel) into libraries of
their own under `build/repro_torch_kernels/tune_routes/`, and times
kernel 6 with each.

Kernel 6 (`src/repro_torch/csrc/flash_attention.cu`): at the six hd-64
shapes of `chip_smoke.FULL_SHAPES` (B 4) and at qwen3-moe's bf16 geometry
(B 4, Hkv 4, G 16, hd 64, S 1,024, causal), the route `flash_route` picks
("tc64", `flash_tcp_kernel<64>`) and the hd-128 kernel it replaced there
("tc128", hd zero-padded to 128) are each held to the plain version
(`chip_smoke.BF16_ATTN_LIMIT`; tc64's log-sum-exp within 1e-5 relative)
and timed in turns (tc64, tc128, tc128, tc64), beside SDPA and the bound
(`kernels/cost.py`). qwen2-7b's hd-128 shape is timed too: its route did
not change.

Kernel 7 (`src/repro_torch/csrc/decode_attention.cu`): the partial form
(`lse=True`) and the whole-cache form at blocks of 66, 88, 110, 132, 264
and 1,056 positions of phase 16's cache (B 4, Hkv 4, G 7, hd 128, bf16)
and at the block a rank holds in the dry-run's qwen2-7b decode_32k cell
on the 16 x 16 mesh (B 8, 2,048 positions), each by the one-pass route
(where its block fits shared memory) and the split route in turns (one
pass, split, split, one pass), held to the plain version (5e-3; the
log-sum-exp 1e-4 relative), beside the library call
(`aten._scaled_dot_product_efficient_attention` asked for its
log-sum-exp; SDPA for the whole-cache form) and the bound; the partial
form at lengths 0 to 66 of the first block by both routes; and the
whole-cache form at qwen2-7b's serve shape (length on the card, 1,040 of
1,056 rows) as `chip_smoke.py` times it.

Times are device times, the median of 20 CUDA-event-timed calls queued
behind a spin kernel (`chip_smoke.median_ms`). Prints one line a reading,
the card's name and power limit, and a last line of JSON with every
reading.
"""
from __future__ import annotations

import argparse
import ctypes
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

import chip_smoke as cs  # noqa: E402  (median_ms, bound, the shapes)
from repro_torch.kernels import build, cost  # noqa: E402
from repro_torch.kernels import decode_attention_kernel as dk  # noqa: E402
from repro_torch.kernels import flash_attention_kernel as fk  # noqa: E402
from repro_torch.kernels.backend import power_limit  # noqa: E402

SOURCE, HEADER = "flash_attention.cu", "wgmma_tile.cuh"
ENTRY = "repro_flash_attention"
QWEN3_MOE = ("qwen3_moe", 4, 16, 64, 1024, 1024, True)
QWEN2 = ("qwen2", cs.LM_HKV, cs.LM_G, cs.LM_HD, cs.LM_PROMPT, cs.LM_PROMPT,
         True)
# (name, B, positions) of kernel 7's blocks; Hkv, G, hd are phase 16's.
DECODE_BLOCKS = (("n66", 4, 66), ("n88", 4, 88), ("n110", 4, 110),
                 ("n132", 4, 132), ("n264", 4, 264), ("n1056", 4, 1056),
                 ("decode_32k_rank", 8, 2048))


def build_variants(const: str, values) -> dict:
    """{value: loaded library} of `flash_attention.cu` built with `const`
    set to each value (beside `wgmma_tile.cuh`); prints ptxas's register,
    spill and wgmma lines."""
    out = build.build_dir() / "tune_routes"
    src = (build.CSRC / SOURCE).read_text()
    procs = []
    for n in values:
        text, hits = re.subn(rf"constexpr int {const} = \d+;",
                             f"constexpr int {const} = {n};", src)
        if hits != 1:
            raise RuntimeError(f"{SOURCE} defines {const} {hits} times")
        d = out / f"{const}{n}"
        d.mkdir(parents=True, exist_ok=True)
        (d / SOURCE).write_text(text)
        shutil.copy(build.CSRC / HEADER, d / HEADER)
        lib = d / "libvariant.so"
        procs.append((n, lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
             str(d / SOURCE), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for n, lib, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {const}={n}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"  {const} {n}: {line.strip()[:150]}")
        libs[n] = ctypes.CDLL(str(lib))
        f = getattr(libs[n], ENTRY)
        f.argtypes, f.restype = build.SIGNATURES[ENTRY], ctypes.c_int
    return libs


def flash_inputs(gen, dev, B, Hkv, G, hd, Sq, Sk):
    """bf16 q, k, v as the model's views, and q in SDPA's layout."""
    q = torch.randn((B, Sq, Hkv * G, hd), generator=gen, device=dev) \
        .to(torch.bfloat16)
    k = torch.randn((B, Sk, Hkv, hd), generator=gen, device=dev) \
        .to(torch.bfloat16)
    v = torch.randn((B, Sk, Hkv, hd), generator=gen, device=dev) \
        .to(torch.bfloat16)
    return (q.view(B, Sq, Hkv, G, hd).permute(0, 2, 1, 3, 4),
            k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), q.transpose(1, 2))


def in_turns(fns: dict, order) -> dict:
    """{name: [ms, ...]} of the calls in `fns`, timed in `order`."""
    got = {n: [] for n in fns}
    for n in order:
        got[n].append(cs.median_ms(fns[n]))
    return got


def flash_readings(dev) -> list:
    gen = torch.Generator(device=dev).manual_seed(31)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes = [s for s in cs.FULL_SHAPES if s[3] == 64] + [QWEN3_MOE, QWEN2]
    rows = []
    for name, Hkv, G, hd, Sq, Sk, causal in shapes:
        B = cs.LM_BATCH
        q, k, v, qs = flash_inputs(gen, dev, B, Hkv, G, hd, Sq, Sk)
        want = fk.flash_attention_plain(q, k, v, causal)
        routes = ("tc64", "tc128") if hd <= 64 else ("tc128",)
        row = {"shape": name, "route": fk.flash_route(q.dtype, hd)}
        for r in routes:
            err = (fk._flash_launch(r, q, k, v, causal) - want).abs() \
                .max().item()
            if not err <= cs.BF16_ATTN_LIMIT:
                raise AssertionError(f"kernel 6 {r} at {name}: {err}")
            row[f"err_{r}"] = err
        if hd <= 64:
            lse = torch.empty((B, Hkv, Sq, G), device=dev)
            fk._flash_launch("tc64", q, k, v, causal, lse)
            w = fk.attention_lse_plain(q, k, causal)
            e = ((lse - w).abs().max() / w.abs().max()).item()
            if not e <= 1e-5:
                raise AssertionError(f"kernel 6 tc64's lse at {name}: {e}")
            row["lse_rel_err_tc64"] = e
        fns = {r: (lambda r=r: fk._flash_launch(r, q, k, v, causal))
               for r in routes}
        order = routes + routes[::-1]
        for r, ts in in_turns(fns, order).items():
            row[f"ms_{r}"] = ts
        row["library_ms"] = cs.median_ms(
            lambda: sdpa(qs, k, v, is_causal=causal, enable_gqa=True))
        row["bound_ms"], row["bound_by"] = cs.bound(cost.flash_attention(
            B, Hkv, G, hd, Sq, Sk, causal, 2))
        rows.append(row)
        print("kernel 6 " + " ".join(f"{a} {b}" for a, b in row.items()))
    return rows


def decode_readings(dev) -> list:
    gen = torch.Generator(device=dev).manual_seed(32)
    eff = torch.ops.aten._scaled_dot_product_efficient_attention
    sdpa = torch.nn.functional.scaled_dot_product_attention
    Hkv, G, hd = cs.LM_HKV, cs.LM_G, cs.LM_HD
    rows = []
    for name, B, n in DECODE_BLOCKS:
        q = torch.randn((B, Hkv, G, hd), generator=gen, device=dev) \
            .to(torch.bfloat16)
        cache = [torch.randn((B, max(n, cs.LM_SMAX), Hkv, hd),
                             generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(2)]
        k, v = (c[:, :n].permute(0, 2, 1, 3) for c in cache)
        fits = dk.one_pass_smem(n, G, hd, 2) <= dk.SMEM_MAX
        routes = (True, False) if fits else (False,)
        w_out, w_lse = dk.decode_attention_plain(q, k, v, n, lse=True)
        w_whole = dk.decode_attention_plain(q, k, v, n).float()
        row = {"block": name, "B": B, "positions": n,
               "one_pass_rule": dk.one_pass(n, G, hd, 2)}
        for one in routes:
            tag = "one_pass" if one else "split"
            out, lse = dk._decode_launch(one, q, k, v, n, lse=True)
            e_out = (out - w_out).abs().max().item()
            e_lse = ((lse - w_lse).abs().max() / w_lse.abs().max()).item()
            whole = dk._decode_launch(one, q, k, v, n).float()
            e_whole = (whole - w_whole).abs().max().item()
            if not (e_out <= cs.BF16_ATTN_LIMIT and e_lse <= 1e-4
                    and e_whole <= cs.BF16_ATTN_LIMIT):
                raise AssertionError(f"kernel 7 {tag} at {name}: output "
                                     f"{e_out}, lse {e_lse}, whole "
                                     f"{e_whole}")
            row[f"err_{tag}"] = max(e_out, e_whole)
            row[f"lse_rel_err_{tag}"] = e_lse
        for form, lse in (("lse", True), ("whole", False)):
            fns = {("one_pass" if one else "split"):
                   (lambda one=one, lse=lse: dk._decode_launch(
                       one, q, k, v, n, lse=lse))
                   for one in routes}
            order = list(fns) + list(fns)[::-1]
            for tag, ts in in_turns(fns, order).items():
                row[f"{form}_ms_{tag}"] = ts
            row[f"{form}_bound_ms"] = cs.bound(cost.decode_attention(
                B, Hkv, G, hd, n, 2, lse))[0]
        row["lse_library_ms"] = cs.median_ms(lambda: eff(q, k, v, None,
                                                         True))
        qs = q.reshape(B, Hkv * G, 1, hd)
        row["whole_library_ms"] = cs.median_ms(
            lambda: sdpa(qs, k, v, enable_gqa=True))
        rows.append(row)
        print("kernel 7 " + " ".join(f"{a} {b}" for a, b in row.items()))
    # Short lengths on the first block's cache: where a call's fixed cost
    # lies.
    B, n = 4, 66
    q = torch.randn((B, Hkv, G, hd), generator=gen, device=dev) \
        .to(torch.bfloat16)
    k, v = (torch.randn((B, n, Hkv, hd), generator=gen, device=dev)
            .to(torch.bfloat16).permute(0, 2, 1, 3) for _ in range(2))
    for length in (0, 1, 8, 16, 33, 66):
        row = {"block": f"length{length}", "B": B, "positions": length}
        for one in (True, False):
            row[f"lse_ms_{'one_pass' if one else 'split'}"] = cs.median_ms(
                lambda one=one: dk._decode_launch(one, q, k, v, length,
                                                  lse=True))
        rows.append(row)
        print("kernel 7 " + " ".join(f"{a} {b}" for a, b in row.items()))
    # The whole-cache form as chip_smoke.py times it: the length on the
    # card, so the call reads every row (the split route).
    B, S = cs.LM_B, cs.LM_SMAX
    length = cs.LM_PROMPT + cs.LM_GEN // 2
    q = torch.randn((B, Hkv, G, hd), generator=gen, device=dev) \
        .to(torch.bfloat16)
    k, v = (torch.randn((B, S, Hkv, hd), generator=gen, device=dev)
            .to(torch.bfloat16).permute(0, 2, 1, 3) for _ in range(2))
    len_t = torch.tensor(length, dtype=torch.int32, device=dev)
    ms = [cs.median_ms(lambda: dk.decode_attention_cuda(q, k, v, len_t))
          for _ in range(2)]
    rows.append({"block": "serve", "B": B, "positions": S, "whole_ms": ms})
    print(f"kernel 7 at the serve shape (length {length} on the card): "
          f"{ms} ms")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", action="append", default=[],
                    metavar="NAME=V1,V2",
                    help="also time kernel 6 with flash_attention.cu's "
                         "constant NAME set to each value")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_attention_routes: no CUDA device is available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    res = build.build()
    print(f"kernel build: {res.seconds:.2f} s")
    cs.print_ptxas(res.log)
    own = build.library()
    readings = {"flash": flash_readings(dev), "decode": decode_readings(dev)}
    try:
        for spec in args.variants:
            name, values = spec.split("=")
            got = readings.setdefault("flash_variants", {})
            for n, lib in build_variants(
                    name, [int(x) for x in values.split(",")]).items():
                build.library = lambda lib=lib: lib
                print(f"{name} = {n}:")
                got[f"{name}={n}"] = flash_readings(dev)
    finally:
        build.library = lambda: own
    card = power_limit()
    print(f"card: {card}")
    print(json.dumps({"card": card, **readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
