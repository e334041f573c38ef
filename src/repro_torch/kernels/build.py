"""Build and load the port's CUDA kernels (one shared library, ctypes).

The sources under `src/repro_torch/csrc/` have a plain C interface, so
they compile with `nvcc` alone (no PyTorch headers): one `nvcc -c` per
source (headers beside them found by relative `#include`), all started
together, then one link into
`build/repro_torch_kernels/librepro_torch_kernels-<hash>.so` at the repo
root. The hash covers the sources, their headers and the flags, so an
edited kernel rebuilds and an unchanged one loads from the existing
library. Nothing is built at import time: the first CUDA launch builds.

Each C entry takes device pointers (`c_void_p`), sizes (`c_int`) and the
CUDA stream, launches, and returns `cudaGetLastError()`; `check()` turns
a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = (
    "quant_matmul_packed.cu",
    "hash_gather.cu",
    "hash_encode.cu",
    "alpha_composite.cu",
    "gather_composite.cu",
    "ray_march.cu",
    "quant_matmul.cu",
    "flash_attention.cu",
    "flash_attention_bwd.cu",
    "decode_attention.cu",
)
HEADERS = ("qmm_tile.cuh", "wgmma_tile.cuh")  # included by sources; hashed
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_LP = ctypes.POINTER(ctypes.c_longlong)  # a host array of strides
# C signature of every entry point: argtypes; all return int (cudaError_t).
SIGNATURES: Dict[str, List] = {
    # x, words, offset, sx, sw, zx, out, M, K, N, bits, groups_per_tile,
    # SM count, stream
    "repro_quant_matmul_packed": [_P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _P],
    # idx, table, out, P, T, F, stream
    "repro_hash_gather": [_P, _P, _P, _I, _I, _I, _P],
    # points, table, meta, sx, zx_f, qmax, off (null for the f32
    # encodings), out, B, L, T, F, codes, stream
    "repro_hash_encode": [_P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _P],
    # corner_idx, corner_w, table, level_offsets, sx, zx_f, qmax, off (null
    # for the f32 encodings), out, B, L, T, F, codes, stream
    "repro_hash_encode_corners": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _P],
    # sigma, rgb, delta, color, acc, R, S, early_stop, t_eps, stream
    "repro_alpha_composite": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    # sigma_b, rgb_b, take, valid, active (or null), delta, color, acc, R,
    # S, B, take64, white_bg, early_stop, t_eps, stream
    "repro_gather_composite": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _L,
                               _I, _I, _I, _F, _P],
    # occ, rays_o, rays_d, t, out, R, S, G, early_stop, stream
    "repro_ray_march": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, w, sx, sw, zx, out, M, K, N, SM count, stream
    "repro_quant_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # q, k, v, out, lse (or null), B, Hkv, S, Sk, G, hd, q strides (b, h,
    # s, g), k strides (b, h, s), v strides (b, h, s), out strides (b, h,
    # s, g), causal, scale, dtype, stream
    "repro_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                              _L, _L, _L, _L, _I, _F, _I, _P],
    # q, k, v, o, dO, lse, delta (scratch), dO in bf16 (scratch, or null
    # in float32), dq, dk, dv, B, Hkv, S, Sk, G, hd, 28 strides (q, k, v,
    # o, dO, dq, dk, dv), causal, scale, dtype, stream
    "repro_flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _I, _I, _I, _I, _I, _I, _LP, _I, _F,
                                  _I, _P],
    # q, k, v, length (device pointer or null), length (by value), out,
    # lse (or null), m_part, l_part, acc_part, tickets, B, Hkv, G, S, hd,
    # q strides (b, h, g), k strides (b, h, s), v strides (b, h, s), split,
    # scale, dtype, stream
    "repro_decode_attention": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I,
                               _L, _L, _L, _L, _L, _L, _L, _L, _L,
                               _I, _F, _I, _P],
}


def build_dir() -> Path:
    """`build/repro_torch_kernels/` at the repository root."""
    return _PKG.parents[1] / "build" / "repro_torch_kernels"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "on this machine")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


class BuildResult:
    """Where the library is, how long the build took (0 when it was
    already built) and what `ptxas -v` reported per kernel."""

    def __init__(self, path: Path, seconds: float, log: str):
        self.path, self.seconds, self.log = path, seconds, log


def build(out_dir: Optional[Path] = None) -> BuildResult:
    """Compile every source in parallel and link the shared library,
    unless a library for exactly these sources and flags exists."""
    out_dir = build_dir() if out_dir is None else Path(out_dir)
    lib = out_dir / f"librepro_torch_kernels-{_source_hash()}.so"
    if lib.exists():
        return BuildResult(lib, 0.0, "")
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    objs, procs = [], []
    for name in SOURCES:
        obj = out_dir / f"{Path(name).stem}-{os.getpid()}.o"
        objs.append(obj)
        procs.append((name, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    logs, failed = [], []
    for name, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {name}\n{out}")
        if p.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = out_dir / f"{lib.name}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", *map(str, objs), "-o", str(tmp)],
        capture_output=True, text=True,
    )
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    log = "\n".join(logs)
    (out_dir / "build.log").write_text(log)
    return BuildResult(lib, time.perf_counter() - t0, log)


_LIBRARY: Optional[ctypes.CDLL] = None
_LIBRARY_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with every entry
    point's argtypes/restype declared. Threads that launch their first
    kernels at the same time wait for one build and share its library."""
    global _LIBRARY
    if _LIBRARY is None:
        with _LIBRARY_LOCK:
            if _LIBRARY is None:
                lib = ctypes.CDLL(str(build().path))
                for fn, argtypes in SIGNATURES.items():
                    f = getattr(lib, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
                _LIBRARY = lib
    return _LIBRARY


def check(code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")
