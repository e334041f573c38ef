"""Operations and device-memory bytes of the kernels' work, and the peaks.

A frozen copy of the counts of `src/repro_torch/kernels/cost.py`, kept
here so that a change to the program cannot move the yardstick. Bytes are
what the work must move: each input read once and each output written
once; where a count depends on the data (the distinct table rows an
encode touches, the cells a march reads, the samples a composite
gathers), the caller passes what its data needs. The peaks are the NVIDIA
H100 SXM5 data sheet's dense rates at its 700 W limit.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def least_s(ops: float, nbytes: float, unit: str) -> float:
    """The least time the chip needs: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[unit])


def quant_matmul_packed(M: int, K: int, N: int, words: int):
    """(ops, bytes, unit): int8 codes (M, K) against `words` int32 words
    of packed weight codes -> f32 (M, N), four scalars."""
    return 2.0 * M * N * K, M * K + words * 4 + M * N * 4 + 16, "int8"


def hash_encode_points(B: int, L: int, F: int, rows: int):
    """B points over L levels of F features -> (B, L * F) int8 codes;
    `rows` the distinct table rows the corners touch."""
    return 0.0, B * 3 * 4 + rows * F * 4 + B * L * F + 4 * 4 + L * 16, "f32"


def hash_encode_corners(L: int, B: int, F: int, rows: int):
    """Baked (L, B, 8) corner indices and weights -> (B, L * F) codes."""
    return (16.0 * F * L * B, L * B * 64 + rows * F * 4 + B * L * F + L * 4
            + 16, "f32")


def ray_march(R: int, S: int, cells: int):
    """R rays at S depths -> (R, S) f32 mask; `cells` distinct cells."""
    return 9.0 * R * S, R * 6 * 4 + S * 4 + R * S * 4 + cells * 4, "f32"


def gather_composite(R: int, S: int, take_itemsize: int, valid: int):
    """R * S samples through `take` and `valid` of them gathered from the
    compacted field outputs -> colour and opacity."""
    P = R * S
    return (12.0 * P, P * (1 + take_itemsize) + valid * 16 + S * 4 + R * 16,
            "f32")


def flash_attention(B: int, Hkv: int, G: int, hd: int, Sq: int, Sk: int,
                    causal: bool, itemsize: int):
    """Causal or full attention of q (B, Hkv, Sq, G, hd) over k, v (B,
    Hkv, Sk, hd) in `itemsize` bytes -> an f32 output of q's shape."""
    nq, nk = B * Hkv * Sq * G * hd, B * Hkv * Sk * hd
    ops = 4.0 * B * Hkv * G * Sq * Sk * hd / (2 if causal else 1)
    return ops, itemsize * (nq + 2 * nk) + 4 * nq, \
        "bf16" if itemsize == 2 else "f32"


def decode_attention(B: int, Hkv: int, G: int, hd: int, length: int,
                     itemsize: int):
    """One query a head against `length` cached positions of k and v."""
    nq = B * Hkv * G * hd
    return (4.0 * B * Hkv * G * length * hd,
            itemsize * (2 * B * Hkv * length * hd + nq) + itemsize * nq + 4,
            "bf16" if itemsize == 2 else "f32")
