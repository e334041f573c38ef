"""Each kernel's operations and device-memory bytes, from its shapes.

One count for every reader: `chip_smoke.py`'s bound column (the least
time the card could take for a kernel's work) and the dry-run's counters
(`distributed.hlo_counters`), where a kernel called on tensors without
data (`FakeTensor`, `meta`) records its cost instead of running.

Bytes are what the function must move: each input read once and each
output written once. Where a count depends on the data (the distinct
table rows a hash encode touches, the samples an early-stopping
composite walks), the caller passes what its data needs; without it, the
count assumes every read is distinct and every sample walked.

Operations are counted at the rate of their type (`unit`): kernel 6 and
its backward count the score and value products of the causal half of
the (Sq, Sk) score matrix (the tiles the kernel visits, less the masked
halves of the diagonal ones), and no (Sq, Sk) scores in device memory.

The rates are the NVIDIA H100 SXM5's datasheet numbers (dense tensor-core
rates, without sparsity), the same `hero/targets.py` uses.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {"int8": 1979e12,  # dense int8 tensor-core rate
            "bf16": 989e12,  # dense bf16 tensor-core rate
            "f32": 67e12}  # float32 outside the tensor cores


@dataclasses.dataclass(frozen=True)
class Cost:
    ops: float  # operations, at the rate of `unit`
    bytes: float  # device-memory bytes read and written
    unit: str = "f32"  # "int8", "bf16" or "f32"

    def bound_ms(self):
        """(ms, "bytes" or "operations"): the larger of the bytes over the
        memory rate and the operations over the peak rate of their type."""
        t_bytes = self.bytes / HBM_BYTES_PER_S * 1e3
        t_ops = self.ops / PEAK_OPS[self.unit] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")


def _unit(itemsize: int) -> str:
    return "bf16" if itemsize == 2 else "f32"


# Kernels 5 and 1: ((x - zx) @ w) * sx * sw over int8 codes.
def quant_matmul(M: int, K: int, N: int) -> Cost:
    """x (M, K) int8, w (K, N) int8 -> f32 (M, N), three scalars."""
    return Cost(2.0 * M * N * K, M * K + K * N + M * N * 4 + 12, "int8")


def quant_matmul_packed(M: int, K: int, N: int, words: int) -> Cost:
    """x (M, K) int8 against `words` int32 words of packed codes -> f32
    (M, N), four scalars."""
    return Cost(2.0 * M * N * K, M * K + words * 4 + M * N * 4 + 16, "int8")


# Kernel 2 and its fused forms.
def hash_gather(P: int, F: int, rows: Optional[int] = None) -> Cost:
    """P int32 indices into an (T, F) f32 table -> (P, F) f32; `rows` the
    distinct rows read (P without data)."""
    rows = P if rows is None else rows
    return Cost(0.0, P * 4 + P * F * 4 + rows * F * 4)


def hash_encode_points(B: int, L: int, F: int,
                       rows: Optional[int] = None) -> Cost:
    """B points (3 f32) over L levels of F features -> (B, L * F) int8
    codes; `rows` the distinct table rows the corners touch (8 a point
    and level without data)."""
    rows = 8 * B * L if rows is None else rows
    return Cost(0.0, B * 3 * 4 + rows * F * 4 + B * L * F + 4 * 4 + L * 16)


def hash_encode_corners(L: int, B: int, F: int,
                        rows: Optional[int] = None) -> Cost:
    """(L, B, 8) int32 corners and f32 weights -> (B, L * F) int8 codes:
    8 fused multiply-adds a feature; `rows` as `hash_encode_points`."""
    rows = 8 * B * L if rows is None else rows
    return Cost(16.0 * F * L * B,
                L * B * 64 + rows * F * 4 + B * L * F + L * 4 + 16)


# Kernel 4.
def ray_march(R: int, S: int, cells: Optional[int] = None) -> Cost:
    """R rays (origin, direction) at S depths -> (R, S) f32 mask; `cells`
    the distinct occupancy cells read (R * S without data)."""
    cells = R * S if cells is None else cells
    return Cost(9.0 * R * S, R * 6 * 4 + S * 4 + R * S * 4 + cells * 4)


# Kernel 3 and its gather form.
def alpha_composite(R: int, S: int, walked: Optional[int] = None) -> Cost:
    """R rays of S samples (sigma, rgb, delta) -> colour and opacity;
    `walked` the samples read before the early exit (R * S without
    data)."""
    walked = R * S if walked is None else walked
    return Cost(12.0 * walked, walked * 5 * 4 + R * 4 * 4)


def gather_composite(R: int, S: int, take_itemsize: int,
                     valid: Optional[int] = None) -> Cost:
    """R * S samples through `take` (one byte of mask and one index each)
    and `valid` of them read from the compacted field outputs (all
    without data) -> colour and opacity."""
    P = R * S
    valid = P if valid is None else valid
    return Cost(12.0 * P, P * (1 + take_itemsize) + valid * 16 + S * 4
                + R * 16)


# Kernel 6: flash attention, forward and backward.
def flash_attention(B: int, Hkv: int, G: int, hd: int, Sq: int, Sk: int,
                    causal: bool, itemsize: int, lse: bool = False) -> Cost:
    """q (B, Hkv, Sq, G, hd), k and v (B, Hkv, Sk, hd) in `itemsize`
    bytes -> f32 output of q's shape (and, with `lse`, the f32 (B, Hkv,
    Sq, G) log-sum-exp a training forward writes)."""
    nq, nk = B * Hkv * Sq * G * hd, B * Hkv * Sk * hd
    nbytes = itemsize * (nq + 2 * nk) + 4 * nq \
        + (4 * B * Hkv * Sq * G if lse else 0)
    ops = 4.0 * B * Hkv * G * Sq * Sk * hd / (2 if causal else 1)
    return Cost(ops, nbytes, _unit(itemsize))


def flash_attention_bwd(B: int, Hkv: int, G: int, hd: int, Sq: int, Sk: int,
                        causal: bool, itemsize: int) -> Cost:
    """Kernel 6's backward: q, k, v, the f32 output, its f32 gradient and
    the log-sum-exp in; dq, dk, dv out. Five products of the forward's
    size (the scores again, dP, dV, dQ, dK)."""
    nq, nk = B * Hkv * Sq * G * hd, B * Hkv * Sk * hd
    nbytes = 2 * itemsize * (nq + 2 * nk) + 4 * 2 * nq + 4 * B * Hkv * Sq * G
    ops = 5 * 2.0 * B * Hkv * G * Sq * Sk * hd / (2 if causal else 1)
    return Cost(ops, nbytes, _unit(itemsize))


# Kernel 7.
def decode_attention(B: int, Hkv: int, G: int, hd: int, length: int,
                     itemsize: int, lse: bool = False) -> Cost:
    """One query token per head, q (B, Hkv, G, hd), against `length`
    cached positions of k and v -> q's shape and dtype (with `lse`, the
    partial form: the output in f32 and the f32 (B, Hkv, G) log-sum-exp);
    the length is one scalar."""
    nq = B * Hkv * G * hd
    out = 4 * nq + 4 * B * Hkv * G if lse else itemsize * nq
    return Cost(4.0 * B * Hkv * G * length * hd,
                itemsize * (2 * B * Hkv * length * hd + nq) + out + 4,
                _unit(itemsize))
