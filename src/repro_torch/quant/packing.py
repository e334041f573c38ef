"""Sub-byte bit-packing: the storage codec that makes `model_bytes` real.

Word layout (bit-plane packing), identical to the JAX package's codec so
that artifacts cross over byte for byte: a tensor is viewed as (rows, cols)
with rows = shape[0] and cols = prod(shape[1:]). Rows are padded to groups
of 32; each group of 32 codes in a column is stored as `bits` consecutive
int32 words, word p holding bit p of all 32 codes (code j at bit j):

    words[g * bits + p, c]  =  sum_j  ((u[32 g + j, c] >> p) & 1) << j

with u the unsigned codes. This costs exactly `bits` bits per code (plus
row padding) for every bits in 1..8.

Storage layout vs compute layout: the order above is `layout="planar"`,
what the artifact writes. The matmul kernel also reads ``"tile:<bk>"``,
plane-major within each K-tile:

    tile row  t*(gt*bits) + p*gt + g   <->   planar row  (t*gt + g)*bits + p

with gt = bk // 32 and the trailing tile zero-padded with empty groups.
The permutation is lossless, and `nbytes_packed` counts planar words only.

Codes are stored offset-binary: the word holds u = q - offset clipped to
[0, 2^bits - 1]. `pack_codes(offset=None)` picks the top-exact window
offset = max(min(q), max(q) - 2^b + 1), so only a tensor using the full
2^b + 1 levels of the paper-exact symmetric grid (Eq. 5) clamps, by one
LSB at its lowest level.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

WORD_BITS = 32  # codes per bit-plane word


def _rows_cols(shape: Sequence[int]) -> Tuple[int, int]:
    shape = tuple(int(s) for s in shape)
    rows = shape[0] if shape else 1
    cols = int(np.prod(shape[1:], dtype=np.int64)) if len(shape) > 1 else 1
    return rows, cols


def packed_groups(rows: int) -> int:
    """Number of 32-code groups (bit-plane word rows per plane)."""
    return -(-int(rows) // WORD_BITS)


def tile_layout_bk(layout: str):
    """K-tile size of a ``"tile:<bk>"`` layout string, None for planar."""
    if layout == "planar":
        return None
    if layout.startswith("tile:"):
        bk = int(layout.split(":", 1)[1])
        if bk <= 0 or bk % WORD_BITS:
            raise ValueError(f"tile layout bk must be a positive multiple "
                             f"of {WORD_BITS}: {layout!r}")
        return bk
    raise ValueError(f"unknown packed layout {layout!r}")


@dataclasses.dataclass(frozen=True)
class PackedTensor:
    """Sub-byte integer codes bit-packed into int32 words.

    words  (groups*bits, cols) int32 — layout below
    scale  ()  f32   — dequantization scale (`dequantize` = codes * scale)
    offset ()  int32 — code offset: logical code q = unpacked u + offset
    bits   int       — code width, 1..8
    shape  tuple     — logical tensor shape
    layout str       — "planar" (storage) or "tile:<bk>" (matmul kernel)
    """

    words: torch.Tensor
    scale: torch.Tensor
    offset: torch.Tensor
    bits: int
    shape: Tuple[int, ...]
    layout: str = "planar"

    @property
    def rows(self) -> int:
        return _rows_cols(self.shape)[0]

    @property
    def cols(self) -> int:
        return _rows_cols(self.shape)[1]

    @property
    def device(self) -> torch.device:
        return self.words.device

    @property
    def nbytes_packed(self) -> int:
        """Exact stored payload bytes: the PLANAR words array, whatever
        layout is held in memory."""
        return packed_groups(self.rows) * self.bits * self.cols * 4

    def planar_words(self) -> torch.Tensor:
        """The storage-layout words, whatever layout this tensor holds."""
        bk = tile_layout_bk(self.layout)
        if bk is None:
            return self.words
        return planar_words_from_tile(self.words, self.bits, self.rows, bk)

    def codes(self) -> torch.Tensor:
        """Signed integer codes q (int32, logical shape)."""
        return unpack_words(self.planar_words(), self.bits, self.shape) \
            + self.offset

    def dequantize(self) -> torch.Tensor:
        """Float tensor q * scale (f32, logical shape)."""
        return self.codes().to(torch.float32) * self.scale


# ---------------------------------------------------------------------------
# pack / unpack (bit ops, computed in int64 and wrapped to int32 words)
# ---------------------------------------------------------------------------
def _to_int32_words(w64: torch.Tensor) -> torch.Tensor:
    """Values in [0, 2^32) -> the int32 words with the same bit pattern."""
    return torch.where(w64 >= 2**31, w64 - 2**32, w64).to(torch.int32)


def pack_words(u: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack unsigned codes u (any shape, values in [0, 2^bits - 1]) into
    bit-plane int32 words of shape (groups*bits, cols)."""
    assert 1 <= bits <= 8, bits
    rows, cols = _rows_cols(u.shape)
    g = packed_groups(rows)
    u = torch.as_tensor(u).to(torch.int64).reshape(rows, cols)
    pad = torch.zeros((g * WORD_BITS - rows, cols), dtype=torch.int64,
                      device=u.device)
    u = torch.cat([u, pad]).reshape(g, WORD_BITS, cols)
    pos = torch.arange(WORD_BITS, device=u.device).view(1, WORD_BITS, 1)
    planes = [(((u >> p) & 1) << pos).sum(dim=1) for p in range(bits)]
    w64 = torch.stack(planes, dim=1).reshape(g * bits, cols)
    return _to_int32_words(w64)


def unpack_words(words: torch.Tensor, bits: int,
                 shape: Sequence[int]) -> torch.Tensor:
    """Invert `pack_words` -> unsigned codes u (int32, logical shape)."""
    assert 1 <= bits <= 8, bits
    rows, cols = _rows_cols(shape)
    g = packed_groups(rows)
    w = words.to(torch.int64).reshape(g, bits, 1, cols) & 0xFFFFFFFF
    pos = torch.arange(WORD_BITS, device=w.device).view(1, 1, WORD_BITS, 1)
    plane = torch.arange(bits, device=w.device).view(1, bits, 1, 1)
    u = (((w >> pos) & 1) << plane).sum(dim=1)
    return u.reshape(g * WORD_BITS, cols)[:rows].reshape(
        tuple(shape)).to(torch.int32)


def tile_words_from_planar(words: torch.Tensor, bits: int, rows: int,
                           bk: int) -> torch.Tensor:
    """Permute planar bit-plane words into the K-tile-native order (the
    trailing tile padded with zero words)."""
    bk = int(bk)
    assert bk > 0 and bk % WORD_BITS == 0, bk
    g = packed_groups(rows)
    gt = bk // WORD_BITS
    t = -(-g // gt)
    cols = int(words.shape[-1])
    w = words.reshape(g, bits, cols)
    pad = torch.zeros((t * gt - g, bits, cols), dtype=words.dtype,
                      device=words.device)
    w = torch.cat([w, pad]).reshape(t, gt, bits, cols).permute(0, 2, 1, 3)
    return w.reshape(t * bits * gt, cols).contiguous()


def planar_words_from_tile(words: torch.Tensor, bits: int, rows: int,
                           bk: int) -> torch.Tensor:
    """Exact inverse of `tile_words_from_planar` (drops the pad groups)."""
    bk = int(bk)
    assert bk > 0 and bk % WORD_BITS == 0, bk
    g = packed_groups(rows)
    gt = bk // WORD_BITS
    t = -(-g // gt)
    cols = int(words.shape[-1])
    w = words.reshape(t, bits, gt, cols).permute(0, 2, 1, 3)
    return w.reshape(t * gt, bits, cols)[:g].reshape(g * bits, cols) \
        .contiguous()


def pack_codes(codes, bits: int, scale=1.0, offset=None,
               device=None) -> PackedTensor:
    """Pack integer codes (any int-valued array or tensor) at `bits` per
    code. Host-side: the window needs concrete values. `offset=None` picks
    the top-exact window (module docstring). The result lives on `device`
    (default: the device of `codes`, or the CPU for numpy input)."""
    if device is None:
        device = codes.device if isinstance(codes, torch.Tensor) else "cpu"
    q = codes.detach().cpu().numpy() if isinstance(codes, torch.Tensor) \
        else np.asarray(codes)
    shape = tuple(int(s) for s in np.shape(q))
    q = np.round(q).astype(np.int64)  # fake-quant paths carry float ints
    if offset is None:
        offset = 0 if q.size == 0 else int(max(q.min(), q.max() - (2**bits - 1)))
    u = np.clip(q - int(offset), 0, 2**bits - 1)
    return PackedTensor(
        words=pack_words(torch.from_numpy(u), bits).to(device),
        scale=torch.as_tensor(scale, dtype=torch.float32).to(device),
        offset=torch.tensor(int(offset), dtype=torch.int32, device=device),
        bits=int(bits),
        shape=shape,
    )


# ---------------------------------------------------------------------------
# The shared size function
# ---------------------------------------------------------------------------
def tensor_store_nbytes(rows: int, cols: int, bits) -> np.ndarray:
    """Bytes the packed stack stores for one (rows, cols) tensor at
    `bits`: bit-plane int32 words for bits <= 8, a float32 carrier above
    (the 9..15 fake-quant band and the >= 16 full-precision sentinel)."""
    groups = packed_groups(rows)
    b = np.asarray(bits, np.float64)
    sub = 4.0 * groups * np.round(b) * cols
    full = 4.0 * rows * cols
    return np.where(b <= 8.0, sub, full)


def policy_model_bytes(
    level_entries: Sequence[int],
    n_features: int,
    mlp_dims: Sequence[Tuple[int, int]],
    hash_bits,
    w_bits,
):
    """Total stored model bytes of one policy: every hash level's table
    (rows=entries, cols=n_features) plus every linear layer's weight
    (rows=d_in, cols=d_out), through `tensor_store_nbytes`."""
    total = 0.0
    for l, entries in enumerate(level_entries):
        total = total + tensor_store_nbytes(
            int(entries), int(n_features), hash_bits[l]
        )
    for i, (d_in, d_out) in enumerate(mlp_dims):
        total = total + tensor_store_nbytes(int(d_in), int(d_out), w_bits[i])
    return total
