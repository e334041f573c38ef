"""One-time repack of stored packed weights into the kernel-native layout.

The storage codec (`repro_torch.quant.packing`) orders bit-plane words
group-major, which is what the artifact writes and `model_bytes` measures.
`repack_tile_native(pt, bk)` permutes them to the ``tile:<bk>`` order
(plane-major within each K-tile) once, at artifact load or pack build;
`unrepack_planar(pt)` restores the storage words bit for bit, so a
repacked pack always serializes back to the schema-v2 byte stream. Codes,
`nbytes_packed`, scale, offset, bits and shape are unchanged.
"""
from __future__ import annotations

import dataclasses

from repro_torch.quant.packing import (
    PackedTensor,
    planar_words_from_tile,
    tile_layout_bk,
    tile_words_from_planar,
)

DEFAULT_TILE_BK = 128  # 128 * bits is a multiple of 32 for all bits


def repack_tile_native(pt: PackedTensor, bk: int = DEFAULT_TILE_BK
                       ) -> PackedTensor:
    """Return `pt` with words permuted to the ``tile:<bk>`` layout."""
    bk = int(bk)
    if pt.layout == f"tile:{bk}":
        return pt
    words = tile_words_from_planar(pt.planar_words(), pt.bits, pt.rows, bk)
    return dataclasses.replace(pt, words=words, layout=f"tile:{bk}")


def unrepack_planar(pt: PackedTensor) -> PackedTensor:
    """Return `pt` in the storage layout (byte-identical planar words)."""
    bk = tile_layout_bk(pt.layout)
    if bk is None:
        return pt
    words = planar_words_from_tile(pt.words, pt.bits, pt.rows, bk)
    return dataclasses.replace(pt, words=words, layout="planar")
