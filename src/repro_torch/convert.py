"""Carry weights and packs from numpy arrays into the port's tensors.

The JAX package's parameters are `{top: {sub: array}}` dicts, its packed
tensors carry `words`/`scale`/`offset` arrays beside static `bits`,
`shape` and `layout`, and its `FusedPack` holds `layers`, `hash_tables`,
`modes` and `layout`. These functions read any such object through
`np.asarray` (numpy arrays, or anything that converts to one) and build
the port's counterparts on `device`, so both packages can compute on the
same weights. Nothing here imports the JAX package.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.nerf.fast_render import FusedPack, repack_fused_pack
from repro_torch.quant.packing import PackedTensor


def _tensor(a, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree: Dict, device: DeviceLike = None) -> Dict:
    """NGP parameters `{top: {sub: array}}` -> the same dict of tensors on
    `device` (the card unless `device="cpu"`)."""
    dev = resolve_device(device)
    return {top: {k: _tensor(v, dev) for k, v in sub.items()}
            for top, sub in tree.items()}


def packed_from_numpy(pt, device: DeviceLike = None) -> PackedTensor:
    """A packed tensor (`words`, `scale`, `offset`, `bits`, `shape`,
    `layout`) -> `PackedTensor` on `device`, words bit for bit."""
    dev = resolve_device(device)
    return PackedTensor(
        words=_tensor(np.asarray(pt.words, np.int32), dev),
        scale=_tensor(np.asarray(pt.scale, np.float32), dev),
        offset=_tensor(np.asarray(pt.offset, np.int32), dev),
        bits=int(pt.bits),
        shape=tuple(int(s) for s in pt.shape),
        layout=str(getattr(pt, "layout", "planar")),
    )


def _value(v, dev: torch.device):
    return packed_from_numpy(v, dev) if hasattr(v, "words") \
        else _tensor(v, dev)


def pack_from_numpy(pack, device: DeviceLike = None) -> FusedPack:
    """A fused pack -> `FusedPack` on `device`. The storage arrays are
    carried over; the compute forms are staged anew for the pack's
    `layout` (they are derived from the storage and nothing else)."""
    dev = resolve_device(device)
    layers = {name: {k: _value(v, dev) for k, v in lyr.items()}
              for name, lyr in pack.layers.items()}
    tables = {name: _value(t, dev) for name, t in pack.hash_tables.items()}
    out = FusedPack(layers=layers, hash_tables=tables,
                    modes=tuple(pack.modes))
    layout = str(getattr(pack, "layout", "planar"))
    return repack_fused_pack(out, layout) if layout != "planar" else out
