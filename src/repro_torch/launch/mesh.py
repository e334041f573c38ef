"""Device meshes: a shape, axis names and the cards they hold.

The counterpart of `repro/launch/mesh.py`. There a mesh is what `jit`
shards over; here it is the same description, and the sharding layer
(`distributed/sharding.py`) reads its axis sizes. Placement over a mesh
of more than one card is not ported (ROADMAP item 9b).

Single pod: (data=16, model=16) = 256 cards. Multi-pod: (pod=2, data=16,
model=16) = 512 cards.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.backend import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: np.ndarray  # torch.device objects, of `shape`

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))


def make_mesh(shape, axes, device: DeviceLike = None) -> Mesh:
    """A mesh of `shape` over the first prod(shape) visible cards (or the
    CPU, as one device, where `device="cpu"`); raises when they are too
    few, as `jax.make_mesh` does."""
    dev = resolve_device(device)
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    n = int(np.prod(shape))
    have = [torch.device("cpu")] if dev.type == "cpu" else [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n > len(have):
        raise ValueError(f"a mesh of shape {shape} needs {n} devices, "
                         f"{len(have)} are available")
    devices = np.empty(n, dtype=object)
    devices[:] = have[:n]
    return Mesh(shape, axes, devices.reshape(shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(device: DeviceLike = None) -> Mesh:
    """Whatever this host has: (1, visible cards), or (1, 1) over the CPU
    where `device="cpu"`."""
    dev = resolve_device(device)
    n = 1 if dev.type == "cpu" else torch.cuda.device_count()
    return make_mesh((1, n), ("data", "model"), dev)
