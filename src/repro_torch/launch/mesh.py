"""Device meshes: a shape, axis names and the devices they hold.

The counterpart of `repro/launch/mesh.py`. There a mesh is what `jit`
shards over; here it is the same description, and the sharding layer
(`distributed/sharding.py`) reads its axis sizes. Without a process group
a mesh holds the CPU or this host's cards, and places everything on one
of them. Under a process group (`init_distributed`: torchrun's
environment, or an explicit rank, world size and store) a mesh spans
every rank, one device each, and carries a
`torch.distributed.device_mesh.DeviceMesh` with the same axis names:
`distributed.sharding.named` then places each tensor as a DTensor.

Single pod: (data=16, model=16) = 256 cards. Multi-pod: (pod=2, data=16,
model=16) = 512 cards.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.backend import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    # torch.device objects of `shape`; under a process group the global
    # rank at each coordinate.
    devices: np.ndarray
    device_mesh: Any = None  # DeviceMesh under a process group, else None
    device: Optional[torch.device] = None  # this rank's (placed meshes)
    coords: Tuple[int, ...] = ()  # this rank's coordinates (placed meshes)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def placed(self) -> bool:
        """Whether tensors are placed over ranks (a process group is up)."""
        return self.device_mesh is not None

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def coordinate(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The process group of the ranks that differ only along `axis`."""
        return self.device_mesh.get_group(axis)


def init_distributed(device: DeviceLike = None, *, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     store: Optional[dist.Store] = None) -> torch.device:
    """Start this process's process group and return its device: NCCL and
    `cuda:<local rank>` on the card (the default), gloo and the CPU where
    `device="cpu"`. Rank and world size come from torchrun's `RANK`,
    `WORLD_SIZE` and `LOCAL_RANK` (rendezvous at its `MASTER_ADDR` and
    `MASTER_PORT`) unless given, with a `store` to meet in (a
    `FileStore` in a temporary directory, say)."""
    dev = resolve_device(device)
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None \
        else world_size
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    kw = {"init_method": "env://"} if store is None else {"store": store}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            rank=rank, world_size=world_size, **kw)
    return dev


def _process_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _placed_mesh(shape, axes) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    n = int(np.prod(shape))
    if n != world:
        raise ValueError(f"a mesh of shape {shape} needs {n} devices, "
                         f"{world} ranks are running")
    dev = _process_device()
    dm = init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    coords = tuple(int(c) for c in np.unravel_index(dist.get_rank(), shape))
    return Mesh(shape, axes, np.arange(world).reshape(shape), dm, dev,
                coords)


def make_mesh(shape, axes, device: DeviceLike = None) -> Mesh:
    """A mesh of `shape`. Under a process group: over every rank, which
    must number prod(shape). Otherwise over the first prod(shape) visible
    cards (or the CPU, as one device, where `device="cpu"`). Raises when
    the devices are too few, as `jax.make_mesh` does."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if dist.is_initialized():
        return _placed_mesh(shape, axes)
    dev = resolve_device(device)
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
    """Whatever this host has: (1, ranks) under a process group, else (1,
    visible cards), or (1, 1) over the CPU where `device="cpu"`."""
    if dist.is_initialized():
        return make_mesh((1, dist.get_world_size()), ("data", "model"))
    dev = resolve_device(device)
    n = 1 if dev.type == "cpu" else torch.cuda.device_count()
    return make_mesh((1, n), ("data", "model"), dev)
