"""Shared argument checks and the launch call of the CUDA wrappers."""
from __future__ import annotations

import functools
import threading
from contextlib import contextmanager
from typing import Dict, Iterator

import torch

from repro_torch.kernels import build


def require_rows(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
                 device: torch.device) -> None:
    """Raise unless `t` is a `dtype` tensor of rank `ndim` on the CUDA
    `device` whose innermost axis is contiguous; the other axes may have
    any strides (the kernel takes them), so views need no copy."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must live on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have rank {ndim}, got {tuple(t.shape)}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} must have a contiguous innermost axis")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
            device: torch.device) -> None:
    """`require_rows`, and `t` must be contiguous."""
    require_rows(t, name, dtype, ndim, device)
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_aligned(t: torch.Tensor, name: str) -> None:
    """Raise unless `t` starts on a 16-byte boundary and each stride of an
    axis longer than one (the innermost aside) is a whole number of 16-byte
    units: what a kernel that copies rows 16 bytes at a time with
    `cp.async` takes. Nothing is copied to make it so."""
    unit = 16 // t.element_size()
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")
    for i in range(t.dim() - 1):
        if t.shape[i] > 1 and t.stride(i) % unit:
            raise ValueError(f"{name}'s stride {t.stride(i)} on axis {i} is "
                             f"not a multiple of {unit} elements")


def device_scalar(v, name: str, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """A one-element `dtype` tensor on `device` for a scalar operand the
    kernel reads from device memory (a Python number is written by a fill
    kernel: no host copy and no sync on the launch path)."""
    if isinstance(v, torch.Tensor):
        if v.numel() != 1:
            raise ValueError(f"{name} must hold one element, got "
                             f"{tuple(v.shape)}")
        if v.device != device:
            raise ValueError(f"{name} must live on {device}, got {v.device}")
        return v.to(dtype).reshape(1).contiguous()
    return torch.full((1,), v, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Multiprocessors of CUDA card `index` (the kernels size their grids
    by it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(entry: str, device: torch.device, *args) -> None:
    """Call C entry `entry` on the current stream of `device`; raise if
    the launch was refused."""
    lib = build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, entry)(*args, stream)
    build.check(code, entry)


_COUNT_LOCK = threading.Lock()
_TALLY = threading.local()


def count_launch(wrapper) -> None:
    """Add one to `wrapper.launches`, the count of kernels that CUDA
    wrapper launched. The read-add-store runs under a lock, so launches
    from several host threads are all counted; reading the count and
    setting it to 0 are single stores and need none. Inside `tallied()`
    the launch goes to the tally instead."""
    tally = getattr(_TALLY, "counts", None)
    if tally is not None:
        tally[wrapper] = tally.get(wrapper, 0) + 1
        return
    with _COUNT_LOCK:
        wrapper.launches += 1


@contextmanager
def tallied() -> Iterator[Dict]:
    """Tally this thread's launches inside the block by wrapper, in the
    dict it yields, and leave the counters alone: the block is a CUDA
    graph's capture, which runs nothing. Each replay of the graph adds
    the tally to the counters (`add_launches`)."""
    if getattr(_TALLY, "counts", None) is not None:
        raise RuntimeError("launches are already being tallied")
    _TALLY.counts = {}
    try:
        yield _TALLY.counts
    finally:
        _TALLY.counts = None


def add_launches(tally: Dict) -> None:
    """Count the launches of `tally` once more: one replay of the graph
    whose capture tallied them."""
    with _COUNT_LOCK:
        for wrapper, n in tally.items():
            wrapper.launches += n
