"""Device-split population evaluation for the closed-loop HERO search.

`BatchedQuantEnv` scores K policies on one device. The population axis is
embarrassingly parallel, so on a host with several cards the K policies
split across them. This module wraps any *batched* function (leading
axis = population on every non-broadcast argument and every output leaf)
so that:

  - K is padded up to a multiple of the device count (rows repeat the
    last policy; the pad is cut off after the call), so callers never
    think about divisibility;
  - each shard, and each broadcast argument (e.g. the shared NGP weights
    of the PSNR proxy), is copied to its device; a broadcast argument is
    copied once for each device and the copy kept while the caller passes
    the same object again;
  - the shards run at the same time, one host thread per device, each
    under `torch.cuda.device(d)` on a card: the proxy renders are
    host-bound, so only a thread per card lets the cards overlap;
  - on one device the wrapper makes the plain call (same numbers, no
    threads in the way).

Both halves of a population evaluation fit this contract: `policy_latency`
(the fused NeuRex model with its grid-cache sort) and the proxy-MSE
render. Each policy's arithmetic does not depend on which shard holds it,
and the cache statistics are integers, so the split moves no number.
Results come back as numpy arrays cut to K and feed
`repro_torch.core.pareto` on the host.

The JAX package shards over a 1-D ("pop",) mesh with `shard_map`; the
port takes a list of torch devices instead (`population_devices`).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

POP_AXIS = "pop"


def population_devices(n: Optional[int] = None,
                       kind: str = "cuda") -> List[torch.device]:
    """The devices a population splits over: the visible cards (the first
    `n` of them), or the one CPU. Raises without a card for "cuda"."""
    if kind == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "no CUDA device is available; pass kind='cpu' to split "
                "over the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(count)]
    elif kind == "cpu":
        devices = [torch.device("cpu")]
    else:
        raise ValueError(f"unsupported device kind {kind!r}")
    if n is not None:
        if not 1 <= n <= len(devices):
            raise ValueError(f"asked for {n} {kind} device(s), "
                             f"{len(devices)} visible")
        devices = devices[:n]
    return devices


def pad_population(arr: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """Pad the leading axis up to `multiple` by repeating the last row.
    Returns (padded, original_k). Repeating (vs zero-fill) keeps every row
    a valid policy, so padded lanes can't trip asserts or NaNs."""
    k = arr.shape[0]
    pad = (-k) % multiple
    if pad == 0:
        return arr, k
    filler = np.repeat(arr[-1:], pad, axis=0)
    return np.concatenate([arr, filler], axis=0), k


def to_device(obj: Any, device: torch.device) -> Any:
    """`obj` with every tensor in it on `device`: tensors, dicts, lists,
    tuples and dataclasses are walked; anything else is returned as is."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(v, device) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init
        })
    return obj


def _to_numpy(out: Any) -> Any:
    """A tensor, or a dict of them, as numpy."""
    if isinstance(out, dict):
        return {k: _to_numpy(v) for k, v in out.items()}
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


def _concat(parts: List[Any], k: int) -> Any:
    """The shards' numpy outputs (arrays, or dicts of them) joined along
    axis 0 and cut to `k`."""
    if isinstance(parts[0], dict):
        return {key: _concat([p[key] for p in parts], k) for key in parts[0]}
    return np.concatenate(parts, axis=0)[:k]


def _as_tensor(a: Any, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _on(device: torch.device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def shard_population(
    fn: Callable,
    devices: Optional[Sequence[torch.device]] = None,
    broadcast_argnums: Sequence[int] = (),
) -> Callable:
    """Split a batched fn's population axis over `devices` (default: the
    visible cards).

    `fn` must be shard-agnostic: outputs for row i depend only on inputs
    of row i. Positional args in `broadcast_argnums` go whole to every
    device; all others (numpy arrays or tensors) carry the population on
    axis 0, and so does `fn`'s output (a tensor or a dict of them). The
    wrapper returns numpy arrays of K rows and has `n_shards`.
    """
    devices = population_devices() if devices is None else list(devices)
    n_shards = len(devices)
    bcast = frozenset(broadcast_argnums)
    placed = {}  # (argnum, shard) -> (the caller's object, its copy)
    lock = threading.Lock()

    def place(i: int, s: int, arg: Any) -> Any:
        with lock:
            hit = placed.get((i, s))
            if hit is None or hit[0] is not arg:
                hit = (arg, to_device(arg, devices[s]))
                placed[(i, s)] = hit
            return hit[1]

    def run_shard(s: int, args: List[Any]) -> Any:
        with _on(devices[s]):
            return _to_numpy(fn(*args))

    if n_shards == 1:
        def call_single(*args):
            return run_shard(0, [
                place(i, 0, a) if i in bcast else _as_tensor(a, devices[0])
                for i, a in enumerate(args)
            ])

        call_single.n_shards = 1
        return call_single

    def call(*args):
        batched = [i for i in range(len(args)) if i not in bcast]
        k = int(np.shape(args[batched[0]])[0])
        padded = {}
        for i in batched:
            a = args[i]
            a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
            padded[i], _ = pad_population(np.asarray(a), n_shards)
        rows = padded[batched[0]].shape[0] // n_shards
        shard_args = [
            [place(i, s, a) if i in bcast
             else _as_tensor(padded[i][s * rows:(s + 1) * rows], devices[s])
             for i, a in enumerate(args)]
            for s in range(n_shards)
        ]
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=n_shards,
                thread_name_prefix="hero-pop") as pool:
            futures = [pool.submit(run_shard, s, shard_args[s])
                       for s in range(n_shards)]
            parts = [f.result() for f in futures]
        return _concat(parts, k)

    call.n_shards = n_shards
    return call


def auto_shard(threshold_devices: int = 2) -> bool:
    """Default policy: split when the host exposes at least
    `threshold_devices` cards (never on a CPU-only host)."""
    if not torch.cuda.is_available():
        return False
    return torch.cuda.device_count() >= threshold_devices
