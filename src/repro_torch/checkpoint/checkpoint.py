"""Step-atomic, manifest-hashed checkpointing in the reference's format.

The counterpart of `repro/checkpoint/checkpoint.py`, file for file:
`step_N/arrays.npz` (one entry a leaf, keyed by its '/'-joined path:
dict keys, sequence indices, named-tuple field names, so `(params,
AdamWState)` gives `0/...`, `1/step`, `1/mu/...`, `1/nu/...`, and int8
moments `.../codes` and `.../scale`) beside `step_N/manifest.json` (step,
time, the caller's `extra` such as the data pipeline's state, and per
leaf its shape, dtype name and the first 16 hex digits of the sha256 of
its bytes). A checkpoint either package writes, the other restores, as
long as the tree has the same structure.

- *atomic*: written under `tmp_step_N`, fsynced, renamed to `step_N`; a
  torn write never hides the newest complete checkpoint.
- *verifiable*: a leaf whose shape, dtype or hash disagrees with the
  manifest fails the restore.
- *async*: `CheckpointManager(async_write=True)` copies the tree to the
  host, then a writer thread writes it.
- *exact data resume*: the data pipeline's counter rides in `extra`.
- *placed*: a tree of placed tensors (DTensors) is gathered leaf by leaf
  to rank 0's host memory and written by rank 0 alone, in the layout a
  one-process run writes; the other ranks wait at a barrier. A restore
  given `shardings` of `NamedSharding` leaves keeps each rank's block,
  whatever mesh wrote the checkpoint (elastic restore).

bfloat16: numpy has no bfloat16, and `np.savez` stores the reference's
(ml_dtypes) bfloat16 leaves as raw 2-byte voids (`|V2`) under the
manifest's "bfloat16". The port writes the same bytes and reads them
back as bfloat16; the reference cannot restore them (its check compares
`|V2` with "bfloat16", ROADMAP §3).
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import full_tensor, place
from repro_torch.tree_util import leaves_with_path, map_with_path

_BF16_VOID = np.dtype("V2")


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array np.savez writes, the manifest's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(
                _BF16_VOID), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of a process
    group, or a process without one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def to_host(tree):
    """The tree with every tensor in host memory: a card's tensors are
    copied, host tensors are taken as they are (a saved tree is not
    updated in place afterwards: the train step returns new tensors).
    A placed tensor is gathered (every rank takes part), one leaf at a
    time, into rank 0's host memory; the other ranks keep its shape on
    the meta device."""
    from torch.distributed.tensor import DTensor

    def host(_, v):
        if not isinstance(v, torch.Tensor) or v.device.type == "meta":
            return v
        if isinstance(v, DTensor):
            whole = full_tensor(v).detach()
            return whole.to("cpu") if _writes() else whole.to("meta")
        return v.detach().to("cpu")

    return map_with_path(host, tree)


def save_checkpoint(directory: str | Path, step: int, tree: Any,
                    extra: Optional[Dict[str, Any]] = None) -> Path:
    """Atomic write of `tree` (tensors or numpy arrays; + JSON-serializable
    `extra`, e.g. data state)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"tmp_step_{step}"
    final = directory / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    flat, names = {}, {}
    for k, leaf in leaves_with_path(tree):
        flat[k], names[k] = _to_numpy(leaf)
    manifest = {"step": step, "time": time.time(), "extra": extra or {},
                "arrays": {}}
    np.savez(tmp / "arrays.npz", **flat)
    for k, v in flat.items():
        manifest["arrays"][k] = {"shape": list(v.shape), "dtype": names[k],
                                 "sha256_16": _sha(v)}
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)  # the atomicity point
    return final


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = []
    for p in directory.iterdir():
        if p.name.startswith("step_") and (p / "manifest.json").exists():
            try:
                steps.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def _stored_as(a: np.ndarray, dtype_name: str) -> bool:
    return str(a.dtype) == dtype_name or (
        dtype_name == "bfloat16" and a.dtype == _BF16_VOID)


def restore_checkpoint(directory: str | Path, step: Optional[int] = None,
                       like: Any = None, shardings: Any = None,
                       verify: bool = True):
    """Restore (tree, extra). `like` supplies the tree's structure (its
    leaves, e.g. meta tensors, are not read); `shardings` is where the
    leaves go: one device for all, or a tree mirroring `like` of devices
    or of `NamedSharding`s (`distributed.sharding.named`: each rank keeps
    its block, as a DTensor); None: host memory. Without `like`, the tree
    is {key: tensor}."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    d = directory / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    data = np.load(d / "arrays.npz")
    meta = manifest["arrays"]

    arrays = {}  # each leaf read from the archive once
    for k, m in meta.items():
        a = arrays[k] = data[k]
        if not verify:
            continue
        if list(a.shape) != m["shape"] or not _stored_as(a, m["dtype"]):
            raise ValueError(f"checkpoint leaf {k}: shape/dtype mismatch")
        if _sha(a) != m["sha256_16"]:
            raise ValueError(f"checkpoint leaf {k}: hash mismatch (corrupt)")

    if like is None:
        return {k: _to_tensor(a, meta[k]["dtype"])
                for k, a in arrays.items()}, manifest["extra"]

    paths = [k for k, _ in leaves_with_path(like)]
    if shardings is None or isinstance(shardings, (str, torch.device)):
        devs = [shardings] * len(paths)
    else:
        devs = [v for _, v in leaves_with_path(shardings)]
        if len(devs) != len(paths):
            raise ValueError(f"shardings tree has {len(devs)} leaves, "
                             f"expected {len(paths)} (must mirror `like`)")
    values = {}
    for key, dev in zip(paths, devs):
        if key not in meta:
            raise KeyError(f"checkpoint missing leaf {key}")
        t = _to_tensor(arrays.pop(key), meta[key]["dtype"])
        values[key] = t if dev is None else place(t, dev)
    return map_with_path(lambda p, _: values[p], like), manifest["extra"]


class CheckpointManager:
    """Keeps the last `keep` checkpoints; optional async writer thread.
    `save` copies the tree to the host before it returns; a writer's
    error surfaces at the next `save`, `wait` or `close`."""

    def __init__(self, directory: str | Path, keep: int = 3,
                 async_write: bool = False):
        self.directory = Path(directory)
        self.keep = keep
        self.async_write = async_write
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if async_write and _writes():
            self._worker = threading.Thread(target=self._loop, daemon=True)
            self._worker.start()

    def _loop(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, host_tree, extra = item
                save_checkpoint(self.directory, step, host_tree, extra)
                self._gc()
            except BaseException as e:  # surfaces on the next call
                self._error = e
            finally:
                self._q.task_done()

    def _gc(self):
        steps = sorted(
            int(p.name.split("_")[1])
            for p in self.directory.iterdir()
            if p.name.startswith("step_")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self.directory / f"step_{s}", ignore_errors=True)

    def _raise(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        """Under a process group every rank calls it: rank 0 writes."""
        self._raise()
        host = to_host(tree)  # device -> host now
        if _writes() and self.async_write:
            self._q.put((step, host, extra))
        elif _writes():
            save_checkpoint(self.directory, step, host, extra)
            self._gc()
        _barrier()

    def wait(self):
        """Block until every queued checkpoint is on disk."""
        if self._worker is not None:
            self._q.join()
        _barrier()
        self._raise()

    def close(self):
        """Finish the queued writes and stop the writer."""
        if self._worker is not None:
            self._q.put(None)
            self._worker.join()
            self._worker = None
        _barrier()
        self._raise()


def _barrier():
    if dist.is_initialized():
        dist.barrier()
