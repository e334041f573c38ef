"""Pose-grid plan cache: compiled cull plans for ad-hoc camera poses.

The serve engine renders requests from poses it has never seen; building
a `CullPlan` per request would dwarf the render. But real clients orbit,
dolly, and revisit: poses cluster. This module quantizes each request's
pose onto a configurable position/orientation grid and caches, per
(scene, pose cell, chunk), a compiled `WarpPlan` with THREE uses:

- **hit**: the slot's rays fingerprint-match the plan's reference rays —
  serve the baked plan (precomputed gathers + hash corners + SH bases,
  fixed-ray `CullPlan` speed).
- **warp**: the rays deviate from the reference but by less than the
  plan's coverage margin — reuse the CONSERVATIVE compaction indices for
  the new rays (field inputs are the actual points, the final mask
  re-intersects with the exact device march, so coverage — not the
  reference pose — decides correctness).
- **miss**: no plan or too much deviation — the on-device ray-march path
  renders, and the cell's use count decides whether to build a plan.

Conservativeness is the load-bearing property: a plan built from
`sample_active_mask(..., margin=m)` (box grown by `m`, occupancy dilated
by `ceil(m * resolution)` cells) covers every exact-active sample of ANY
rays whose per-sample points deviate from the reference by at most `m`
in L-inf (|floor(u) - floor(v)| <= ceil(|u - v|), and the box clip is a
projection, so clipping can only shrink the deviation). The deviation
bound per sample is `max|d_o|_inf + t_far * max|d_d|_inf` over the slot
(`warp_deviation`), with `t_far = max(|near|, |far|)` bounding every
sample depth. Reused plans therefore never cull a sample the exact plan
would keep — warped renders match the march tier's sample set exactly.

The plans are baked on the occupancy grid's device (the engine's) by the
renderer's own corner math and SH basis (`fast_render.bake_field_inputs`),
and hold the JAX package's arrays with the same shapes and dtypes, so
their bytes are the same.

LRU eviction by pose cell; pinned (in-flight) cells are never evicted —
the engine pins a cell at submit and unpins when the request's slots
rendered or dropped. Plan bytes are charged to the engine's
`resident_bytes` so artifact-cache pressure sees them.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.nerf.fast_render import bake_field_inputs
from repro_torch.nerf.occupancy import OccupancyGrid, sample_active_mask


@dataclasses.dataclass(frozen=True)
class PoseGridConfig:
    """Quantization grid + cache policy (engine-level knobs)."""

    pos_cell: float = 0.05  # world units per position cell
    dir_cell: float = 0.05  # direction-component units per cell
    margin_cells: float = 1.0  # warp coverage margin, in OCC grid cells
    entries: int = 128  # LRU capacity (pose cells per engine)
    build_after: int = 2  # build plans on the Nth request visit of a cell

    def margin(self, occ: OccupancyGrid) -> float:
        """World-space coverage margin for this scene's grid."""
        return float(self.margin_cells) / float(occ.resolution)


def pose_cell_key(rays_o, rays_d, pos_cell: float,
                  dir_cell: float) -> Tuple[int, ...]:
    """Deterministic pose-grid cell of a ray bundle.

    Quantizes the mean ray origin (the camera position for pinhole
    bundles) by `pos_cell` and the first and last ray directions (which
    pin the orientation and field of view) by `dir_cell`, all by floor —
    equal bundles always land in equal cells, nearby poses usually do.
    """
    ro = np.asarray(rays_o, np.float32).reshape(-1, 3)
    rd = np.asarray(rays_d, np.float32).reshape(-1, 3)
    o = np.floor(ro.mean(axis=0) / pos_cell).astype(np.int64)
    d0 = np.floor(rd[0] / dir_cell).astype(np.int64)
    d1 = np.floor(rd[-1] / dir_cell).astype(np.int64)
    return tuple(o.tolist()) + tuple(d0.tolist()) + tuple(d1.tolist())


def ray_fingerprint(rays_o: np.ndarray, rays_d: np.ndarray) -> str:
    """Content hash of a (padded) slot ray bundle — the hit-tier test."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(rays_o, np.float32).tobytes())
    h.update(np.ascontiguousarray(rays_d, np.float32).tobytes())
    return h.hexdigest()


def warp_deviation(rays_o, rays_d, ref_o: np.ndarray, ref_d: np.ndarray,
                   rcfg) -> float:
    """Upper bound on the per-sample L-inf deviation of these rays'
    sample points from the reference rays' (shape mismatch -> inf)."""
    ro = np.asarray(rays_o, np.float32)
    rd = np.asarray(rays_d, np.float32)
    if ro.shape != ref_o.shape:
        return float("inf")
    t_far = max(abs(float(rcfg.near)), abs(float(rcfg.far)))
    d_o = float(np.max(np.abs(ro - ref_o), initial=0.0))
    d_d = float(np.max(np.abs(rd - ref_d), initial=0.0))
    return d_o + t_far * d_d


@dataclasses.dataclass
class WarpPlan:
    """One pose cell's compiled compaction for one request chunk.

    `take`/`inv_take`/`valid_cons` are the conservative compaction shared
    by the warp tier; `plan_row` is the fully baked hit-tier row
    (`fast_render.slot_plan`'s layout). Tensors live on the engine's
    device; the reference rays stay on the host for the tier tests.
    """

    fp: str  # fingerprint of the reference rays (hit test)
    ref_o: np.ndarray  # (R, 3) reference rays, host-side
    ref_d: np.ndarray
    margin: float  # world-space coverage margin
    budget: int  # conservative buffer rows B
    inv_take: torch.Tensor  # (B,) i32: flat sample index per buffer row
    take: torch.Tensor  # (P,) i32: buffer row per flat sample
    valid_cons: torch.Tensor  # (P,) bool: conservative active mask
    plan_row: tuple  # (buf_pts, buf_dirs, take, valid_exact, hi, hw, sh)
    nbytes: int


def build_warp_plan(occ: OccupancyGrid, rays_o, rays_d, rcfg, cfg,
                    margin: float) -> WarpPlan:
    """Bake one slot's plan: conservative compaction indices (warp tier)
    plus the exact-ray gather buffers/corner data (hit tier), on the
    occupancy grid's device."""
    ro = np.asarray(rays_o, np.float32).reshape(-1, 3)
    rd = np.asarray(rays_d, np.float32).reshape(-1, 3)
    n_s = rcfg.n_samples
    P = ro.shape[0] * n_s

    m_cons, pts = sample_active_mask(occ, ro, rd, rcfg, margin=margin)
    m_exact, _ = sample_active_mask(occ, ro, rd, rcfg)
    cons = m_cons.reshape(-1)
    idx = np.nonzero(cons)[0]
    count = idx.size
    B = int(min(P, max(128, -(-count // 128) * 128)))

    take = np.zeros(P, np.int32)
    take[idx] = np.arange(count, dtype=np.int32)
    inv_take = np.zeros(B, np.int32)
    inv_take[:count] = idx

    pts_unit = np.clip(pts + 0.5, 0.0, 1.0).reshape(-1, 3)
    dirs = np.broadcast_to(rd[:, None, :], (ro.shape[0], n_s, 3))
    dirs = np.ascontiguousarray(dirs.reshape(-1, 3))
    buf_pts = np.zeros((B, 3), np.float32)
    buf_pts[:count] = pts_unit[idx]
    buf_dirs = np.zeros((B, 3), np.float32)
    buf_dirs[:count] = dirs[idx]

    dev = occ.occ.device
    pts_d, dirs_d, hash_idx, hash_w, sh = bake_field_inputs(buf_pts, buf_dirs,
                                                            cfg, dev)
    take_d = torch.from_numpy(take).to(dev)
    plan_row = (pts_d, dirs_d, take_d,
                torch.from_numpy(m_exact.reshape(-1)).to(dev), hash_idx,
                hash_w, sh)
    held = (torch.from_numpy(inv_take).to(dev), take_d,
            torch.from_numpy(cons).to(dev)) + plan_row
    nbytes = ro.nbytes + rd.nbytes + sum(
        int(a.numel() * a.element_size()) for a in held)
    return WarpPlan(
        fp=ray_fingerprint(ro, rd), ref_o=ro, ref_d=rd,
        margin=float(margin), budget=B,
        inv_take=held[0], take=take_d, valid_cons=held[2],
        plan_row=plan_row, nbytes=nbytes,
    )


@dataclasses.dataclass
class CellEntry:
    uses: int = 0
    plans: Dict[int, WarpPlan] = dataclasses.field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.plans.values())


class PosePlanCache:
    """LRU of pose cells -> per-chunk WarpPlans, with pin-aware eviction.

    Keys are `(scene,) + pose_cell_key(...)`. A pinned key (in-flight
    request) is NEVER evicted — the cache runs over capacity instead —
    and pins may precede the entry itself (submit pins before the first
    render touches the cell). `drop_scene` removes even pinned cells:
    the scene's artifact left the device, the plans index nothing.
    """

    def __init__(self, max_entries: int = 128):
        self.max_entries = int(max_entries)
        self._entries: "OrderedDict[tuple, CellEntry]" = OrderedDict()
        self._pins: Dict[tuple, int] = {}
        self.hits = 0
        self.warps = 0
        self.misses = 0
        self.builds = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def note_use(self, key: tuple) -> CellEntry:
        """Touch (MRU) + use-count the cell, creating it if new."""
        entry = self._entries.get(key)
        if entry is None:
            entry = CellEntry()
            self._entries[key] = entry
            self._evict()
        else:
            self._entries.move_to_end(key)
        entry.uses += 1
        return entry

    def get(self, key: tuple) -> Optional[CellEntry]:
        return self._entries.get(key)

    def put_plan(self, key: tuple, seq: int, plan: WarpPlan) -> None:
        entry = self._entries.get(key)
        if entry is None:
            entry = CellEntry()
            self._entries[key] = entry
            self._evict()
        entry.plans[int(seq)] = plan
        self.builds += 1

    def pin(self, key: tuple) -> None:
        self._pins[key] = self._pins.get(key, 0) + 1

    def unpin(self, key: tuple) -> None:
        n = self._pins.get(key, 0) - 1
        if n > 0:
            self._pins[key] = n
        else:
            self._pins.pop(key, None)

    def pinned(self, key: tuple) -> bool:
        return self._pins.get(key, 0) > 0

    def drop_scene(self, scene: str) -> int:
        doomed = [k for k in self._entries if k[0] == scene]
        for k in doomed:
            del self._entries[k]
        return len(doomed)

    def reset_stats(self) -> None:
        self.hits = self.warps = self.misses = self.builds = 0
        self.evictions = 0

    def stats(self) -> Dict[str, int]:
        return {
            "cells": len(self._entries),
            "bytes": self.nbytes,
            "hits": self.hits,
            "warps": self.warps,
            "misses": self.misses,
            "builds": self.builds,
            "evictions": self.evictions,
        }

    def _evict(self) -> None:
        # Oldest-out, skipping pinned keys; all-pinned -> run over budget.
        excess = len(self._entries) - self.max_entries
        if excess <= 0:
            return
        for k in list(self._entries):
            if excess <= 0:
                break
            if self.pinned(k):
                continue
            del self._entries[k]
            self.evictions += 1
            excess -= 1
