"""Cameras, rays and the pose-cell key.

Frozen copies from the port: the look-at pose of
`src/repro_torch/nerf/scenes.py` (`camera_poses`), its pinhole directions
(`camera_rays`; here normalised in the camera frame, which the rotation
keeps), and the pose-cell key of `src/repro_torch/nerf/pose_cache.py`
(`pose_cell_key`) with the jitter of `chip_smoke.py` (`jittered`): an
origin moved by the first of +-1e-4, +-5e-5 that keeps the key.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def look_at(theta: float, elevation: float, radius: float) -> np.ndarray:
    """(3, 4) float32 camera-to-world [R | eye] on the sphere of `radius`,
    looking at the origin, y up."""
    eye = np.array([radius * np.cos(theta) * np.cos(elevation),
                    radius * np.sin(elevation),
                    radius * np.sin(theta) * np.cos(elevation)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.stack([right, up, -fwd], axis=1)
    return np.concatenate([c2w, eye[:, None]], axis=1).astype(np.float32)


def pixel_dirs(hw: int, focal: float) -> np.ndarray:
    """(hw * hw, 3) float32 unit directions of a pinhole's pixel centres
    in the camera frame, row-major from the top left."""
    j, i = np.meshgrid(np.arange(hw), np.arange(hw), indexing="ij")
    d = np.stack([(i - hw / 2 + 0.5) / focal, -(j - hw / 2 + 0.5) / focal,
                  -np.ones((hw, hw))], axis=-1).reshape(-1, 3)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def frame_rays(c2w: np.ndarray, dirs: np.ndarray, shift: float = 0.0
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(origins, directions), each (N, 3) float32: the origins one
    broadcast row (the eye, moved by `shift` on every axis)."""
    eye = c2w[:, 3] + np.float32(shift)
    rd = dirs @ c2w[:, :3].T
    return np.broadcast_to(eye.astype(np.float32), rd.shape), rd


def pose_cell_key(ro: np.ndarray, rd: np.ndarray, pos_cell: float,
                  dir_cell: float) -> Tuple[int, ...]:
    """The mean origin quantized by `pos_cell`, the first and the last
    direction by `dir_cell`, all by floor."""
    ro = np.asarray(ro, np.float32).reshape(-1, 3)
    rd = np.asarray(rd, np.float32).reshape(-1, 3)
    o = np.floor(ro.mean(axis=0) / pos_cell).astype(np.int64)
    d0 = np.floor(rd[0] / dir_cell).astype(np.int64)
    d1 = np.floor(rd[-1] / dir_cell).astype(np.int64)
    return tuple(o.tolist()) + tuple(d0.tolist()) + tuple(d1.tolist())


def eye_cell_key(c2w: np.ndarray, rd: np.ndarray, pos_cell: float,
                 dir_cell: float) -> Tuple[int, ...]:
    """`pose_cell_key` of a pinhole frame from its eye in place of the mean
    of its origins (a mean over a frame's rows costs ~10 ms on the host;
    the two differ only where the eye lies within rounding of a cell's
    edge)."""
    o = np.floor(c2w[:, 3] / pos_cell).astype(np.int64)
    d0 = np.floor(rd[0] / dir_cell).astype(np.int64)
    d1 = np.floor(rd[-1] / dir_cell).astype(np.int64)
    return tuple(o.tolist()) + tuple(d0.tolist()) + tuple(d1.tolist())


def jitter_shift(c2w: np.ndarray, dirs: np.ndarray, pos_cell: float,
                 dir_cell: float) -> Optional[float]:
    """The first origin shift of +-1e-4, +-5e-5 that keeps the pose's
    key, or None."""
    ro, rd = frame_rays(c2w, dirs)
    key = pose_cell_key(ro, rd, pos_cell, dir_cell)
    for eps in (1e-4, -1e-4, 5e-5, -5e-5):
        if pose_cell_key(frame_rays(c2w, dirs, eps)[0], rd, pos_cell,
                         dir_cell) == key:
            return eps
    return None
