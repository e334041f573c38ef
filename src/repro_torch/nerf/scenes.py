"""Cameras of the procedural scenes: the ring of look-at poses and pinhole
rays, so serve requests carry real camera rays. Scenes live in
[-0.5, 0.5]^3. (The SDF scenes and their ground-truth renders are not
ported yet.)"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    name: str = "chair"
    image_hw: int = 64
    n_train_views: int = 12
    n_test_views: int = 3
    cam_radius: float = 1.3
    cam_elevation: float = 0.45  # radians above the equator
    focal_mult: float = 1.2  # focal = focal_mult * image_hw
    light_dir: Tuple[float, float, float] = (0.5, -1.0, 0.6)
    ambient: float = 0.35


def camera_poses(cfg: SceneConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Ring of look-at cameras. Returns (train (Nt,3,4), test (Ne,3,4))
    camera-to-world matrices [R|t]."""

    def pose(theta):
        eye = np.array([
            cfg.cam_radius * np.cos(theta) * np.cos(cfg.cam_elevation),
            cfg.cam_radius * np.sin(cfg.cam_elevation),
            cfg.cam_radius * np.sin(theta) * np.cos(cfg.cam_elevation),
        ])
        fwd = -eye / np.linalg.norm(eye)  # look at origin
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
        right /= np.linalg.norm(right)
        up2 = np.cross(right, fwd)
        c2w = np.stack([right, up2, -fwd], axis=1)  # columns
        return np.concatenate([c2w, eye[:, None]], axis=1)  # (3,4)

    train = np.stack([
        pose(t) for t in
        np.linspace(0, 2 * np.pi, cfg.n_train_views, endpoint=False)
    ])
    test = np.stack([
        pose(t + 0.13) for t in
        np.linspace(0, 2 * np.pi, cfg.n_test_views, endpoint=False)
    ])
    return train.astype(np.float32), test.astype(np.float32)


def camera_rays(c2w, hw: int, focal: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pinhole rays for one pose (CPU tensors: a request's payload).
    Returns (origins (hw*hw,3), dirs (hw*hw,3)) f32."""
    c2w = torch.as_tensor(np.asarray(c2w, np.float32))
    j, i = torch.meshgrid(torch.arange(hw), torch.arange(hw), indexing="ij")
    x = (i - hw / 2 + 0.5) / focal
    y = -(j - hw / 2 + 0.5) / focal
    d_cam = torch.stack([x, y, -torch.ones_like(x)], dim=-1).reshape(-1, 3)
    d_world = d_cam.to(torch.float32) @ c2w[:, :3].T
    d_world = d_world / torch.linalg.norm(d_world, dim=-1, keepdim=True)
    return c2w[:, 3].expand(d_world.shape).contiguous(), d_world
