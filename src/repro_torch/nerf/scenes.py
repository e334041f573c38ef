"""Procedural ground-truth scenes (Synthetic-NeRF stand-ins).

Three SDF scenes named after their Synthetic-NeRF counterparts -- `chair`,
`lego` (a stacked-brick tower), `ficus` (blobby plant in a pot) --
rendered analytically by sphere tracing with Lambertian + ambient shading
on a white background, on the rays' device. Scenes live in
[-0.5, 0.5]^3. Cameras are look-at poses on a ring; intrinsics are a
simple pinhole.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

SceneFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
# point (..., 3) -> (sdf (...,), rgb (..., 3))


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


# ---------------------------------------------------------------------------
# SDF primitives (float32, as the reference computes them)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _const(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """A small f32 constant on `device`, copied there once: a copy from
    host memory per sphere-tracing step would stall the card's stream."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _sd_box(p, center, half):
    q = torch.abs(p - _const(tuple(center), p.device)) \
        - _const(tuple(half), p.device)
    outside = _norm(torch.clamp_min(q, 0.0))
    inside = torch.clamp_max(torch.amax(q, dim=-1), 0.0)
    return outside + inside


def _sd_sphere(p, center, r):
    return _norm(p - _const(tuple(center), p.device)) - r


def _sd_cylinder_y(p, center, r, half_h):
    d = p - _const(tuple(center), p.device)
    dxz = torch.sqrt(d[..., 0] ** 2 + d[..., 2] ** 2) - r
    dy = torch.abs(d[..., 1]) - half_h
    outside = torch.sqrt(torch.clamp_min(dxz, 0.0) ** 2
                         + torch.clamp_min(dy, 0.0) ** 2)
    inside = torch.clamp_max(torch.maximum(dxz, dy), 0.0)
    return outside + inside


def _union(parts: Sequence):
    """parts: list of (sdf (...,), rgb (3,)). Min-union with the winner's
    color (the first part on a tie)."""
    sdfs = torch.stack([s for s, _ in parts], dim=-1)  # (..., K)
    cols = _const(tuple(float(v) for _, c in parts for v in c),
                  sdfs.device).reshape(-1, 3)
    sdf, k = torch.min(sdfs, dim=-1)
    return sdf, cols[k]


# ---------------------------------------------------------------------------
# Scenes
# ---------------------------------------------------------------------------
def _chair(p):
    seat = (_sd_box(p, (0.0, -0.05, 0.0), (0.18, 0.02, 0.18)),
            (0.72, 0.45, 0.20))
    back = (_sd_box(p, (0.0, 0.12, -0.16), (0.18, 0.16, 0.02)),
            (0.76, 0.50, 0.24))
    legs = []
    for sx in (-0.14, 0.14):
        for sz in (-0.14, 0.14):
            legs.append((_sd_box(p, (sx, -0.20, sz), (0.02, 0.13, 0.02)),
                         (0.45, 0.28, 0.12)))
    return _union([seat, back] + legs)


def _lego(p):
    bricks = []
    cols = [(0.85, 0.15, 0.12), (0.95, 0.75, 0.10), (0.15, 0.45, 0.80),
            (0.20, 0.65, 0.25)]
    for i, c in enumerate(cols):
        y = -0.28 + 0.14 * i
        half = 0.20 - 0.035 * i
        bricks.append((_sd_box(p, (0.0, y, 0.0), (half, 0.06, half * 0.7)),
                       c))
        # studs
        bricks.append((_sd_cylinder_y(p, (half * 0.5, y + 0.08, 0.0), 0.03,
                                      0.02), c))
        bricks.append((_sd_cylinder_y(p, (-half * 0.5, y + 0.08, 0.0), 0.03,
                                      0.02), c))
    return _union(bricks)


@functools.lru_cache(maxsize=None)
def _ficus_blobs() -> Tuple[Tuple[Tuple[float, ...], float, float], ...]:
    """(center, radius, green) of the nine leaf blobs, from the reference's
    seeded draw."""
    rng = np.random.RandomState(7)
    blobs = []
    for _ in range(9):
        c = rng.uniform(-0.16, 0.16, size=3)
        c[1] = rng.uniform(0.05, 0.30)
        r = rng.uniform(0.05, 0.10)
        g = rng.uniform(0.35, 0.65)
        blobs.append((tuple(float(v) for v in c), float(r), float(g)))
    return tuple(blobs)


def _ficus(p):
    pot = (_sd_cylinder_y(p, (0.0, -0.33, 0.0), 0.12, 0.08),
           (0.55, 0.27, 0.15))
    trunk = (_sd_cylinder_y(p, (0.0, -0.10, 0.0), 0.025, 0.18),
             (0.42, 0.30, 0.16))
    blobs = [(_sd_sphere(p, c, r), (0.10, g, 0.12))
             for c, r, g in _ficus_blobs()]
    return _union([pot, trunk] + blobs)


_SCENES = {"chair": _chair, "lego": _lego, "ficus": _ficus}


def make_scene(name: str) -> SceneFn:
    if name not in _SCENES:
        raise KeyError(f"unknown scene {name!r}; have {sorted(_SCENES)}")
    return _SCENES[name]


# ---------------------------------------------------------------------------
# Cameras
# ---------------------------------------------------------------------------
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


# ---------------------------------------------------------------------------
# Ground-truth rendering (sphere tracing)
# ---------------------------------------------------------------------------
@torch.no_grad()
def render_ground_truth(scene: SceneFn, rays_o: torch.Tensor,
                        rays_d: torch.Tensor, cfg: SceneConfig,
                        n_steps: int = 48, eps: float = 2e-3) -> torch.Tensor:
    """Sphere-trace each ray (`n_steps` steps, a hit at sdf < eps);
    Lambertian shade on a hit (central-difference normals); white
    background. Runs on the rays' device. Returns (R, 3) f32."""
    t = torch.full((rays_o.shape[0],), 0.05, device=rays_o.device)
    hit = torch.zeros((rays_o.shape[0],), dtype=torch.bool,
                      device=rays_o.device)
    for _ in range(n_steps):
        d, _ = scene(rays_o + rays_d * t[:, None])
        hit = hit | (d < eps)
        t = t + torch.where(hit, 0.0, torch.clamp_min(d, 1e-3))

    p = rays_o + rays_d * t[:, None]
    _, albedo = scene(p)

    # Normal via central differences.
    h = 1e-3
    grads = []
    for axis in range(3):
        e = torch.zeros(3, device=p.device)
        e[axis] = h
        grads.append(scene(p + e)[0] - scene(p - e)[0])
    n = torch.stack(grads, dim=-1)
    n = n / (_norm(n)[:, None] + 1e-9)

    light = _const(tuple(cfg.light_dir), p.device)
    light = light / _norm(light)
    diffuse = torch.clamp(torch.sum(n * (-light)[None], dim=-1), 0.0, 1.0)
    shade = cfg.ambient + (1.0 - cfg.ambient) * diffuse
    color = albedo * shade[:, None]
    return torch.where(hit[:, None], color, torch.ones_like(color))
