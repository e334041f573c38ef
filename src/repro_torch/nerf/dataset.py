"""Dataset: posed ground-truth images + ray batch iterator for NGP training.

The arrays are numpy, as the reference's are, so a dataset crosses between
the two packages as it is; the ground truth is rendered on the card unless
the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.nerf.scenes import (
    SceneConfig,
    camera_poses,
    camera_rays,
    make_scene,
    render_ground_truth,
)


@dataclasses.dataclass
class NGPDataset:
    scene_name: str
    cfg: SceneConfig
    # Flattened over all train views:
    train_rays_o: np.ndarray  # (N, 3)
    train_rays_d: np.ndarray  # (N, 3)
    train_rgb: np.ndarray  # (N, 3)
    # Per test view:
    test_rays_o: np.ndarray  # (V, hw*hw, 3)
    test_rays_d: np.ndarray  # (V, hw*hw, 3)
    test_rgb: np.ndarray  # (V, hw*hw, 3)

    def ray_batches(self, batch_size: int, seed: int = 0
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Infinite shuffled ray batches (deterministic given seed: the
        same `np.random.RandomState` draws as the reference's)."""
        rng = np.random.RandomState(seed)
        n = self.train_rays_o.shape[0]
        while True:
            idx = rng.randint(0, n, size=batch_size)
            yield (self.train_rays_o[idx], self.train_rays_d[idx],
                   self.train_rgb[idx])


def _render_views(scene, poses: np.ndarray, cfg: SceneConfig,
                  device: torch.device):
    focal = cfg.focal_mult * cfg.image_hw
    out = [], [], []
    for pose in poses:
        o, d = camera_rays(pose, cfg.image_hw, focal)
        c = render_ground_truth(scene, o.to(device), d.to(device), cfg)
        for acc, a in zip(out, (o, d, c)):
            acc.append(a.cpu().numpy())
    return out


def make_dataset(cfg: SceneConfig, device: DeviceLike = None) -> NGPDataset:
    """Render the scene's train and test views (on the card unless
    `device="cpu"`) into a dataset of numpy arrays."""
    dev = resolve_device(device)
    scene = make_scene(cfg.name)
    train_poses, test_poses = camera_poses(cfg)
    tr_o, tr_d, tr_c = _render_views(scene, train_poses, cfg, dev)
    te_o, te_d, te_c = _render_views(scene, test_poses, cfg, dev)
    return NGPDataset(
        scene_name=cfg.name,
        cfg=cfg,
        train_rays_o=np.concatenate(tr_o),
        train_rays_d=np.concatenate(tr_d),
        train_rgb=np.concatenate(tr_c),
        test_rays_o=np.stack(te_o),
        test_rays_d=np.stack(te_d),
        test_rgb=np.stack(te_c),
    )
