"""NGP training / finetuning / PSNR evaluation.

`train_ngp` fits a fresh model (full precision). `finetune_ngp` is the
retraining step of the HERO episode (Sec. III-E): short QAT through the
fake-quantized forward with the episode's bit assignment. Both run one
train step a batch on plain PyTorch autograd (the reference trains on
plain `jnp` too, no kernel): the loss, its gradient, the global-norm clip
at 10.0 and an AdamW update, with a fresh optimizer state per run. The
stratified jitter is an operand of the step; the loops draw it from a
`torch.Generator` seeded from the run's seed, on the training device.
Entry points run on the card unless given `device="cpu"`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.backend import DeviceLike, check_device, resolve_device
from repro_torch.nerf.dataset import NGPDataset
from repro_torch.nerf.fast_render import FastRenderEngine
from repro_torch.nerf.ngp import NGPConfig, NGPQuantSpec, init_ngp, no_quant_spec
from repro_torch.nerf.render import RenderConfig, render_rays
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
)
from repro_torch.tree_util import leaves_with_path, map_with_path, tree_map

# The reference clips at this constant, not at `TrainConfig.grad_clip`.
GRAD_CLIP = 10.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 400
    batch_rays: int = 512
    lr: float = 5e-3
    finetune_lr: float = 1e-3
    weight_decay: float = 1e-6
    grad_clip: float = 10.0
    seed: int = 0
    eval_ray_chunk: int = 4096


def psnr(mse: float) -> float:
    return float(-10.0 * np.log10(max(mse, 1e-12)))


def _loss_fn(params, rays_o, rays_d, target, cfg, rcfg, spec, jitter):
    color, _ = render_rays(params, rays_o, rays_d, cfg, rcfg, spec, jitter)
    return torch.mean((color - target) ** 2)


def _train_step(params, opt_state, rays_o, rays_d, target, jitter,
                spec: NGPQuantSpec, cfg: NGPConfig, rcfg: RenderConfig,
                opt_cfg: AdamWConfig):
    """One step: (new params, new AdamW state, loss as a device scalar).
    `jitter` (R, S) uniforms stratify the samples (`render_rays`)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    paths, leaves = zip(*leaves_with_path(live))
    loss = _loss_fn(live, rays_o, rays_d, target, cfg, rcfg, spec, jitter)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_path = {k: torch.zeros_like(p) if g is None else g
               for k, p, g in zip(paths, leaves, grads)}
    grads = map_with_path(lambda path, _: by_path[path], live)
    grads, _ = clip_by_global_norm(grads, GRAD_CLIP)
    params, opt_state = adamw_update(grads, opt_state,
                                     tree_map(torch.Tensor.detach, live),
                                     opt_cfg)
    return params, opt_state, loss.detach()


def _run_steps(params, dataset: NGPDataset, cfg: NGPConfig,
               rcfg: RenderConfig, tcfg: TrainConfig, spec: NGPQuantSpec,
               steps: int, lr: float, seed: int):
    dev = params["sigma/0"]["w"].device
    opt_cfg = AdamWConfig(lr=lr, weight_decay=tcfg.weight_decay)
    opt_state = adamw_init(params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batches = dataset.ray_batches(tcfg.batch_rays, seed=seed)
    loss = None
    for _ in range(steps):
        ro, rd, c = (torch.from_numpy(a).to(dev) for a in next(batches))
        jitter = torch.rand((tcfg.batch_rays, rcfg.n_samples),
                            generator=gen, device=dev)
        params, opt_state, loss = _train_step(params, opt_state, ro, rd, c,
                                              jitter, spec, cfg, rcfg,
                                              opt_cfg)
    return params, float(loss) if loss is not None else float("nan")


def train_ngp(dataset: NGPDataset, cfg: NGPConfig, rcfg: RenderConfig,
              tcfg: TrainConfig, device: DeviceLike = None
              ) -> Tuple[Dict, float]:
    """Train a fresh full-precision NGP, initialised from
    `torch.Generator().manual_seed(tcfg.seed)`. Returns (params,
    final_loss): the last step's loss."""
    dev = resolve_device(device)
    params = init_ngp(torch.Generator().manual_seed(tcfg.seed), cfg,
                      device=dev)
    return _run_steps(params, dataset, cfg, rcfg, tcfg,
                      no_quant_spec(cfg, dev), tcfg.steps, tcfg.lr,
                      tcfg.seed)


def finetune_ngp(params: Dict, dataset: NGPDataset, cfg: NGPConfig,
                 rcfg: RenderConfig, tcfg: TrainConfig, spec: NGPQuantSpec,
                 steps: int, device: DeviceLike = None
                 ) -> Tuple[Dict, float]:
    """QAT finetune under a quantization spec (the episode retraining), at
    `tcfg.finetune_lr` from seed `tcfg.seed + 1`. `params` and `spec` must
    live on the device; `params` is not changed in place."""
    dev = resolve_device(device)
    check_device(params["sigma/0"]["w"], dev, "the parameters")
    check_device(spec.hash_bits, dev, "the quantization spec")
    return _run_steps(params, dataset, cfg, rcfg, tcfg, spec, steps,
                      tcfg.finetune_lr, tcfg.seed + 1)


def evaluate_psnr(params: Dict, dataset: NGPDataset, cfg: NGPConfig,
                  rcfg: RenderConfig, spec: Optional[NGPQuantSpec] = None,
                  chunk: int = 4096, occ=None, mode: str = "reference",
                  budget: Optional[int] = None,
                  device: DeviceLike = None) -> float:
    """Mean PSNR over held-out test views (`FastRenderEngine.
    evaluate_psnr`): `mode="reference"` renders through the fake-quant
    oracle; `mode="fused"` through the integer kernel path, culled by the
    occupancy grid `occ` when one is given, under the test set's cull plan
    or under an explicit `budget`."""
    return FastRenderEngine(params, cfg, rcfg, spec=spec, occ=occ, mode=mode,
                            chunk=chunk, budget=budget,
                            device=device).evaluate_psnr(dataset)


def render_test_view(params: Dict, dataset: NGPDataset, cfg: NGPConfig,
                     rcfg: RenderConfig, view: int = 0,
                     spec: Optional[NGPQuantSpec] = None, chunk: int = 4096,
                     occ=None, mode: str = "reference",
                     device: DeviceLike = None) -> np.ndarray:
    """Render one held-out view to an (hw, hw, 3) image (for Fig. 5-style
    qualitative comparisons)."""
    engine = FastRenderEngine(params, cfg, rcfg, spec=spec, occ=occ,
                              mode=mode, chunk=chunk, device=device)
    colors = engine.render_frame(dataset.test_rays_o[view],
                                 dataset.test_rays_d[view])
    hw = dataset.cfg.image_hw
    return colors.cpu().numpy().reshape(hw, hw, 3)
