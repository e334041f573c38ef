"""Instant-NGP field, occupancy culling and the fused integer renderer."""
from repro_torch.nerf.hash_encoding import HashEncodingConfig, init_hash_tables, hash_encode
from repro_torch.nerf.ngp import (
    NGPConfig,
    NGPQuantSpec,
    init_ngp,
    ngp_apply,
    ngp_linear_names,
    make_quant_units,
    no_quant_spec,
    spec_from_policy,
)
from repro_torch.nerf.render import render_rays, RenderConfig
from repro_torch.nerf.scenes import SceneConfig, make_scene, render_ground_truth
from repro_torch.nerf.dataset import NGPDataset, make_dataset
from repro_torch.nerf.train import train_ngp, psnr, TrainConfig, evaluate_psnr, finetune_ngp
from repro_torch.nerf.occupancy import (
    OccupancyGrid,
    bake_occupancy,
    cull_budget,
    occupancy_lookup,
)
from repro_torch.nerf.fast_render import (
    FastRenderEngine,
    FusedPack,
    build_fused_pack,
    fast_render_rays,
    fused_ngp_apply,
    fused_pack_stored_bytes,
)

__all__ = [
    "OccupancyGrid",
    "bake_occupancy",
    "cull_budget",
    "occupancy_lookup",
    "FastRenderEngine",
    "FusedPack",
    "build_fused_pack",
    "fast_render_rays",
    "fused_ngp_apply",
    "fused_pack_stored_bytes",
    "HashEncodingConfig",
    "init_hash_tables",
    "hash_encode",
    "NGPConfig",
    "NGPQuantSpec",
    "init_ngp",
    "ngp_apply",
    "ngp_linear_names",
    "make_quant_units",
    "no_quant_spec",
    "spec_from_policy",
    "render_rays",
    "RenderConfig",
    "SceneConfig",
    "make_scene",
    "render_ground_truth",
    "NGPDataset",
    "make_dataset",
    "train_ngp",
    "finetune_ngp",
    "psnr",
    "TrainConfig",
    "evaluate_psnr",
]
