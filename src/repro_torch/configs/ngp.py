"""The paper's own model: Instant-NGP configs (full + CPU-scale).

`paper()` is the Instant-NGP configuration the HERO paper quantizes
(16 hash levels, F=2, T=2^19, two small MLPs); `cpu_scale()` the reduced
member of the same family the runnable experiments use on a CPU, with
`cpu_render()` and `cpu_train()` its render and training settings.
"""
from repro_torch.nerf.hash_encoding import HashEncodingConfig
from repro_torch.nerf.ngp import NGPConfig
from repro_torch.nerf.render import RenderConfig
from repro_torch.nerf.train import TrainConfig


def paper() -> NGPConfig:
    return NGPConfig(
        hash=HashEncodingConfig(
            n_levels=16,
            n_features=2,
            log2_table_size=19,
            base_resolution=16,
            max_resolution=2048,
        ),
        hidden_dim=64,
        geo_feat_dim=15,
        color_hidden_dim=64,
        sh_degree=4,
    )


def cpu_scale() -> NGPConfig:
    return NGPConfig(
        hash=HashEncodingConfig(
            n_levels=8,
            n_features=2,
            log2_table_size=11,
            base_resolution=4,
            max_resolution=64,
        ),
        hidden_dim=32,
        geo_feat_dim=15,
        color_hidden_dim=32,
        sh_degree=3,
    )


def cpu_render() -> RenderConfig:
    return RenderConfig(n_samples=32)


def cpu_train() -> TrainConfig:
    return TrainConfig(steps=300, batch_rays=512, lr=5e-3)
