"""The distribution substrate: sharding rules and placement over a mesh
of ranks, the device-split population evaluation, fault tolerance, fault
injection, gradient compression and the elastic cell-parallel search
orchestrator.

`orchestrator`/`chaos`/`worker_main` are imported by path (the
orchestrator depends on `repro_torch.core.closed_loop`, which reaches
this package through `core.batched_env` — an eager re-export here would
be circular). The reference's `population_mesh` is `population_devices`
here; its `hlo_analysis` names are not ported yet (ROADMAP item 10)."""
from repro_torch.distributed.sharding import (
    ShardingConfig,
    param_pspecs,
    cache_pspecs,
    data_pspecs,
    batch_axes,
    named,
    validate_divisibility,
)
from repro_torch.distributed.population import (
    POP_AXIS,
    auto_shard,
    pad_population,
    population_devices,
    shard_population,
)

__all__ = [
    "ShardingConfig",
    "param_pspecs",
    "cache_pspecs",
    "data_pspecs",
    "batch_axes",
    "named",
    "validate_divisibility",
    "POP_AXIS",
    "auto_shard",
    "pad_population",
    "population_devices",
    "shard_population",
]
