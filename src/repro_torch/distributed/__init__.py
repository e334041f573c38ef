"""The distributed HERO search: the device-split population evaluation,
fault tolerance, fault injection and the elastic cell-parallel search
orchestrator.

`orchestrator`/`chaos`/`worker_main` are imported by path (the
orchestrator depends on `repro_torch.core.closed_loop`, which reaches
this package through `core.batched_env` — an eager re-export here would
be circular)."""
from repro_torch.distributed.population import (
    POP_AXIS,
    auto_shard,
    pad_population,
    population_devices,
    shard_population,
)

__all__ = [
    "POP_AXIS",
    "auto_shard",
    "pad_population",
    "population_devices",
    "shard_population",
]
