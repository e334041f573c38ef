"""Public HERO API: hardware targets, deployable artifacts, render serving.

    import repro_torch.hero as hero

    result   = hero.search(scenes=("chair",), budget_fracs=(1.0, 0.85))
    scene, bits = hero.best_bits(result)
    artifact = hero.compile_scene(scene, bits)   # or hero.compile(env, bits)
    artifact.save("artifacts/chair")
    service  = hero.serve(hero.QuantArtifact.load("artifacts/chair"))
    colors   = service.render(rays_o, rays_d)

`search`, `compile_scene` and `serve` run on the card unless given
`device="cpu"`; `compile` runs on its env's device.

Hardware targets (`HardwareTarget` protocol, `make_target`/`list_targets`)
plug different accelerator models into the same search loop; the NeuRex
simulator is the default, `roofline-edge` is an analytic non-NeuRex
alternative, and `register_target` adds your own.

Layering note: `repro_torch.core` imports `repro_torch.hero.targets`, so
this package's `__init__` only imports the (cycle-free) targets module
eagerly; the facade and its dependencies load lazily on first attribute
access.
"""
from repro_torch.hero.targets import (
    BatchedHardwareSim,
    HardwareTarget,
    NeuRexTarget,
    RooflineHWConfig,
    RooflineTarget,
    list_targets,
    make_target,
    register_target,
    resolve_target,
)

__all__ = [
    "BatchedHardwareSim",
    "HardwareTarget",
    "NeuRexTarget",
    "RooflineHWConfig",
    "RooflineTarget",
    "list_targets",
    "make_target",
    "register_target",
    "resolve_target",
    # lazy (PEP 562):
    "search",
    "compile",
    "compile_scene",
    "serve",
    "best_bits",
    "QuantArtifact",
    "compile_artifact",
    "RenderService",
    "ServeConfig",
    "ServeEngine",
    "EngineConfig",
    "serve_engine",
    "AdmissionFull",
    "RequestExpired",
    "ArtifactLoadError",
]

_LAZY = {
    "search": ("repro_torch.hero.api", "search"),
    "compile": ("repro_torch.hero.api", "compile"),
    "compile_scene": ("repro_torch.hero.api", "compile_scene"),
    "serve": ("repro_torch.hero.api", "serve"),
    "best_bits": ("repro_torch.hero.api", "best_bits"),
    "QuantArtifact": ("repro_torch.hero.artifact", "QuantArtifact"),
    "compile_artifact": ("repro_torch.hero.artifact", "compile_artifact"),
    "RenderService": ("repro_torch.hero.service", "RenderService"),
    "ServeConfig": ("repro_torch.hero.service", "ServeConfig"),
    "ServeEngine": ("repro_torch.hero.engine", "ServeEngine"),
    "EngineConfig": ("repro_torch.hero.scheduler", "EngineConfig"),
    "serve_engine": ("repro_torch.hero.engine", "serve_engine"),
    "AdmissionFull": ("repro_torch.hero.scheduler", "AdmissionFull"),
    "RequestExpired": ("repro_torch.hero.scheduler", "RequestExpired"),
    "ArtifactLoadError": ("repro_torch.hero.scheduler", "ArtifactLoadError"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        value = getattr(importlib.import_module(module), attr)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'repro_torch.hero' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
