"""The port stands alone: no module of `repro_torch`, nor `chip_smoke.py`,
imports JAX or the JAX package, and entry points asked for the default
device (the card) raise without one instead of carrying on on the CPU.
Its packages re-export what the reference's do, but for the recorded
divergences (ROADMAP section 3)."""
import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_BLOCKED_IMPORTS = r"""
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None  # `import jax` now raises ImportError
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m, mod in sys.modules.items() if mod is not None
       and (m in ("jax", "repro") or m.startswith(("jax.", "repro.")))]
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORTS, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25  # every module was imported


def test_no_source_line_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_entry_points_raise_without_a_card(no_card, tmp_path):
    from repro_torch.configs.ngp import cpu_scale
    from repro_torch.convert import params_from_numpy
    from repro_torch.hero.artifact import QuantArtifact
    from repro_torch.hero.engine import ServeEngine
    from repro_torch.hero.service import RenderService, serve
    from repro_torch.nerf.fast_render import FastRenderEngine
    from repro_torch.nerf.ngp import init_ngp, no_quant_spec, uniform_quant_spec
    from repro_torch.nerf.render import RenderConfig

    cfg = cpu_scale()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_ngp(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        no_quant_spec(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        uniform_quant_spec(cfg, 8)
    params = init_ngp(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FastRenderEngine(params, cfg, RenderConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"a": {"b": np.zeros(2)}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QuantArtifact.load(tmp_path)  # before reading anything
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RenderService(object())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(object())
    # Asking for the CPU works.
    FastRenderEngine(params, cfg, RenderConfig(), device="cpu")
    assert no_quant_spec(cfg, "cpu").hash_bits.device.type == "cpu"
    assert uniform_quant_spec(cfg, 8, device="cpu").act_bits.device.type \
        == "cpu"


def test_search_entry_points_raise_without_a_card(no_card):
    """The simulator, the targets, the envs, the agent and both searches
    run on the card by default and raise without one, before any work."""
    from types import SimpleNamespace

    from repro_torch.configs.ngp import cpu_scale
    from repro_torch.core import (
        BatchedQuantEnv,
        DDPGAgent,
        NGPQuantEnv,
        hero_population_search,
        hero_search,
    )
    from repro_torch.hero.targets import (
        NeuRexTarget,
        RooflineTarget,
        make_target,
    )
    from repro_torch.hwsim import (
        BatchedNeuRexSimulator,
        NeuRexSimulator,
        build_trace,
    )
    from repro_torch.nerf.render import RenderConfig

    cfg, rcfg = cpu_scale(), RenderConfig(n_samples=4)
    rays = np.zeros((2, 3), np.float32)
    calls = [
        lambda: build_trace(cfg, rcfg, rays, rays),
        lambda: BatchedNeuRexSimulator(object()),
        lambda: NeuRexSimulator(),
        lambda: NeuRexTarget(),
        lambda: RooflineTarget(),
        lambda: make_target("neurex-edge"),
        lambda: NGPQuantEnv({}, None, cfg, rcfg, None),
        lambda: BatchedQuantEnv(object()),
        lambda: DDPGAgent(),
        lambda: hero_search(object()),
        lambda: hero_population_search(SimpleNamespace(env=object())),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # Asking for the CPU works; the numpy oracle needs no device.
    assert NeuRexSimulator(backend="numpy").device is None
    trace = make_target("neurex", device="cpu").build_workload(
        cfg, rcfg, rays, rays)
    BatchedNeuRexSimulator(trace, device="cpu").baseline_batch()
    DDPGAgent(device="cpu")


def test_training_entry_points_raise_without_a_card(no_card):
    from repro_torch.configs.ngp import cpu_scale
    from repro_torch.nerf.dataset import make_dataset
    from repro_torch.nerf.ngp import init_ngp, no_quant_spec
    from repro_torch.nerf.render import RenderConfig
    from repro_torch.nerf.scenes import SceneConfig
    from repro_torch.nerf.train import (
        TrainConfig,
        evaluate_psnr,
        finetune_ngp,
        train_ngp,
    )

    cfg, rcfg = cpu_scale(), RenderConfig(n_samples=4)
    scene = SceneConfig(image_hw=4, n_train_views=1, n_test_views=1)
    tcfg = TrainConfig(steps=1, batch_rays=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_dataset(scene)
    ds = make_dataset(scene, device="cpu")
    params = init_ngp(torch.Generator().manual_seed(0), cfg, device="cpu")
    spec = no_quant_spec(cfg, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ngp(ds, cfg, rcfg, tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        finetune_ngp(params, ds, cfg, rcfg, tcfg, spec, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_psnr(params, ds, cfg, rcfg)
    # Asking for the CPU works.
    trained, loss = train_ngp(ds, cfg, rcfg, tcfg, device="cpu")
    finetune_ngp(trained, ds, cfg, rcfg, tcfg, spec, 1, device="cpu")
    assert np.isfinite(loss)
    assert np.isfinite(evaluate_psnr(trained, ds, cfg, rcfg, device="cpu"))


def test_pipeline_entry_points_raise_without_a_card(no_card, tmp_path,
                                                   monkeypatch):
    """The closed loop, the facade and both CLIs run on the card by
    default and raise without one, before training anything."""
    import repro_torch.hero as hero
    from repro_torch.core.closed_loop import (
        ClosedLoopConfig,
        HeroSearchRun,
        build_scene_bundle,
        build_scene_env,
    )
    from repro_torch.hero import cli
    from repro_torch.workloads import get_workload

    monkeypatch.chdir(tmp_path)
    calls = [
        lambda: build_scene_env("chair"),
        lambda: build_scene_bundle("chair"),
        lambda: get_workload("nerf").build_bundle("chair"),
        lambda: HeroSearchRun(ClosedLoopConfig(verbose=False)).run(),
        lambda: hero.search(verbose=False),
        lambda: hero.compile_scene("chair"),
        lambda: cli.main(["search", "--quick"]),
        lambda: cli.main(["serve", "--quick"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not list(tmp_path.iterdir())  # nothing was written
    # Asking for the CPU works (no work: every cell resumed or none).
    run = HeroSearchRun(ClosedLoopConfig(scenes=(), verbose=False),
                        device="cpu").run()
    assert run.cells == [] and run.device == "cpu"


def test_distributed_entry_points_raise_without_a_card(no_card):
    """The orchestrated sweep, a subprocess worker, the population split
    and its device list run on the card by default and raise without
    one, before any work; given "cpu" they run there."""
    from repro_torch.core import BatchedQuantEnv
    from repro_torch.core.closed_loop import ClosedLoopConfig, HeroSearchRun
    from repro_torch.distributed import (
        auto_shard,
        population_devices,
        shard_population,
    )
    from repro_torch.distributed.orchestrator import (
        SubprocessWorker,
        run_orchestrated,
    )

    cfg = ClosedLoopConfig(scenes=(), verbose=False)
    calls = [
        lambda: run_orchestrated(HeroSearchRun(cfg), workers=2),
        lambda: SubprocessWorker(lambda spec: {}),
        lambda: BatchedQuantEnv(object(), sharded=True),
        lambda: population_devices(),
        lambda: shard_population(lambda x: x),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert auto_shard() is False
    # Asking for the CPU works.
    res = run_orchestrated(HeroSearchRun(cfg, device="cpu"), workers=2)
    assert res.cells == [] and res.device == "cpu"
    assert SubprocessWorker(lambda spec: {}, device="cpu").card is None
    assert population_devices(kind="cpu") == [torch.device("cpu")]
    twice = shard_population(lambda x: 2 * x, [torch.device("cpu")])
    np.testing.assert_array_equal(twice(np.arange(3)), [0, 2, 4])


def test_lm_entry_points_raise_without_a_card(no_card):
    from repro_torch.configs import get_arch
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = get_arch("qwen2-7b").smoke
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_params_from_numpy({"embed": np.zeros((2, 2), np.float32),
                              "blocks": {}})
    # Asking for the CPU works.
    lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def test_ops_dispatch_by_device_and_refuse_others():
    from repro_torch.kernels import ops

    idx = torch.tensor([0, 2, -1], dtype=torch.int32)
    table = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    np.testing.assert_array_equal(ops.hash_gather(idx, table).numpy(),
                                  [[0, 1], [4, 5], [0, 0]])
    with pytest.raises(ValueError, match="unsupported device"):
        ops.hash_gather(idx.to("meta"), table.to("meta"))


def test_runner_fingerprint_names_the_device(no_card):
    from repro_torch.kernels.backend import runner_fingerprint

    fp = runner_fingerprint()
    assert fp["device_kind"] == "cpu" and fp["device_count"] == 0
    assert fp["kernel_backend"] == "plain-cpu"
    assert fp["torch_version"] == torch.__version__


def test_lm_workload_entry_points_raise_without_a_card(no_card):
    """The LM search's entry points (the roofline target, the env, the
    workload's bundle, the spec helpers and the search CLI) run on the
    card by default and raise without one, before any forward pass."""
    from repro_torch.configs import get_arch
    from repro_torch.hero import cli
    from repro_torch.hero.targets import LMRooflineTarget, make_target
    from repro_torch.models.lm import no_lm_quant
    from repro_torch.workloads import get_workload
    from repro_torch.workloads.lm import LMQuantEnv

    cfg = get_arch("qwen2-7b").smoke
    calls = [
        lambda: LMRooflineTarget(),
        lambda: make_target("roofline-lm"),
        lambda: LMQuantEnv("qwen2-7b"),
        lambda: get_workload("lm").build_bundle("qwen2-7b"),
        lambda: no_lm_quant(cfg),
        lambda: cli.main(["search", "--workload", "lm", "--checkpoint", ""]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert no_lm_quant(cfg, "cpu").w_bits.device.type == "cpu"
    assert make_target("roofline-lm", device="cpu").device.type == "cpu"


_EXAMPLE_IMPORTS = r"""
import importlib.util, pathlib, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
for path in sorted(pathlib.Path(sys.argv[1]).glob("*.py")):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m, mod in sys.modules.items() if mod is not None
       and (m in ("jax", "repro") or m.startswith(("jax.", "repro.")))]
assert not bad, bad
print(len(list(pathlib.Path(sys.argv[1]).glob("*.py"))))
"""


def test_ported_examples_import_only_the_port():
    examples = ROOT / "examples" / "torch"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _EXAMPLE_IMPORTS,
                          str(examples)], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == 5  # distributed_train among them
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
    hits = [f"{f}:{i}" for f in sorted(examples.glob("*.py"))
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits


# Reference package names the port's package does not re-export, each for
# a recorded reason: the counterpart has another name, or it belongs to
# ROADMAP item 10 (the reference's abstract shape trees and HLO analysis).
_NOT_MIRRORED = {
    "hwsim": {"mlp_cycles_jnp": "mlp_cycles_torch"},
    "distributed": {"population_mesh": "population_devices",
                    **dict.fromkeys(("ChipSpec", "CollectiveStats",
                                     "RooflineTerms", "parse_collectives",
                                     "op_census", "roofline_terms"))},
    "models": dict.fromkeys(("param_specs", "cache_specs")),
}


@pytest.mark.parametrize("package", ["nerf", "quant", "models", "kernels",
                                     "distributed", "hwsim"])
def test_port_packages_reexport_the_reference_names(package):
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    skip = _NOT_MIRRORED.get(package, {})
    want = [n for n in ref.__all__ if n not in skip]
    assert [n for n in want if not hasattr(port, n)] == []
    assert set(want) <= set(port.__all__)
    for name, counterpart in skip.items():
        assert not hasattr(port, name)
        if counterpart is not None:
            assert counterpart in port.__all__ and hasattr(port, counterpart)
    from repro_torch.distributed import param_pspecs  # noqa: F401
    from repro_torch.nerf import train_ngp  # noqa: F401
