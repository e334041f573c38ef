"""The `repro_torch.hero` facade, `compile_artifact` and the two CLIs,
against the JAX package's `repro.hero` at `SceneScale.tiny()`, on the
reference's trained chair env (its params, dataset and activation ranges
carried into the port's env: the port's own calibration is within one
ulp, `tests/test_torch_search.py`):

- `compile_artifact` without finetuning writes the reference's directory:
  the same `arrays.npz` and manifest, but for `hardware` (the port's
  target records its device where the reference's records its TPU
  autotune key, ROADMAP §3) and the recorded PSNR (within 1e-3 dB: no
  float carrier, ROADMAP §3); with 2 finetune steps (unstratified, so the
  two packages' jitter draws do not enter) PSNR within 1e-3 dB,
  `latency_cycles` within 1e-6 relative, the rest exact;
- `model_bytes` is one number from the simulator to the bytes on disk;
- the compiled artifact serves through `hero.serve` as the in-process
  fused engine renders it;
- the lazy facade and `best_bits`; the CLIs on the CPU with
  `SceneScale.quick` patched to `tiny`.
"""
import copy
import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core.closed_loop as jcl
import repro.hero as jhero
import repro_torch.core.closed_loop as tcl
import repro_torch.hero as hero
from repro_torch.convert import dataset_from_numpy, params_from_numpy
from repro_torch.hero import cli

TINY = tcl.SceneScale.tiny()
PSNR_ATOL_DB = 1e-3
REL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny shapes gain nothing from more, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def envs():
    """(the reference's tiny chair env, the port's on the same trained
    params, dataset and activation ranges)."""
    import jax

    je = jcl.build_scene_env("chair", jcl.SceneScale.tiny(), seed=0)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, je.params),
                           device="cpu")
    te = tcl.scene_env(tp, dataset_from_numpy(je.dataset), TINY, seed=0,
                       device="cpu")
    te.act_ranges = torch.from_numpy(np.array(je.act_ranges))
    return je, te


def _bits(env):
    return np.random.RandomState(3).randint(4, 9, size=env.n_units).tolist()


def _unstratified(env):
    out = copy.copy(env)
    out.rcfg = dataclasses.replace(env.rcfg, stratified=False)
    return out


# ---------------------------------------------------------------------------
# compile_artifact against the reference
# ---------------------------------------------------------------------------
def test_compile_without_finetune_writes_the_reference_directory(envs,
                                                                 tmp_path):
    je, te = envs
    jpath = jhero.compile(je, _bits(je), finetune_steps=0).save(tmp_path / "j")
    tpath = hero.compile(te, _bits(te), finetune_steps=0).save(tmp_path / "t")
    with np.load(jpath / "arrays.npz") as jz, np.load(tpath / "arrays.npz") as tz:
        assert sorted(tz.files) == sorted(jz.files)
        for k in jz.files:
            assert tz[k].dtype == jz[k].dtype, k
            np.testing.assert_array_equal(tz[k], jz[k], err_msg=k)
    jm = json.loads((jpath / "manifest.json").read_text())
    tm = json.loads((tpath / "manifest.json").read_text())
    jhw, thw = jm.pop("hardware"), tm.pop("hardware")
    # The compile's PSNR: the integer path against the reference's float
    # carrier on the CPU (ROADMAP §3), 3.3e-7 dB here.
    jpsnr, tpsnr = jm["metrics"].pop("psnr"), tm["metrics"].pop("psnr")
    assert tpsnr == pytest.approx(jpsnr, abs=PSNR_ATOL_DB)
    assert tm == jm
    assert thw.pop("device") == "cpu"
    jhw.pop("kernel_autotune")
    assert thw == jhw
    assert tm["metrics"]["finetune_steps"] == 0


def test_compile_with_finetune_within_bands(envs):
    je, te = (_unstratified(e) for e in envs)
    want = jhero.compile(je, _bits(je), finetune_steps=2).metrics
    got = hero.compile(te, _bits(te), finetune_steps=2).metrics
    assert got["psnr"] == pytest.approx(want["psnr"], abs=PSNR_ATOL_DB)
    assert got["latency_cycles"] == pytest.approx(want["latency_cycles"],
                                                  rel=REL)
    for k in ("model_bytes", "fqr", "finetune_steps"):
        assert got[k] == want[k], k
    assert got["finetune_steps"] == 2


def test_compile_bits_none_is_uniform_8(envs):
    _, te = envs
    art = hero.compile(te, None, finetune_steps=0)
    assert art.bits == [8] * te.n_units
    assert art.metrics == hero.compile(te, [8] * te.n_units,
                                       finetune_steps=0).metrics
    assert art.metrics["fqr"] == 8.0
    # The env's own finetune depth by default.
    assert hero.compile(te, None).metrics["finetune_steps"] \
        == te.ecfg.finetune_steps


def test_compile_bakes_occupancy_for_a_reference_env(envs):
    """An env scoring in reference mode has no grid: the compile bakes
    one through the registry, the same grid the fused env holds."""
    _, te = envs
    ref_env = copy.copy(te)
    ref_env.occ = None
    ref_env.ecfg = dataclasses.replace(te.ecfg, render_backend="reference")
    art = hero.compile(ref_env, _bits(te), finetune_steps=0)
    assert art.occ is te.occ
    fused = hero.compile(te, _bits(te), finetune_steps=0)
    assert art.metrics["psnr"] == pytest.approx(fused.metrics["psnr"],
                                                abs=PSNR_ATOL_DB)


def test_model_bytes_exact_from_search_to_disk(envs, tmp_path):
    """For a 4-bit-MLP / 6-bit-hash policy the simulator's model_bytes,
    the batched evaluator's, the compiled artifact's metric, the pack's
    payload and the bytes in arrays.npz are one number."""
    from repro_torch.core.batched_env import BatchedQuantEnv
    from repro_torch.hero.artifact import _SEP
    from repro_torch.quant.packing import PackedTensor
    from repro_torch.quant.policy import QuantPolicy

    _, te = envs
    bits = [6 if u.name.startswith("hash/") else 4 for u in te.units]
    art = hero.compile(te, bits, finetune_steps=0)
    lat = te.simulate_policy(QuantPolicy.uniform(te.units, 8).with_bits(bits))
    assert art.metrics["model_bytes"] == lat.model_bytes
    assert art.metrics["model_bytes"] == art.stored_model_bytes()
    sim = BatchedQuantEnv(te, device="cpu").simulate_batch(
        np.asarray([bits], np.int32))
    assert float(sim["model_bytes"][0]) == art.metrics["model_bytes"]

    path = art.save(tmp_path / "art")
    disk = 0
    with np.load(path / "arrays.npz") as z:
        for k in z.files:
            parts = k.split(_SEP)
            if parts[-2:] == ["pt", "words"]:
                disk += z[k].nbytes
            elif parts[0] == "pack" and parts[-1] == "w":
                disk += z[k].nbytes
            elif parts[0] == "packtab" and "pt" not in parts:
                disk += z[k].nbytes
    assert disk == art.stored_model_bytes()
    int8_store = sum(
        int(np.prod(v.shape)) for lyr in art.pack.layers.values()
        for v in lyr.values() if isinstance(v, PackedTensor)
    ) + sum(int(np.prod(t.shape)) for t in art.pack.hash_tables.values()
            if isinstance(t, PackedTensor))
    assert disk < 0.8 * int8_store


def test_compiled_artifact_serves_as_the_in_process_engine(envs, tmp_path):
    """compile -> save -> load -> `hero.serve`: every test view's colours
    equal the in-process fused engine's, and the PSNR the compile
    recorded."""
    _, te = envs
    art = hero.compile(te, _bits(te), finetune_steps=0)
    ds = te.dataset
    assert art.engine().evaluate_psnr(ds) == pytest.approx(
        art.metrics["psnr"], abs=1e-9)
    loaded = hero.QuantArtifact.load(art.save(tmp_path / "art"),
                                     device="cpu")
    svc = hero.serve(loaded, hero.ServeConfig(slots=2, slot_rays=64),
                     device="cpu")
    engine = loaded.engine()
    se, px = 0.0, 0
    for v in range(ds.test_rays_o.shape[0]):
        ro, rd = ds.test_rays_o[v], ds.test_rays_d[v]
        colors = svc.render(ro, rd)
        np.testing.assert_allclose(
            colors, engine.render_frame(ro, rd).numpy(), rtol=0, atol=1e-6)
        gt = ds.test_rgb[v].reshape(-1, 3)
        se += float(((colors - gt) ** 2).sum())
        px += gt.size
    psnr = -10.0 * np.log10(max(se / px, 1e-12))
    assert round(psnr, 4) == round(art.metrics["psnr"], 4)
    engine_svc = hero.serve({"chair": loaded}, warmup=False, device="cpu")
    assert isinstance(engine_svc, hero.ServeEngine)


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------
def test_every_lazy_name_resolves_as_in_the_reference():
    assert sorted(hero.__all__) == sorted(jhero.__all__)
    for name in hero.__all__:
        assert getattr(hero, name) is not None, name
        assert name in dir(hero)
    assert hero.compile_artifact.__module__ == "repro_torch.hero.artifact"
    with pytest.raises(AttributeError, match="no attribute"):
        hero.nope


def test_best_bits_and_compile_accepts_a_bundle(envs):
    _, te = envs
    cells = [
        tcl.CellResult("chair", 1.0, 1e9, 0.5, [8] * te.n_units, 4, 1, 1.0),
        tcl.CellResult("chair", 0.85, 9e8, 0.9, [6] * te.n_units, 4, 1, 1.0),
    ]
    result = tcl.ClosedLoopResult(
        frontier=tcl.ParetoFrontier(), scene_frontiers={}, cells=cells,
        policies_evaluated=8, search_seconds=2.0, wall_seconds=3.0,
        resumed_cells=0, seconds_to_fixed_bit=None, fixed_bit_reference=6,
    )
    scene, bits = hero.best_bits(result)
    assert scene == "chair" and bits == [6] * te.n_units
    assert hero.best_bits(result, scene="chair") == (scene, bits)
    with pytest.raises(ValueError):
        hero.best_bits(result, scene="lego")
    a = hero.compile(SimpleNamespace(env=te), bits, finetune_steps=0)
    b = hero.compile(te, bits, finetune_steps=0)
    assert a.bits == b.bits and a.metrics == b.metrics


def test_search_and_compile_scene_on_the_cpu(monkeypatch):
    """`hero.search` and `hero.compile_scene` build their scene on the
    asked device: one cell at the tiny scale, then its best policy
    compiled from scratch."""
    monkeypatch.setattr(tcl.SceneScale, "quick", staticmethod(tcl.SceneScale.tiny))
    res = hero.search(("chair",), (1.0,), n_iterations=1, population=4,
                      verbose=False, device="cpu")
    assert len(res.cells) == 1 and res.device == "cpu"
    scene, bits = hero.best_bits(res)
    art = hero.compile_scene(scene, bits, finetune_steps=0, device="cpu")
    assert art.bits == bits and art.device == torch.device("cpu")
    assert np.isfinite(art.metrics["psnr"])


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------
@pytest.fixture
def tiny_quick(monkeypatch, tmp_path):
    monkeypatch.setattr(tcl.SceneScale, "quick", staticmethod(tcl.SceneScale.tiny))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_search_cli_writes_the_reference_report(tiny_quick, capsys):
    rc = cli.main(["search", "--quick", "--scenes", "chair", "--budgets",
                   "1.0,0.8", "--iterations", "1", "--population", "4",
                   "--device", "cpu"])
    assert rc == 0
    report = json.loads((tiny_quick / "BENCH_search_torch.json").read_text())
    want = jcl.bench_report(
        jcl.ClosedLoopResult(
            frontier=jcl.ParetoFrontier(), scene_frontiers={}, cells=[],
            policies_evaluated=0, search_seconds=0.0, wall_seconds=0.0,
            resumed_cells=0, seconds_to_fixed_bit=None,
            fixed_bit_reference=6),
        jcl.ClosedLoopConfig())
    assert sorted(report) == sorted(want)
    assert report["frontier_size"] > 0 and report["frontier_valid_vs_8bit"]
    assert report["scale"] == dataclasses.asdict(TINY)
    assert len(report["cells"]) == 2 and report["n_devices"] == 1
    ckpts = list((tiny_quick / "experiments").glob("*.json"))
    assert len(ckpts) == 1 and json.loads(ckpts[0].read_text())["version"] == 2
    # Run again: the default checkpoint resumes both cells.
    assert cli.main(["search", "--quick", "--scenes", "chair", "--budgets",
                     "1.0,0.8", "--iterations", "1", "--population", "4",
                     "--device", "cpu", "--out", "again.json"]) == 0
    assert "resumed 2 completed cell(s)" in capsys.readouterr().out


def test_serve_cli_compiles_saves_and_serves(tiny_quick):
    rc = cli.serve_main(["--quick", "--scene", "chair", "--bits", "6",
                         "--requests", "3", "--slots", "2", "--slot-rays",
                         "64", "--device", "cpu"])
    assert rc == 0
    report = json.loads((tiny_quick / "BENCH_serve_torch.json").read_text())
    assert report["requests"] == 3 and report["roundtrip_through_disk"]
    assert report["psnr_delta_db"] <= 1e-4
    art_dir = tiny_quick / "experiments" / "artifacts_torch" / "chair"
    assert (art_dir / "manifest.json").exists()
    # Serve the saved directory again, from disk.
    assert cli.serve_main(["--artifact", str(art_dir), "--requests", "2",
                           "--slots", "2", "--slot-rays", "64", "--device",
                           "cpu", "--out", "from_disk.json"]) == 0
    again = json.loads((tiny_quick / "from_disk.json").read_text())
    assert again["bits"] == report["bits"] == [6] * len(report["bits"])
    assert not again["roundtrip_through_disk"]
    assert again["psnr_delta_db"] <= 1e-4


def test_search_cli_orchestrated_runs_write_the_sequential_frontier(
        tiny_quick, capsys):
    """`--workers 2` (threads), `--workers 2 --worker-kind inline` and
    `--chaos 3` go through the orchestrator and each writes the frontier
    `--workers 1` writes."""
    base = ["search", "--quick", "--scenes", "chair", "--budgets", "1.0,0.8",
            "--iterations", "1", "--population", "4", "--device", "cpu",
            "--checkpoint", ""]
    reports = {}
    for name, extra in (("one", []), ("threads", ["--workers", "2"]),
                        ("inline", ["--workers", "2", "--worker-kind",
                                    "inline"]),
                        ("chaos", ["--chaos", "3"])):
        assert cli.main(base + extra + ["--out", f"{name}.json"]) == 0
        reports[name] = json.loads((tiny_quick / f"{name}.json").read_text())
    out = capsys.readouterr().out
    assert "1 device(s))" in out and "(sharded)" not in out
    one = reports.pop("one")
    for name, r in reports.items():
        assert r["frontier"] == one["frontier"], name
        assert r["frontier_hypervolume"] == one["frontier_hypervolume"]
        assert [c["best_bits"] for c in r["cells"]] \
            == [c["best_bits"] for c in one["cells"]], name
        assert r["policies_evaluated"] == one["policies_evaluated"]
        assert r["sharded"] is False and r["n_devices"] == 1
    assert not (tiny_quick / "experiments").exists()


def test_unknown_arch_exits_2_and_the_bits_parse(tiny_quick, capsys):
    assert cli.main(["search", "--workload", "lm", "--arch", "no-such-arch",
                     "--device", "cpu"]) == 2
    assert "unknown arch 'no-such-arch'" in capsys.readouterr().err
    assert cli.main([]) == 2
    assert cli._parse_bits("5", 3) == [5, 5, 5]
    assert cli._parse_bits("", 3) is None
    with pytest.raises(SystemExit):
        cli._parse_bits("1,2", 3)
