"""The port's examples (`examples/torch/*.py`) and the LM search CLI on the
CPU, each at tiny scale, as `tests/test_torch_hero_api.py` runs the CLIs:
`hero-search-torch --workload lm --arch qwen2-7b --quick --device cpu`
returns 0 and writes the reference's report schema, with the reference
CLI's defaults and flag rules; each example's `main` returns 0 and prints
its result."""
import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest
import torch

import repro.core.closed_loop as jcl
import repro_torch.core.closed_loop as tcl
from repro_torch.hero import cli

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny shapes gain nothing from more, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def in_tmp(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _example(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _empty_report(workload):
    return jcl.bench_report(
        jcl.ClosedLoopResult(
            frontier=jcl.ParetoFrontier(), scene_frontiers={}, cells=[],
            policies_evaluated=0, search_seconds=0.0, wall_seconds=0.0,
            resumed_cells=0, seconds_to_fixed_bit=None,
            fixed_bit_reference=6),
        jcl.ClosedLoopConfig(workload=workload))


def test_lm_search_cli_runs_on_the_cpu(in_tmp, capsys):
    rc = cli.main(["search", "--workload", "lm", "--arch", "qwen2-7b",
                   "--quick", "--device", "cpu"])
    assert rc == 0
    report = json.loads((in_tmp / "BENCH_search_torch.json").read_text())
    assert sorted(report) == sorted(_empty_report("lm"))
    assert (report["workload"], report["hardware"], report["scenes"]) == (
        "lm", "roofline-lm", ["qwen2-7b"])
    assert report["budget_fracs"] == [1.0, 0.85]
    assert report["n_iterations"] == 3 and report["population"] == 8
    assert report["policies_evaluated"] == 2 * 3 * 8
    assert report["frontier_size"] > 0 and report["frontier_valid_vs_8bit"]
    out = capsys.readouterr().out
    assert "workload=lm: 1 arch(s)" in out and "roofline-lm" in out
    ckpts = list((in_tmp / "experiments").glob("*.json"))
    assert len(ckpts) == 1
    state = json.loads(ckpts[0].read_text())
    assert state["config"]["workload"] == "lm"
    # The default checkpoint is keyed on the reference's fingerprint.
    cfg = tcl.ClosedLoopConfig(scenes=("qwen2-7b",),
                               scale=tcl.SceneScale.quick(), n_iterations=3,
                               hardware="roofline-lm", workload="lm")
    jcfg = jcl.ClosedLoopConfig(scenes=("qwen2-7b",),
                                scale=jcl.SceneScale.quick(), n_iterations=3,
                                hardware="roofline-lm", workload="lm")
    assert cfg.fingerprint() == jcfg.fingerprint()
    # A rerun resumes both cells from it.
    assert cli.main(["search", "--workload", "lm", "--quick", "--device",
                     "cpu"]) == 0
    again = json.loads((in_tmp / "BENCH_search_torch.json").read_text())
    assert again["frontier"] == report["frontier"]


def test_search_cli_flag_rules(in_tmp, capsys):
    with pytest.raises(SystemExit):
        cli.main(["search", "--arch", "qwen2-7b", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["search", "--workload", "lm", "--arch", "qwen2-7b",
                  "--scenes", "qwen2-7b", "--device", "cpu"])
    assert cli.main(["search", "--workload", "lm", "--scenes", "no-such",
                     "--device", "cpu"]) == 2
    assert "unknown arch" in capsys.readouterr().err


def test_quickstart_example_runs_on_the_cpu(in_tmp, capsys):
    assert _example("quickstart").main(["--device", "cpu", "--tiny"]) == 0
    out = capsys.readouterr().out
    assert "HERO best policy" in out and "vs PTQ(6b)" in out
    assert "on cpu" in out


def test_render_compare_example_runs_on_the_cpu(in_tmp, capsys):
    out_dir = in_tmp / "renders"
    assert _example("render_compare").main(
        ["--device", "cpu", "--tiny", "--out", str(out_dir)]) == 0
    names = {"ground_truth", "full_precision", "ptq_4bit", "hero_mixed"}
    assert {p.stem for p in out_dir.glob("*.ppm")} == names
    head = (out_dir / "hero_mixed.ppm").read_bytes()[:11]
    assert head == b"P6\n12 12\n25"
    assert "mixed-policy episode" in capsys.readouterr().out


def test_lm_quant_search_example_runs_on_the_cpu(in_tmp, capsys):
    assert _example("lm_quant_search").main(
        ["--device", "cpu", "--iterations", "1", "--population", "4"]) == 0
    out = capsys.readouterr().out
    assert "joint frontier:" in out and "best cell qwen2-7b@" in out
    assert not (in_tmp / "experiments").exists()  # checkpoint_path=None


def test_hero_search_example_wraps_the_search_cli(in_tmp, monkeypatch):
    mod = _example("hero_search")
    assert mod.main is cli.search_main
    monkeypatch.setattr(tcl.SceneScale, "quick",
                        staticmethod(tcl.SceneScale.tiny))
    assert mod.main(["--quick", "--scenes", "chair", "--budgets", "1.0",
                     "--iterations", "1", "--population", "4", "--device",
                     "cpu", "--checkpoint", ""]) == 0
    report = json.loads((in_tmp / "BENCH_search_torch.json").read_text())
    assert report["workload"] == "nerf"
    assert report["scale"] == dataclasses.asdict(tcl.SceneScale.tiny())
