"""The port's dry-run (`repro_torch.launch.dryrun`) and the shape trees it
reads, against the reference's.

- `lm.param_specs` and `lm.cache_specs` are trees of `meta` tensors (no
  storage) whose shapes and dtypes, in the reference's layout
  (`lm.to_reference_layout` for the parameters; the cache keeps it), are
  the reference's `jax.eval_shape` trees, for all ten archs' published
  and smoke configs;
- a step's counts over A microbatches, extrapolated from traces of one
  and two (`hlo_counters.extrapolate`), equal a traced step of A = 3
  exactly;
- `active_params` and `_model_flops` equal the reference's for every
  cell of `configs.all_cells()`: the reference's module sets `XLA_FLAGS`
  when imported, so it is read in a subprocess of its own;
- `run_cell` of qwen2-7b's smoke config on the fake (16, 16) mesh writes
  the reference's JSON keys (`trace_s` in place of `lower_s` and
  `compile_s`; XLA's `cost_analysis_raw_body_once` has no counterpart)
  and leaves no process group up, for a train cell and for prefill and
  decode cells at small shapes (kernel 6 once an attention layer in
  prefill, kernel 7 once in decode; a batch of one sequence, as
  long_500k's, whole on every rank); `main` runs an explicit small
  decode cell and exits 0.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-moe-235b-a22b", "arctic-480b", "llama3-405b", "qwen2-7b",
         "granite-34b", "nemotron-4-340b", "llava-next-mistral-7b",
         "whisper-large-v3", "jamba-v0.1-52b", "xlstm-350m")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny shapes gain nothing from more, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_group_left():
    """No test may leave a process group up: later files on this worker
    would build placed meshes."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _port_leaves(tree):
    from repro_torch.tree_util import leaves_with_path

    out = {}
    for path, t in leaves_with_path(tree):
        assert t.device.type == "meta", path
        out[path] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    return out


def _ref_leaves(tree):
    import jax

    from repro.distributed.sharding import _path_str

    return {_path_str(p): (tuple(l.shape), str(l.dtype))
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("which", ["model", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_are_the_references(arch, which):
    from repro.configs import get_arch as ref_arch
    from repro.models import lm as ref_lm
    from repro_torch.configs import get_arch
    from repro_torch.models import lm, param_specs

    assert param_specs is lm.param_specs
    cfg = getattr(get_arch(arch), which)
    got = _port_leaves(lm.to_reference_layout(lm.param_specs(cfg), cfg))
    want = _ref_leaves(ref_lm.param_specs(getattr(ref_arch(arch), which)))
    assert got == want


@pytest.mark.parametrize("which", ["model", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_are_the_references(arch, which):
    from repro.configs import get_arch as ref_arch
    from repro.models import lm as ref_lm
    from repro_torch.configs import get_arch
    from repro_torch.models import cache_specs

    cfg = getattr(get_arch(arch), which)
    got = _port_leaves(cache_specs(cfg, 2, 256))
    want = _ref_leaves(ref_lm.cache_specs(getattr(ref_arch(arch), which),
                                          2, 256))
    assert got == want


def test_the_microbatch_extrapolation_is_exact():
    from repro_torch.configs import get_arch
    from repro_torch.distributed.hlo_counters import Recorder, extrapolate
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = get_arch("qwen3-moe-235b-a22b").smoke
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    opt = adamw_init(params, "float32")
    step = make_train_step(cfg, AdamWConfig(lr=1e-4, weight_decay=0.1),
                           moment_dtype="float32")
    traces = {}
    for A in (1, 2, 3):
        batch = {"tokens": torch.zeros((A, 2, 32), dtype=torch.int32)}
        with Recorder() as rec:
            step(params, opt, batch)
        traces[A] = rec.trace
    got = extrapolate(traces[1], traces[2], 1, 2, 3).aggregate()
    assert got == traces[3].aggregate()


_REFERENCE = """
import json, sys
import numpy as np
from repro.configs import all_cells
from repro.launch.dryrun import active_params, _model_flops
out = {f"{s.arch_id}/{sh.name}": [active_params(s.model), _model_flops(s, sh)]
       for s, sh in all_cells()}
json.dump(out, sys.stdout)
"""


def test_active_params_and_model_flops_are_the_references():
    from repro_torch.configs import all_cells
    from repro_torch.launch.dryrun import _model_flops, active_params

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", XLA_FLAGS="",
               REPRO_XLA_DUMP=str(ROOT / "build" / "dryrun_test_dump"))
    out = subprocess.run([sys.executable, "-c", _REFERENCE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    want = json.loads(out.stdout)
    got = {f"{s.arch_id}/{sh.name}": [active_params(s.model),
                                      _model_flops(s, sh)]
           for s, sh in all_cells()}
    assert got == want and len(got) == len(list(all_cells()))


# The reference's per-cell JSON keys (`repro.launch.dryrun.run_cell`).
_KEYS = {"cell", "arch", "shape", "mesh", "n_devices", "ok",
         "memory_analysis", "param_bytes_global", "param_bytes_per_device",
         "dot_flops_per_device", "collectives", "roofline"}
_MEMORY = {"argument_size_in_bytes", "output_size_in_bytes",
           "temp_size_in_bytes", "alias_size_in_bytes"}
_ROOFLINE = {"compute_s", "memory_s", "collective_s", "hlo_flops",
             "hlo_bytes", "collective_bytes", "model_flops", "dominant",
             "useful_flops_fraction", "roofline_fraction"}


def test_run_cell_writes_the_references_keys(tmp_path):
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.launch import dryrun

    spec = get_arch("qwen2-7b")
    spec = dataclasses.replace(spec, model=spec.smoke)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64,
                                global_batch=128)
    r = dryrun.run_cell(spec, shape, False, tmp_path)
    written = json.loads(
        (tmp_path / "qwen2-7b__train_4k__16_16.json").read_text())
    assert written == json.loads(json.dumps(r))
    assert _KEYS | {"trace_s"} <= set(r)
    assert not {"lower_s", "compile_s", "cost_analysis_raw_body_once"} \
        & set(r)
    assert _MEMORY <= set(r["memory_analysis"])
    assert _ROOFLINE <= set(r["roofline"])
    assert set(r["collectives"]) == {"counts", "bytes_by_kind",
                                     "per_device_link_bytes"}
    assert (r["mesh"], r["n_devices"], r["ok"]) == ("16x16", 256, True)
    # two microbatches of 64 sequences (4 at this rank): each layer's
    # kernel 6 twice a microbatch (remat), its backward once
    assert r["kernels"] == {"flash_attention": 8.0,
                            "flash_attention_bwd": 4.0}
    # Megatron-SP over 16 model ranks: the sequence gathered and scattered
    assert r["collectives"]["counts"]["all-gather"] > 0
    assert r["collectives"]["counts"]["reduce-scatter"] > 0
    assert r["memory_analysis"]["peak_size_in_bytes"] > \
        r["memory_analysis"]["argument_size_in_bytes"] > 0


def _small(arch: str, shape: str, seq: int = 64, batch: int = 32):
    """(arch's smoke config as its ArchSpec, `shape` cut to `seq`
    positions and `batch` sequences)."""
    from repro_torch.configs import SHAPES, get_arch

    spec = get_arch(arch)
    return (dataclasses.replace(spec, model=spec.smoke),
            dataclasses.replace(SHAPES[shape], seq_len=seq,
                                global_batch=batch))


def _attention_layers(cfg) -> int:
    from repro_torch.models import lm

    return sum(lm._layer_kind(cfg, l) in ("attn", "dec")
               for l in range(cfg.n_layers))


@pytest.mark.parametrize("cell", [("qwen2-7b", "prefill_32k", 32),
                                  ("qwen2-7b", "decode_32k", 128),
                                  ("jamba-v0.1-52b", "prefill_32k", 32),
                                  ("jamba-v0.1-52b", "long_500k", 1),
                                  ("xlstm-350m", "long_500k", 1)],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_run_cell_writes_the_references_keys_for_serve_cells(cell,
                                                             tmp_path):
    """A prefill or decode cell at a small shape on the fake (16, 16)
    mesh: the reference's keys; one call of the step (kernel 6 once an
    attention layer in prefill, kernel 7 once in decode, over this
    rank's block of the cache's positions); a decode cell's cache
    updated in place (`alias_size_in_bytes`) and merged over `model`
    (all-reduces); a batch the data axis does not divide whole on every
    rank."""
    from repro_torch.launch import dryrun

    arch, name, batch = cell
    spec, shape = _small(arch, name, batch=batch)
    r = dryrun.run_cell(spec, shape, False, tmp_path)
    written = json.loads((tmp_path / f"{arch}__{name}__16_16.json")
                         .read_text())
    assert written == json.loads(json.dumps(r))
    assert _KEYS | {"trace_s"} <= set(r)
    assert _MEMORY <= set(r["memory_analysis"])
    assert _ROOFLINE <= set(r["roofline"])
    assert (r["mesh"], r["n_devices"], r["ok"]) == ("16x16", 256, True)
    n = _attention_layers(spec.model)
    mem = r["memory_analysis"]
    if shape.kind == "prefill":
        assert r["kernels"] == {"flash_attention": float(n)}
        assert mem["alias_size_in_bytes"] == 0
    else:
        assert r["kernels"] == ({"decode_attention": float(n)} if n else {})
        assert 0 < mem["alias_size_in_bytes"] < mem["argument_size_in_bytes"]
        assert r["collectives"]["counts"]["all-reduce"] > 0
    assert mem["peak_size_in_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0


def test_a_decode_cell_reads_its_block_of_the_cache(tmp_path):
    """Flash decoding in the dry-run: kernel 7's bytes at (16, 16) are
    those of one sixteenth of the cache's positions (its block, full at
    pos = seq_len - 1) of this rank's eighth of the batch, in the partial
    form (f32 output and log-sum-exp)."""
    from repro_torch.kernels import cost
    from repro_torch.launch import dryrun

    spec, shape = _small("qwen2-7b", "decode_32k", seq=256, batch=128)
    trace, _ = dryrun.trace_cell(spec, shape, (16, 16), ("data", "model"))
    cfg = spec.model
    c = cost.decode_attention(128 // 16, cfg.n_kv_heads,
                              cfg.n_heads // cfg.n_kv_heads, cfg.head_dim,
                              256 // 16, 4, lse=True)
    got = [r for r in trace.records if r.op == "kernel.decode_attention"]
    assert sum(r.calls for r in got) == _attention_layers(cfg)
    assert sum(r.out_bytes for r in got) == c.bytes * _attention_layers(cfg)


def test_main_runs_an_explicit_small_decode_cell(capsys, tmp_path,
                                                 monkeypatch):
    """`--shape decode_32k` asked for by name runs (at a small shape here)
    and exits 0 with its JSON written."""
    from repro_torch.launch import dryrun

    spec, shape = _small("qwen2-7b", "decode_32k", batch=128)
    monkeypatch.setitem(dryrun.SHAPES, "decode_32k", shape)
    monkeypatch.setattr(dryrun, "get_arch", lambda _: spec)
    dryrun.main(["--arch", "qwen2-7b", "--shape", "decode_32k", "--mesh",
                 "single", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "OK   qwen2-7b x decode_32k x 1pod" in out
    assert "dry-run: 1 ok, 0 skipped (recorded), 0 failed" in out
    assert (tmp_path / "qwen2-7b__decode_32k__16_16.json").exists()


def test_a_fake_mesh_refuses_a_second_group():
    from repro_torch.launch.mesh import fake_mesh

    with fake_mesh((2, 2), ("data", "model")) as mesh:
        assert mesh.placed and mesh.coords == (0, 0)
        with pytest.raises(RuntimeError):
            with fake_mesh((2, 2), ("data", "model")):
                pass
