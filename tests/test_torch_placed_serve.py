"""Prefill and decode placed over a mesh of ranks against the one-process
serve and the reference's GSPMD steps.

One spawn of four gloo ranks on the CPU (one thread each, rendezvous
through a `FileStore` under the test's temporary directory) serves each
case on the meshes (2, 2), (1, 4) and (4, 1) over ("data", "model"):
`launch.steps.make_prefill_step(cfg, MAX_SEQ, mesh)` over a PROMPT-token
prompt of BATCH sequences, then STEPS greedy `make_decode_step` calls,
from the seed-0 weights (float32 smoke configs) placed by their pruned
specs. The cases: qwen2-7b (on (1, 4) its 2 KV heads replicated over 4
`model` ranks), qwen3-moe (MoE: experts over `model`, the routing the
whole batch's), jamba (Mamba by its channels, attention, MoE), xlstm
(mLSTM and sLSTM by their heads) and whisper (the cross cache, whole in
its positions); xlstm with 2 heads on (1, 4) (its cells compute whole,
their states whole on every `model` rank); qwen2-7b with a batch of 2 on
(4, 1) (the batch does not divide the data axis: whole on every rank,
the cache's batch axis dropped). With MAX_SEQ 32 the decode positions
13..20 cross a block boundary on two `model` ranks, and on four the last
rank's block of positions stays empty throughout.

Against the one-process `lm.prefill` / `lm.decode_step` from the same
weights and prompts: the placed logits within REL of the largest, the
gathered caches within REL of each leaf's largest, the greedy tokens
equal, and each rank's cache blocks shaped as the pruned cache specs
(`launch.steps.serve_pspecs`) say. A fifth process runs the reference's
own `make_prefill_step` / `make_decode_step`, jitted with the shardings
of its dry-run's cells (`src/repro/launch/dryrun.py:177-229`), on four
forced host devices over (2, 2) and (1, 4), from the port's weights in
the reference's layout: the placed logits and tokens equal it at the
same limits. The ranks also record the dry-run's decode cell of two
smoke configs on (2, 2) (`launch.dryrun.build_cell` on the real mesh),
and `run_cell` on a fake (2, 2) mesh counts the same.

Run as a script, this file is one rank of the spawn,
`python tests/test_torch_placed_serve.py <rank> <store file> <out dir>`,
or the reference's runs, `python tests/test_torch_placed_serve.py
reference <out dir>`.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
AXES = ("data", "model")
MESHES = ((2, 2), (1, 4), (4, 1))
REF_MESHES = ((2, 2), (1, 4))
ARCHS = ("qwen2-7b", "qwen3-moe-235b-a22b", "jamba-v0.1-52b", "xlstm-350m",
         "whisper-large-v3")
# (name, arch, mesh, heads (n_heads, n_kv_heads) or None, batch)
EXTRA = (("xlstm-whole", "xlstm-350m", (1, 4), (2, 2), 4),
         ("qwen2-7b-b2", "qwen2-7b", (4, 1), None, 2))
BATCH, PROMPT, STEPS, MAX_SEQ = 4, 13, 8, 32
REL = 1e-5
# The dry-run's decode cells recorded on the ranks at (2, 2): smoke
# configs, DRY_BATCH sequences, a cache of DRY_SEQ positions
DRY = ("qwen2-7b", "jamba-v0.1-52b")
DRY_SEQ, DRY_BATCH = 32, 4


def cases():
    """(key, arch, mesh, heads, batch) of every placed serve."""
    out = [(f"{m[0]}x{m[1]}/{a}", a, m, None, BATCH)
           for m in MESHES for a in ARCHS]
    return out + [(f"{m[0]}x{m[1]}/{n}", a, m, h, b)
                  for n, a, m, h, b in EXTRA]


def smoke(arch: str, heads=None):
    from repro_torch.configs import get_arch

    cfg = get_arch(arch).smoke
    if heads is not None:
        cfg = dataclasses.replace(cfg, n_heads=heads[0], n_kv_heads=heads[1])
    return cfg


def init(arch: str, heads=None):
    """The smoke config and its seed-0 weights on the CPU."""
    from repro_torch.models import lm

    cfg = smoke(arch, heads)
    return cfg, lm.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")


def prompt(cfg, batch: int) -> dict:
    """The prompt every process serves: tokens (batch, PROMPT) and, for
    whisper, frames (batch, max_source_len, d)."""
    rng = np.random.default_rng(1)
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, PROMPT)).astype(np.int32))}
    if cfg.embed_frontend == "stub_frames":
        out["frames"] = torch.from_numpy((rng.normal(size=(
            batch, cfg.max_source_len, cfg.d_model)) * 0.02)
            .astype(np.float32))
    return out


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


def serve(prefill, decode, params, batch, full):
    """Prefill and STEPS greedy decode steps: (the logits of the prefill
    and of each step, the tokens fed, the cache after prefill, the cache
    at the end, each through `full` (whole tensors of their own); the
    cache as the steps return it)."""
    logits, cache = prefill(params, batch)
    first = full(cache)
    out, toks = [full(logits)], []
    for i in range(STEPS):
        toks.append(greedy(out[-1]))
        logits, cache = decode(params, cache, toks[-1], PROMPT + i)
        out.append(full(logits))
    return out, torch.cat(toks, dim=1), first, full(cache), cache


# ---------------------------------------------------------------------------
# One rank of the spawn
# ---------------------------------------------------------------------------
def rank_main(rank: int, store: str, out: str) -> None:
    import torch.distributed as dist

    from repro_torch.distributed.hlo_counters import Recorder, analyze
    from repro_torch.distributed.sharding import (
        NamedSharding,
        ShardingConfig,
        gather,
        named,
        param_pspecs,
        place,
    )
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.steps import (
        make_decode_step,
        make_prefill_step,
        serve_pspecs,
    )
    from repro_torch.tree_util import leaves_with_path, tree_map

    torch.set_num_threads(1)
    init_distributed("cpu", rank=rank, world_size=WORLD,
                     store=dist.FileStore(store, WORLD))
    res = {}
    for name, arch, shape, heads, batch in cases():
        mesh = make_mesh(shape, AXES, "cpu")
        cfg, params = init(arch, heads)
        p = place(params, named(mesh, param_pspecs(params, ShardingConfig(),
                                                   mesh)))
        sp = serve_pspecs(cfg, batch, MAX_SEQ, mesh)
        logits, tokens, first, last, cache = serve(
            make_prefill_step(cfg, MAX_SEQ, mesh),
            make_decode_step(cfg, mesh), p, prompt(cfg, batch),
            lambda t: tree_map(torch.clone, gather(t)))
        res[name] = {
            "logits": logits, "tokens": tokens, "first": first,
            "last": last,
            "local": {k: tuple(t.to_local().shape)
                      for k, t in leaves_with_path(cache)},
            "want": {k: NamedSharding(mesh, s).block_shape(t.shape)
                     for (k, s), (_, t) in zip(leaves_with_path(sp.cache),
                                               leaves_with_path(cache))}}

    # the dry-run's decode cells on the real ranks, recorded as
    # `launch.dryrun.trace_cell` records them on a fake mesh
    mesh = make_mesh((2, 2), AXES, "cpu")
    for arch in DRY:
        step, args, _ = dryrun.build_cell(*dry_cell(arch), mesh)
        with Recorder() as rec:
            step(*args)
        c = analyze(rec.trace)
        res["dry/" + arch] = {"flops": c.flops, "dot_flops": c.dot_flops,
                              "bytes": c.bytes, "counts": c.coll_counts,
                              "link": c.link_bytes,
                              "kernels": rec.trace.calls(
                                  "kernel.decode_attention")}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def dry_cell(arch: str):
    """(ArchSpec, ShapeSpec) of the decode cell the ranks and the fake mesh
    both run: `arch`'s smoke config, DRY_BATCH sequences, a cache of
    DRY_SEQ positions."""
    from repro_torch.configs import SHAPES, get_arch

    spec = get_arch(arch)
    return (dataclasses.replace(spec, model=spec.smoke),
            dataclasses.replace(SHAPES["decode_32k"], seq_len=DRY_SEQ,
                                global_batch=DRY_BATCH))


# ---------------------------------------------------------------------------
# The reference's GSPMD steps
# ---------------------------------------------------------------------------
def reference_main(out: str) -> None:
    """The reference's prefill and decode steps, jitted with the shardings
    of its dry-run's prefill and decode cells, over each of REF_MESHES of
    four forced host devices, for each of ARCHS from the port's seed-0
    weights in the reference's layout. Saves {key: {"logits", "tokens"}}
    as `serve` gives them."""
    os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                               f"{WORLD} " + os.environ.get("XLA_FLAGS", ""))
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from repro.configs import get_arch as j_get_arch
    from repro.distributed.sharding import (
        ShardingConfig,
        cache_pspecs,
        param_pspecs,
        prune_pspecs,
    )
    from repro.launch.mesh import make_mesh_compat
    from repro.launch.steps import make_decode_step, make_prefill_step
    from repro.models import lm as j_lm
    from repro_torch.models import lm

    assert len(jax.devices()) == WORLD, jax.devices()
    res = {}
    for shape in REF_MESHES:
        mesh = make_mesh_compat(shape, AXES)
        sh = lambda t: jax.tree_util.tree_map(
            lambda s: NamedSharding(mesh, s), t,
            is_leaf=lambda x: isinstance(x, JP))
        for arch in ARCHS:
            cfg, params = init(arch)
            model = j_get_arch(arch).smoke
            jp = jax.tree_util.tree_map(
                lambda t: jnp.asarray(t.numpy()),
                lm.to_reference_layout(params, cfg))
            scfg = ShardingConfig()
            b = "data"
            pspec = param_pspecs(jp, scfg, mesh)
            cache_sds = j_lm.cache_specs(model, BATCH, MAX_SEQ)
            cspec = prune_pspecs(cache_pspecs(cache_sds, mesh, scfg),
                                 cache_sds, mesh)
            vocab = "model" if model.vocab_size % mesh.shape["model"] == 0 \
                else None
            batch = {k: jnp.asarray(v.numpy())
                     for k, v in prompt(cfg, BATCH).items()}
            bspec = {k: JP(*((b,) + (None,) * (v.ndim - 1)))
                     for k, v in batch.items()}
            prefill = jax.jit(make_prefill_step(model, MAX_SEQ),
                              in_shardings=(sh(pspec), sh(bspec)),
                              out_shardings=(NamedSharding(
                                  mesh, JP(b, None, vocab)), sh(cspec)))
            decode = jax.jit(
                make_decode_step(model),
                in_shardings=(sh(pspec), sh(cspec),
                              NamedSharding(mesh, JP(b, None)),
                              NamedSharding(mesh, JP())),
                out_shardings=(NamedSharding(mesh, JP(b, None, vocab)),
                               sh(cspec)), donate_argnums=(1,))
            with mesh:
                p = jax.device_put(jp, sh(pspec))
                full = lambda t: torch.from_numpy(np.asarray(t).copy())
                logits, tokens, _, _, _ = serve(
                    lambda p, bt: prefill(p, bt),
                    lambda p, c, tok, pos: decode(
                        p, c, jnp.asarray(tok.numpy()),
                        jnp.asarray(pos, jnp.int32)),
                    p, batch, lambda t: jax.tree_util.tree_map(full, t)
                    if isinstance(t, dict) else full(t))
            res[f"{shape[0]}x{shape[1]}/{arch}"] = {"logits": logits,
                                                    "tokens": tokens}
    torch.save(res, os.path.join(out, "reference.pt"))


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        reference_main(sys.argv[2])
    else:
        rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
    sys.exit(0)


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as each rank has."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    """Every case served once by four ranks, and the reference's runs in a
    fifth process beside them: ({rank: results}, the reference's)."""
    tmp = tmp_path_factory.mktemp("placed_serve")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    args = [[str(r), str(tmp / "store"), str(tmp)] for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, __file__] + a, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for a in args + [["reference", str(tmp)]]]
    logs = []
    try:
        for p in procs:  # a hang guard
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log)
           in enumerate(zip(procs, logs)) if p.returncode]
    assert not bad, bad
    return ({r: torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)},
            torch.load(tmp / "reference.pt", weights_only=False))


_ONE = {}


def one_process(arch, heads, batch):
    """The one-process serve of a case (memoised)."""
    from repro_torch.models import lm
    from repro_torch.tree_util import tree_map

    key = (arch, heads, batch)
    if key not in _ONE:
        cfg, params = init(arch, heads)
        _ONE[key] = serve(
            lambda p, b: lm.prefill(p, b, cfg, MAX_SEQ),
            lambda p, c, t, pos: lm.decode_step(p, c, t, pos, cfg),
            params, prompt(cfg, batch),
            lambda t: tree_map(torch.clone, t))[:4]
    return _ONE[key]


def assert_close(got, want, what):
    """got within REL of want's largest magnitude."""
    scale = float(torch.max(torch.abs(want)))
    err = float(torch.max(torch.abs(got - want)))
    assert err <= REL * max(scale, 1e-30), (what, err, scale)


def assert_serves_alike(got, want, name):
    """(logits, tokens) of two serves: the logits of every call within
    REL of their largest, the greedy tokens equal."""
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        assert g.shape == w.shape, (name, i)
        assert_close(g, w, f"{name} logits {i}")
    assert torch.equal(got[1], want[1]), name


@pytest.mark.parametrize("case", cases(), ids=lambda c: c[0])
def test_placed_serve_equals_one_process(spawn, case):
    """Every rank's placed prefill and decode: the logits and tokens of
    the one-process serve, the cache after prefill and at the end within
    REL of each leaf's largest, gathered from every rank's blocks."""
    from repro_torch.tree_util import leaves_with_path

    name, arch, _, heads, batch = case
    logits, tokens, first, last = one_process(arch, heads, batch)
    for r in range(WORLD):
        got = spawn[0][r][name]
        assert_serves_alike((got["logits"], got["tokens"]),
                            (logits, tokens), f"{name} rank {r}")
        for which, want in (("first", first), ("last", last)):
            g = dict(leaves_with_path(got[which]))
            w = dict(leaves_with_path(want))
            assert g.keys() == w.keys()
            for k in w:
                assert_close(g[k], w[k], f"{name} rank {r} {which} {k}")


@pytest.mark.parametrize("case", cases(), ids=lambda c: c[0])
def test_each_rank_holds_its_cache_blocks(spawn, case):
    """Each rank's cache leaves are its blocks by the pruned cache specs:
    on `model` ranks the keys' and values' positions split, the Mamba and
    xLSTM states split by channels or heads where `model` divides them,
    the batch split where the data axis divides it."""
    name, arch, shape, heads, batch = case
    for r in range(WORLD):
        got = spawn[0][r][name]
        assert got["local"] == got["want"], (name, r)
    cfg = smoke(arch, heads)
    tp, dp = shape[1], shape[0]
    b = batch // dp if batch % dp == 0 else batch
    local = spawn[0][0][name]["local"]
    for path, s in local.items():
        leaf = path.rsplit("/", 1)[-1]
        assert s[1] == b, (path, s)
        if leaf in ("k", "v"):
            assert s[2] == MAX_SEQ // tp, (path, s)
        if leaf == "C":
            assert s[2] == (cfg.n_heads // tp if cfg.n_heads % tp == 0
                            else cfg.n_heads), (path, s)


@pytest.mark.parametrize("shape", REF_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_serve_equals_the_reference_gspmd_steps(spawn, shape, arch):
    """The placed prefill and decode against the reference's own steps,
    jitted with its dry-run cells' shardings over four host devices: the
    same logits within REL of their largest, the same greedy tokens."""
    name = f"{shape[0]}x{shape[1]}/{arch}"
    want = spawn[1][name]
    for r in range(WORLD):
        got = spawn[0][r][name]
        assert_serves_alike((got["logits"], got["tokens"]),
                            (want["logits"], want["tokens"]),
                            f"{name} rank {r}")


@pytest.mark.parametrize("arch", DRY)
def test_the_fake_mesh_counts_what_the_ranks_serve(spawn, arch, tmp_path):
    """`launch.dryrun.run_cell` of a decode cell at (2, 2), rank 0 of a
    fake process group on tensors without data, counts the FLOPs,
    device-memory bytes, collectives and link bytes that the recorder
    counts on the real gloo ranks running the same cell, kernel 7 once a
    layer that attends."""
    from repro_torch.launch import dryrun
    from repro_torch.models import lm

    spec, shape = dry_cell(arch)
    r = dryrun.run_cell(spec, shape, False, tmp_path, mesh=((2, 2), AXES))
    got = spawn[0][0]["dry/" + arch]
    assert r["flops_per_device"] == got["flops"]
    assert r["dot_flops_per_device"] == got["dot_flops"]
    assert r["bytes_per_device"] == got["bytes"]
    assert r["collectives"]["counts"] == got["counts"]
    assert r["collectives"]["per_device_link_bytes"] == got["link"]
    cfg = spec.model
    attn = sum(lm._layer_kind(cfg, l) in ("attn", "dec")
               for l in range(cfg.n_layers))
    assert r["kernels"] == {"decode_attention": float(attn)} \
        and got["kernels"] == attn
