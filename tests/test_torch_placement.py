"""Training placed over a mesh of ranks against the one-process step.

One spawn of four gloo ranks on the CPU (one thread each, rendezvous
through a `FileStore` under the test's temporary directory) runs every
scenario, on the meshes (4, 1), (2, 2) and (1, 4) over ("data",
"model"): two steps of two microbatches of qwen2-7b's smoke config with
float32 and with int8 moments and of llama3-405b's (int8 moments), from
the seed-0 weights placed by their pruned specs; qwen3-moe's smoke config
(float32), which runs where the batch is not split and raises naming
ROADMAP item 9c where it is; and a checkpoint written on (2, 2) after two
steps, then two more steps there (the uninterrupted run), the same
checkpoint restored on (4, 1) and trained two steps, and restored by
`restore_checkpoint` onto (4, 1)'s blocks directly.

Against the one-process step (`make_train_step` without a mesh) from the
same weights and batches: loss and grad norm within 1e-5 relative (equal
on every rank), both moments within 1e-5 of each leaf's largest entry
(int8: codes within one code step, scales within 1e-5), parameters within
1e-5 where the gradient exceeds 100 eps and within 2 lr elsewhere (AdamW
divides the rounding of a near-zero gradient by eps), as
`tests/test_torch_train_lm.py` holds them. Each rank's parameters,
moments and gradient accumulator are its block of the spec pruned for
its mesh. The checkpoint resumes on (4, 1) and in one process with the
next two steps within 1e-5 of the uninterrupted run, and the reference's
`repro.checkpoint.restore_checkpoint` reads it. The launcher trains over
two ranks under torchrun as it does alone.

Against the reference: a fifth process beside the ranks runs the
reference's own train step (`repro.launch.steps.make_train_step` with
`grad_pspecs`, jitted with `train_shardings`: GSPMD) over the meshes
(2, 2) and (4, 1) of four forced host devices, from the port's seed-0
weights in the reference's layout and the same batches. The placed steps
of the three cases equal it at the limits above, the parameters held
within 1e-5 where the reference's gradient exceeds 100 eps at both steps
and its int8 codes agree with the port's after the first. qwen2-7b's
smoke config with bfloat16 parameters runs placed on both meshes too:
every gradient the ranks reduce is bfloat16, and the step is the
reference's within bfloat16's rounding (the limits are in
`test_placed_bf16_step_against_the_reference_gspmd_step`).

Run as a script, this file is one rank of the spawn,
`python tests/test_torch_placement.py <rank> <store file> <out dir>`, or
the reference's runs, `python tests/test_torch_placement.py reference
<out dir>`.
"""
import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
MESHES = ((4, 1), (2, 2), (1, 4))
AXES = ("data", "model")
CASES = (("qwen2-7b", "float32"), ("qwen2-7b", "int8"),
         ("llama3-405b", "int8"))
MOE = ("qwen3-moe-235b-a22b", "float32")
CKPT_MESH, RESUME_MESH = (2, 2), (4, 1)
# The reference's GSPMD step runs CASES and BF16 (qwen2-7b's smoke config
# with bfloat16 parameters, f32 moments) on these meshes of four forced
# host devices; the ranks run BF16 on them too.
REF_MESHES = ((2, 2), (4, 1))
BF16 = ("qwen2-7b", "float32")
BF16_EPS = 2.0 ** -7  # bfloat16's spacing at 1 (8 significand bits)
STEPS, ACCUM, MB, SEQ = 2, 2, 4, 32
LR = 3e-4  # the launcher's default, weight decay 0.1
REL = 1e-5
EPS = 1e-8  # AdamWConfig().eps


def key(shape, arch, md) -> str:
    return f"{shape[0]}x{shape[1]}/{arch}/{md}"


def batches(cfg, n: int, seed: int = 0):
    """n (A, MB, SEQ) token stacks, the same in every process."""
    rng = np.random.default_rng(seed)
    return [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (ACCUM, MB, SEQ)).astype(np.int32))}
        for _ in range(n)]


def smoke(arch: str, dtype: str = "float32"):
    """The smoke config, its parameters in `dtype`."""
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(arch).smoke, dtype=dtype)


def init(arch: str, dtype: str = "float32"):
    """The smoke config (its parameters in `dtype`) and its seed-0
    weights."""
    from repro_torch.models import lm

    cfg = smoke(arch, dtype)
    return cfg, lm.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")


def opt_cfg():
    from repro_torch.optim import AdamWConfig

    return AdamWConfig(lr=LR, weight_decay=0.1)


def train(step, p, o, bs, each=None):
    """Steps over `bs`; `each(p, o)` after every step but the last."""
    rows = []
    for i, b in enumerate(bs):
        p, o, m = step(p, o, b)
        rows.append((float(m["loss"]), float(m["grad_norm"])))
        if each is not None and i + 1 < len(bs):
            each(p, o)
    return p, o, rows


# ---------------------------------------------------------------------------
# One rank of the spawn
# ---------------------------------------------------------------------------
def placed_run(mesh, arch, md, bs, record, grad_pspecs=True,
               dtype="float32", each=None):
    """Train `bs` placed over `mesh` from the seed-0 weights (in `dtype`),
    the accumulator placed like the parameters (or, `grad_pspecs=False`,
    whole on every rank); `each` as `train` takes it. Returns (params, opt state, rows, the pruned
    specs, {path: local shape})."""
    from repro_torch.distributed.sharding import (
        ShardingConfig,
        blocks,
        from_blocks,
        named,
        param_pspecs,
        place,
    )
    from repro_torch.launch.steps import make_train_step, opt_state_pspecs
    from repro_torch.optim import adamw_init
    from repro_torch.tree_util import leaves_with_path

    cfg, params = init(arch, dtype)
    pspec = param_pspecs(params, ShardingConfig(), mesh)
    p = place(params, named(mesh, pspec))
    o = from_blocks(adamw_init(blocks(p), md),
                    named(mesh, opt_state_pspecs(pspec, md)))
    step = make_train_step(cfg, opt_cfg(), moment_dtype=md,
                           grad_pspecs=pspec if grad_pspecs else None,
                           mesh=mesh)
    del record[:]
    p, o, rows = train(step, p, o, bs, each)
    local = {k: tuple(t.to_local().shape)
             for k, t in leaves_with_path((p, o))}
    specs = {k: tuple(s) for k, s in leaves_with_path(pspec)}
    return p, o, rows, specs, local


def rank_main(rank: int, store: str, out: str) -> None:
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.train import checkpoint_state, restore_state
    from repro_torch.models import lm
    from repro_torch.tree_util import leaves_with_path

    torch.set_num_threads(1)
    init_distributed("cpu", rank=rank, world_size=WORLD,
                     store=dist.FileStore(store, WORLD))
    record = []  # (whole gradient shape, block shape, dtype) a call
    reduce = steps_mod.reduce_to_block

    def recording(g, sh, over):
        b = reduce(g, sh, over)
        record.append((tuple(g.shape), tuple(b.shape), str(g.dtype)))
        return b

    steps_mod.reduce_to_block = recording
    gathered = lambda t: sharding.gather(t) if rank == 0 \
        else sharding.gather(t) and None  # noqa: E731
    res = {}
    for shape in MESHES:
        mesh = make_mesh(shape, AXES, "cpu")
        for arch, md in CASES + (MOE,):
            cfg, mids = init(arch)[0], []
            try:
                p, o, rows, specs, local = placed_run(
                    mesh, arch, md, batches(cfg, STEPS), record,
                    each=lambda p, o: mids.append(gathered(o)))
            except NotImplementedError as e:
                res[key(shape, arch, md)] = {"raised": str(e)}
                continue
            res[key(shape, arch, md)] = {
                "rows": rows, "specs": specs, "local": local,
                "accumulator": list(record), "state": gathered((p, o)),
                "mids": mids}
        # without grad_pspecs the accumulator is whole on every rank
        arch, md = CASES[0]
        p, o, rows, _, _ = placed_run(mesh, arch, md,
                                      batches(init(arch)[0], STEPS), record,
                                      grad_pspecs=False)
        res[key(shape, arch, md) + "/whole"] = {
            "rows": rows, "accumulator": list(record),
            "state": gathered((p, o))}

    # bfloat16 parameters, against the reference's GSPMD step
    for shape in REF_MESHES:
        arch, md = BF16
        mesh = make_mesh(shape, AXES, "cpu")
        p, o, rows, _, _ = placed_run(mesh, arch, md,
                                      batches(init(arch)[0], STEPS), record,
                                      dtype="bfloat16")
        res[key(shape, arch, md) + "/bf16"] = {
            "rows": rows, "accumulator": list(record),
            "state": gathered((p, o))}

    # The checkpoint: written on CKPT_MESH after STEPS steps, then STEPS
    # more steps there; restored on RESUME_MESH and trained the same.
    arch, md = CASES[0]
    cfg = init(arch)[0]
    bs = batches(cfg, 2 * STEPS)
    ckpt = os.path.join(out, "ckpt")
    mesh = make_mesh(CKPT_MESH, AXES, "cpu")
    p, o, _, _, _ = placed_run(mesh, arch, md, bs[:STEPS], record)
    mgr = CheckpointManager(ckpt, async_write=True)
    mgr.save(STEPS, checkpoint_state(p, o, cfg), {"train_step": STEPS})
    mgr.close()
    step = steps_mod.make_train_step(cfg, opt_cfg(), moment_dtype=md,
                                     grad_pspecs=sharding.param_pspecs(
                                         p, mesh=mesh), mesh=mesh)
    p, o, rows = train(step, p, o, bs[STEPS:])
    res["uninterrupted"] = {"rows": rows, "state": gathered((p, o))}

    mesh = make_mesh(RESUME_MESH, AXES, "cpu")
    like_p = init(arch)[1]
    pspec = sharding.param_pspecs(like_p, mesh=mesh)
    ospec = steps_mod.opt_state_pspecs(pspec, md)
    placement = (sharding.named(mesh, pspec), sharding.named(mesh, ospec))
    like_o = steps_mod.AdamWState(
        torch.zeros((), dtype=torch.int32), like_p, like_p)
    (p, o), extra = restore_state(ckpt, like_p, like_o, cfg, "cpu",
                                  placement=placement)
    local = {k: tuple(t.to_local().shape)
             for k, t in leaves_with_path((p, o))}
    step = steps_mod.make_train_step(cfg, opt_cfg(), moment_dtype=md,
                                     grad_pspecs=pspec, mesh=mesh)
    p, o, rows = train(step, p, o, bs[STEPS:])
    res["resumed"] = {"rows": rows, "state": gathered((p, o)),
                      "extra": extra, "local": local,
                      "specs": {k: tuple(s)
                                for k, s in leaves_with_path(pspec)}}

    # restore_checkpoint onto blocks, in the file's (stacked) layout
    ref = lm.to_reference_layout(like_p, cfg)
    rspec = sharding.param_pspecs(ref, mesh=mesh)
    got, _ = restore_checkpoint(ckpt, like=(ref, steps_mod.AdamWState(
        like_o.step, ref, ref)), shardings=(
        sharding.named(mesh, rspec), sharding.named(
            mesh, steps_mod.opt_state_pspecs(rspec, md))))
    res["restored_blocks"] = {
        "local": {k: tuple(t.to_local().shape)
                  for k, t in leaves_with_path(got)},
        "specs": {k: tuple(s) for k, s in leaves_with_path(rspec)},
        "state": gathered(got)}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def reference_main(out: str) -> None:
    """The reference's train step (`repro.launch.steps.make_train_step`
    with `grad_pspecs` = its pruned parameter specs, jitted with the
    shardings of `train_shardings`, as its launcher runs it) over each of
    REF_MESHES of four forced host devices, on CASES and BF16 from the
    port's seed-0 weights in the reference's layout and the same batches.
    Saves {key: {"rows", "state"}} with each state a (params, AdamWState)
    tree in the reference's layout, as tensors."""
    os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                               f"{WORLD} " + os.environ.get("XLA_FLAGS", ""))
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as j_get_arch
    from repro.distributed.sharding import ShardingConfig as JShardingConfig
    from repro.distributed.sharding import param_pspecs as j_param_pspecs
    from repro.launch.mesh import make_mesh_compat
    from repro.launch.steps import make_train_step as j_make_train_step
    from repro.launch.steps import train_shardings
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.optim import adamw_init as j_adamw_init
    from repro.optim.state_codec import Quantized as JQuantized
    from repro_torch.models import lm
    from repro_torch.optim import AdamWState
    from repro_torch.optim.state_codec import Quantized

    assert len(jax.devices()) == WORLD, jax.devices()

    def to_jax(t):
        dt = jnp.bfloat16 if t.dtype == torch.bfloat16 else None
        return jnp.asarray(t.float().numpy() if dt else t.numpy(), dtype=dt)

    def to_torch(node):
        if isinstance(node, dict):
            return {k: to_torch(v) for k, v in node.items()}
        if isinstance(node, JQuantized):
            return Quantized(codes=to_torch(node.codes),
                             scale=to_torch(node.scale))
        a = np.asarray(node)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())

    res = {}
    for shape in REF_MESHES:
        mesh = make_mesh_compat(shape, AXES)
        for (arch, md), dtype, tag in [(c, "float32", "") for c in CASES] \
                + [(BF16, "bfloat16", "/bf16")]:
            cfg, params = init(arch, dtype)
            model = dataclasses.replace(j_get_arch(arch).smoke, dtype=dtype)
            jp = {k: v for k, v in lm.to_reference_layout(params, cfg).items()}
            jp = jax.tree_util.tree_map(to_jax, jp)
            jo = j_adamw_init(jp, moment_dtype=md)
            bs = [{k: v.numpy() for k, v in b.items()}
                  for b in batches(cfg, STEPS)]
            scfg = JShardingConfig()
            ins, outs = train_shardings(jp, jo, bs[0], mesh, scfg, md)
            step = jax.jit(j_make_train_step(
                model, JAdamWConfig(lr=LR, weight_decay=0.1),
                moment_dtype=md,
                grad_pspecs=j_param_pspecs(jp, scfg, mesh)),
                in_shardings=ins, out_shardings=outs)
            rows, opts = [], []
            with mesh:
                p, o = jax.device_put(jp, ins[0]), jax.device_put(jo, ins[1])
                for b in bs:
                    p, o, m = step(p, o, b)
                    rows.append((float(m["loss"]), float(m["grad_norm"])))
                    opts.append(AdamWState(to_torch(o.step), to_torch(o.mu),
                                           to_torch(o.nu)))
            res[key(shape, arch, md) + tag] = {
                "rows": rows, "opts": opts,
                "state": (to_torch(p), opts[-1])}
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


class Spawn(NamedTuple):
    ranks: dict  # rank -> its results
    ckpt: Path  # the checkpoint written on CKPT_MESH
    reference: dict  # the reference's GSPMD runs (`reference_main`)


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    """Every scenario, run once by four ranks, and the reference's runs in
    a fifth process beside them."""
    tmp = tmp_path_factory.mktemp("placement")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    args = [[str(r), str(tmp / "store"), str(tmp)] for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, __file__] + a, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for a in args + [["reference", str(tmp)]]]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log)
           in enumerate(zip(procs, logs)) if p.returncode]
    assert not bad, bad
    return Spawn({r: torch.load(tmp / f"rank{r}.pt", weights_only=False)
                  for r in range(WORLD)}, tmp / "ckpt",
                 torch.load(tmp / "reference.pt", weights_only=False))


def one_process(arch, md, bs, p=None, o=None):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init

    cfg, params = init(arch)
    p = params if p is None else p
    o = adamw_init(p, md) if o is None else o
    step = make_train_step(cfg, opt_cfg(), moment_dtype=md)
    return train(step, p, o, bs)


def _decoded(m, md):
    return m.codes.float() * m.scale if md == "int8" else m


def assert_states_close(got, want, md, mus=None, flipped=None):
    """(params, opt state) trees: moments within REL of each leaf's
    largest entry (int8: codes within one step, scales within REL);
    parameters as `tests/test_torch_train_lm.py` holds them, within REL
    where the gradient exceeds 100 eps and within 2 lr elsewhere (the
    key biases' gradient is rounding noise: softmax ignores the shift
    q . bk of every key, and AdamW divides that noise by eps). Given
    `mus`, `want`'s first-moment trees after each step, the gradient must
    exceed 100 eps at every step (each step's 0.1 x gradient is
    mu - 0.9 x the previous mu): an entry whose first gradient was noise
    keeps the difference that step made. `flipped` (param path -> mask)
    marks the entries whose int8 moment codes differed after an earlier
    step, one code step apart: held like noise entries, since the next
    update divides that code step by sqrt(nu) as it divides noise."""
    from repro_torch.tree_util import leaves_with_path, map_with_path

    g, w = dict(leaves_with_path(got)), dict(leaves_with_path(want))
    assert g.keys() == w.keys()
    steps = [want[1].mu] if mus is None else mus
    grads = {}  # param path -> 0.1 x its gradient at each step
    for i, tree in enumerate(steps):
        map_with_path(lambda k, _, m: grads.setdefault(k, []).append(
            _decoded(m, md)), want[0], tree)
    for k in w:
        a, b = g[k], w[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k.endswith("/codes"):
            assert int((a.int() - b.int()).abs().max()) <= 1, k
            continue
        diff = (a.double() - b.double()).abs()
        if k.startswith("0/"):
            ms = grads[k[2:]]
            if mus is not None:  # each step's 0.1 x gradient
                ms = [ms[0]] + [m - 0.9 * p for p, m in zip(ms, ms[1:])]
            steady = torch.stack([m.abs() / 0.1 > 100 * EPS
                                  for m in ms]).all(0)
            if flipped is not None and k[2:] in flipped:
                steady &= ~flipped[k[2:]]
            assert float(diff.max()) <= 2 * LR, k
            assert float(torch.where(steady, diff, 0.0).max()) <= REL, k
            continue
        top = float(b.double().abs().max())
        assert float(diff.max()) <= REL * top, (k, float(diff.max()), top)


def expected_block(shape, spec, mesh_shape):
    sizes = dict(zip(AXES, mesh_shape))
    out = []
    for d, n in enumerate(shape):
        ax = spec[d] if d < len(spec) else None
        axes = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        ways = int(np.prod([sizes[a] for a in axes]))
        assert n % ways == 0
        out.append(n // ways)
    return tuple(out)


def pruned_specs(arch, mesh_shape):
    from repro_torch.distributed.sharding import param_pspecs, prune_pspecs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.tree_util import leaves_with_path

    params = init(arch)[1]
    mesh = Mesh(mesh_shape, AXES, np.empty(mesh_shape, dtype=object))
    return {k: tuple(s) for k, s in leaves_with_path(prune_pspecs(
        param_pspecs(params), params, mesh))}, params


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_placed_steps_equal_the_one_process_step(spawn, shape, case):
    ranks = spawn.ranks
    arch, md = case
    got = ranks[0][key(shape, arch, md)]
    for r in range(1, WORLD):  # the metrics are equal on every rank
        assert ranks[r][key(shape, arch, md)]["rows"] == got["rows"]
    p, o, rows = one_process(arch, md, batches(init(arch)[0], STEPS))
    for (l1, g1), (l2, g2) in zip(got["rows"], rows):
        assert abs(l1 / l2 - 1) <= REL and abs(g1 / g2 - 1) <= REL
    assert_states_close(got["state"], (p, o), md)


def reference_layout(state, arch, dtype="float32"):
    """A (params, AdamWState) tree of the port, or an AdamWState, in the
    reference's layout (blocks stacked under `pos<i>`), as the
    reference's runs are saved."""
    from repro_torch.models import lm
    from repro_torch.optim import AdamWState

    cfg = smoke(arch, dtype)
    if isinstance(state, AdamWState):
        return AdamWState(state.step, lm.to_reference_layout(state.mu, cfg),
                          lm.to_reference_layout(state.nu, cfg))
    p, o = state
    return lm.to_reference_layout(p, cfg), reference_layout(o, arch, dtype)


def code_flips(got_opts, want_opts):
    """param path -> the entries whose int8 mu or nu code differs between
    two runs' AdamW states after any of the steps given."""
    from repro_torch.tree_util import leaves_with_path

    out = {}
    for go, wo in zip(got_opts, want_opts):
        g = dict(leaves_with_path(go))
        for k, w in leaves_with_path(wo):
            if k.endswith("/codes"):
                path = k.split("/", 1)[1][:-len("/codes")]
                out[path] = out.get(path, False) | (g[k] != w)
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
@pytest.mark.parametrize("shape", REF_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_placed_steps_equal_the_reference_gspmd_step(spawn, shape, case):
    """The placed step against the reference's own step over the same
    mesh (GSPMD over four forced host devices, `reference_main`), from
    the same weights and batches, at the limits of the one-process
    comparison."""
    arch, md = case
    got = spawn.ranks[0][key(shape, arch, md)]
    want = spawn.reference[key(shape, arch, md)]
    assert len(got["rows"]) == len(want["rows"]) == STEPS
    for (l1, g1), (l2, g2) in zip(got["rows"], want["rows"]):
        assert abs(l1 / l2 - 1) <= REL and abs(g1 / g2 - 1) <= REL
    flips = code_flips([reference_layout(o, arch) for o in got["mids"]],
                       want["opts"][:-1])
    assert_states_close(reference_layout(got["state"], arch), want["state"],
                        md, [o.mu for o in want["opts"]], flips)


def bf16_spacing(x: torch.Tensor) -> torch.Tensor:
    """The distance from |x| to the next bfloat16 above it."""
    e = torch.floor(torch.log2(x.double().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("shape", REF_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_placed_bf16_step_against_the_reference_gspmd_step(spawn, shape):
    """bfloat16 parameters (qwen2-7b's smoke config, f32 moments): every
    gradient the ranks reduce is bfloat16, the parameters' dtype (the sum
    rounds to it before the f32 accumulator), and the placed step is the
    reference's GSPMD step within bfloat16's rounding. The loss and grad
    norm within BF16_EPS relative; mu within 4 BF16_EPS and nu (a square)
    within 8 BF16_EPS of each leaf's largest entry (the gradients pass
    through a few bf16 roundings each way). Parameters: every entry
    within 2 lr a step (1 % more: the second step's bias-corrected ratio
    may exceed 1 by 0.14 %) plus two bf16 spacings, the most two runs of
    STEPS updates can differ; and 99 % of the entries whose gradient
    exceeds BF16_EPS of that step's largest entry at every step within
    two bf16 spacings (each update may round the other way) plus
    8 BF16_EPS of the updates (lr times m/sqrt(v), whose error is mu's
    plus half nu's). The rest are noise: a gradient below bf16's
    resolution of the step's largest, or the key biases' (softmax ignores
    q . bk: their gradient is rounding noise at any size), which AdamW
    scales to +-lr with a sign unrelated between the runs; and where m
    changes sign between the steps m/sqrt(v) divides a difference of
    nearly equal terms."""
    from repro_torch.tree_util import leaves_with_path, map_with_path

    arch, md = BF16
    k = key(shape, arch, md) + "/bf16"
    for r in range(WORLD):
        acc = spawn.ranks[r][k]["accumulator"]
        assert acc and {dt for _, _, dt in acc} == {"torch.bfloat16"}
    got, want = spawn.ranks[0][k], spawn.reference[k]
    assert len(got["rows"]) == len(want["rows"]) == STEPS
    for (l1, g1), (l2, g2) in zip(got["rows"], want["rows"]):
        assert abs(l1 / l2 - 1) <= BF16_EPS and abs(g1 / g2 - 1) <= BF16_EPS
    g = dict(leaves_with_path(reference_layout(got["state"], arch,
                                               "bfloat16")))
    w = dict(leaves_with_path(want["state"]))
    assert g.keys() == w.keys()
    grads = {}  # param path -> 0.1 x its gradient at each step
    for o in want["opts"]:
        map_with_path(lambda p, _, m: grads.setdefault(p, []).append(m),
                      want["state"][0], o.mu)
    for p in grads:
        ms = grads[p]
        grads[p] = [ms[0]] + [m - 0.9 * q for q, m in zip(ms, ms[1:])]
    tops = [max(float(ms[i].abs().max()) for ms in grads.values())
            for i in range(STEPS)]  # each step's largest entry
    n_near = n_resolved = 0
    for name in w:
        a, b = g[name], w[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        diff = (a.double() - b.double()).abs()
        if name.startswith("0/"):
            resolved = torch.stack([
                m.abs() > BF16_EPS * top for m, top
                in zip(grads[name[2:]], tops)]).all(0)
            resolved &= not name.endswith("/bk")
            ceiling = 2 * bf16_spacing(b) + 2 * STEPS * LR * 1.01
            near = 2 * bf16_spacing(b) + 8 * BF16_EPS * STEPS * LR
            assert bool((diff <= ceiling).all()), name
            n_near += int((diff <= near)[resolved].sum())
            n_resolved += int(resolved.sum())
            continue
        if name == "1/step":
            assert torch.equal(a, b)
            continue
        n = 4 if name.startswith("1/mu/") else 8
        assert float(diff.max()) <= n * BF16_EPS * float(b.abs().max()), \
            name
    assert n_near >= 0.99 * n_resolved > 0, (n_near, n_resolved)


def assert_blocks(local, specs, params, mesh_shape):
    """Each local shape of a (params, opt state) tree is the block of its
    spec: a parameter's and its moments' (int8 codes) the parameter's
    spec, int8 row scales that spec without its last axis."""
    from repro_torch.tree_util import leaves_with_path

    full = dict(leaves_with_path(params))
    assert len(local) > len(full)
    for k, shape in local.items():
        if k == "1/step":
            assert shape == ()
            continue
        path = k[2:] if k.startswith("0/") else k.split("/", 2)[2]
        spec = None
        if path.endswith("/scale"):
            path = path[:-len("/scale")]
            spec = specs[path][:-1] + (None,)
        elif path.endswith("/codes"):
            path = path[:-len("/codes")]
        whole = tuple(full[path].shape)
        if spec is not None:
            whole = whole[:-1] + (1,)
        spec = specs[path] if spec is None else spec
        assert shape == expected_block(whole, spec, mesh_shape), k


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_each_rank_holds_its_blocks(spawn, shape):
    """Parameters, moments (int8 codes and row scales) and the gradient
    accumulator: each rank's local shape is the block of its pruned
    spec, and the step reduced every microbatch's gradient onto it."""
    from repro_torch.tree_util import leaves_with_path

    ranks = spawn.ranks
    for arch, md in CASES:
        want, params = pruned_specs(arch, shape)
        full = dict(leaves_with_path(params))
        paths = list(full)
        for r in range(WORLD):
            got = ranks[r][key(shape, arch, md)]
            assert got["specs"] == want
            assert_blocks(got["local"], want, params, shape)
            acc = got["accumulator"]
            assert len(acc) == len(paths) * ACCUM * STEPS
            for i, (g, b, dt) in enumerate(acc):
                assert dt == "torch.float32"
                path = paths[i % len(paths)]
                assert g == tuple(full[path].shape)
                assert b == expected_block(g, want[path], shape), path


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_a_whole_accumulator_gives_the_same_step(spawn, shape):
    """`grad_pspecs=None`, as in the reference: the accumulator is whole
    on every rank (an all-reduce a microbatch), the update still runs on
    the parameters' blocks, and the step is the one-process step."""
    ranks = spawn.ranks
    arch, md = CASES[0]
    got = ranks[0][key(shape, arch, md) + "/whole"]
    assert all(g == b for g, b, _ in got["accumulator"])
    p, o, rows = one_process(arch, md, batches(init(arch)[0], STEPS))
    for (l1, g1), (l2, g2) in zip(got["rows"], rows):
        assert abs(l1 / l2 - 1) <= REL and abs(g1 / g2 - 1) <= REL
    assert_states_close(got["state"], (p, o), md)


def test_moe_on_a_model_mesh_equals_one_process(spawn):
    ranks = spawn.ranks
    arch, md = MOE
    got = ranks[0][key((1, 4), arch, md)]
    p, o, rows = one_process(arch, md, batches(init(arch)[0], STEPS))
    for (l1, g1), (l2, g2) in zip(got["rows"], rows):
        assert abs(l1 / l2 - 1) <= REL and abs(g1 / g2 - 1) <= REL
    assert_states_close(got["state"], (p, o), md)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_over_a_split_batch_raises_naming_item_9c(spawn, shape):
    ranks = spawn.ranks
    for r in range(WORLD):
        got = ranks[r][key(shape, *MOE)]
        assert "item 9c" in got["raised"]


def _resumed_one_process(ckpt):
    from repro_torch.launch.train import restore_state
    from repro_torch.optim import AdamWState

    arch, md = CASES[0]
    cfg, like = init(arch)
    (p, o), extra = restore_state(
        ckpt, like, AdamWState(torch.zeros((), dtype=torch.int32), like,
                               like), cfg, "cpu")
    assert extra == {"train_step": STEPS}
    return one_process(arch, md, batches(cfg, 2 * STEPS)[STEPS:], p, o)


@pytest.mark.parametrize("where", ["4x1", "one_process"])
def test_a_2x2_checkpoint_resumes_elsewhere(spawn, where):
    ranks, ckpt = spawn.ranks, spawn.ckpt
    want = ranks[0]["uninterrupted"]
    if where == "4x1":
        got = ranks[0]["resumed"]
        assert got["extra"] == {"train_step": STEPS}
        rows, state = got["rows"], got["state"]
        specs, params = pruned_specs(CASES[0][0], RESUME_MESH)
        for r in range(WORLD):  # each rank keeps its block of (4, 1)
            mine = ranks[r]["resumed"]
            assert mine["rows"] == rows and mine["specs"] == specs
            assert_blocks(mine["local"], specs, params, RESUME_MESH)
    else:
        p, o, rows = _resumed_one_process(ckpt)
        state = (p, o)
    for (l1, g1), (l2, g2) in zip(rows, want["rows"]):
        assert abs(l1 / l2 - 1) <= REL and abs(g1 / g2 - 1) <= REL
    assert_states_close(state, want["state"], CASES[0][1])


def test_restore_checkpoint_keeps_each_ranks_block(spawn):
    """`restore_checkpoint(shardings=)` in the file's stacked layout: each
    rank holds the block of the pruned stacked spec, and the blocks make
    the tensors a host restore reads."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.tree_util import leaves_with_path

    ranks, ckpt = spawn.ranks, spawn.ckpt
    host, _ = restore_checkpoint(ckpt)
    for r in range(WORLD):
        got = ranks[r]["restored_blocks"]
        specs = got["specs"]
        for k, local in got["local"].items():
            part, rest = k.split("/", 1)
            if part == "0":
                assert local == expected_block(tuple(host[k].shape),
                                               specs[rest], RESUME_MESH), k
    state = dict(leaves_with_path(ranks[0]["restored_blocks"]["state"]))
    assert state.keys() == host.keys()
    for k, t in host.items():
        assert torch.equal(state[k], t), k


def test_the_reference_restores_a_placed_checkpoint(spawn):
    from repro.checkpoint import restore_checkpoint as j_restore
    from repro_torch.checkpoint import restore_checkpoint

    ckpt = spawn.ckpt
    ref, extra = j_restore(ckpt)
    port, _ = restore_checkpoint(ckpt)
    assert extra == {"train_step": STEPS} and ref.keys() == port.keys()
    for k, t in port.items():
        np.testing.assert_array_equal(np.asarray(ref[k]), t.numpy())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _torchrun(args, tmp):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc-per-node", "2", "--rdzv-backend", "c10d",
           "--rdzv-endpoint", f"localhost:{_free_port()}",
           "-m", "repro_torch.launch.train"] + args
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=240, cwd=tmp)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_the_launcher_trains_over_two_ranks_under_torchrun(tmp_path):
    """torchrun --nproc-per-node 2: rank 0 alone prints the step lines,
    the losses are the one-process launcher's, and --resume picks up the
    placed run's checkpoint; the checkpoints agree within 1e-5."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.launch import train as ttrain

    base = ["--arch", "qwen2-7b", "--smoke", "--device", "cpu",
            "--ckpt-every", "2", "--resume"]
    ranked = tmp_path / "ranked"
    first = _torchrun(base + ["--steps", "2", "--ckpt-dir", str(ranked)],
                      tmp_path)
    again = _torchrun(base + ["--steps", "4", "--ckpt-dir", str(ranked)],
                      tmp_path)
    lines = [l for l in (first + again).splitlines()
             if l.startswith("step ")]
    assert [int(l.split()[1]) for l in lines] == [0, 1, 2, 3]
    assert "resumed at step 2 (data step 4)" in again
    assert "resumed" not in first

    alone = tmp_path / "alone"
    log = []
    ttrain.main(base + ["--steps", "4", "--ckpt-dir", str(alone)], log=log)
    for line, row in zip(lines, log):
        loss = float(line.split()[3])
        assert abs(loss - row["loss"]) <= 5e-5 + REL * abs(row["loss"])
    got, _ = restore_checkpoint(ranked)
    want, _ = restore_checkpoint(alone)
    assert got.keys() == want.keys()
    for k, t in want.items():  # assert_states_close's rule
        gap = (got[k].double() - t.double()).abs()
        if k.startswith("0/"):
            steady = want["1/mu/" + k[2:]].abs() / 0.1 > 100 * EPS
            assert float(gap.max()) <= 2 * LR, k
            assert float(torch.where(steady, gap, 0.0).max()) <= REL, k
        else:
            assert float(gap.max()) <= REL * float(t.double().abs().max()), k
