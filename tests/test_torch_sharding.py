"""The port's sharding rule layer and meshes against the JAX package's.

Param specs (`param_pspecs`, with and without a host mesh, tensor
parallelism on and off) and decode-cache specs (`cache_pspecs`) of all
ten archs, smoke and published configs, equal as tuples to the
reference's `PartitionSpec`s: the port's parameters are shaped without
storage (`FakeTensorMode`) and stacked into the reference's layout
(`lm.to_reference_layout`); in the port's own layout (one dict a layer)
each spec is the reference's without the period axis. Data, batch,
optimizer-state (int8 codes and scales) and train-step spec trees, and
`validate_divisibility` on a 16 x 16 mesh, equal too. `named` places
every leaf on the one device of a 1 x 1 mesh and raises on a mesh of two
(ROADMAP item 9b); `make_production_mesh` raises without 256 cards, and
`make_host_mesh()` without a card.
"""
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_arch as j_get_arch
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps
from repro.launch.mesh import make_mesh_compat
from repro.models import lm as jlm
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.tree_util import map_with_path


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny shapes gain nothing from more, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j_flat(tree):
    """{path: tuple(spec)} of a reference spec tree (a named tuple's
    field `.codes` read as `codes`)."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {jsh._path_str(p).replace("/.", "/"): tuple(s)
            for p, s in leaves}


def _t_flat(tree):
    out = {}
    map_with_path(lambda p, s: out.__setitem__(p, s), tree)
    for s in out.values():
        assert isinstance(s, tuple)
    return {p: tuple(s) for p, s in out.items()}


def _shapes(arch: str, which: str):
    """(reference ShapeDtypeStruct params, port params without storage in
    the port's layout, the port's config)."""
    jm = getattr(j_get_arch(arch), which)
    tm = getattr(get_arch(arch), which)
    j = jax.eval_shape(lambda k: jlm.init_params(jm, k),
                       jax.random.PRNGKey(0))
    with FakeTensorMode():
        t = tlm.init_params(tm, torch.Generator().manual_seed(0),
                            device="cpu")
    return j, t, tm


def _host_meshes():
    return (make_mesh_compat((1, 1), ("data", "model")),
            tmesh.make_host_mesh("cpu"))


@pytest.mark.parametrize("which", ["smoke", "model"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_specs_match_the_reference(arch, which):
    j_params, t_params, tm = _shapes(arch, which)
    j_mesh, t_mesh = _host_meshes()
    stacked = tlm.to_reference_layout(t_params, tm)
    for cfg in ({}, {"tp_axis": None}):
        jcfg, tcfg = jsh.ShardingConfig(**cfg), tsh.ShardingConfig(**cfg)
        want = _j_flat(jsh.param_pspecs(j_params, jcfg))
        assert _t_flat(tsh.param_pspecs(stacked, tcfg)) == want
        assert _t_flat(tsh.param_pspecs(stacked, tcfg, t_mesh)) == \
            _j_flat(jsh.param_pspecs(j_params, jcfg, j_mesh))
        # the port's own layout: the same specs without the period axis
        own = _t_flat(tsh.param_pspecs(t_params, tcfg))
        p = tlm.period(tm)
        for path, spec in own.items():
            parts = path.split("/")
            if parts[0] in ("blocks", "enc_blocks"):
                per = p if parts[0] == "blocks" else 1
                ref = "/".join([parts[0], f"pos{int(parts[1]) % per}"]
                               + parts[2:])
                assert spec == want[ref][1:], path
            else:
                assert spec == want[path], path

    j_cache = jax.eval_shape(lambda: jlm.init_cache(
        getattr(j_get_arch(arch), which), 2, 64))
    with FakeTensorMode():
        t_cache = tlm.init_cache(tm, 2, 64, device="cpu")
    assert _t_flat(tsh.cache_pspecs(t_cache, t_mesh)) == \
        _j_flat(jsh.cache_pspecs(j_cache, j_mesh))


def test_step_spec_trees_match_the_reference():
    arch = "llama3-405b"
    j_params, t_params, tm = _shapes(arch, "smoke")
    j_mesh, t_mesh = _host_meshes()
    stacked = tlm.to_reference_layout(t_params, tm)
    j_specs = jsh.param_pspecs(j_params)
    t_specs = tsh.param_pspecs(stacked)
    for md in ("float32", "int8"):
        j_o = jsteps.opt_state_pspecs(j_specs, md)
        t_o = tsteps.opt_state_pspecs(t_specs, md)
        assert t_o.step == () == tuple(j_o.step)
        for name in ("mu", "nu"):
            assert _t_flat(getattr(t_o, name)) == \
                _j_flat(getattr(j_o, name))
        if md == "int8":
            q = t_o.mu["embed"]
            assert (q.codes, q.scale) == (("model", "data"), ("model", None))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 9, (2, 4, 16)).astype(np.int32),
             "frames": np.zeros((2, 4, 8, 5), np.float32)}
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert _t_flat(tsteps.accum_batch_pspecs(
        t_batch, t_mesh, tsh.ShardingConfig())) == _j_flat(
        jsteps.accum_batch_pspecs(batch, j_mesh, jsh.ShardingConfig()))
    one = {k: v[0] for k, v in batch.items()}
    assert _t_flat(tsh.data_pspecs({k: torch.from_numpy(v) for k, v in
                                    one.items()}, t_mesh)) == \
        _j_flat(jsh.data_pspecs(one, j_mesh))
    (tp, to, tb), (tp2, to2, tm_) = tsteps.train_shardings(
        stacked, None, t_batch, t_mesh, tsh.ShardingConfig(), "int8")
    assert _t_flat(tp) == _j_flat(jsh.param_pspecs(j_params,
                                                   jsh.ShardingConfig(),
                                                   j_mesh))
    assert tm_ == {"loss": (), "grad_norm": ()} and tp2 is tp and to2 is to


def test_validate_divisibility_matches_the_reference():
    j_params, t_params, tm = _shapes("whisper-large-v3", "model")
    stacked = tlm.to_reference_layout(t_params, tm)
    fake = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((16, 16), object))
    t_mesh = tmesh.Mesh((16, 16), ("data", "model"),
                        np.empty((16, 16), object))
    want = jsh.validate_divisibility(jsh.param_pspecs(j_params), j_params,
                                     fake)
    got = tsh.validate_divisibility(tsh.param_pspecs(stacked), stacked,
                                    t_mesh)
    assert got == want and want  # whisper's 51,866 tokens: not 16 ways
    pruned = tsh.prune_pspecs(tsh.param_pspecs(stacked), stacked, t_mesh)
    assert _t_flat(pruned) == _j_flat(jsh.prune_pspecs(
        jsh.param_pspecs(j_params), j_params, fake))


def test_placement_is_one_device():
    _, t_params, tm = _shapes("qwen2-7b", "smoke")
    t_mesh = tmesh.make_host_mesh("cpu")
    assert t_mesh.shape == (1, 1) and t_mesh.axis_names == ("data", "model")
    placed = tsh.named(t_mesh, tsh.param_pspecs(t_params, mesh=t_mesh))
    devs = set()
    map_with_path(lambda _, d: devs.add(d), placed)
    assert devs == {torch.device("cpu")}
    two = tmesh.Mesh((1, 2), ("data", "model"),
                     np.array([[torch.device("cpu")] * 2], dtype=object))
    with pytest.raises(NotImplementedError, match="item 9b"):
        tsh.named(two, tsh.param_pspecs(t_params))


def test_meshes_refuse_what_the_host_does_not_have(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_host_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_production_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 256 devices"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 devices"):
        tmesh.make_production_mesh(multi_pod=True)
    assert tmesh.make_host_mesh().shape == (1, 1)
