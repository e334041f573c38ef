"""The port's checkpoints against the JAX package's, on the CPU.

- The reference's `launch.train.main` (qwen2-7b smoke, f32 moments) saves
  at step 2; the port's launcher resumes from that checkpoint, and its
  steps 3-4 give the reference's uninterrupted run's losses within 1e-5
  relative.
- The same state written by both packages (f32 moments after a step of
  qwen2-7b's smoke config; int8 moments on llama3-405b's): the same
  '/'-joined keys, the same bytes a leaf, the same manifest entries
  (shape, dtype, sha256_16); each package restores the other's files to
  the same values.
- bf16 leaves round-trip in the port, written as the reference writes
  them (`|V2` under "bfloat16", the same sha); the reference cannot read
  them back (a recorded reference fault, ROADMAP §3).
- A corrupt leaf, a torn `tmp_step_N`, the manager's keep and async
  writer, as `tests/test_checkpoint_data.py` checks the reference.

The reference's launcher builds its host mesh with `jax.make_mesh`'s
default axis types, which this jax makes Explicit, and its train step's
sharding constraint then refuses the mesh; the test hands it the mesh
its own `make_mesh_compat` builds (Auto axes), as its dry-run does.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jtrain
from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import get_arch as j_get_arch
from repro.launch.mesh import make_mesh_compat
from repro.models import lm as jlm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import train as ttrain
from repro_torch.optim import adamw_init

REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny shapes gain nothing from more, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reference_launcher(monkeypatch):
    """The reference's `launch.train` with an Auto-axis host mesh, and the
    loss of each step it runs, read at its finite-loss check (its printed
    line rounds it)."""
    monkeypatch.setattr(jtrain, "make_host_mesh", lambda: make_mesh_compat(
        (1, len(jax.devices())), ("data", "model")))
    seen = []

    class _Np:
        def __getattr__(self, name):
            return getattr(np, name)

        def isfinite(self, x):
            seen.append(float(x))
            return np.isfinite(x)

    monkeypatch.setattr(jtrain, "np", _Np())
    return seen


BASE = ["--arch", "qwen2-7b", "--smoke", "--seq-len", "32",
        "--global-batch", "4", "--accum", "2"]


def test_port_resumes_the_reference_checkpoint(reference_launcher, tmp_path,
                                               capsys):
    jtrain.main(BASE + ["--steps", "4"])
    full = list(reference_launcher)
    jtrain.main(BASE + ["--steps", "2", "--ckpt-dir", str(tmp_path),
                        "--ckpt-every", "2"])
    assert latest_step(tmp_path) == 2
    log = []
    ttrain.main(BASE + ["--steps", "4", "--ckpt-dir", str(tmp_path),
                        "--ckpt-every", "100", "--resume", "--device", "cpu"],
                log=log)
    assert "resumed at step 2 (data step 4)" in capsys.readouterr().out
    assert [r["step"] for r in log] == [2, 3]
    np.testing.assert_allclose([r["loss"] for r in log], full[2:],
                               rtol=REL)


def _j_state(arch: str, moment_dtype: str):
    """The reference's (params, opt_state) after one AdamW step with
    numpy-seeded gradients."""
    model = j_get_arch(arch).smoke
    params = jlm.init_params(model, jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape) * 1e-2, p.dtype),
        params)
    opt = j_adamw_init(params, moment_dtype=moment_dtype)
    return j_adamw_update(grads, opt, params, JAdamWConfig(lr=1e-3),
                          moment_dtype=moment_dtype)


def _files(d):
    data = np.load(d / "arrays.npz")
    manifest = json.loads((d / "manifest.json").read_text())["arrays"]
    return {k: data[k] for k in data.files}, manifest


@pytest.mark.parametrize("arch,moment_dtype", [("qwen2-7b", "float32"),
                                               ("llama3-405b", "int8")])
def test_checkpoints_cross_both_ways(arch, moment_dtype, tmp_path):
    j_state = _j_state(arch, moment_dtype)
    j_save(tmp_path / "ref", 1, j_state, extra={"train_step": 1})

    model = get_arch(arch).smoke
    tp = lm_params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jlm.init_params(j_get_arch(arch).smoke,
                                    jax.random.PRNGKey(1))), device="cpu")
    (params, opt), extra = ttrain.restore_state(
        tmp_path / "ref", tp, adamw_init(tp, moment_dtype=moment_dtype),
        model, "cpu")
    assert extra == {"train_step": 1} and int(opt.step) == 1
    save_checkpoint(tmp_path / "port", 1,
                    ttrain.checkpoint_state(params, opt, model), extra)

    ref_arrays, ref_manifest = _files(tmp_path / "ref" / "step_1")
    port_arrays, port_manifest = _files(tmp_path / "port" / "step_1")
    assert port_arrays.keys() == ref_arrays.keys()
    assert port_manifest == ref_manifest
    if moment_dtype == "int8":
        assert any(k.endswith("/codes") for k in port_arrays)
        assert "1/mu/embed/scale" in port_arrays
    for k, a in ref_arrays.items():
        assert port_arrays[k].dtype == a.dtype
        assert port_arrays[k].tobytes() == a.tobytes(), k

    like = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), j_state)
    back, extra = j_restore(tmp_path / "port", like=like)
    assert extra == {"train_step": 1}
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(j_state)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_bf16_leaves_round_trip_in_the_port(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 7)).astype(np.float32)
    tree = {"w": torch.from_numpy(x).to(torch.bfloat16),
            "b": torch.from_numpy(x[0])}
    save_checkpoint(tmp_path / "port", 3, tree, extra={"data_step": 2})
    got, extra = restore_checkpoint(
        tmp_path / "port", like=tree)
    assert extra == {"data_step": 2} and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], tree["w"]) and torch.equal(got["b"],
                                                            tree["b"])
    flat, _ = restore_checkpoint(tmp_path / "port")
    assert torch.equal(flat["w"], tree["w"])

    j_save(tmp_path / "ref", 3, {"w": jnp.asarray(x, jnp.bfloat16),
                                 "b": jnp.asarray(x[0])})
    ref_arrays, ref_manifest = _files(tmp_path / "ref" / "step_3")
    port_arrays, port_manifest = _files(tmp_path / "port" / "step_3")
    assert port_manifest == ref_manifest
    assert ref_manifest["w"]["dtype"] == "bfloat16"
    assert port_arrays["w"].dtype == ref_arrays["w"].dtype == np.dtype("V2")
    assert port_arrays["w"].tobytes() == ref_arrays["w"].tobytes()
    # The reference's restore refuses its own bfloat16 leaves.
    with pytest.raises(ValueError, match="shape/dtype mismatch"):
        j_restore(tmp_path / "ref")
    got, _ = restore_checkpoint(tmp_path / "ref", like=tree)
    assert torch.equal(got["w"], tree["w"])


def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32)}}


def test_corrupt_leaf_and_torn_write_are_refused(tmp_path):
    save_checkpoint(tmp_path, 1, _tree())
    (tmp_path / "tmp_step_2").mkdir()
    (tmp_path / "tmp_step_2" / "arrays.npz").write_bytes(b"partial garbage")
    assert latest_step(tmp_path) == 1
    got, _ = restore_checkpoint(tmp_path)
    assert torch.equal(got["a"], _tree()["a"])

    save_checkpoint(tmp_path, 5, _tree())
    d = tmp_path / "step_5"
    manifest = json.loads((d / "manifest.json").read_text())
    manifest["arrays"]["a"]["sha256_16"] = "deadbeefdeadbeef"
    (d / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="hash mismatch"):
        restore_checkpoint(tmp_path, step=5)
    manifest["arrays"]["a"]["dtype"] = "int8"
    (d / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="shape/dtype mismatch"):
        restore_checkpoint(tmp_path, step=5)
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(tmp_path, step=1,
                           like={"a": torch.zeros(3, 4), "z": torch.zeros(1)})


def test_manager_keeps_last_k_and_writes_async(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_write=True)
    for s in range(5):
        mgr.save(s, _tree(), extra={"data_step": s})
    mgr.wait()
    mgr.close()
    steps = sorted(int(p.name.split("_")[1])
                   for p in tmp_path.iterdir() if p.name.startswith("step_"))
    assert steps == [3, 4]
    got, extra = restore_checkpoint(tmp_path, like=_tree(),
                                    shardings={"a": "cpu", "b": {"c": "cpu"}})
    assert extra == {"data_step": 4} and torch.equal(got["b"]["c"],
                                                     _tree()["b"]["c"])
