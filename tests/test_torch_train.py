"""The port's training against the JAX package from the same parameters,
optimizer state, batches and jitter (numpy arrays carried across):

- the loss gradient of `render_rays` reaches every hash table and matches
  `jax.grad` of the reference's loss on every leaf, with no quantization
  spec and with a mixed one (within 1e-5 of the largest gradient of the
  leaf: measured at most 3e-7 of it);
- one train step and ten: the loss within 1e-6 relative, every leaf
  within 2e-5 (measured at most 5.5e-6, in table entries whose tiny
  gradients make AdamW's first update m / sqrt(v) sensitive: 0.1 % of one
  step of lr 5e-3);
- `finetune_ngp` under a mixed spec, and the port's own `train_ngp`
  raising PSNR by more than 2 dB, as the reference's test asks of it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nerf import dataset as jd
from repro.nerf import hash_encoding as jhe
from repro.nerf import ngp as jngp
from repro.nerf import render as jr
from repro.nerf import scenes as js
from repro.nerf import train as jt
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.quant.policy import QuantPolicy as JQuantPolicy
from repro_torch.convert import (
    adamw_state_from_numpy,
    dataset_from_numpy,
    params_from_numpy,
)
from repro_torch.nerf import dataset as td
from repro_torch.nerf import hash_encoding as the
from repro_torch.nerf import ngp as tngp
from repro_torch.nerf import render as tr
from repro_torch.nerf import scenes as ts
from repro_torch.nerf import train as tt
from repro_torch.optim import AdamWConfig as TAdamWConfig
from repro_torch.optim import adamw_init as t_adamw_init
from repro_torch.quant.policy import QuantPolicy as TQuantPolicy
from repro_torch.tree_util import leaves_with_path

HASH = dict(n_levels=4, log2_table_size=9, base_resolution=4,
            max_resolution=32)
MLP = dict(hidden_dim=16, color_hidden_dim=16, geo_feat_dim=7, sh_degree=2)
J_CFG = jngp.NGPConfig(hash=jhe.HashEncodingConfig(**HASH), **MLP)
T_CFG = tngp.NGPConfig(hash=the.HashEncodingConfig(**HASH), **MLP)
J_RCFG, T_RCFG = jr.RenderConfig(n_samples=16), tr.RenderConfig(n_samples=16)
GRAD_RTOL = 1e-5
LOSS_RTOL = 1e-6
LEAF_ATOL = 2e-5
# 6-bit hash levels, 4-bit weights, 8-bit activations: every linear in the
# integer mode.
KIND_BITS = {"HASH_LEVEL": 6, "WEIGHT": 4, "ACTIVATION": 8}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(j_tree):
    return {"/".join(str(p.key) for p in k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(j_tree)[0]}


def _cmp_leaves(t_tree, j_tree, atol):
    j, t = _leaves(j_tree), dict(leaves_with_path(t_tree))
    assert sorted(t) == sorted(j)
    for name, v in j.items():
        np.testing.assert_allclose(t[name].detach().numpy(), v, rtol=0,
                                   atol=atol, err_msg=name)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny shapes gain nothing from more, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def j_ds():
    return jd.make_dataset(js.SceneConfig(image_hw=16, n_train_views=4,
                                          n_test_views=2))


@pytest.fixture(scope="module")
def j_params():
    """Reference init at trained-model magnitudes: tables scaled so the
    quantizers see signal, and non-zero biases. (With the init's zero
    biases a layer whose inputs and weights are both on quantization grids
    can sum to exactly zero, and XLA's and PyTorch's dot products leave
    residues of opposite sign there, which flip the following relu: ROADMAP
    §3.)"""
    p = jngp.init_ngp(jax.random.PRNGKey(0), J_CFG)
    p["hash"] = {k: v * 1e3 for k, v in p["hash"].items()}
    rng = np.random.RandomState(4)
    for name in jngp.ngp_linear_names(J_CFG):
        b = p[name]["b"]
        p[name]["b"] = jnp.asarray(
            rng.normal(scale=0.05, size=b.shape).astype(np.float32))
    return p


def _mixed_specs(j_params):
    """The same mixed policy in both packages, activation ranges from the
    reference field's taps on uniform points."""
    pts = np.random.RandomState(1).uniform(size=(512, 3)).astype(np.float32)
    dirs = np.tile(np.float32([[0.0, 0.0, 1.0]]), (512, 1))
    _, _, taps = jngp.ngp_apply(j_params, jnp.asarray(pts), jnp.asarray(dirs),
                                J_CFG, None, return_taps=True)
    ranges = np.asarray([[float(jnp.min(taps[n])), float(jnp.max(taps[n]))]
                         for n in jngp.ngp_linear_names(J_CFG)], np.float32)
    ju, tu = jngp.make_quant_units(J_CFG), tngp.make_quant_units(T_CFG)
    bits = [KIND_BITS[u.kind.name] for u in ju]
    jspec = jngp.spec_from_policy(
        J_CFG, JQuantPolicy.uniform(ju, 8).with_bits(bits),
        jnp.asarray(ranges))
    tspec = tngp.spec_from_policy(
        T_CFG, TQuantPolicy.uniform(tu, 8).with_bits(bits),
        torch.from_numpy(ranges))
    return jspec, tspec


def _specs(kind, j_params):
    if kind == "none":
        return None, None
    return _mixed_specs(j_params)


def _batch(j_ds, n=96, seed=0):
    ro, rd, c = next(j_ds.ray_batches(n, seed=seed))
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed + 7), (n, 16)))
    return ro, rd, c, u


@pytest.mark.parametrize("spec_kind", ["none", "mixed"])
def test_render_rays_gradient_matches_reference(j_ds, j_params, spec_kind):
    """The trilinear sum's backward: every hash table gets a non-zero
    gradient, equal to the reference's within GRAD_RTOL of the leaf's
    largest; the forward loss is the same."""
    jspec, tspec = _specs(spec_kind, j_params)
    ro, rd, c, u = _batch(j_ds)
    key = jax.random.PRNGKey(7)  # the reference draws `u` from this key
    u = np.asarray(jax.random.uniform(key, (ro.shape[0], 16)))
    j_loss, j_grads = jax.jit(jax.value_and_grad(jt._loss_fn),
                              static_argnames=("cfg", "rcfg"))(
        j_params, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(c),
        cfg=J_CFG, rcfg=J_RCFG, spec=jspec, key=key)
    tp = params_from_numpy(_np(j_params), device="cpu")
    leaves = dict(leaves_with_path(tp))
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    loss = tt._loss_fn(tp, *map(torch.from_numpy, (ro, rd, c)), T_CFG,
                       T_RCFG, tspec, torch.from_numpy(u))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_RTOL)
    for name, want in _leaves(j_grads).items():
        got = leaves[name].grad
        assert got is not None, f"no gradient reaches {name}"
        if name.startswith("hash/"):
            assert np.count_nonzero(want) > 0 and \
                torch.count_nonzero(got) > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("steps", [1, 10])
def test_train_steps_match_reference(j_ds, steps):
    """From the reference's init and AdamW state, its batches and its
    jitter draws (`_run_steps`' key splits): the loss of every step and
    every leaf after the last."""
    jp = jngp.init_ngp(jax.random.PRNGKey(0), J_CFG)
    tp = params_from_numpy(_np(jp), device="cpu")
    js_ = j_adamw_init(jp)
    ts_ = adamw_state_from_numpy(_np(js_), device="cpu")
    jo = JAdamWConfig(lr=5e-3, weight_decay=1e-6)
    to = TAdamWConfig(lr=5e-3, weight_decay=1e-6)
    jspec = jngp.no_quant_spec(J_CFG)
    tspec = tngp.no_quant_spec(T_CFG, device="cpu")
    key, batches = jax.random.PRNGKey(0), j_ds.ray_batches(64, seed=0)
    for _ in range(steps):
        ro, rd, c = next(batches)
        key, sub = jax.random.split(key)
        u = np.asarray(jax.random.uniform(sub, (64, 16)))
        jp, js_, j_loss = jt._train_step(
            jp, js_, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(c), sub,
            jspec, J_CFG, J_RCFG, jo)
        tp, ts_, t_loss = tt._train_step(
            tp, ts_, *map(torch.from_numpy, (ro, rd, c, u)), tspec, T_CFG,
            T_RCFG, to)
        np.testing.assert_allclose(float(t_loss), float(j_loss),
                                   rtol=LOSS_RTOL)
    assert int(ts_.step) == int(js_.step) == steps
    _cmp_leaves(tp, jp, LEAF_ATOL)
    _cmp_leaves(ts_.mu, js_.mu, LEAF_ATOL)


def test_finetune_matches_reference_under_a_mixed_spec(j_ds, j_params):
    """`finetune_ngp` of both packages (unstratified, so the run needs no
    jitter): finetune_lr, seed + 1's batches, the last step's loss."""
    jspec, tspec = _mixed_specs(j_params)
    tcfg_kw = dict(batch_rays=64, seed=2)
    rj = dataclasses.replace(J_RCFG, stratified=False)
    rt = dataclasses.replace(T_RCFG, stratified=False)
    jp, j_loss = jt.finetune_ngp(dict(j_params), j_ds, J_CFG, rj,
                                 jt.TrainConfig(**tcfg_kw), jspec, 5)
    tp0 = params_from_numpy(_np(j_params), device="cpu")
    tp, t_loss = tt.finetune_ngp(tp0, dataset_from_numpy(j_ds), T_CFG, rt,
                                 tt.TrainConfig(**tcfg_kw), tspec, 5,
                                 device="cpu")
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    _cmp_leaves(tp, jp, LEAF_ATOL)
    # The caller's parameters are not changed in place.
    _cmp_leaves(tp0, j_params, 0.0)


def test_port_training_improves_psnr():
    """The reference's `test_training_improves_psnr`, on the port alone."""
    ds = td.make_dataset(ts.SceneConfig(name="lego", image_hw=20,
                                        n_train_views=4, n_test_views=1),
                         device="cpu")
    tcfg = tt.TrainConfig(steps=80, batch_rays=256, lr=5e-3)
    p0 = tngp.init_ngp(torch.Generator().manual_seed(0), T_CFG, device="cpu")
    before = tt.evaluate_psnr(p0, ds, T_CFG, T_RCFG, device="cpu")
    params, loss = tt.train_ngp(ds, T_CFG, T_RCFG, tcfg, device="cpu")
    after = tt.evaluate_psnr(params, ds, T_CFG, T_RCFG, device="cpu")
    assert np.isfinite(loss)
    assert after > before + 2.0, f"{before} -> {after}"
