"""The port's optimizer substrate and QAT helpers against the JAX
package on the same numpy inputs: AdamW (decay and no decay by path,
within 1e-6 after three steps), global-norm clipping (1e-6), the LR
schedules (1e-6), `fake_quant_params_tree` (exact) and the calibrators
(the minmax ranges exact, the percentile ones within 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.quant import calibration as jcal
from repro.quant import qat as jqat
from repro_torch import optim as topt
from repro_torch.convert import adamw_state_from_numpy, params_from_numpy
from repro_torch.quant import calibration as tcal
from repro_torch.quant import qat as tqat
from repro_torch.tree_util import leaves_with_path


def _tree(seed=0):
    """An NGP-shaped params tree plus leaves whose paths hit each
    no-decay substring."""
    rng = np.random.RandomState(seed)

    def a(*shape):
        return rng.normal(size=shape).astype(np.float32)
    return {"hash": {"level_0": a(40, 2), "level_1": a(64, 2)},
            "sigma/0": {"w": a(8, 16), "b": a(16)},
            "color/2": {"w": a(16, 3), "b": a(3)},
            "norm": {"scale": a(5)}, "proj": {"bias": a(4)},
            "lm": {"scale_param": a(3)}}


def _cmp(t_tree, j_tree, atol):
    j = {"/".join(str(p.key) for p in k): np.asarray(v)
         for k, v in jax.tree_util.tree_flatten_with_path(j_tree)[0]}
    t = dict(leaves_with_path(t_tree))
    assert sorted(t) == sorted(j)
    for name, v in j.items():
        np.testing.assert_allclose(t[name].numpy(), v, rtol=0, atol=atol,
                                   err_msg=name)


def test_leaf_paths_are_the_reference_path_strings():
    tree = _tree()
    j = ["/".join(str(p.key) for p in k)
         for k, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [p for p, _ in leaves_with_path(tree)] == j
    assert "sigma/0/b" in j and "hash/level_1" in j


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_reference(weight_decay):
    """Three updates from the same state; with decay, exactly the leaves
    whose path holds no no-decay substring are decayed (the NGP biases
    and tables included, as in the reference)."""
    params, cfg_kw = _tree(0), dict(lr=1e-2, weight_decay=weight_decay)
    jp, tp = params, params_from_numpy(params, device="cpu")
    js = jopt.adamw_init(jp)
    ts = adamw_state_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                                device="cpu")
    for step in range(3):
        g = _tree(10 + step)
        jp, js = jopt.adamw_update(g, js, jp, jopt.AdamWConfig(**cfg_kw))
        tp, ts = topt.adamw_update(params_from_numpy(g, device="cpu"), ts,
                                   tp, topt.AdamWConfig(**cfg_kw))
    assert int(ts.step) == int(js.step) == 3
    _cmp(tp, jp, 1e-6)
    _cmp(ts.mu, js.mu, 1e-6)
    _cmp(ts.nu, js.nu, 1e-6)
    if weight_decay:
        # One step with decay against one without, from the same state:
        # exactly the decayed leaves differ.
        p0 = params_from_numpy(params, device="cpu")
        g = params_from_numpy(_tree(10), device="cpu")
        st = topt.adamw_init(p0)
        plain, _ = topt.adamw_update(g, st, p0, topt.AdamWConfig(lr=1e-2))
        decayed, _ = topt.adamw_update(g, st, p0, topt.AdamWConfig(**cfg_kw))
        moved = {p: bool((a != b).any()) for (p, a), (_, b)
                 in zip(leaves_with_path(decayed), leaves_with_path(plain))}
        assert moved == {p: not any(s in p for s in ("bias", "norm",
                                                     "scale_param"))
                         for p in moved}
        assert moved["sigma/0/b"] and moved["hash/level_0"]


@pytest.mark.parametrize("max_norm", [1e-3, 10.0, 1e6])
def test_clip_by_global_norm_matches_reference(max_norm):
    tree = _tree(4)
    j_clip, j_norm = jopt.clip_by_global_norm(tree, max_norm)
    t_clip, t_norm = topt.clip_by_global_norm(
        params_from_numpy(tree, device="cpu"), max_norm)
    np.testing.assert_allclose(float(t_norm), float(j_norm), rtol=1e-6)
    _cmp(t_clip, j_clip, 1e-6)


@pytest.mark.parametrize("name,args", [
    ("constant_schedule", ()), ("cosine_schedule", (50, 0.1)),
    ("linear_warmup_cosine", (10, 50, 0.1)), ("exponential_decay", (20, 0.5)),
])
def test_schedules_match_reference(name, args):
    steps = np.arange(0, 70, dtype=np.int32)
    want = np.asarray(jax.vmap(getattr(jopt, name)(*args))(jnp.asarray(steps)))
    got = getattr(topt, name)(*args)(torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_ranges", [False, True])
def test_fake_quant_params_tree_matches_reference(with_ranges):
    tree = _tree(5)

    def bits_fn(name):
        return {"hash/level_0": 6, "sigma/0/w": 4, "color/2/w": 3,
                "proj/bias": 16}.get(name, 0)
    ranges = {"sigma/0/w": (-1.5, 2.0)} if with_ranges else None
    want = jqat.fake_quant_params_tree(tree, bits_fn, ranges)
    got = tqat.fake_quant_params_tree(params_from_numpy(tree, device="cpu"),
                                      bits_fn, ranges)
    _cmp(got, want, 0.0)
    t = dict(leaves_with_path(got))
    np.testing.assert_array_equal(t["proj/bias"].numpy(),
                                  tree["proj"]["bias"])


def test_calibrators_match_reference():
    rng = np.random.RandomState(6)
    x = rng.standard_t(3, size=(4096,)).astype(np.float32)
    jlo, jhi = jcal.calibrate_minmax(jnp.asarray(x))
    tlo, thi = tcal.calibrate_minmax(torch.from_numpy(x))
    assert (float(tlo), float(thi)) == (float(jlo), float(jhi))
    jlo, jhi = jcal.calibrate_percentile(jnp.asarray(x), 99.0)
    tlo, thi = tcal.calibrate_percentile(torch.from_numpy(x), 99.0)
    np.testing.assert_allclose([float(tlo), float(thi)],
                               [float(jlo), float(jhi)], rtol=1e-6)
    for mode in ("minmax", "percentile"):
        jc, tc = jcal.Calibrator(mode), tcal.Calibrator(mode)
        for i in range(3):
            b = rng.normal(size=(256, 8)).astype(np.float32) * (i + 1)
            jc.observe("a", jnp.asarray(b))
            tc.observe("a", torch.from_numpy(b))
            jc.observe("b", b[:, :2])
            tc.observe("b", b[:, :2])
        assert tc.ranges().keys() == jc.ranges().keys()
        for k, v in jc.ranges().items():
            np.testing.assert_allclose(tc.ranges()[k], v, rtol=1e-6)
    with pytest.raises(ValueError, match="unknown calibration mode"):
        tcal.Calibrator("mse")
