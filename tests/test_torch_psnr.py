"""The PSNR half of the reward: the port's `evaluate_psnr` against the JAX
package's on the same trained parameters, dataset and occupancy grid
(carried across as numpy arrays), within 1e-3 dB (ROADMAP §1 item 2's
gate), in reference mode, and in fused mode under the test set's cull
plan and under an explicit budget (the march); and the port-internal
0.1 dB band of fused against reference mode on a scene the port trained.

The grid is baked at a density threshold of 1.0, which culls 63 % of the
cells of this briefly trained scene (at the engine's 1e-2 the grid is
still full after 60 steps), so the plans and the march drop samples."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nerf import dataset as jd
from repro.nerf import fast_render as jfr
from repro.nerf import ngp as jngp
from repro.nerf import occupancy as jocc
from repro.nerf import scenes as js
from repro.nerf import train as jt
from repro.quant.policy import QuantPolicy as JQuantPolicy
from repro_torch.convert import dataset_from_numpy, params_from_numpy
from repro_torch.nerf import fast_render as tfr
from repro_torch.nerf import ngp as tngp
from repro_torch.nerf import occupancy as tocc
from repro_torch.nerf import train as tt
from repro_torch.quant.policy import QuantPolicy as TQuantPolicy
from test_torch_train import J_CFG, J_RCFG, KIND_BITS, T_CFG, T_RCFG

PSNR_ATOL_DB = 1e-3
BAND_DB = 0.1
CULL_THRESHOLD = 1.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny shapes gain nothing from more, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """(reference params, reference dataset, the port's dataset)."""
    j_ds = jd.make_dataset(js.SceneConfig(image_hw=16, n_train_views=4,
                                          n_test_views=2))
    jp, _ = jt.train_ngp(j_ds, J_CFG, J_RCFG,
                         jt.TrainConfig(steps=60, batch_rays=256))
    return jp, j_ds, dataset_from_numpy(j_ds)


@pytest.fixture(scope="module")
def grids(scene):
    jp = scene[0]
    jg = jocc.bake_occupancy(jp, J_CFG, resolution=16,
                             threshold=CULL_THRESHOLD)
    assert 0.0 < jg.occupied_fraction < 0.5
    tg = tocc.OccupancyGrid(occ=torch.from_numpy(np.asarray(jg.occ)),
                            resolution=jg.resolution,
                            threshold=jg.threshold,
                            occupied_fraction=jg.occupied_fraction)
    return jg, tg


def _specs(jp, j_ds, kind):
    """None, or the mixed policy with ranges from the reference field's
    taps on 64 train rays' samples (as the episode calibrates)."""
    if kind == "none":
        return None, None
    idx = np.random.RandomState(0).randint(0, j_ds.train_rays_o.shape[0], 64)
    t = np.linspace(0.2, 2.5, 16)
    pts = j_ds.train_rays_o[idx][:, None] + j_ds.train_rays_d[idx][:, None] \
        * t[None, :, None]
    pts = np.clip(pts + 0.5, 0.0, 1.0).reshape(-1, 3).astype(np.float32)
    dirs = np.repeat(j_ds.train_rays_d[idx], 16, axis=0)
    _, _, taps = jngp.ngp_apply(jp, jnp.asarray(pts), jnp.asarray(dirs),
                                J_CFG, None, return_taps=True)
    ranges = np.asarray([[float(jnp.min(taps[n])), float(jnp.max(taps[n]))]
                         for n in jngp.ngp_linear_names(J_CFG)], np.float32)
    ju, tu = jngp.make_quant_units(J_CFG), tngp.make_quant_units(T_CFG)
    bits = [KIND_BITS[u.kind.name] for u in ju]
    return (jngp.spec_from_policy(J_CFG, JQuantPolicy.uniform(ju, 8)
                                  .with_bits(bits), jnp.asarray(ranges)),
            tngp.spec_from_policy(T_CFG, TQuantPolicy.uniform(tu, 8)
                                  .with_bits(bits), torch.from_numpy(ranges)))


CASES = [  # (mode, spec, grid, budget)
    ("reference", "none", False, None),
    ("reference", "mixed", False, None),
    ("reference", "mixed", True, None),
    ("fused", "none", True, None),
    ("fused", "mixed", True, None),
    ("fused", "mixed", True, 2048),
]


@pytest.mark.parametrize("mode,spec_kind,with_grid,budget", CASES)
def test_evaluate_psnr_matches_reference(scene, grids, mode, spec_kind,
                                         with_grid, budget):
    jp, j_ds, t_ds = scene
    jspec, tspec = _specs(jp, j_ds, spec_kind)
    jg, tg = grids if with_grid else (None, None)
    want = jt.evaluate_psnr(jp, j_ds, J_CFG, J_RCFG, jspec, occ=jg,
                            mode=mode, budget=budget)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    got = tt.evaluate_psnr(tp, t_ds, T_CFG, T_RCFG, tspec, occ=tg, mode=mode,
                           budget=budget, device="cpu")
    assert abs(got - want) <= PSNR_ATOL_DB, (got, want)


def test_plan_budget_frame_se_and_staging_match_reference(scene, grids):
    """The cull plan's budget equals the reference's, each view's masked
    squared error agrees, and a second evaluation reuses the staged test
    set and plan (no restaging, same PSNR)."""
    jp, j_ds, t_ds = scene
    jg, tg = grids
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    je = jfr.FastRenderEngine(jp, J_CFG, J_RCFG, occ=jg, mode="fused")
    te = tfr.FastRenderEngine(tp, T_CFG, T_RCFG, occ=tg, mode="fused",
                              device="cpu")
    assert te.test_views_budget(t_ds) == je.test_views_budget(j_ds)
    assert te.test_views_budget(t_ds) < 16 * 512  # culling drops samples
    for v in range(t_ds.test_rays_o.shape[0]):
        args = (t_ds.test_rays_o[v], t_ds.test_rays_d[v], t_ds.test_rgb[v])
        np.testing.assert_allclose(float(te.frame_se(*args)),
                                   float(je.frame_se(*args)), rtol=1e-5)
    first = te.evaluate_psnr(t_ds)
    staged = tfr._stage_test_set(t_ds, te.chunk, te.device)
    plan = tfr._test_set_plan(t_ds, tg, te.rcfg, te.chunk, T_CFG)
    assert te.evaluate_psnr(t_ds) == first
    assert tfr._stage_test_set(t_ds, te.chunk, te.device) is staged
    assert tfr._test_set_plan(t_ds, tg, te.rcfg, te.chunk, T_CFG) is plan
    # A copy of the arrays is another test set: staged anew.
    other = dataclasses.replace(t_ds, test_rays_o=t_ds.test_rays_o.copy())
    assert tfr._stage_test_set(other, te.chunk, te.device) is not staged


def test_fused_frames_against_the_reference_float_carrier(scene, grids):
    """ROADMAP §3's float carrier reaches the fused PSNR evaluation: off
    the TPU the reference runs the fused `int` mode on a float carrier,
    the port on the integer path. Under the mixed policy with culling the
    frames agree within 1e-6 (measured 1.2e-7, on 125 of a view's 768
    values), which keeps the PSNR within its 1e-3 dB gate."""
    jp, j_ds, t_ds = scene
    jg, tg = grids
    jspec, tspec = _specs(jp, j_ds, "mixed")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    je = jfr.FastRenderEngine(jp, J_CFG, J_RCFG, spec=jspec, occ=jg,
                              mode="fused")
    te = tfr.FastRenderEngine(tp, T_CFG, T_RCFG, spec=tspec, occ=tg,
                              mode="fused", device="cpu")
    for v in range(t_ds.test_rays_o.shape[0]):
        ro, rd = t_ds.test_rays_o[v], t_ds.test_rays_d[v]
        np.testing.assert_allclose(te.render_frame(ro, rd).numpy(),
                                   np.asarray(je.render_frame(ro, rd)),
                                   rtol=0, atol=1e-6)


def test_render_test_view_matches_reference(scene, grids):
    jp, j_ds, t_ds = scene
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    want = jt.render_test_view(jp, j_ds, J_CFG, J_RCFG, view=1)
    got = tt.render_test_view(tp, t_ds, T_CFG, T_RCFG, view=1, device="cpu")
    assert got.shape == want.shape == (16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_fused_psnr_within_band_on_a_scene_the_port_trained():
    """Port-internal: fused within 0.1 dB of reference mode, unquantized
    and at 8 bits everywhere: with the engine's grid (threshold 1e-2)
    against no grid, as the reference's
    `test_trained_psnr_parity_within_acceptance_band` asks, and with the
    culling grid in both modes."""
    from repro_torch.nerf import dataset as td
    from repro_torch.nerf import scenes as ts

    ds = td.make_dataset(ts.SceneConfig(name="lego", image_hw=16,
                                        n_train_views=4, n_test_views=2),
                         device="cpu")
    params, _ = tt.train_ngp(ds, T_CFG, T_RCFG,
                             tt.TrainConfig(steps=80, batch_rays=256),
                             device="cpu")
    engine_grid = tocc.bake_occupancy(params, T_CFG, resolution=16)
    culling = tocc.bake_occupancy(params, T_CFG, resolution=16,
                                  threshold=CULL_THRESHOLD)
    assert culling.occupied_fraction < 0.9
    for bits in (None, 8):
        spec = None if bits is None else tngp.uniform_quant_spec(
            T_CFG, bits, device="cpu")
        for ref_grid, grid in ((None, engine_grid), (culling, culling)):
            ref = tt.evaluate_psnr(params, ds, T_CFG, T_RCFG, spec,
                                   occ=ref_grid, device="cpu")
            fused = tt.evaluate_psnr(params, ds, T_CFG, T_RCFG, spec,
                                     occ=grid, mode="fused", device="cpu")
            assert abs(fused - ref) < BAND_DB, (bits, fused, ref)
