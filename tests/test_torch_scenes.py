"""The port's procedural scenes and dataset against the JAX package on the
same inputs: SDF values (within 2.4e-7, colours exact), sphere-traced
ground truth (within 1e-4, and no pixel flips between hit and miss), the
dataset's arrays, and the training batches (equal)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nerf import dataset as jd
from repro.nerf import scenes as js
from repro_torch.convert import dataset_from_numpy
from repro_torch.nerf import dataset as td
from repro_torch.nerf import scenes as ts

SCENES = ("chair", "lego", "ficus")
# Ground-truth colours: the SDFs agree to a few ulp, and the central
# differences of the normals (h = 1e-3) scale that by ~1/h: measured
# 2.1e-5 at most over the three scenes.
GT_ATOL = 1e-4


def _scene_cfgs(name):
    kw = dict(name=name, image_hw=16, n_train_views=4, n_test_views=2)
    return js.SceneConfig(**kw), ts.SceneConfig(**kw)


@pytest.fixture(scope="module")
def datasets():
    out = {}
    for name in SCENES:
        jc, tc = _scene_cfgs(name)
        out[name] = (jd.make_dataset(jc), td.make_dataset(tc, device="cpu"))
    return out


@pytest.mark.parametrize("name", SCENES)
def test_sdf_values_match_reference(name):
    rng = np.random.RandomState(0)
    p = rng.uniform(-0.6, 0.6, size=(8192, 3)).astype(np.float32)
    j_sdf, j_rgb = js.make_scene(name)(jnp.asarray(p))
    t_sdf, t_rgb = ts.make_scene(name)(torch.from_numpy(p))
    np.testing.assert_allclose(t_sdf.numpy(), np.asarray(j_sdf), rtol=0,
                               atol=2.4e-7)
    np.testing.assert_array_equal(t_rgb.numpy(), np.asarray(j_rgb))


def test_unknown_scene_raises():
    with pytest.raises(KeyError, match="unknown scene"):
        ts.make_scene("drums")


def _margin(scene, o, d, n_steps=48, eps=2e-3):
    """Closest approach of each ray's traced SDF to the hit threshold."""
    t = torch.full((o.shape[0],), 0.05)
    hit = torch.zeros(o.shape[0], dtype=torch.bool)
    margin = torch.full((o.shape[0],), float("inf"))
    for _ in range(n_steps):
        sdf = scene(o + d * t[:, None])[0]
        margin = torch.minimum(margin, torch.abs(sdf - eps))
        hit = hit | (sdf < eps)
        t = t + torch.where(hit, 0.0, torch.clamp_min(sdf, 1e-3))
    return margin


@pytest.mark.parametrize("name", SCENES)
def test_render_ground_truth_matches_reference(name):
    """Every pixel of a train and a test view within GT_ATOL; a pixel that
    flips between hit and miss (sdf at the eps threshold) is counted and
    reported with its SDF margin, and none may flip."""
    jc, tc = _scene_cfgs(name)
    focal = tc.focal_mult * tc.image_hw
    scene = ts.make_scene(name)
    for pose in np.concatenate(ts.camera_poses(tc)[:2])[::3]:
        o, d = ts.camera_rays(pose, tc.image_hw, focal)
        want = np.asarray(js.render_ground_truth(
            js.make_scene(name), jnp.asarray(o.numpy()),
            jnp.asarray(d.numpy()), jc))
        got = ts.render_ground_truth(scene, o, d, tc).numpy()
        j_white = np.all(want == 1.0, axis=-1)
        t_white = np.all(got == 1.0, axis=-1)
        flips = np.nonzero(j_white != t_white)[0]
        if flips.size:
            pytest.fail(f"{flips.size} pixels flip between hit and miss; "
                        f"their traced SDF comes within "
                        f"{_margin(scene, o[flips], d[flips]).tolist()} of "
                        f"the hit threshold")
        np.testing.assert_allclose(got, want, rtol=0, atol=GT_ATOL)


@pytest.mark.parametrize("name", SCENES)
def test_make_dataset_arrays_match_reference(datasets, name):
    j, t = datasets[name]
    assert t.scene_name == j.scene_name and t.cfg == _scene_cfgs(name)[1]
    for field in ("train_rays_o", "test_rays_o"):
        np.testing.assert_array_equal(getattr(t, field), getattr(j, field))
    for field in ("train_rays_d", "test_rays_d"):  # one ulp of a unit vector
        np.testing.assert_allclose(getattr(t, field), getattr(j, field),
                                   rtol=0, atol=1.2e-7)
    for field in ("train_rgb", "test_rgb"):
        assert getattr(t, field).shape == getattr(j, field).shape
        np.testing.assert_allclose(getattr(t, field), getattr(j, field),
                                   rtol=0, atol=GT_ATOL)


def test_ray_batches_equal_reference(datasets):
    j = datasets["chair"][0]
    t = dataset_from_numpy(j)
    jb, tb = j.ray_batches(64, seed=3), t.ray_batches(64, seed=3)
    for _ in range(4):
        for a, b in zip(next(jb), next(tb)):
            np.testing.assert_array_equal(a, b)
