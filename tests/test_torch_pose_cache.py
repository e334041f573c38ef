"""The port's pose-grid plan cache and cull plans against the JAX
package's, on the same numpy inputs.

Held to: pose-cell keys, ray fingerprints, warp deviations, the margin
mask and the plans' compaction indices exactly equal; the plans' baked
trilinear weights within one float32 ulp and SH bases within 1e-6 (the
bands `tests/test_torch_field.py` holds the corner math and the SH basis
to: XLA contracts some products the port rounds apart); plan bytes
equal; the LRU, pin and drop policy step for step; and the port's plan
renders byte-equal to its march renders."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_shim import given, settings, st
from repro.nerf import fast_render as jfr
from repro.nerf import hash_encoding as jhe
from repro.nerf import ngp as jngp
from repro.nerf import occupancy as jocc
from repro.nerf import pose_cache as jpc
from repro.nerf.render import RenderConfig as JRenderConfig
from repro_torch.convert import params_from_numpy
from repro_torch.nerf import fast_render as tfr
from repro_torch.nerf import hash_encoding as the
from repro_torch.nerf import ngp as tngp
from repro_torch.nerf import occupancy as tocc
from repro_torch.nerf import pose_cache as tpc
from repro_torch.nerf.render import RenderConfig

RCFG = RenderConfig(n_samples=8, stratified=False)
J_RCFG = JRenderConfig(n_samples=8, stratified=False)
_HASH = dict(n_levels=4, log2_table_size=9, base_resolution=4,
             max_resolution=32)
_MLP = dict(hidden_dim=16, color_hidden_dim=16, geo_feat_dim=7, sh_degree=2)
J_CFG = jngp.NGPConfig(hash=jhe.HashEncodingConfig(**_HASH), **_MLP)
T_CFG = tngp.NGPConfig(hash=the.HashEncodingConfig(**_HASH), **_MLP)


def _occ(g=8, frac=0.4, seed=7):
    """The same random grid in both packages."""
    occ = (np.random.RandomState(seed).rand(g, g, g) < frac) \
        .astype(np.float32)
    return (jocc.OccupancyGrid(occ=jnp.asarray(occ), resolution=g,
                               threshold=0.0, occupied_fraction=frac),
            tocc.OccupancyGrid(occ=torch.from_numpy(occ), resolution=g,
                               threshold=0.0, occupied_fraction=frac))


def _rays(n=8, seed=0):
    rng = np.random.RandomState(seed)
    ro = rng.uniform(-0.35, 0.35, size=(n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


# ---------------------------------------------------------------------------
# Keys, fingerprints, deviations: identical to the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_pose_cell_key_fingerprint_and_deviation_equal_reference(seed):
    ro, rd = _rays(n=64, seed=seed)
    for cells in ((0.05, 0.05), (0.013, 0.2)):
        got = tpc.pose_cell_key(ro, rd, *cells)
        assert got == jpc.pose_cell_key(ro, rd, *cells)
        assert all(isinstance(v, int) for v in got) and len(got) == 9
        assert tpc.pose_cell_key(ro.reshape(8, 8, 3), rd.reshape(8, 8, 3),
                                 *cells) == got
    assert tpc.ray_fingerprint(ro, rd) == jpc.ray_fingerprint(ro, rd)
    ro2 = ro.copy()
    ro2[3, 1] += np.float32(1e-6)
    assert tpc.ray_fingerprint(ro2, rd) != tpc.ray_fingerprint(ro, rd)
    rng = np.random.RandomState(seed + 10)
    ro_j = ro + rng.uniform(-1e-3, 1e-3, ro.shape).astype(np.float32)
    rd_j = rd + rng.uniform(-1e-3, 1e-3, rd.shape).astype(np.float32)
    for args in ((ro_j, rd_j, ro, rd), (ro, rd, ro, rd),
                 (ro_j[:4], rd_j[:4], ro, rd)):
        assert tpc.warp_deviation(*args, RCFG) \
            == jpc.warp_deviation(*args, J_RCFG)
    assert tpc.warp_deviation(ro[:4], rd[:4], ro, rd, RCFG) == float("inf")
    assert tpc.PoseGridConfig() == tpc.PoseGridConfig(
        **vars(jpc.PoseGridConfig()))


# ---------------------------------------------------------------------------
# The margin mask: equal to the reference's, and a superset of the exact
# mask of any rays within the margin
# ---------------------------------------------------------------------------
@settings(max_examples=20, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000),
       frac=st.floats(min_value=0.05, max_value=0.95))
def test_margin_mask_equals_reference_and_covers_jittered_exact(seed, frac):
    rng = np.random.RandomState(seed)
    j_occ, t_occ = _occ(g=8, frac=frac, seed=seed)
    ro, rd = _rays(n=8, seed=seed + 1)
    margin = tpc.PoseGridConfig().margin(t_occ)
    cons, pts = tocc.sample_active_mask(t_occ, ro, rd, RCFG, margin=margin)
    j_cons, j_pts = jocc.sample_active_mask(j_occ, ro, rd, J_RCFG,
                                            margin=margin)
    np.testing.assert_array_equal(cons, j_cons)
    np.testing.assert_array_equal(pts, j_pts)
    t_far = max(abs(RCFG.near), abs(RCFG.far))
    d_o, d_d = margin * 0.5, (margin * 0.5) / t_far
    ro_j = ro + rng.uniform(-d_o, d_o, ro.shape).astype(np.float32)
    rd_j = rd + rng.uniform(-d_d, d_d, rd.shape).astype(np.float32)
    assert tpc.warp_deviation(ro_j, rd_j, ro, rd, RCFG) <= margin + 1e-6
    exact_j, _ = tocc.sample_active_mask(t_occ, ro_j, rd_j, RCFG)
    assert np.all(cons | ~exact_j)
    exact, _ = tocc.sample_active_mask(t_occ, ro, rd, RCFG)
    assert np.all(cons | ~exact) and cons.sum() >= exact.sum()


# ---------------------------------------------------------------------------
# Plans: the reference's indices, bytes and shapes
# ---------------------------------------------------------------------------
def _assert_baked_equal(t_idx, t_w, t_sh, j_idx, j_w, j_sh):
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    assert t_idx.dtype == torch.int32 and t_w.dtype == torch.float32
    j_w = np.asarray(j_w)
    np.testing.assert_array_max_ulp(t_w.numpy(), j_w, maxulp=1)
    np.testing.assert_allclose(t_sh.numpy(), np.asarray(j_sh), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("seed", [3, 11])
def test_build_warp_plan_equals_reference(seed):
    j_occ, t_occ = _occ(seed=seed)
    ro, rd = _rays(n=16, seed=seed)
    margin = 1.0 / t_occ.resolution
    got = tpc.build_warp_plan(t_occ, ro, rd, RCFG, T_CFG, margin)
    want = jpc.build_warp_plan(j_occ, ro, rd, J_RCFG, J_CFG, margin)
    assert got.budget == want.budget and got.budget % 128 == 0
    assert got.fp == want.fp and got.margin == want.margin
    np.testing.assert_array_equal(got.ref_o, want.ref_o)
    np.testing.assert_array_equal(got.ref_d, want.ref_d)
    for a, b in ((got.take, want.take), (got.inv_take, want.inv_take),
                 (got.valid_cons, want.valid_cons)):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for i in range(4):  # buf_pts, buf_dirs, take, valid_exact
        a, b = got.plan_row[i].numpy(), np.asarray(want.plan_row[i])
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    _assert_baked_equal(*got.plan_row[4:], *want.plan_row[4:])
    assert got.nbytes == want.nbytes
    cons, exact = got.valid_cons.numpy(), got.plan_row[3].numpy()
    assert np.all(cons | ~exact)
    idx = np.nonzero(cons)[0]
    np.testing.assert_array_equal(got.inv_take.numpy()[got.take.numpy()[idx]],
                                  idx)


def test_build_cull_plan_equals_reference():
    j_occ, t_occ = _occ(seed=5)
    ro = np.stack([_rays(n=16, seed=s)[0] for s in (1, 2)])
    rd = np.stack([_rays(n=16, seed=s)[1] for s in (1, 2)])
    mask = np.ones((2, 16, 1), np.float32)
    mask[1, 12:] = 0.0
    got = tfr.build_cull_plan(t_occ, ro, rd, mask, RCFG, T_CFG)
    want = jfr.build_cull_plan(j_occ, ro, rd, mask, J_RCFG, J_CFG)
    assert got.budget == want.budget
    for name in ("buf_pts", "buf_dirs", "take", "valid"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)
    _assert_baked_equal(got.hash_idx, got.hash_w, got.sh, want.hash_idx,
                        want.hash_w, want.sh)


# ---------------------------------------------------------------------------
# Plan renders: byte-equal to the march inside the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def field():
    """A tiny integer-mode field (all five linears int) with the grid."""
    params = jngp.init_ngp(jax.random.PRNGKey(1), J_CFG)
    params["hash"] = {k: v * 1e3 for k, v in params["hash"].items()}
    tp = params_from_numpy({k: {n: np.asarray(v) for n, v in sub.items()}
                            for k, sub in params.items()}, "cpu")
    ro, rd = _rays(n=64, seed=4)
    pts = torch.from_numpy(np.clip(ro + 0.3 * rd + 0.5, 0, 1))
    _, _, taps = tngp.ngp_apply(tp, pts, torch.from_numpy(rd), T_CFG, None,
                                return_taps=True)
    spec = tngp.NGPQuantSpec(
        hash_bits=torch.full((4,), 6.0), weight_bits=torch.full((5,), 4.0),
        act_bits=torch.full((5,), 8.0),
        act_ranges=torch.tensor([[float(taps[n].min()), float(taps[n].max())]
                                 for n in tngp.ngp_linear_names(T_CFG)]))
    pack = tfr.build_fused_pack(tp, T_CFG, spec)
    assert pack.modes == ("int",) * 5
    _, t_occ = _occ(seed=9, frac=0.6)
    return tp, spec, pack, t_occ


def test_plan_render_byte_equal_to_march(field):
    params, spec, pack, occ = field
    ro, rd = _rays(n=64, seed=6)
    plan = tfr.build_cull_plan(occ, ro[None], rd[None], None, RCFG, T_CFG)
    for mode in ("fused", "reference"):
        march = tfr.fast_render_rays(params, torch.from_numpy(ro),
                                     torch.from_numpy(rd), T_CFG, RCFG, spec,
                                     occ, mode, pack)
        planned = tfr.fast_render_rays(params, torch.from_numpy(ro),
                                       torch.from_numpy(rd), T_CFG, RCFG,
                                       spec, occ, mode, pack, plan=plan)
        for a, b in zip(planned, march):
            assert torch.equal(a, b), mode


def test_slot_tiers_byte_equal_on_the_same_rays(field):
    """hit (the plan row), warp (a nearby pose's conservative indices) and
    march give the same bits for the same rays; warp of jittered rays
    equals the march of those rays."""
    params, spec, pack, occ = field
    ro, rd = _rays(n=64, seed=8)
    margin = tpc.PoseGridConfig().margin(occ)
    plan = tpc.build_warp_plan(occ, ro, rd, RCFG, T_CFG, margin)
    args = (params, pack, spec, occ)
    kw = dict(cfg=T_CFG, rcfg=RCFG, mode="fused", early_stop=True)
    for o in (ro, ro + np.float32(0.3 * margin)):
        o_t, d_t = torch.from_numpy(o), torch.from_numpy(rd)
        assert tpc.warp_deviation(o, rd, plan.ref_o, plan.ref_d, RCFG) \
            <= margin
        march, need = tfr.slot_march(*args, o_t, d_t, T_CFG, RCFG, "fused",
                                     None, True)
        warp = tfr.slot_warp(*args, o_t, d_t, plan.inv_take, plan.take,
                             plan.valid_cons, **kw)
        assert int(need) > 0
        assert torch.equal(warp, march)
        if o is ro:
            hit = tfr.slot_plan(*args, o_t, d_t, plan.plan_row, **kw)
            assert torch.equal(hit, march)


# ---------------------------------------------------------------------------
# PosePlanCache: the reference's policy, step for step
# ---------------------------------------------------------------------------
def test_pose_cache_lru_and_use_counts():
    c = tpc.PosePlanCache(max_entries=2)
    a, b, d = ("s", 1), ("s", 2), ("s", 3)
    assert c.note_use(a).uses == 1
    assert c.note_use(a).uses == 2
    c.note_use(b)
    c.note_use(a)  # a is MRU
    c.note_use(d)  # capacity 2 -> b (LRU) evicted
    assert c.get(b) is None and c.get(a) is not None and c.get(d) is not None
    assert c.stats()["evictions"] == 1
    assert len(c) == 2


def test_pose_cache_never_evicts_pinned_and_drops_scenes():
    c = tpc.PosePlanCache(max_entries=1)
    a, b, d = ("s", 1), ("s", 2), ("s", 3)
    c.note_use(a)
    c.pin(a)
    c.note_use(b)  # a pinned: over capacity, b evicts nothing
    assert c.get(a) is not None
    c.note_use(d)  # b unpinned and LRU -> evicted
    assert c.get(b) is None and c.get(a) is not None
    c.pin(a)
    c.unpin(a)
    assert c.pinned(a)
    c.unpin(a)
    assert not c.pinned(a)
    c.note_use(("s", 4))
    c.note_use(("s", 5))
    assert c.get(a) is None
    c = tpc.PosePlanCache(max_entries=8)
    for k in (("a", 1), ("a", 2), ("b", 1)):
        c.note_use(k)
    c.pin(("a", 1))
    assert c.drop_scene("a") == 2
    assert c.get(("a", 1)) is None and c.get(("b", 1)) is not None
    assert c.stats()["cells"] == 1


@pytest.mark.parametrize("seed", range(3))
def test_pose_cache_policy_trace_equals_reference(seed):
    """A random run of uses, pins, unpins, plan puts and scene drops leaves
    both caches with the same cells, use counts, pins and stats after
    every operation."""
    j_occ, t_occ = _occ(seed=seed)
    ro, rd = _rays(n=4, seed=seed)
    plans = (tpc.build_warp_plan(t_occ, ro, rd, RCFG, T_CFG, 0.125),
             jpc.build_warp_plan(j_occ, ro, rd, J_RCFG, J_CFG, 0.125))
    caches = (tpc.PosePlanCache(max_entries=3),
              jpc.PosePlanCache(max_entries=3))
    rng = np.random.RandomState(seed)
    for _ in range(60):
        op = rng.randint(5)
        key = (rng.choice(["a", "b"]), int(rng.randint(6)))
        for c, plan in zip(caches, plans):
            if op == 0 or op == 1:
                c.note_use(key)
            elif op == 2:
                c.pin(key)
            elif op == 3:
                c.put_plan(key, 0, plan)
            else:
                c.unpin(key)
        if rng.rand() < 0.05:
            assert caches[0].drop_scene("a") == caches[1].drop_scene("a")
        t, j = caches
        assert t.stats() == j.stats()
        assert [(k, e.uses, sorted(e.plans)) for k, e in t._entries.items()] \
            == [(k, e.uses, sorted(e.plans)) for k, e in j._entries.items()]
        assert t._pins == j._pins
