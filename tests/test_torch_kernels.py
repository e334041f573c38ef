"""The port's plain kernel versions against the JAX package's Pallas
kernels (interpret mode, as its own tests run them on the CPU) and its
`ref.*_ref` oracles, on the same numpy inputs.

Tolerances: the integer matmul, the gather and the march mask are exact
(the reference is exact); compositing is float, within 1e-6 of the dense
walk, and within t_eps (+1e-6) of the Pallas early-stop walk. The fused
gather-composite's plain version is bit-equal to the composition it
replaced in the renderer, on each serve tier's inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.repack import repack_tile_native as j_repack
from repro.nerf import occupancy as jocc
from repro.nerf.render import RenderConfig as JRenderConfig
from repro.quant.packing import pack_codes as j_pack_codes
from repro_torch.convert import packed_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.nerf import occupancy as tocc
from repro_torch.nerf.render import RenderConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# quant_matmul_packed: exact, bits 1-8, both layouts, ragged M/K/N
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("layout", ["planar", "tile:128"])
def test_quant_matmul_packed_exact(bits, layout):
    rng = np.random.RandomState(bits)
    m, k, n = 37, 45, 5
    x = rng.randint(-128, 128, size=(m, k)).astype(np.int8)
    q = rng.randint(-(2 ** (bits - 1)) - 1, 2 ** (bits - 1), size=(k, n))
    jw = j_pack_codes(q, bits, scale=0.011)
    if layout != "planar":
        jw = j_repack(jw, 128)
    tw = packed_from_numpy(jw, device="cpu")
    assert tw.layout == layout
    for zx in (17, 128):
        got = tops.quant_matmul_packed(_t(x), tw, 0.037, tw.scale, zx)
        pallas = jops.quant_matmul_packed(jnp.asarray(x), jw, 0.037, jw.scale,
                                          zx, use_pallas=True)
        oracle = jref.quant_matmul_packed_ref(jnp.asarray(x), jw, 0.037,
                                              jw.scale, zx)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
        np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))
        assert got.dtype == torch.float32 and got.shape == (m, n)


def test_quant_matmul_packed_ref_name_is_the_plain_version():
    rng = np.random.RandomState(0)
    x = _t(rng.randint(-128, 128, size=(9, 33)).astype(np.int8))
    w = packed_from_numpy(j_pack_codes(rng.randint(-8, 8, (33, 4)), 4),
                          device="cpu")
    np.testing.assert_array_equal(
        tref.quant_matmul_packed_ref(x, w, 0.5, w.scale, 3).numpy(),
        tops.quant_matmul_packed(x, w, 0.5, w.scale, 3).numpy())


# ---------------------------------------------------------------------------
# hash_gather: exact, out-of-range rows give zeros (as the Pallas kernel)
# ---------------------------------------------------------------------------
def test_hash_gather_exact_with_out_of_range_rows():
    rng = np.random.RandomState(1)
    T, F, P = 300, 2, 200
    table = rng.normal(size=(T, F)).astype(np.float32)
    idx = rng.randint(0, T, size=P).astype(np.int32)
    idx[:6] = [-1, -300, T, T + 7, 0, T - 1]
    got = tops.hash_gather(_t(idx), _t(table)).numpy()
    pallas = np.asarray(jops.hash_gather(jnp.asarray(idx), jnp.asarray(table),
                                         use_pallas=True))
    np.testing.assert_array_equal(got, pallas)
    assert not got[:4].any()  # out of range -> zero rows
    ok = (idx >= 0) & (idx < T)
    oracle = np.asarray(jref.hash_gather_ref(jnp.asarray(idx[ok]),
                                             jnp.asarray(table)))
    np.testing.assert_array_equal(got[ok], oracle)


# ---------------------------------------------------------------------------
# ray_march: exact, cell-face and box-face points, degenerate rays
# ---------------------------------------------------------------------------
def _march_inputs(G=8, R=48, seed=2):
    rng = np.random.RandomState(seed)
    occ = (rng.uniform(size=(G, G, G)) < 0.5).astype(np.float32)
    o = rng.uniform(-1.2, 1.2, size=(R, 3)).astype(np.float32)
    d = (rng.uniform(-0.4, 0.4, size=(R, 3)) - o).astype(np.float32)
    faces = (np.arange(G + 1) / G - 0.5).astype(np.float32)
    for i in range(16):  # two coordinates pinned on cell or box faces
        ax = i % 3
        o[i] = faces[rng.randint(0, G + 1, size=3)]
        o[i, ax] = -1.5 if i % 2 else 1.5
        d[i] = 0.0
        d[i, ax] = 1.0 if i % 2 else -1.0
    d[16:20] = 0.0  # degenerate: zero direction, inside and outside
    o[16:18] = [[0.1, -0.2, 0.3], [0.5, 0.0, 0.0]]
    n = np.linalg.norm(d, axis=-1, keepdims=True)
    d = np.where(n > 0, d / np.where(n > 0, n, 1.0), 0.0).astype(np.float32)
    t = jocc.ray_t_samples(JRenderConfig(n_samples=16))
    return occ, o, d, t


@pytest.mark.parametrize("early_stop", [True, False])
def test_ray_march_exact_against_reference_and_host_oracle(early_stop):
    occ, o, d, t = _march_inputs()
    got = tops.ray_march(_t(occ), _t(o), _t(d), _t(t), early_stop).numpy()
    pallas = np.asarray(jops.ray_march(
        jnp.asarray(occ), jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
        use_pallas=True, early_stop=early_stop))
    oracle = np.asarray(jref.ray_march_ref(jnp.asarray(occ), jnp.asarray(o),
                                           jnp.asarray(d), jnp.asarray(t)))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, oracle)
    grid = tocc.OccupancyGrid(occ=_t(occ), resolution=occ.shape[0],
                              threshold=0.5,
                              occupied_fraction=float(occ.mean()))
    host, _ = tocc.sample_active_mask(grid, o, d, RenderConfig(n_samples=16))
    np.testing.assert_array_equal(got > 0.5, host)
    assert 0 < got.sum() < got.size
    assert not got[16:18].any() or occ.any()


def test_ray_t_samples_and_occupancy_lookup_equal_reference():
    rc = RenderConfig(n_samples=19, near=0.13, far=2.7)
    jt = jocc.ray_t_samples(JRenderConfig(n_samples=19, near=0.13, far=2.7))
    assert tocc.ray_t_samples(rc).tobytes() == jt.tobytes()
    occ, o, d, t = _march_inputs(seed=5)
    pts = np.clip(o[:, None] + d[:, None] * t[None, :, None] + 0.5, 0, 1)
    jg = jocc.OccupancyGrid(occ=jnp.asarray(occ), resolution=8,
                            threshold=0.5, occupied_fraction=0.5)
    tg = tocc.OccupancyGrid(occ=_t(occ), resolution=8, threshold=0.5,
                            occupied_fraction=0.5)
    np.testing.assert_array_equal(
        tocc.occupancy_lookup(tg, _t(pts)).numpy(),
        np.asarray(jocc.occupancy_lookup(jg, jnp.asarray(pts))))
    r = JRenderConfig(n_samples=16)
    assert tocc.cull_budget(tg, o, d, RenderConfig(n_samples=16), 16) == \
        jocc.cull_budget(jg, o, d, r, 16)


# ---------------------------------------------------------------------------
# alpha_composite: 1e-6 dense; the t_eps band with early stop
# ---------------------------------------------------------------------------
def _composite_inputs(R=40, S=24, seed=3):
    rng = np.random.RandomState(seed)
    scale = rng.choice([0.0, 0.3, 3.0, 400.0], size=(R, 1))
    sigma = (rng.exponential(1.0, size=(R, S)) * scale).astype(np.float32)
    delta = rng.uniform(0.01, 0.1, size=(R, S)).astype(np.float32)
    delta[:, -1] = 1e10
    rgb = rng.uniform(size=(R, S, 3)).astype(np.float32)
    return sigma, rgb, delta


def test_alpha_composite_dense_within_1e6():
    sigma, rgb, delta = _composite_inputs()
    c, a = tops.alpha_composite(_t(sigma), _t(rgb), _t(delta))
    for jc, ja in (
        jref.alpha_composite_ref(jnp.asarray(sigma), jnp.asarray(rgb),
                                 jnp.asarray(delta)),
        jops.alpha_composite(jnp.asarray(sigma), jnp.asarray(rgb),
                             jnp.asarray(delta), use_pallas=True),
    ):
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0,
                                   atol=1e-6)
    assert c.shape == (40, 3) and a.shape == (40, 1)


def test_alpha_composite_early_stop_within_t_eps():
    sigma, rgb, delta = _composite_inputs(seed=4)
    t_eps = 1e-4
    c, a = tops.alpha_composite(_t(sigma), _t(rgb), _t(delta), True, t_eps)
    jc, ja = jops.alpha_composite(jnp.asarray(sigma), jnp.asarray(rgb),
                                  jnp.asarray(delta), use_pallas=True,
                                  early_stop=True, t_eps=t_eps)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0,
                               atol=t_eps + 1e-6)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0,
                               atol=t_eps + 1e-6)


# ---------------------------------------------------------------------------
# Compositions of ops
# ---------------------------------------------------------------------------
def test_hash_encode_matches_reference_composition():
    rng = np.random.RandomState(6)
    L, B, T, F = 3, 17, 90, 2
    cat = rng.normal(size=(T, F)).astype(np.float32)
    off = np.array([0, 30, 60], np.int32)
    idx = rng.randint(0, 30, size=(L, B, 8)).astype(np.int32)
    w = rng.uniform(size=(L, B, 8)).astype(np.float32)
    got = tops.hash_encode(_t(idx), _t(w), _t(cat), _t(off)).numpy()
    want = np.asarray(jops.hash_encode(jnp.asarray(idx), jnp.asarray(w),
                                       jnp.asarray(cat), jnp.asarray(off),
                                       use_pallas=True))
    # Corners are summed one by one here, by XLA's reduction there.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got.shape == (B, L * F)


# ---------------------------------------------------------------------------
# gather_composite: the gather + composite step every serve tier ends in
# ---------------------------------------------------------------------------
def _tier_composite_inputs(tier: str, seed: int = 7):
    """One chunk's (sigma_b, rgb_b, take, valid, delta_row, active) as each
    serve tier hands them over: the march (int64 rank, an overflowing
    budget), a plan hit (int32 take, exact mask) and a warp (int32 take,
    conservative mask, the march's f32 mask to AND)."""
    rng = np.random.RandomState(seed)
    R, S = 24, 12
    P = R * S
    active = rng.uniform(size=P) < 0.4
    delta = np.append(np.diff(np.linspace(0.2, 2.5, S)), 1e10) \
        .astype(np.float32)
    if tier == "march":
        B = 64  # fewer rows than active samples: the overflow is dropped
        rank = np.cumsum(active) - 1
        take, valid, act = rank.astype(np.int64), active & (rank < B), None
    else:
        cons = active | (rng.uniform(size=P) < 0.2)
        B = int(cons.sum())
        take = np.zeros(P, np.int32)
        take[cons] = np.arange(B, dtype=np.int32)
        valid, act = (active, None) if tier == "hit" else (
            cons, active.astype(np.float32))
    scale = rng.choice([0.0, 0.5, 5.0, 200.0], B)
    sigma_b = (rng.exponential(1.0, B) * scale).astype(np.float32)
    rgb_b = rng.uniform(size=(B, 3)).astype(np.float32)
    return sigma_b, rgb_b, take, valid, delta, act


def _replaced_composition(sigma_b, rgb_b, take, valid, delta_row, white_bg,
                          active):
    """The composition `ops.gather_composite` replaced in `_chunk_color`,
    spelled out: the take clamp, the masked gathers, the (R, S) delta,
    `alpha_composite`, the white background."""
    if active is not None:
        valid = valid & (active > 0.5)
    R, S = take.shape[0] // delta_row.shape[0], delta_row.shape[0]
    take = torch.clamp(take, 0, sigma_b.shape[0] - 1)
    zero = torch.zeros(())
    sigma = torch.where(valid, sigma_b[take], zero).reshape(R, S)
    rgb = torch.where(valid[:, None], rgb_b[take], zero).reshape(R, S, 3)
    color, acc = tops.alpha_composite(
        sigma.contiguous(), rgb.contiguous(),
        delta_row.expand(R, S).contiguous())
    return (color + (1.0 - acc) if white_bg else color), acc, sigma, rgb


@pytest.mark.parametrize("white_bg", [True, False])
@pytest.mark.parametrize("tier", ["march", "hit", "warp"])
def test_gather_composite_plain_bit_equal_to_the_composition(tier, white_bg):
    args = [None if a is None else _t(a)
            for a in _tier_composite_inputs(tier)]
    sigma_b, rgb_b, take, valid, delta, act = args
    color, acc = tops.gather_composite(sigma_b, rgb_b, take, valid, delta,
                                       white_bg, True, active=act)
    w_color, w_acc, sigma, rgb = _replaced_composition(
        sigma_b, rgb_b, take, valid, delta, white_bg, act)
    assert torch.equal(color, w_color) and torch.equal(acc, w_acc)
    assert color.shape == (24, 3) and acc.shape == (24, 1)
    # And the reference's compositing of the same gathered samples.
    R, S = sigma.shape
    jc, ja = jref.alpha_composite_ref(
        jnp.asarray(sigma.numpy()), jnp.asarray(rgb.numpy()),
        jnp.asarray(np.tile(delta.numpy(), (R, 1))))
    jc = np.asarray(jc) + (1.0 - np.asarray(ja)) * white_bg
    np.testing.assert_allclose(color.numpy(), jc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(acc.numpy(), np.asarray(ja), rtol=0,
                               atol=1e-6)


def test_gather_composite_plain_refuses_bad_shapes():
    sigma_b, rgb_b, take, valid, delta = (
        _t(a) for a in _tier_composite_inputs("hit")[:5])
    good = dict(sigma_b=sigma_b, rgb_b=rgb_b, take=take, valid=valid,
                delta_row=delta, white_bg=True)
    for bad in (dict(rgb_b=rgb_b[:, :2]), dict(valid=valid[:-1]),
                dict(delta_row=delta[:-1]), dict(active=torch.zeros(3))):
        with pytest.raises(ValueError):
            tops.gather_composite(**dict(good, **bad))
