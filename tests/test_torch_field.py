"""The port's NeRF field against the JAX package on the same inputs: hash
corner indices (exact, at the paper's hash config, hashed levels
included), trilinear weights (1 ulp), the fake-quant field (1e-5), and the
fused integer field fed the reference's corner data (identical activation
codes, outputs within 1e-6)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.ngp import paper as j_paper
from repro.kernels import ops as jops
from repro.nerf import fast_render as jfr
from repro.nerf import hash_encoding as jhe
from repro.nerf import ngp as jngp
from repro.quant.policy import QuantPolicy as JQuantPolicy
from repro_torch.configs.ngp import paper as t_paper
from repro_torch.convert import pack_from_numpy, params_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.nerf import fast_render as tfr
from repro_torch.nerf import hash_encoding as the
from repro_torch.nerf import ngp as tngp
from repro_torch.quant.policy import QuantPolicy as TQuantPolicy

J_CFG = jngp.NGPConfig(
    hash=jhe.HashEncodingConfig(n_levels=4, log2_table_size=9,
                                base_resolution=4, max_resolution=32),
    hidden_dim=16, color_hidden_dim=16, geo_feat_dim=7, sh_degree=2,
)
CPU = torch.device("cpu")
T_CFG = tngp.NGPConfig(
    hash=the.HashEncodingConfig(n_levels=4, log2_table_size=9,
                                base_resolution=4, max_resolution=32),
    hidden_dim=16, color_hidden_dim=16, geo_feat_dim=7, sh_degree=2,
)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def j_params():
    p = jngp.init_ngp(jax.random.PRNGKey(0), J_CFG)
    # Trained-model magnitudes, so quantization sees signal.
    p["hash"] = {k: v * 1e3 for k, v in p["hash"].items()}
    return p


@pytest.fixture(scope="module")
def points():
    rng = np.random.RandomState(0)
    pts = rng.uniform(size=(96, 3)).astype(np.float32)
    d = rng.normal(size=(96, 3)).astype(np.float32)
    return pts, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def ranges(j_params):
    """Activation ranges calibrated from the reference field's taps."""
    rng = np.random.RandomState(1)
    pts = jnp.asarray(rng.uniform(size=(256, 3)).astype(np.float32))
    dirs = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (256, 1))
    _, _, taps = jngp.ngp_apply(j_params, pts, dirs, J_CFG, None,
                                return_taps=True)
    return np.asarray([[float(jnp.min(taps[n])), float(jnp.max(taps[n]))]
                       for n in jngp.ngp_linear_names(J_CFG)], np.float32)


def _spec(ranges, w_bits, a_bits, h_bits):
    return jngp.NGPQuantSpec(
        hash_bits=jnp.asarray(h_bits, jnp.float32),
        weight_bits=jnp.asarray(w_bits, jnp.float32),
        act_bits=jnp.asarray(a_bits, jnp.float32),
        act_ranges=jnp.asarray(ranges),
    )


def _t_spec(j_spec):
    return tngp.NGPQuantSpec(
        hash_bits=torch.tensor(np.asarray(j_spec.hash_bits)),
        weight_bits=torch.tensor(np.asarray(j_spec.weight_bits)),
        act_bits=torch.tensor(np.asarray(j_spec.act_bits)),
        act_ranges=torch.tensor(np.asarray(j_spec.act_ranges)),
        paper_exact=j_spec.paper_exact,
    )


# ---------------------------------------------------------------------------
# Hash encoding at the paper's widths
# ---------------------------------------------------------------------------
def test_paper_config_equals_reference():
    assert dataclasses.asdict(t_paper()) == dataclasses.asdict(j_paper())
    hc = t_paper().hash
    assert hc.resolutions() == j_paper().hash.resolutions()
    rows = [hc.level_entries(l) for l in range(hc.n_levels)]
    assert rows == [j_paper().hash.level_entries(l) for l in range(16)]
    assert [hc.is_direct(l) for l in range(16)] == [True] * 5 + [False] * 11
    assert sum(rows) == 6_098_925


@pytest.mark.parametrize("level", range(16))
def test_corner_indices_exact_and_weights_within_1ulp_paper(level):
    rng = np.random.RandomState(level)
    res = j_paper().hash.resolutions()[level]
    pts = rng.uniform(size=(300, 3)).astype(np.float32)
    pts[:4] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 1]]
    pts[4:20] = (rng.randint(0, res + 1, (16, 3)) / res).astype(np.float32)
    ji, jw = jhe.level_corner_data(jnp.asarray(pts), level, j_paper().hash)
    ti, tw = the.level_corner_data(torch.from_numpy(pts), level,
                                   t_paper().hash)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_max_ulp(tw.numpy(), np.asarray(jw), maxulp=1)


def test_hash_encode_within_1e6(j_params, points):
    pts, _ = points
    tp = params_from_numpy(_np_tree(j_params), device="cpu")
    for bits in (None, [8.0, 6.0, 16.0, 3.0]):
        jb = None if bits is None else jnp.asarray(bits, jnp.float32)
        tb = None if bits is None else torch.tensor(bits)
        want = jhe.hash_encode(j_params["hash"], jnp.asarray(pts),
                               J_CFG.hash, level_bits=jb)
        got = the.hash_encode(tp["hash"], torch.from_numpy(pts), T_CFG.hash,
                              level_bits=tb)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# The fake-quant field
# ---------------------------------------------------------------------------
def test_ngp_apply_and_taps_within_1e5(j_params, points):
    pts, dirs = points
    tp = params_from_numpy(_np_tree(j_params), device="cpu")
    js, jrgb, jtaps = jngp.ngp_apply(j_params, jnp.asarray(pts),
                                     jnp.asarray(dirs), J_CFG,
                                     return_taps=True)
    ts, trgb, ttaps = tngp.ngp_apply(tp, torch.from_numpy(pts),
                                     torch.from_numpy(dirs), T_CFG,
                                     return_taps=True)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), rtol=0,
                               atol=1e-5)
    assert set(ttaps) == set(jtaps)
    for name in jtaps:
        np.testing.assert_allclose(ttaps[name].numpy(),
                                   np.asarray(jtaps[name]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("degree", range(5))
def test_sh_encode_within_1e6(points, degree):
    _, dirs = points
    np.testing.assert_allclose(
        tngp.sh_encode(torch.from_numpy(dirs), degree).numpy(),
        np.asarray(jngp.sh_encode(jnp.asarray(dirs), degree)),
        rtol=0, atol=1e-6)


def test_quant_units_and_spec_from_policy_equal_reference():
    tu, ju = tngp.make_quant_units(t_paper()), jngp.make_quant_units(j_paper())
    bits = [(3 * i) % 8 + 1 for i in range(len(tu))]
    tpol = TQuantPolicy.uniform(tu, 8).with_bits(bits)
    jpol = JQuantPolicy.uniform(ju, 8).with_bits(bits)
    assert tpol.to_json() == jpol.to_json()
    assert TQuantPolicy.from_json(jpol.to_json()).to_json() == jpol.to_json()
    assert tpol.fqr() == jpol.fqr() and tpol.model_bits() == jpol.model_bits()
    ranges = np.arange(10, dtype=np.float32).reshape(5, 2)
    ts = tngp.spec_from_policy(t_paper(), tpol, torch.from_numpy(ranges))
    js = jngp.spec_from_policy(j_paper(), jpol, jnp.asarray(ranges))
    for f in ("hash_bits", "weight_bits", "act_bits", "act_ranges"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))


# ---------------------------------------------------------------------------
# The fused integer field
# ---------------------------------------------------------------------------
INT_BITS = ([4, 6, 8, 4, 8], [8, 8, 6, 8, 4], [6, 4, 8, 3])


def test_build_fused_pack_equals_reference(j_params, ranges):
    """The port packs converted weights into the reference's exact words,
    scales and activation grids."""
    spec = _spec(ranges, [8, 4, 32, 6, 12], [6, 8, 8, 32, 4],
                 [8, 6, 12, 32])
    jp = jfr.build_fused_pack(j_params, J_CFG, spec, layout="planar")
    tp = tfr.build_fused_pack(params_from_numpy(_np_tree(j_params), "cpu"),
                              T_CFG, _t_spec(spec), layout="planar")
    assert tp.modes == jp.modes == ("int", "int", "float_qact", "float",
                                    "float_qact")
    for name, jl in jp.layers.items():
        assert set(tp.layers[name]) == set(jl)
        for k, v in jl.items():
            t = tp.layers[name][k]
            if hasattr(v, "words"):
                np.testing.assert_array_equal(t.words.numpy(),
                                              np.asarray(v.words))
                t, v = t.scale, v.scale
            assert t.numpy().dtype == np.asarray(v).dtype, (name, k)
            np.testing.assert_array_equal(t.numpy(), np.asarray(v))
    for name, jt in jp.hash_tables.items():
        t = tp.hash_tables[name]
        a, b = (t.words, jt.words) if hasattr(jt, "words") else (t, jt)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tfr.fused_pack_stored_bytes(tp) == jfr.fused_pack_stored_bytes(jp)


@pytest.fixture(scope="module")
def int_packs(j_params, ranges):
    spec = _spec(ranges, *INT_BITS)
    jp = jfr.build_fused_pack(j_params, J_CFG, spec)
    return jp, pack_from_numpy(jp, device="cpu")


def _corner_data(pts):
    per = [jhe.level_corner_data(jnp.asarray(pts), l, J_CFG.hash)
           for l in range(J_CFG.hash.n_levels)]
    return jnp.stack([i for i, _ in per]), jnp.stack([w for _, w in per])


def test_fused_field_query_identical_codes(int_packs, points):
    jp, tp = int_packs
    pts, _ = points
    idx, w = _corner_data(pts)
    cat, off = jp.compute["table_cat"], jp.compute["table_off"]
    lyr = jp.layers["sigma/0"]
    j_enc = jops.hash_encode(idx, w, cat, off, use_pallas=True)
    j_codes = jnp.clip(jnp.round(j_enc / lyr["sx"] + lyr["zx_f"]), 0.0,
                       lyr["qmax"]) - lyr["off"]
    t_idx, t_w = torch.tensor(np.asarray(idx)), torch.tensor(np.asarray(w))
    tl = tp.layers["sigma/0"]
    t_enc = tops.hash_encode(t_idx, t_w, tp.compute["table_cat"],
                             tp.compute["table_off"])
    t_codes = tops.quantize_codes(t_enc, tl)
    np.testing.assert_array_equal(t_codes.numpy(),
                                  np.asarray(j_codes).astype(np.int8))
    want = jops.fused_field_query(idx, w, cat, off,
                                  jp.compute["sigma/0::wq_tile"], lyr,
                                  use_pallas=True)
    got = tops.fused_field_query_points(torch.from_numpy(pts),
                                        tp.compute["table_cat"],
                                        the.level_meta(T_CFG.hash, CPU),
                                        tp.compute["sigma/0::wq_tile"], tl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_fused_field_query_reference_signature(int_packs, points):
    """`ops.fused_field_query(corner_idx, corner_w, table_cat,
    level_offsets, wq, act)`, the reference's signature: on the same
    corner data, the reference's codes (`use_pallas=False`) and its
    output, and the same bits as the points form."""
    jp, tp = int_packs
    pts, _ = points
    idx, w = _corner_data(pts)
    cat, off = jp.compute["table_cat"], jp.compute["table_off"]
    lyr, tl = jp.layers["sigma/0"], tp.layers["sigma/0"]
    wq = jp.compute["sigma/0::wq_tile"]
    j_enc = jops.hash_encode(idx, w, cat, off, use_pallas=False)
    j_codes = jnp.clip(jnp.round(j_enc / lyr["sx"] + lyr["zx_f"]), 0.0,
                       lyr["qmax"]) - lyr["off"]
    want = jops.fused_field_query(idx, w, cat, off, wq, lyr,
                                  use_pallas=False)
    t_idx, t_w = torch.tensor(np.asarray(idx)), torch.tensor(np.asarray(w))
    t_cat, t_off = tp.compute["table_cat"], tp.compute["table_off"]
    t_codes = tops.quantize_codes(tops.hash_encode(t_idx, t_w, t_cat, t_off),
                                  tl)
    np.testing.assert_array_equal(t_codes.numpy(),
                                  np.asarray(j_codes).astype(np.int8))
    got = tops.fused_field_query(t_idx, t_w, t_cat, t_off,
                                 tp.compute["sigma/0::wq_tile"], tl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    points_form = tops.fused_field_query_points(
        torch.from_numpy(pts), t_cat, the.level_meta(T_CFG.hash, CPU),
        tp.compute["sigma/0::wq_tile"], tl)
    assert torch.equal(got, points_form)


def test_fused_ngp_apply_within_1e6(int_packs, points):
    jp, tp = int_packs
    pts, dirs = points
    idx, w = _corner_data(pts)
    sh = jngp.sh_encode(jnp.asarray(dirs), J_CFG.sh_degree)
    js, jrgb = jfr.fused_ngp_apply(jp, jnp.asarray(pts), jnp.asarray(dirs),
                                   J_CFG, use_pallas=True,
                                   corner_data=(idx, w), sh=sh)
    ts, trgb = tfr.fused_ngp_apply(
        tp, torch.from_numpy(pts), torch.from_numpy(dirs), T_CFG,
        corner_data=(torch.tensor(np.asarray(idx)),
                     torch.tensor(np.asarray(w))),
        sh=torch.tensor(np.asarray(sh)))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), rtol=0,
                               atol=1e-6)
    # Without precomputed corner data the port derives its own.
    ts2, trgb2 = tfr.fused_ngp_apply(tp, torch.from_numpy(pts),
                                     torch.from_numpy(dirs), T_CFG)
    np.testing.assert_allclose(trgb2.numpy(), np.asarray(jrgb), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# The trilinear sum: an FMA chain, as XLA compiles the reference under jit
# ---------------------------------------------------------------------------
def test_hash_encode_bit_equal_to_the_jitted_reference():
    rng = np.random.default_rng(0)
    L, B, F, rows = 16, 4096, 2, 1 << 12
    idx = rng.integers(0, rows, (L, B, 8)).astype(np.int32)
    w = rng.uniform(size=(L, B, 8)).astype(np.float32)
    w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    table = (rng.normal(size=(L * rows, F)) * 1e-2).astype(np.float32)
    off = (np.arange(L) * rows).astype(np.int32)
    jitted = jax.jit(lambda i, w, t, o: jops.hash_encode(i, w, t, o,
                                                         use_pallas=False))
    want = np.asarray(jitted(idx, w, table, off))
    got = tops.hash_encode(*map(torch.from_numpy, (idx, w, table, off)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_field_query_codes_equal_the_jitted_reference(int_packs):
    jp, tp = int_packs
    pts = np.random.default_rng(5).uniform(size=(16384, 3)).astype(np.float32)
    idx, w = _corner_data(pts)
    cat, off = jp.compute["table_cat"], jp.compute["table_off"]
    lyr = jp.layers["sigma/0"]
    wq = jp.compute["sigma/0::wq_tile"]

    @jax.jit
    def j_query(idx, w, sx, zx_f, qmax, act_off):
        enc = jops.hash_encode(idx, w, cat, off, use_pallas=False)
        codes = jnp.clip(jnp.round(enc / sx + zx_f), 0.0, qmax) - act_off
        act = dict(lyr, sx=sx, zx_f=zx_f, qmax=qmax, off=act_off)
        return enc, codes.astype(jnp.int8), jops.fused_field_query(
            idx, w, cat, off, wq, act, use_pallas=False)

    j_enc, j_codes, j_out = j_query(idx, w, lyr["sx"], lyr["zx_f"], lyr["qmax"],
                             lyr["off"])
    t_idx, t_w = torch.tensor(np.asarray(idx)), torch.tensor(np.asarray(w))
    tl = tp.layers["sigma/0"]
    t_enc = tops.hash_encode(t_idx, t_w, tp.compute["table_cat"],
                             tp.compute["table_off"])
    np.testing.assert_array_equal(t_enc.numpy(), np.asarray(j_enc))
    np.testing.assert_array_equal(tops.quantize_codes(t_enc, tl).numpy(),
                                  np.asarray(j_codes))
    got = tops.fused_field_query_points(torch.from_numpy(pts),
                                        tp.compute["table_cat"],
                                        the.level_meta(T_CFG.hash, CPU),
                                        tp.compute["sigma/0::wq_tile"], tl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_out))
