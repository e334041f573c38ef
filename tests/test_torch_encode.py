"""The port's fused hash encode and its ray march on the CPU, against the
JAX package on the same numpy inputs.

The plain fused encode (points -> level-major encodings, or -> a first
linear's int8 activation codes) is held bit-equal to the jitted
reference's `hash_encode` over the stacked `level_corner_data` and its
round/clip codes: at the paper's widths (16 levels, 5 direct and 11
hashed, 16,384 points) on random points and on the grid's edges (0, 1,
the float below 1, exact cell faces of every level). One documented
divergence: XLA on the CPU flushes subnormal values to zero, and the
port (IEEE, as the CUDA kernel) keeps them, so tables whose corner
products go subnormal (below 1.2e-38; a quantized table's smallest
magnitude is its scale, many orders above) are compared apart. The march
mask is exact against `ref.ray_march_ref` and the host oracle. Also: the
fused field gives the same bits with and without precomputed corner
data, and the wrapper's launch arguments match the C entry's ctypes
signature."""
import ctypes
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.ngp import paper as j_paper
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.nerf import hash_encoding as jhe
from repro_torch.configs.ngp import paper as t_paper
from repro_torch.kernels import build
from repro_torch.kernels import hash_encode as he
from repro_torch.kernels import ops as tops
from repro_torch.nerf import fast_render as tfr
from repro_torch.nerf import hash_encoding as the
from repro_torch.nerf import ngp as tngp
from repro_torch.nerf import occupancy as tocc
from repro_torch.nerf.render import RenderConfig

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
T_CFG = tngp.NGPConfig(
    hash=the.HashEncodingConfig(n_levels=4, log2_table_size=9,
                                base_resolution=4, max_resolution=32),
    hidden_dim=16, color_hidden_dim=16, geo_feat_dim=7, sh_degree=2,
)


def _chip_smoke():
    """`chip_smoke.py`, for the inputs it drives the kernels with."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _j_encode(j_hc, t_hc, pts, table, act):
    """The jitted reference: encodings and activation codes."""
    off = jnp.asarray(the.level_meta(t_hc, CPU)[:, 3].numpy())

    @jax.jit
    def run(p, table, sx, zx_f, qmax, act_off):
        per = [jhe.level_corner_data(p, l, j_hc)
               for l in range(j_hc.n_levels)]
        enc = jops.hash_encode(jnp.stack([i for i, _ in per]),
                               jnp.stack([w for _, w in per]), table, off,
                               use_pallas=False)
        codes = jnp.clip(jnp.round(enc / sx + zx_f), 0.0, qmax) - act_off
        return enc, codes.astype(jnp.int8)

    enc, codes = run(pts, table, *(np.float32(act[k].item())
                                   for k in ("sx", "zx_f", "qmax", "off")))
    return np.asarray(enc), np.asarray(codes)


def _assert_encode_equal(j_hc, t_hc, pts, table, act):
    want_enc, want_codes = _j_encode(j_hc, t_hc, pts, table, act)
    meta = the.level_meta(t_hc, CPU)
    p, tab = torch.from_numpy(pts), torch.from_numpy(table)
    enc = tops.hash_encode_points(p, tab, meta)
    codes = tops.hash_encode_points(p, tab, meta, act)
    assert enc.dtype == torch.float32 and codes.dtype == torch.int8
    assert enc.shape == codes.shape == (pts.shape[0], t_hc.out_dim)
    np.testing.assert_array_equal(enc.numpy(), want_enc)
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    assert np.unique(want_codes).size > 10  # the grid is exercised


@pytest.mark.parametrize("which", ["random", "edges"])
def test_plain_fused_encode_bit_equal_to_the_jitted_reference_paper(which):
    hc = t_paper().hash
    assert [hc.is_direct(l) for l in range(16)] == [True] * 5 + [False] * 11
    rng = np.random.default_rng(3)
    table, _, act = CS.encode_inputs(rng, hc, CPU, subnormal=False)
    if which == "random":
        pts = rng.uniform(size=(16384, 3)).astype(np.float32)
    else:
        pts = CS.encode_edge_points(hc, 1024)
    assert pts.shape == (16384, 3)
    _assert_encode_equal(j_paper().hash, hc, pts, table.numpy(), act)


@pytest.mark.parametrize("F", [1, 2])
def test_plain_fused_encode_at_a_narrow_grid(F):
    """A 5-level grid, one or two features: exact against the port's
    corner-data composition, and within 4e-7 of the jitted reference,
    which at these narrow shapes vectorizes the corner sum in another
    order than its FMA chain at the paper's widths (a few ulps of values
    of order 1)."""
    kw = dict(n_levels=5, n_features=F, log2_table_size=9,
              base_resolution=3, max_resolution=40)
    t_hc, j_hc = the.HashEncodingConfig(**kw), jhe.HashEncodingConfig(**kw)
    assert 0 < sum(t_hc.is_direct(l) for l in range(5)) < 5
    rng = np.random.default_rng(F)
    T = sum(t_hc.level_entries(l) for l in range(5))
    table = rng.normal(size=(T, F)).astype(np.float32)
    pts = np.concatenate([rng.uniform(size=(700, 3)),
                          CS.encode_edge_points(t_hc, 60)]).astype(np.float32)
    meta = the.level_meta(t_hc, CPU)
    p, tab = torch.from_numpy(pts), torch.from_numpy(table)
    per = [the.level_corner_data(p, l, t_hc) for l in range(5)]
    want = tops.hash_encode(torch.stack([i for i, _ in per]),
                            torch.stack([w for _, w in per]), tab,
                            meta[:, 3].contiguous())
    got = tops.hash_encode_points(p, tab, meta)
    assert torch.equal(got, want)
    _, _, act = CS.encode_inputs(rng, t_hc, CPU, subnormal=False)
    j_enc, _ = _j_encode(j_hc, t_hc, pts, table, act)
    np.testing.assert_allclose(got.numpy(), j_enc, rtol=0, atol=4e-7)


@pytest.mark.parametrize("F", [1, 4])
def test_plain_fused_encode_other_feature_counts_equal_the_reference(F):
    """F = 1 and 4 features a level (the kernel's other widths besides 8):
    the paper's 16 levels on a 2^14-row table, bit-equal to the jitted
    reference's encodings and codes."""
    kw = dict(n_levels=16, n_features=F, log2_table_size=14,
              base_resolution=16, max_resolution=2048)
    t_hc, j_hc = the.HashEncodingConfig(**kw), jhe.HashEncodingConfig(**kw)
    assert 0 < sum(t_hc.is_direct(l) for l in range(16)) < 16
    rng = np.random.default_rng(20 + F)
    table, _, act = CS.encode_inputs(rng, t_hc, CPU, subnormal=False)
    assert table.shape[1] == F
    pts = np.concatenate([rng.uniform(size=(3000, 3)),
                          CS.encode_edge_points(t_hc, 64)]).astype(np.float32)
    _assert_encode_equal(j_hc, t_hc, pts, table.numpy(), act)


def test_subnormal_corner_products_kept_where_the_reference_flushes():
    """The documented divergence: on a table of subnormal-scale values the
    jitted reference on the CPU flushes every product to zero, the port
    keeps the IEEE results (nonzero, below the smallest normal)."""
    hc = T_CFG.hash
    rng = np.random.default_rng(4)
    T = sum(hc.level_entries(l) for l in range(hc.n_levels))
    table = (rng.uniform(0.5, 1.0, (T, 2)) * 1e-38).astype(np.float32)
    pts = rng.uniform(size=(64, 3)).astype(np.float32)
    _, _, act = CS.encode_inputs(rng, hc, CPU, subnormal=False)
    want, _ = _j_encode(jhe.HashEncodingConfig(**vars(hc)), hc, pts, table,
                        act)
    got = tops.hash_encode_points(torch.from_numpy(pts),
                                  torch.from_numpy(table),
                                  the.level_meta(hc, CPU)).numpy()
    tiny = np.finfo(np.float32).tiny
    assert not want.any()
    assert (got > 0).all() and (got < tiny).any()


def test_plain_fused_encode_equals_the_corner_data_composition():
    """`hash_encode_points` == `hash_encode` over stacked
    `level_corner_data`, at a table whose level offsets are not multiples
    of 32, and an index past the table gives a zero row in both."""
    hc = the.HashEncodingConfig(n_levels=6, log2_table_size=10,
                                base_resolution=5, max_resolution=90)
    meta = the.level_meta(hc, CPU)
    assert (meta[1:, 3] % 32 != 0).any()
    rng = np.random.default_rng(7)
    table = torch.from_numpy(rng.normal(size=(int(meta[:, 2].sum()), 2))
                             .astype(np.float32))
    pts = torch.from_numpy(rng.uniform(size=(999, 3)).astype(np.float32))
    per = [the.level_corner_data(pts, l, hc) for l in range(6)]
    want = tops.hash_encode(torch.stack([i for i, _ in per]),
                            torch.stack([w for _, w in per]), table,
                            meta[:, 3].contiguous())
    assert torch.equal(tops.hash_encode_points(pts, table, meta), want)
    short = table[:-50]  # the last level's top rows fall off the table
    per_off = tops.hash_encode_points(pts, short, meta)
    want = tops.hash_encode(torch.stack([i for i, _ in per]),
                            torch.stack([w for _, w in per]), short,
                            meta[:, 3].contiguous())
    assert torch.equal(per_off, want)


# ---------------------------------------------------------------------------
# The fused field with and without precomputed corner data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("first_bits", [8.0, 12.0, 32.0])
def test_fused_ngp_apply_same_with_and_without_corner_data(first_bits):
    """The first linear in `int` (the fused codes), `float_qact` and
    `float` mode: the encode from points gives the same bits as the
    corner-data composition."""
    params = tngp.init_ngp(torch.Generator().manual_seed(0), T_CFG,
                           device="cpu")
    params["hash"] = {k: v * 1e3 for k, v in params["hash"].items()}
    rng = np.random.default_rng(11)
    pts = torch.from_numpy(rng.uniform(size=(300, 3)).astype(np.float32))
    d = rng.normal(size=(300, 3)).astype(np.float32)
    dirs = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    _, _, taps = tngp.ngp_apply(params, pts, dirs, T_CFG, None,
                                return_taps=True)
    names = tngp.ngp_linear_names(T_CFG)
    spec = tngp.NGPQuantSpec(
        hash_bits=torch.tensor([8.0, 6.0, 4.0, 8.0]),
        weight_bits=torch.tensor([4.0, 6.0, 8.0, 4.0, 8.0]),
        act_bits=torch.tensor([first_bits, 8.0, 8.0, 8.0, 8.0]),
        act_ranges=torch.tensor([[float(taps[n].min()), float(taps[n].max())]
                                 for n in names]))
    pack = tfr.build_fused_pack(params, T_CFG, spec)
    assert pack.modes[0] == {8.0: "int", 12.0: "float_qact",
                             32.0: "float"}[first_bits]
    per = [the.level_corner_data(pts, l, T_CFG.hash) for l in range(4)]
    corner = (torch.stack([i for i, _ in per]),
              torch.stack([w for _, w in per]))
    s1, c1 = tfr.fused_ngp_apply(pack, pts, dirs, T_CFG)
    s2, c2 = tfr.fused_ngp_apply(pack, pts, dirs, T_CFG, corner_data=corner)
    assert torch.equal(s1, s2) and torch.equal(c1, c2)
    assert torch.isfinite(c1).all() and c1.std() > 0


# ---------------------------------------------------------------------------
# The C entry and the wrapper's call
# ---------------------------------------------------------------------------
def test_hash_encode_wrapper_call_matches_its_ctypes_signature(monkeypatch):
    """The arguments `hash_encode_points_cuda` hands the C entry (with the
    stream the launcher appends) fit the ctypes signature in
    `kernels/build.py`, one for one, and the C source declares as many
    parameters."""
    calls = []
    monkeypatch.setattr(he, "require", lambda *a: None)
    monkeypatch.setattr(he, "launch",
                        lambda entry, dev, *args: calls.append((entry, args)))
    monkeypatch.setattr(he.hash_encode_points_cuda, "launches", 0)
    hc = T_CFG.hash
    meta = the.level_meta(hc, CPU)
    table = torch.zeros((int(meta[:, 2].sum()), 2))
    pts = torch.zeros((5, 3))
    _, _, act = CS.encode_inputs(np.random.default_rng(0), hc, CPU)
    f32 = he.hash_encode_points_cuda(pts, table, meta)
    codes = he.hash_encode_points_cuda(pts, table, meta, act)
    assert f32.dtype == torch.float32 and codes.dtype == torch.int8
    assert he.hash_encode_points_cuda.launches == 2
    src = (build.CSRC / "hash_encode.cu").read_text()
    n_c = len(re.search(r'extern "C" int repro_hash_encode\(([^)]*)\)',
                        src).group(1).split(","))
    argtypes = build.SIGNATURES["repro_hash_encode"]
    assert n_c == len(argtypes)
    for entry, args in calls:
        assert entry == "repro_hash_encode"
        full = args + (0,)  # the stream
        assert len(full) == len(argtypes)
        for a, t in zip(full, argtypes):
            if t is ctypes.c_int:
                assert isinstance(a, int) and -2 ** 31 <= a < 2 ** 31
            else:
                assert t is ctypes.c_void_p and (a is None
                                                 or isinstance(a, int))
            t(a)  # ctypes takes it
    (_, (*_, B, L, T, F, codes_flag)), (_, args) = calls
    assert (B, L, T, F, codes_flag) == (5, 4, table.shape[0], 2, 0)
    assert args[-1] == 1 and all(isinstance(a, int) for a in args[3:7])
    assert calls[0][1][3:7] == (None,) * 4  # no activation grid


# ---------------------------------------------------------------------------
# The ray march: plain version == reference oracle == host oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 31, 32, 33, 64])
def test_ray_march_plain_exact_against_reference_and_host_oracle(S):
    rng = np.random.default_rng(S)
    G, R = 32, 200  # R not a multiple of 32
    occ = (rng.uniform(size=(G, G, G)) < 0.5).astype(np.float32)
    o, d = CS.march_rays(rng, R)
    rcfg = RenderConfig(n_samples=S)
    t = tocc.ray_t_samples(rcfg)
    got = tops.ray_march(*(torch.from_numpy(a) for a in (occ, o, d, t)),
                         True).numpy()
    want = np.asarray(jref.ray_march_ref(jnp.asarray(occ), jnp.asarray(o),
                                         jnp.asarray(d), jnp.asarray(t)))
    np.testing.assert_array_equal(got, want)
    grid = tocc.OccupancyGrid(occ=torch.from_numpy(occ), resolution=G,
                              threshold=0.5,
                              occupied_fraction=float(occ.mean()))
    host, _ = tocc.sample_active_mask(grid, o, d, rcfg)
    np.testing.assert_array_equal(got > 0.5, host)
    assert got.shape == (R, S) and set(np.unique(got)) <= {0.0, 1.0}
    if S > 1:
        assert 0 < got.sum() < got.size
