"""The port's quantized matmuls on the CPU: their plain versions against the
JAX package at the kernels' edge shapes and at the five NeRF serve linears,
and the C entry points' argument lists.

The plain versions are held exactly (the reference is exact) to the
reference's oracles `ref.quant_matmul_ref` / `ref.quant_matmul_packed_ref`
and to its Pallas kernels in interpret mode, as its own tests run them on
the CPU. The edges are those of the Hopper kernels' tiles: K around the
32-code MMA step and past one 256-code chunk, N around the 8-column MMA
tile and past one 64-column block tile, M around the 16-row fragment."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.repack import repack_tile_native as j_repack
from repro.quant.packing import pack_codes as j_pack_codes
from repro_torch.convert import packed_from_numpy
from repro_torch.kernels import build
from repro_torch.kernels import ops as tops

KS = (1, 8, 31, 33, 40, 64, 257)
NS = (1, 3, 8, 16, 65, 200)
MS = (1, 15, 16, 127, 16385)
ZXS = (-128, 0, 17, 127)
LAYOUTS = ("planar", "tile:128")


def _packed(rng, k, n, bits, layout):
    """(reference packed tensor, the port's) of random codes spanning the
    paper-exact grid [-2^(b-1) - 1, 2^(b-1) - 1] (its lowest level clamps)."""
    q = rng.integers(-(2 ** (bits - 1)) - 1, 2 ** (bits - 1), (k, n))
    jw = j_pack_codes(q, bits, scale=0.011)
    if layout != "planar":
        jw = j_repack(jw, 128)
    tw = packed_from_numpy(jw, device="cpu")
    assert tw.layout == layout
    return jw, tw


def _x(rng, m, k):
    return rng.integers(-128, 128, (m, k)).astype(np.int8)


# ---------------------------------------------------------------------------
# Plain versions == the reference's oracles on every edge shape
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", NS)
def test_packed_plain_equals_reference_oracle_on_edges(k, n):
    rng = np.random.default_rng(1000 * k + n)
    # Every (bits, layout) pair over the (K, N) cases.
    case = KS.index(k) * len(NS) + NS.index(n)
    bits, layout = 1 + case % 8, LAYOUTS[case // 8 % 2]
    jw, tw = _packed(rng, k, n, bits, layout)
    for m in MS:
        x = _x(rng, m, k)
        for zx in ZXS:
            got = tops.quant_matmul_packed(torch.from_numpy(x), tw, 0.037,
                                           tw.scale, zx)
            want = jref.quant_matmul_packed_ref(jnp.asarray(x), jw, 0.037,
                                                jw.scale, zx)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert got.dtype == torch.float32 and got.shape == (m, n)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", NS)
def test_unpacked_plain_equals_reference_oracle_on_edges(k, n):
    rng = np.random.default_rng(2000 * k + n)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    for m in MS:
        x = _x(rng, m, k)
        for zx in ZXS:
            got = tops.quant_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                    0.037, 0.011, zx)
            want = jref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(w), 0.037,
                                         0.011, zx)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Plain versions == the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------
PALLAS_SHAPES = ((15, 33, 3), (16, 40, 8), (1, 257, 65))


@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_packed_plain_equals_pallas_interpret_on_edges(bits, layout):
    rng = np.random.default_rng(bits)
    for m, k, n in PALLAS_SHAPES:
        x = _x(rng, m, k)
        jw, tw = _packed(rng, k, n, bits, layout)
        zx = ZXS[bits % len(ZXS)]
        got = tops.quant_matmul_packed(torch.from_numpy(x), tw, 0.037,
                                       tw.scale, zx)
        pallas = jops.quant_matmul_packed(jnp.asarray(x), jw, 0.037, jw.scale,
                                          zx, use_pallas=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("m,k,n", PALLAS_SHAPES)
def test_unpacked_plain_equals_pallas_interpret_on_edges(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = _x(rng, m, k)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    for zx in ZXS:
        got = tops.quant_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                0.037, 0.011, zx)
        pallas = jops.quant_matmul(jnp.asarray(x), jnp.asarray(w), 0.037,
                                   0.011, zx, use_pallas=True, bm=32, bn=32,
                                   bk=64)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_plain_takes_a_view_that_starts_off_a_16_byte_boundary():
    rng = np.random.default_rng(5)
    big = torch.from_numpy(_x(rng, 301 * 40 + 1, 1).reshape(-1))
    x = big[1:].view(301, 40)  # one byte in: no alignment at all
    assert x.is_contiguous() and x.data_ptr() % 2 == 1
    jw, tw = _packed(rng, 40, 16, 4, "tile:128")
    got = tops.quant_matmul_packed(x, tw, 0.5, tw.scale, 17)
    want = jref.quant_matmul_packed_ref(jnp.asarray(x.numpy()), jw, 0.5,
                                        jw.scale, 17)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Plain versions == the reference's oracles at the five NeRF serve linears
# ---------------------------------------------------------------------------
SERVE_KN = ((32, 64), (64, 16), (40, 64), (64, 64), (64, 3))  # paper (K, N)
SERVE_M = 512 * 32  # one slot: 512 rays x 32 samples


@pytest.mark.parametrize("k,n", SERVE_KN)
@pytest.mark.parametrize("bits", range(1, 9))
def test_packed_plain_equals_reference_oracle_at_serve_shapes(k, n, bits):
    """A whole slot's rows (16,384), the layout the artifact loads
    (tile:128) and the planar one."""
    rng = np.random.default_rng(100 * bits + k + n)
    x = _x(rng, SERVE_M, k)
    zx = ZXS[bits % len(ZXS)]
    for layout in LAYOUTS:
        jw, tw = _packed(rng, k, n, bits, layout)
        got = tops.quant_matmul_packed(torch.from_numpy(x), tw, 0.02,
                                       tw.scale, zx)
        want = jref.quant_matmul_packed_ref(jnp.asarray(x), jw, 0.02,
                                            jw.scale, zx)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _c_entries():
    """{entry: number of parameters} of every extern "C" function in the
    CUDA sources."""
    found = {}
    for name in build.SOURCES:
        src = (build.CSRC / name).read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
            found[m.group(1)] = len(m.group(2).split(","))
    return found


def test_c_entry_points_match_their_ctypes_signatures():
    entries = _c_entries()
    assert set(entries) == set(build.SIGNATURES)
    for name, argtypes in build.SIGNATURES.items():
        assert entries[name] == len(argtypes), name


def test_headers_are_part_of_the_build_hash():
    for name in build.HEADERS:
        assert (build.CSRC / name).exists()
    included = set()
    for name in build.SOURCES:
        included |= set(re.findall(r'#include "([^"]+)"',
                                   (build.CSRC / name).read_text()))
    assert included == set(build.HEADERS)
