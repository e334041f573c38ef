"""The port's hash encode from baked corner data on the CPU, against the
JAX package on the same numpy inputs.

`ops.hash_encode` and `ops.fused_field_query` keep the reference's
signatures; on a CPU tensor they take the plain version of the corners
kernel of `csrc/hash_encode.cu`. They are held to the reference's
`hash_encode` / `fused_field_query`, jitted, with its Pallas gather in
interpret mode, as its own tests run it on the CPU: an index outside the
table gives a zero row there, as in the port (`use_pallas=False` would
wrap or clamp it). For F in {1, 2, 4, 8}, with 1 % of the corner indices
out of the table: the encodings bit-equal at 16 levels and within 4e-7 at
5 (where XLA may sum the corners in another order than its FMA chain),
the activation codes and the first linear's output exact. Also, with the
device faked: both entry points launch the corners kernel once and no
gather, the CUDA wrapper refuses a table or weights that need a gradient
under grad mode, and its launch arguments fit the C entry's ctypes
signature."""
import ctypes
import importlib.util
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.repack import repack_tile_native as j_repack
from repro.nerf import hash_encoding as jhe
from repro.quant.packing import pack_codes as j_pack_codes
from repro_torch.convert import packed_from_numpy
from repro_torch.kernels import build
from repro_torch.kernels import hash_encode as he
from repro_torch.kernels import ops as tops
from repro_torch.nerf import hash_encoding as the

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
N_OUT = 64  # the first linear's width at the paper's config


def _chip_smoke():
    """`chip_smoke.py`, for the inputs it drives the kernels with."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _case(L, F, B, seed):
    """Corner data of B random points on an L-level grid of F features
    (narrow tables), 1 % of the indices moved outside the table once their
    level's offset is added (below 0, at T and past it, and at 2^31 - 1),
    the table, the level offsets and an 8-bit activation grid."""
    kw = dict(n_levels=L, n_features=F, log2_table_size=8, base_resolution=4,
              max_resolution=256 if L == 16 else 40)
    t_hc, j_hc = the.HashEncodingConfig(**kw), jhe.HashEncodingConfig(**kw)
    assert 0 < sum(t_hc.is_direct(l) for l in range(L)) < L
    rng = np.random.default_rng(seed)
    table, meta, act = CS.encode_inputs(rng, t_hc, CPU, subnormal=False)
    off = meta[:, 3].numpy().copy()
    T = table.shape[0]
    pts = jnp.asarray(rng.uniform(size=(B, 3)).astype(np.float32))
    per = [jhe.level_corner_data(pts, l, j_hc) for l in range(L)]
    idx = np.array(jnp.stack([i for i, _ in per]))
    w = np.array(jnp.stack([wl for _, wl in per]))
    pos = rng.choice(idx.size, idx.size // 100, replace=False)
    level = np.unravel_index(pos, idx.shape)[0]
    rows = rng.choice(np.array([-1, -7, T, T + 5, 2 ** 31 - 1]), pos.size)
    idx.reshape(-1)[pos] = (rows - off[level]).astype(np.int32)
    act["zx"] = (act["zx_f"] - act["off"]).to(torch.int32)
    return idx, w, table.numpy(), off, act


def _weights(rng, K):
    """A 4-bit tile:128 first-linear weight: (the reference's, the port's)."""
    q = rng.integers(-9, 8, (K, N_OUT))
    jw = j_repack(j_pack_codes(q, 4, scale=0.013), 128)
    return jw, packed_from_numpy(jw, device="cpu")


@pytest.mark.parametrize("F", [1, 2, 4, 8])
@pytest.mark.parametrize("L", [5, 16])
def test_encode_from_corners_matches_the_reference(L, F):
    idx, w, table, off, act = _case(L, F, 700 if L == 5 else 512, 40 + F + L)
    jw, tw = _weights(np.random.default_rng(F), L * F)
    j_act = {k: jnp.asarray(v.numpy()) for k, v in act.items()}

    @jax.jit
    def j_query(idx, w, table, off, act):
        enc = jops.hash_encode(idx, w, table, off, use_pallas=True)
        codes = jnp.clip(jnp.round(enc / act["sx"] + act["zx_f"]), 0.0,
                         act["qmax"]) - act["off"]
        out = jops.fused_field_query(idx, w, table, off, jw, act,
                                     use_pallas=True)
        return enc, codes.astype(jnp.int8), out

    j_enc, j_codes, j_out = map(np.asarray,
                                j_query(idx, w, table, off, j_act))
    t_in = [torch.from_numpy(a) for a in (idx, w, table, off)]
    enc = tops.hash_encode(*t_in)
    codes = tops.hash_encode_corners(*t_in, act)
    out = tops.fused_field_query(*t_in, tw, act)
    assert enc.shape == codes.shape == (idx.shape[1], L * F)
    assert enc.dtype == torch.float32 and codes.dtype == torch.int8
    if L == 16:
        np.testing.assert_array_equal(enc.numpy(), j_enc)
    else:
        np.testing.assert_allclose(enc.numpy(), j_enc, rtol=0, atol=4e-7)
    np.testing.assert_array_equal(codes.numpy(), j_codes)
    np.testing.assert_array_equal(out.numpy(), j_out)
    assert np.unique(j_codes).size > 10  # the grid is exercised
    # The out-of-range rows read as zeros: a point and level whose every
    # corner is out of the table encodes to 0.
    every = np.zeros_like(idx[:, :1])
    t_in[0] = torch.from_numpy(np.concatenate(
        [idx[:, :1], every - off[:, None, None] - 1], axis=1))
    t_in[1] = torch.from_numpy(np.ascontiguousarray(w[:, :2]))
    assert not tops.hash_encode(*t_in)[1].any()


# ---------------------------------------------------------------------------
# The CUDA route, with the device faked
# ---------------------------------------------------------------------------
def _small(rng=None):
    rng = rng or np.random.default_rng(0)
    hc = the.HashEncodingConfig(n_levels=4, log2_table_size=9,
                                base_resolution=4, max_resolution=32)
    table, meta, act = CS.encode_inputs(rng, hc, CPU, subnormal=False)
    pts = torch.from_numpy(rng.uniform(size=(5, 3)).astype(np.float32))
    per = [the.level_corner_data(pts, l, hc) for l in range(4)]
    act["zx"] = (act["zx_f"] - act["off"]).to(torch.int32)
    return (torch.stack([i for i, _ in per]),
            torch.stack([wl for _, wl in per]), table,
            meta[:, 3].contiguous(), act)


@pytest.fixture
def fake_card(monkeypatch):
    """Every tensor counts as on the card, the wrapper's device checks
    pass, and each launch of a C entry is recorded instead of run."""
    calls = []
    monkeypatch.setattr(tops, "_on_card", lambda t: True)
    monkeypatch.setattr(he, "require", lambda *a: None)
    monkeypatch.setattr(he, "launch",
                        lambda entry, dev, *args: calls.append((entry, args)))
    monkeypatch.setattr(he.hash_encode_corners_cuda, "launches", 0)
    return calls


def test_both_entry_points_launch_the_corners_kernel_once(fake_card,
                                                          monkeypatch):
    """`ops.hash_encode` -> one launch for the f32 encodings;
    `ops.fused_field_query` -> one launch for the codes, fed to the packed
    matmul; neither gathers or sums in tensor code."""
    def refuse(*args, **kwargs):
        raise AssertionError("the corner-data route gathered or summed "
                             "outside the kernel")

    fed = []
    monkeypatch.setattr(tops, "hash_gather_cuda", refuse)
    monkeypatch.setattr(he, "hash_gather_plain", refuse)
    monkeypatch.setattr(he, "trilinear_sum", refuse)
    monkeypatch.setattr(tops, "quant_matmul_packed_cuda",
                        lambda x, *a: fed.append(x) or x)
    idx, w, table, off, act = _small()
    enc = tops.hash_encode(idx, w, table, off)
    codes = tops.fused_field_query(idx, w, table, off,
                                   types.SimpleNamespace(scale=0.01), act)
    assert enc.dtype == torch.float32 and enc.shape == (5, 8)
    assert fed == [codes] and codes.dtype == torch.int8
    assert [(e, a[-1]) for e, a in fake_card] == [
        ("repro_hash_encode_corners", 0), ("repro_hash_encode_corners", 1)]
    assert he.hash_encode_corners_cuda.launches == 2


@pytest.mark.parametrize("needs_grad", ["table_cat", "corner_w"])
def test_corners_wrapper_refuses_a_gradient_under_grad_mode(fake_card,
                                                            needs_grad):
    """The kernel has no backward: a table or weights that require a
    gradient raise while grad mode is on, through `ops.hash_encode` as
    through the wrapper, and launch under `torch.no_grad()`."""
    idx, w, table, off, act = _small()
    if needs_grad == "table_cat":
        table.requires_grad_(True)
    else:
        w.requires_grad_(True)
    for call in (lambda: tops.hash_encode(idx, w, table, off),
                 lambda: he.hash_encode_corners_cuda(idx, w, table, off,
                                                     act)):
        with pytest.raises(RuntimeError, match="no backward"):
            call()
    assert fake_card == []
    with torch.no_grad():
        tops.hash_encode(idx, w, table, off)
    assert len(fake_card) == 1


def test_corners_wrapper_call_matches_its_ctypes_signature(fake_card):
    """The arguments `hash_encode_corners_cuda` hands the C entry (with
    the stream the launcher appends) fit the ctypes signature in
    `kernels/build.py`, one for one, and the C source declares as many
    parameters."""
    idx, w, table, off, act = _small()
    f32 = he.hash_encode_corners_cuda(idx, w, table, off)
    codes = he.hash_encode_corners_cuda(idx, w, table, off, act)
    assert f32.dtype == torch.float32 and codes.dtype == torch.int8
    src = (build.CSRC / "hash_encode.cu").read_text()
    n_c = len(re.search(r'extern "C" int repro_hash_encode_corners\(([^)]*)\)',
                        src).group(1).split(","))
    argtypes = build.SIGNATURES["repro_hash_encode_corners"]
    assert n_c == len(argtypes)
    for entry, args in fake_card:
        assert entry == "repro_hash_encode_corners"
        full = args + (0,)  # the stream
        assert len(full) == len(argtypes)
        for a, t in zip(full, argtypes):
            if t is ctypes.c_int:
                assert isinstance(a, int) and -2 ** 31 <= a < 2 ** 31
            else:
                assert t is ctypes.c_void_p and (a is None
                                                 or isinstance(a, int))
            t(a)  # ctypes takes it
    (_, first), (_, second) = fake_card
    assert first[-5:] == (5, 4, table.shape[0], 2, 0)
    assert first[4:8] == (None,) * 4  # no activation grid
    assert second[-1] == 1 and all(isinstance(a, int) for a in second[4:8])
