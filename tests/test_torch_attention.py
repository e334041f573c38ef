"""The port's kernels 5-7 (unpacked quant_matmul, flash attention, flash
decoding) through `repro_torch.kernels.ops` (their plain versions on the
CPU) against the JAX package's Pallas kernels in interpret mode and its
`ref.*_ref` oracles, on the same numpy inputs.

Tolerances: the integer matmul is exact (the reference is exact).
Attention is float: 1e-5 in float32 (summation order only); in bfloat16
3e-2 for flash and 2e-2 for decode, the bands of `tests/test_kernels.py`
(p is rounded to bf16 before the PV product, at a different running
maximum in each implementation)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import _sdpa_chunked
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels._launch import require_aligned
from repro_torch.kernels.decode_attention_kernel import (
    FAC_MAX,
    KV_SMEM,
    SPLIT_MAX,
    split_len,
)
from repro_torch.models.attention import grouped_attention

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


# ---------------------------------------------------------------------------
# quant_matmul: exact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (70, 200, 90), (128, 128, 128),
                                   (129, 257, 65)])
@pytest.mark.parametrize("zx", [0, 17, 128])
def test_quant_matmul_exact(m, k, n, zx):
    rng = np.random.default_rng(m * 1000 + k + n)
    x = rng.integers(0, 256, (m, k)).astype(np.uint8).view(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    got = tops.quant_matmul(torch.from_numpy(x), torch.from_numpy(w), 0.037,
                            0.011, zx)
    pallas = jops.quant_matmul(jnp.asarray(x), jnp.asarray(w), 0.037, 0.011,
                               zx, use_pallas=True, bm=32, bn=32, bk=64)
    oracle = jref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(w), 0.037,
                                   0.011, zx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))
    assert got.dtype == torch.float32 and got.shape == (m, n)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_quant_matmul_bits_range_exact(bits):
    rng = np.random.default_rng(bits)
    hi = 2 ** (bits - 1) - 1
    x = rng.integers(0, 2 ** bits, (33, 47)).astype(np.uint8).view(np.int8)
    w = rng.integers(-hi, hi + 1, (47, 21)).astype(np.int8)
    got = tops.quant_matmul(torch.from_numpy(x), torch.from_numpy(w), 1.0,
                            1.0, 2 ** (bits - 1))
    want = jref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(w), 1.0, 1.0,
                                 2 ** (bits - 1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tref.quant_matmul_ref(torch.from_numpy(x), torch.from_numpy(w), 1.0,
                              1.0, 2 ** (bits - 1)).numpy(), got.numpy())


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,hkv,g,s,hd", [(1, 1, 1, 32, 16), (2, 4, 3, 100, 16),
                                          (2, 2, 8, 257, 64),
                                          (2, 2, 7, 300, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention(b, hkv, g, s, hd, dtype):
    rng = np.random.default_rng(b + s + hd)
    q_np = rng.normal(size=(b, hkv, g, hd)).astype(np.float32)
    k_np = rng.normal(size=(b, hkv, s, hd)).astype(np.float32)
    v_np = rng.normal(size=(b, hkv, s, hd)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q_np, k_np, v_np))
    length = s - 5
    got = tops.decode_attention(tq, tk, tv, length)
    assert got.dtype == tq.dtype and got.shape == (b, hkv, g, hd)
    pallas = jops.decode_attention(jq, jk, jv, jnp.int32(length),
                                   use_pallas=True, bs=64)
    oracle = jref.decode_attention_ref(jq, jk, jv, jnp.int32(length))
    tol = 1e-5 if dtype == "float32" else 2e-2
    for want in (pallas, oracle):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_decode_attention_masks_future():
    """Entries at or beyond `length` must not affect the output."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(1, 2, 2, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 2, 64, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 2, 64, 16)).astype(np.float32))
    base = tops.decode_attention(q, k, v, 20)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 20:] = 99.0
    v2[:, :, 20:] = -99.0
    poisoned = tops.decode_attention(q, k2, v2, torch.tensor(20))
    np.testing.assert_allclose(base.numpy(), poisoned.numpy(), atol=1e-6)
    want = jops.decode_attention(jnp.asarray(q.numpy()), jnp.asarray(k2.numpy()),
                                 jnp.asarray(v2.numpy()), jnp.int32(20),
                                 use_pallas=True, bs=16)
    np.testing.assert_allclose(poisoned.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _masked_scores(q, k, length):
    """(B, Hkv, G, S) f32 scores of q against k, positions < length."""
    s = torch.einsum("bhgd,bhsd->bhgs", q.float(), k.float()) \
        / np.sqrt(q.shape[-1])
    return s[..., :length]


def _decode_inputs(seed, b, hkv, g, s, hd, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 .to(dtype) for shape in ((b, hkv, g, hd), (b, hkv, s, hd),
                                          (b, hkv, s, hd)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", [1, 37, 100])
def test_decode_attention_lse_is_the_logsumexp_of_the_masked_scores(dtype,
                                                                    length):
    """Kernel 7's partial form on the CPU: the f32 output of the plain
    form unrounded, and the log-sum-exp of the scores at positions <
    length."""
    q, k, v = _decode_inputs(length, 2, 3, 4, 100, 32, dtype)
    out, lse = tops.decode_attention(q, k, v, length, lse=True)
    assert out.dtype == lse.dtype == torch.float32
    assert out.shape == q.shape and lse.shape == q.shape[:3]
    want = torch.logsumexp(_masked_scores(q, k, length), dim=-1)
    assert (lse - want).abs().max() <= 1e-5 * want.abs().max()
    plain = tops.decode_attention(q, k, v, length)
    assert torch.equal(out.to(dtype), plain)


def test_decode_attention_of_an_empty_block_is_zero_and_minus_inf():
    """A block of the cache wholly past the token (length 0), given as an
    int and as a tensor: zero output, -inf log-sum-exp, no NaN; without
    `lse`, zero in q's dtype."""
    q, k, v = _decode_inputs(5, 2, 2, 3, 16, 16)
    for n in (0, torch.tensor(0)):
        out, lse = tops.decode_attention(q, k, v, n, lse=True)
        assert torch.equal(out, torch.zeros_like(out))
        assert torch.equal(lse, torch.full_like(lse, -torch.inf))
        assert torch.equal(tops.decode_attention(q, k, v, n),
                           torch.zeros_like(q))


@pytest.mark.parametrize("blocks", [1, 2, 4])
@pytest.mark.parametrize("length", [1, 9, 40, 64])
def test_combined_blocks_equal_the_whole_cache(blocks, length):
    """Flash decoding over ranks, in one process: the cache cut into
    `blocks` blocks of positions (those wholly past the token empty),
    kernel 7's partial form on each at its length clamp(length - lo, 0,
    S / blocks), merged by `combine_partials`: the whole cache's output
    within 1e-6 (float32)."""
    from repro_torch.distributed.sharding import combine_partials

    S = 64
    q, k, v = _decode_inputs(blocks * 100 + length, 2, 2, 4, S, 32)
    n = S // blocks
    parts = [tops.decode_attention(
        q, k[:, :, r * n:(r + 1) * n], v[:, :, r * n:(r + 1) * n],
        min(max(length - r * n, 0), n), lse=True) for r in range(blocks)]
    got = combine_partials(torch.stack([o for o, _ in parts]),
                           torch.stack([l for _, l in parts]))
    want = tops.decode_attention(q, k, v, length)
    assert (got - want).abs().max() <= 1e-6


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,hkv,g,s,hd", [(1, 1, 1, 64, 16), (2, 2, 4, 96, 32),
                                          (1, 4, 2, 130, 64),
                                          (1, 2, 7, 100, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_causal(b, hkv, g, s, hd, dtype):
    rng = np.random.default_rng(s + hd)
    q_np = rng.normal(size=(b, hkv, s, g, hd)).astype(np.float32)
    k_np = rng.normal(size=(b, hkv, s, hd)).astype(np.float32)
    v_np = rng.normal(size=(b, hkv, s, hd)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q_np, k_np, v_np))
    got = tops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.float32 and got.shape == (b, hkv, s, g, hd)
    pallas = jops.flash_attention(jq, jk, jv, causal=True, use_pallas=True,
                                  bq=32, bk=32)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=True)
    tol = 1e-5 if dtype == "float32" else 3e-2
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.numpy(), _f32(want), rtol=tol, atol=tol)


def test_flash_attention_noncausal():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(1, 2, 128, 2, 16)).astype(np.float32)
    k = rng.normal(size=(1, 2, 128, 16)).astype(np.float32)
    v = rng.normal(size=(1, 2, 128, 16)).astype(np.float32)
    got = tops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False)
    pallas = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=False,
                                  use_pallas=True, bq=32, bk=32)
    oracle = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                      causal=False)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_flash_attention_noncausal_ragged_raises_as_the_reference():
    q = np.zeros((1, 1, 100, 2, 16), np.float32)
    k = np.zeros((1, 1, 100, 16), np.float32)
    with pytest.raises(ValueError, match="S % bk"):
        jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                             causal=False, use_pallas=True)
    with pytest.raises(ValueError, match="S % bk"):
        tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(k), causal=False)


def test_grouped_attention_on_views_matches_model_attention():
    """The model layout (B, S, H, hd), handed to the kernel as strided
    views, against the reference model's chunked attention; query head h
    belongs to KV head h // G."""
    rng = np.random.default_rng(7)
    B, S, Hkv, G, hd = 2, 64, 2, 3, 16
    q = rng.normal(size=(B, S, Hkv * G, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
    got = grouped_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    want = _sdpa_chunked(*map(jnp.asarray, (q, k, v)), causal=True, chunk=32)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).reshape(B, S, -1),
                               rtol=2e-4, atol=2e-4)
    # The kernel's own layout, from the same arrays.
    q5 = np.moveaxis(q.reshape(B, S, Hkv, G, hd), 1, 2)
    out5 = tops.flash_attention(torch.from_numpy(q5),
                                torch.from_numpy(np.moveaxis(k, 1, 2)),
                                torch.from_numpy(np.moveaxis(v, 1, 2)))
    np.testing.assert_allclose(
        np.moveaxis(out5.numpy(), 2, 1).reshape(B, S, -1), got.numpy(),
        rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Host-side choices of the CUDA wrappers (plain Python: no card needed)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_seq,S,G,hd,esize", [
    (16, 1056, 7, 128, 2),  # qwen2-7b decode at batch 4
    (16, 1056, 7, 128, 4),
    (1, 1056, 7, 128, 2),
    (64, 1056, 7, 128, 2),
    (2, 300, 3, 40, 2),
    (4, 100_000, 16, 128, 2),
    (1, 200, 16, 256, 4),
])
def test_decode_split_len_fills_the_card_within_its_limits(n_seq, S, G, hd,
                                                           esize):
    n_sm = 132
    sp = split_len(n_seq, S, G, hd, esize, n_sm)
    row = -(-hd * esize // 16) * 16
    most = min(SPLIT_MAX, KV_SMEM // (2 * row))
    assert sp % 16 == 0 and 16 <= sp <= most
    assert G * -(-S // sp) <= FAC_MAX
    if 16 < sp < most:  # no limit reached: about three blocks an SM
        assert 2 * n_sm <= n_seq * -(-S // sp) <= 4 * n_sm


def test_decode_split_len_refuses_a_cache_too_long_for_the_combine():
    with pytest.raises(ValueError, match="positions"):
        split_len(1, 10 ** 6, 16, 128, 2, 132)


def test_require_aligned_refuses_what_16_byte_copies_cannot_take():
    n = 4 * 64 * 2 * 16
    flat = torch.zeros(n + 8, dtype=torch.bfloat16)
    cache = flat[:n].view(4, 64, 2, 16)
    require_aligned(cache.permute(0, 2, 1, 3), "k")  # the model's view
    with pytest.raises(ValueError, match="16-byte boundary"):
        require_aligned(flat[1:n + 1].view(4, 64, 2, 16), "k")
    wide = torch.zeros((4, 64, 2, 20), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="stride 20 on axis 1"):
        require_aligned(wide[..., :16].permute(0, 2, 1, 3), "k")
    # An axis of length one may have any stride; float32 counts in fours.
    require_aligned(wide[:, :, :1, :16], "k")
    require_aligned(torch.zeros((3, 5, 12), dtype=torch.float32), "q")
    with pytest.raises(ValueError, match="multiple of 4 elements"):
        require_aligned(torch.zeros((3, 5, 6), dtype=torch.float32), "q")
