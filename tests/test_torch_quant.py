"""Parity of the port's quantization grids and storage codec with the JAX
package: packed words, repacks, qparams and stored byte counts are equal
bit for bit (tolerance 0 everywhere: the reference is exact here)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import repack as jrepack
from repro.quant import linear_quant as jlq
from repro.quant import packing as jpk
from repro.quant import qat as jqat
from repro_torch.convert import packed_from_numpy
from repro_torch.kernels import repack as trepack
from repro_torch.quant import linear_quant as tlq
from repro_torch.quant import packing as tpk
from repro_torch.quant import qat as tqat

SHAPES = [(37, 5), (33,), (5, 4, 3)]


def _codes(rng, shape, bits, full_span):
    lo = -(2 ** (bits - 1)) - (1 if full_span else 0)
    hi = 2 ** (bits - 1) - 1
    return rng.randint(lo, hi + 1, size=shape)


def _same_packed(t: tpk.PackedTensor, j) -> None:
    np.testing.assert_array_equal(t.words.numpy(), np.asarray(j.words))
    assert t.words.dtype == torch.int32
    assert int(t.offset) == int(j.offset)
    assert t.scale.numpy().tobytes() == np.asarray(j.scale).tobytes()
    assert (t.bits, t.shape, t.layout) == (j.bits, tuple(j.shape), j.layout)


@pytest.mark.parametrize("bits", range(1, 9))
def test_pack_codes_words_equal_reference(bits):
    rng = np.random.RandomState(bits)
    for shape in (SHAPES[bits % 3], SHAPES[(bits + 1) % 3]):
        for full_span in (False, True):
            q = _codes(rng, shape, bits, full_span)
            t = tpk.pack_codes(q, bits, scale=0.0123, device="cpu")
            j = jpk.pack_codes(q, bits, scale=0.0123)
            _same_packed(t, j)
            np.testing.assert_array_equal(t.codes().numpy(),
                                          np.asarray(j.codes()))
            np.testing.assert_array_equal(
                t.dequantize().numpy(), np.asarray(j.dequantize()))
            assert t.nbytes_packed == j.nbytes_packed


def test_full_span_clamps_one_lsb_like_reference():
    """The paper-exact grid's 2^b + 1 levels: only the lowest code moves,
    up by one, in both packages."""
    bits = 3
    q = np.array([[-5], [-4], [0], [3]])
    t = tpk.pack_codes(q, bits, device="cpu").codes().numpy()
    np.testing.assert_array_equal(t, [[-4], [-4], [0], [3]])
    np.testing.assert_array_equal(
        t, np.asarray(jpk.pack_codes(q, bits).codes()))


@pytest.mark.parametrize("bits", [1, 3, 8])
@pytest.mark.parametrize("bk", [32, 128])
def test_repack_and_unrepack_byte_equal(bits, bk):
    rng = np.random.RandomState(10 * bits + bk)
    for rows in (31, 129):
        q = _codes(rng, (rows, 7), bits, False)
        j = jpk.pack_codes(q, bits, scale=0.5)
        t = packed_from_numpy(j, device="cpu")
        jt = jrepack.repack_tile_native(j, bk)
        tt = trepack.repack_tile_native(t, bk)
        _same_packed(tt, jt)
        _same_packed(trepack.unrepack_planar(tt), jrepack.unrepack_planar(jt))
        np.testing.assert_array_equal(tt.codes().numpy(),
                                      np.asarray(jt.codes()))


@pytest.mark.parametrize("bits", [1, 2, 4, 6, 8, 12, 16])
def test_qparams_and_quantizers_equal_reference(bits):
    rng = np.random.RandomState(bits)
    x = rng.normal(size=(64, 9)).astype(np.float32)
    x[0, :4] = [0.5, 1.5, -2.5, 2.5]  # round-half-to-even ties
    lo, hi = float(x.min()), float(x.max())
    tx = torch.from_numpy(x)
    for paper_exact in (True, False):
        tw = tlq.weight_qparams(tx.min(), tx.max(), bits, paper_exact)
        jw = jlq.weight_qparams(jnp.min(x), jnp.max(x), bits, paper_exact)
        for a, b in zip(tw, jw):
            assert a.numpy().tobytes() == np.asarray(b, np.float32).tobytes()
        np.testing.assert_array_equal(
            tlq.fake_quant_weight(tx, tw).numpy(),
            np.asarray(jlq.fake_quant_weight(jnp.asarray(x), jw)))
    # Activation ranges arrive as host floats: differenced in double.
    ta = tlq.activation_qparams(lo, hi, bits)
    ja = jlq.activation_qparams(lo, hi, bits)
    for a, b in zip(ta, ja):
        assert a.numpy().tobytes() == np.asarray(b, np.float32).tobytes()
    np.testing.assert_array_equal(
        tlq.quantize_activation(tx, ta).numpy(),
        np.asarray(jlq.quantize_activation(jnp.asarray(x), ja)))
    np.testing.assert_array_equal(
        tlq.fake_quant_activation(tx, ta).numpy(),
        np.asarray(jlq.fake_quant_activation(jnp.asarray(x), ja)))


def test_ste_fake_quant_forward_and_gradient_equal_reference():
    import jax

    rng = np.random.RandomState(3)
    x = rng.uniform(-1.0, 1.0, size=(50,)).astype(np.float32)
    x[:3] = [2.0, -2.0, 0.3]  # outside the clip range: zero gradient
    qp_j = jlq.weight_qparams(jnp.asarray(-0.9, jnp.float32),
                              jnp.asarray(0.9, jnp.float32), 4)
    qp_t = tlq.weight_qparams(torch.tensor(-0.9), torch.tensor(0.9), 4)
    for symmetric in (True, False):
        qj = qp_j if symmetric else jlq.activation_qparams(-0.9, 0.9, 4)
        qt = qp_t if symmetric else tlq.activation_qparams(-0.9, 0.9, 4)
        fj = lambda v: jqat.ste_fake_quant(v, qj, symmetric)  # noqa: E731
        want = np.asarray(fj(jnp.asarray(x)))
        g_want = np.asarray(jax.grad(lambda v: jnp.sum(fj(v) * 3.0))(
            jnp.asarray(x)))
        tx = torch.from_numpy(x).requires_grad_(True)
        got = tqat.ste_fake_quant(tx, qt, symmetric)
        (got * 3.0).sum().backward()
        np.testing.assert_array_equal(got.detach().numpy(), want)
        np.testing.assert_array_equal(tx.grad.numpy(), g_want)


def test_store_nbytes_and_policy_model_bytes_equal_reference():
    for rows, cols in [(1, 1), (31, 2), (32, 2), (4913, 2), (64, 3)]:
        for bits in [1, 3, 8, 9, 12, 16, 32]:
            assert float(tpk.tensor_store_nbytes(rows, cols, bits)) == \
                float(jpk.tensor_store_nbytes(rows, cols, bits))
    entries = [4913, 35937, 524288]
    dims = [(32, 64), (64, 16), (40, 64), (64, 64), (64, 3)]
    hb, wb = [2, 6, 16], [1, 4, 8, 12, 32]
    assert float(tpk.policy_model_bytes(entries, 2, dims, hb, wb)) == \
        float(jpk.policy_model_bytes(entries, 2, dims, hb, wb))
