"""The port's encoder-decoder half (whisper) against the JAX package on
the CPU: full attention over separate query and key lengths
(`full_attention_plain` and `ops.full_attention` against the reference's
`_sdpa_chunked`), cross-attention (`attention(x_kv=...)`,
`precompute_cross_kv`, `decode_cross_attention` over a cache padded past
the encoder's length), `encode_source` with and without a spec, and the
prefill -> decode path on frames shorter than `max_source_len`, where the
reference attends over the cross cache's zero padding (no mask), and so
does the port.

Weights come from the reference's `init_attn` / `lm.init_params` and
cross through numpy (`lm_params_from_numpy`); inputs are drawn with
numpy. Tolerance 1e-5 relative in float32 (1e-6 absolute near 0), the
same operations in another summation order; `encode_source` (two layers
behind a layer norm, outputs of order 1) 1e-5 absolute; the whole
model's logits 2e-4, `tests/test_torch_lm.py`'s band."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention_kernel import full_attention_plain
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm

ARCH = "whisper-large-v3"
RTOL, ATOL = 1e-5, 1e-6
MODEL_TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny shapes gain nothing from more, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """(reference config, port config, reference params, port params) of
    whisper's smoke config (2 encoder and 2 decoder layers, d 64,
    max_source_len 24)."""
    jc, tc = j_get_arch(ARCH).smoke, get_arch(ARCH).smoke
    jp = jlm.init_params(jc, jax.random.PRNGKey(5))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return jc, tc, jp, tp


def _close(t: torch.Tensor, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=rtol, atol=atol)


def _normal(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(np.float32)


def _xattn(jp, layer):
    """Decoder layer `layer`'s cross-attention weights, reference side."""
    return jax.tree_util.tree_map(lambda a: a[layer],
                                  jp["blocks"]["pos0"]["xattn"])


# ---------------------------------------------------------------------------
# Full attention over separate query and key lengths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,Sq,Sk,Hkv,G,hd", [
    (2, 5, 24, 4, 1, 16), (1, 64, 150, 2, 3, 32), (2, 33, 7, 1, 4, 8),
    (1, 1, 1, 2, 2, 16)])
def test_full_attention_matches_the_reference_sdpa(B, Sq, Sk, Hkv, G, hd):
    q = _normal(B, Sq, Hkv * G, hd, seed=1)
    k = _normal(B, Sk, Hkv, hd, seed=2)
    v = _normal(B, Sk, Hkv, hd, seed=3)
    want = jattn._sdpa_chunked(*map(jnp.asarray, (q, k, v)), causal=False,
                               chunk=16)
    q5 = torch.from_numpy(q).view(B, Sq, Hkv, G, hd).permute(0, 2, 1, 3, 4)
    k4, v4 = (torch.from_numpy(a).permute(0, 2, 1, 3) for a in (k, v))
    for got in (full_attention_plain(q5, k4, v4), ops.full_attention(q5, k4,
                                                                     v4)):
        assert got.dtype == torch.float32 and got.shape == (B, Hkv, Sq, G,
                                                            hd)
        _close(got.permute(0, 2, 1, 3, 4).reshape(B, Sq, Hkv * G, hd), want)


# ---------------------------------------------------------------------------
# Cross-attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_rope", [False, True])
def test_attention_over_x_kv_matches(model, use_rope):
    """`attention(x_kv=...)`: non-causal, the keys not turned by the rotary
    embedding (only the queries, when asked)."""
    jc, tc, jp, tp = model
    x = _normal(2, 9, jc.d_model, seed=4)
    enc = _normal(2, 20, jc.d_model, seed=5)
    want = jattn.attention(_xattn(jp, 1), jnp.asarray(x), jc, causal=True,
                           x_kv=jnp.asarray(enc), use_rope=use_rope)
    got = tattn.attention(tp["blocks"][1]["xattn"], torch.from_numpy(x), tc,
                          causal=True, use_rope=use_rope,
                          x_kv=torch.from_numpy(enc))
    _close(got, want)


def test_precompute_cross_kv_matches(model):
    jc, tc, jp, tp = model
    enc = _normal(2, 20, jc.d_model, seed=6)
    want = jattn.precompute_cross_kv(_xattn(jp, 0), jnp.asarray(enc), jc)
    got = tattn.precompute_cross_kv(tp["blocks"][0]["xattn"],
                                    torch.from_numpy(enc), tc)
    assert set(got) == set(want) == {"k", "v"}
    for name in got:
        assert tuple(got[name].shape) == want[name].shape
        _close(got[name], want[name])


def test_decode_cross_attention_over_a_padded_cache_matches(model):
    """The cross cache holds 20 frames' K/V and 4 zero rows (up to
    max_source_len = 24); the reference's softmax takes the zero rows in
    (scores 0), and so does the port's decode kernel at length 24."""
    jc, tc, jp, tp = model
    enc = _normal(2, 20, jc.d_model, seed=7)
    kv = jattn.precompute_cross_kv(_xattn(jp, 1), jnp.asarray(enc), jc)
    pad = jc.max_source_len - 20
    kv = {n: jnp.pad(a, ((0, 0), (0, pad), (0, 0), (0, 0)))
          for n, a in kv.items()}
    x = _normal(2, 1, jc.d_model, seed=8)
    want = jattn.decode_cross_attention(_xattn(jp, 1), jnp.asarray(x), kv, jc)
    got = tattn.decode_cross_attention(
        tp["blocks"][1]["xattn"], torch.from_numpy(x),
        {n: torch.from_numpy(np.array(a)) for n, a in kv.items()}, tc)
    _close(got, want)
    # Masked to the 20 real rows the result differs: the padding counts.
    masked = tattn.decode_cross_attention(
        tp["blocks"][1]["xattn"], torch.from_numpy(x),
        {n: torch.from_numpy(np.array(a)[:, :20]) for n, a in kv.items()},
        tc)
    assert (masked - got).abs().max() > 1e-4


@pytest.mark.parametrize("spec", [False, True])
def test_encode_source_matches(model, spec):
    """Whisper's encoder over 20 frames; under a spec its layers take the
    spec's first `encoder_layers` rows."""
    jc, tc, jp, tp = model
    frames = _normal(2, 20, jc.d_model, seed=9, scale=0.02)
    js = ts = None
    if spec:
        rng = np.random.default_rng(10)
        L = jlm.total_layers(jc)
        bits = (rng.integers(2, 9, jc.n_embed_bands),
                rng.integers(2, 9, (L, jlm.N_GROUPS)),
                rng.integers(2, 9, (L, jlm.N_GROUPS)))
        js = jlm.LMQuantSpec(*(jnp.asarray(b, jnp.float32) for b in bits))
        ts = tlm.LMQuantSpec(*(torch.tensor(b, dtype=torch.float32)
                               for b in bits))
    want = jlm.encode_source(jp, jnp.asarray(frames), jc, js)
    got = tlm.encode_source(tp, torch.from_numpy(frames), tc, ts)
    _close(got, want, RTOL, 1e-5)


def test_lm_params_from_numpy_unstacks_the_encoder(model):
    jc, _, jp, tp = model
    assert len(tp["enc_blocks"]) == jc.encoder_layers
    assert len(tp["blocks"]) == jc.n_layers
    for l in range(jc.encoder_layers):
        np.testing.assert_array_equal(
            tp["enc_blocks"][l]["attn"]["wq"].numpy(),
            np.asarray(jp["enc_blocks"]["pos0"]["attn"]["wq"][l]))
    assert set(tp["blocks"][0]) == {"ln1", "attn", "ln_x", "xattn", "ln2",
                                    "ffn"}
    for key in ("enc_pos_embed", "enc_final_norm", "pos_embed"):
        assert key in tp


# ---------------------------------------------------------------------------
# The model: frames shorter than max_source_len
# ---------------------------------------------------------------------------
def test_prefill_and_decode_on_short_frames_reproduce_the_reference(model):
    """Prefill over 20 frames (the cross cache zero-padded to 24), then
    decode steps fed the reference's greedy tokens: logits and every
    cache leaf against the reference's, whose cross decode attends over
    the padding too."""
    jc, tc, jp, tp = model
    rng = np.random.default_rng(11)
    B, S, steps = 2, 12, 4
    toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    frames = _normal(B, 20, jc.d_model, seed=12, scale=0.02)
    jl, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(toks),
                                  "frames": jnp.asarray(frames)}, jc,
                             S + steps)
    with torch.no_grad():
        tl, tcache = tlm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                      "frames": torch.from_numpy(frames)},
                                 tc, S + steps)
    _close(tl, jl, MODEL_TOL, MODEL_TOL)
    assert set(tcache["pos0"]) == set(jcache["pos0"]) == {"k", "v", "xk",
                                                          "xv"}
    assert float(tcache["pos0"]["xk"][:, :, 20:].abs().max()) == 0.0
    for i in range(steps):
        jt = jnp.argmax(jl[:, -1], -1)[:, None]
        jl, jcache = jlm.decode_step(jp, jcache, jt, jnp.int32(S + i), jc)
        with torch.no_grad():
            tl, tcache = tlm.decode_step(tp, tcache, torch.from_numpy(
                np.array(jt)).long(), S + i, tc)
        _close(tl, jl, MODEL_TOL, MODEL_TOL)
    for name in jcache["pos0"]:
        assert tcache["pos0"][name].shape == jcache["pos0"][name].shape
        _close(tcache["pos0"][name], jcache["pos0"][name], MODEL_TOL,
               MODEL_TOL)
