"""The port's Mamba block (`repro_torch.models.ssm`) against the JAX
package's on the CPU: the parameter layout and its seeded init, the
causal conv, `ssm_forward` over one chunk (S = 130, not a multiple of
128, falls back to a single chunk) and over two (S = 256), with
`return_state`, and `ssm_decode_step` continuing from that state.

Weights come from the reference's `init_ssm` and cross as numpy arrays;
inputs are drawn with numpy. Tolerance 1e-5 relative in float32 (and
1e-6 absolute for values near 0): the port's within-chunk scan combines
positions in a log-step (Hillis-Steele) order, the reference's
`associative_scan` in another, so the two agree to rounding, not bit for
bit. The causal conv adds its shifts in the reference's order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import ssm as jssm
from repro_torch.configs import get_arch
from repro_torch.models import ssm as tssm

ARCH = "jamba-v0.1-52b"
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny shapes gain nothing from more, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def block():
    """(reference config, port config, reference params, port params)."""
    jc, tc = j_get_arch(ARCH).smoke, get_arch(ARCH).smoke
    jp = jssm.init_ssm(jax.random.PRNGKey(4), jc)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jc, tc, jp, tp


def _x(S, d, seed=0, B=2):
    return np.random.default_rng(seed).normal(size=(B, S, d)) \
        .astype(np.float32)


def _close(t: torch.Tensor, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                               atol=ATOL)


def test_dims_shapes_and_seeded_init_follow_the_reference(block):
    jc, tc, jp, _ = block
    assert tssm.ssm_dims(tc) == jssm.ssm_dims(jc)
    assert tssm.ssm_param_shapes(tc) == jssm.ssm_param_shapes(jc)
    a = tssm.init_ssm(torch.Generator().manual_seed(3), tc)
    b = tssm.init_ssm(torch.Generator().manual_seed(3), tc)
    assert set(a) == set(jp)
    for name, w in a.items():
        assert tuple(w.shape) == jp[name].shape, name
        assert str(w.dtype).split(".")[-1] == str(jp[name].dtype), name
        assert torch.equal(w, b[name])
    # The deterministic leaves equal the reference's; softplus(dt bias)
    # lands in the reference's [1e-3, 1e-1] step range.
    for name in ("A_log", "D", "conv_b"):
        np.testing.assert_array_equal(a[name].numpy(), np.asarray(jp[name]))
    dt = torch.nn.functional.softplus(a["dt_proj_b"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)


def test_causal_conv_matches(block):
    jc, _, jp, tp = block
    x = _x(9, tssm.ssm_dims(jc)[0], seed=1)
    _close(tssm._causal_conv(torch.from_numpy(x), tp["conv_w"], tp["conv_b"]),
           jssm._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"]))


def test_scan_chunk_equals_the_sequential_recurrence():
    """The log-step scan against the plain loop h = a_t h + x_t."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 3, 4))
                         .astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2, 37, 3, 4)).astype(np.float32))
    acc_a, acc_x = tssm._scan_chunk(a, x)
    h, p = torch.zeros_like(x[:, 0]), torch.ones_like(a[:, 0])
    for t in range(37):
        h = a[:, t] * h + x[:, t]
        p = p * a[:, t]
        torch.testing.assert_close(acc_x[:, t], h, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(acc_a[:, t], p, rtol=1e-6, atol=0)


@pytest.mark.parametrize("S", [1, 16, 130, 256])
def test_ssm_forward_and_state_match(block, S):
    """One chunk (S < 128, and S = 130 % 128 != 0) and two (S = 256)."""
    jc, tc, jp, tp = block
    x = _x(S, jc.d_model, seed=S)
    want, jstate = jssm.ssm_forward(jp, jnp.asarray(x), jc,
                                    return_state=True)
    got, tstate = tssm.ssm_forward(tp, torch.from_numpy(x), tc,
                                   return_state=True)
    _close(got, want)
    assert set(tstate) == set(jstate) == {"conv", "ssm"}
    for name in tstate:
        assert tuple(tstate[name].shape) == jstate[name].shape
        _close(tstate[name], jstate[name])
    _close(tssm.ssm_forward(tp, torch.from_numpy(x), tc), want)


def test_ssm_decode_steps_continue_the_prefix(block):
    """Decode steps from `return_state`'s cache, fed the same tokens,
    against the reference's steps from its own cache."""
    jc, tc, jp, tp = block
    x = _x(133, jc.d_model, seed=7)
    _, jcache = jssm.ssm_forward(jp, jnp.asarray(x[:, :130]), jc,
                                 return_state=True)
    _, tcache = tssm.ssm_forward(tp, torch.from_numpy(x[:, :130]), tc,
                                 return_state=True)
    for t in range(130, 133):
        want, jcache = jssm.ssm_decode_step(jp, jnp.asarray(x[:, t:t + 1]),
                                            jcache, jc)
        got, tcache = tssm.ssm_decode_step(tp, torch.from_numpy(
            x[:, t:t + 1]), tcache, tc)
        _close(got, want)
        for name in ("conv", "ssm"):
            _close(tcache[name], jcache[name])
    # The decode from the initial cache equals the reference's.
    jc0 = jssm.init_ssm_cache(jc, 2)
    tc0 = tssm.init_ssm_cache(tc, 2, torch.device("cpu"))
    for name in ("conv", "ssm"):
        assert tuple(tc0[name].shape) == jc0[name].shape
        assert str(tc0[name].dtype).split(".")[-1] == str(jc0[name].dtype)
    want, _ = jssm.ssm_decode_step(jp, jnp.asarray(x[:, :1]), jc0, jc)
    got, _ = tssm.ssm_decode_step(tp, torch.from_numpy(x[:, :1]), tc0, tc)
    _close(got, want)
