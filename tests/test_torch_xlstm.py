"""The port's xLSTM blocks (`repro_torch.models.xlstm_blocks`) against the
JAX package's on the CPU: parameter layouts and seeded init, the mLSTM's
parallel form over query chunks with a remainder tail, both cells' final
states (the decode cache a prefill leaves), the sLSTM's recurrence, both
decode steps continuing from those states, and the initial caches (the
stabilizer m at -1e30).

Weights come from the reference's `init_mlstm` / `init_slstm` and cross
as numpy arrays; inputs are drawn with numpy. Tolerance 1e-5 relative in
float32 (1e-6 absolute near 0): the same operations in another
summation order."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import xlstm_blocks as jxl
from repro_torch.configs import get_arch
from repro_torch.models import xlstm_blocks as txl

ARCH = "xlstm-350m"
RTOL, ATOL = 1e-5, 1e-6
# attn_chunk 32 at S = 70: two query chunks and a tail of 6.
CHUNK, S_TAIL = 32, 70


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny shapes gain nothing from more, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cells():
    """(reference config, port config, {cell: (reference params, port
    params)}), attn_chunk cut to CHUNK."""
    jc = dataclasses.replace(j_get_arch(ARCH).smoke, attn_chunk=CHUNK)
    tc = dataclasses.replace(get_arch(ARCH).smoke, attn_chunk=CHUNK)
    out = {}
    for name, init in (("mlstm", jxl.init_mlstm), ("slstm", jxl.init_slstm)):
        jp = init(jax.random.PRNGKey(len(name)), jc)
        out[name] = (jp, {k: torch.from_numpy(np.array(v))
                          for k, v in jp.items()})
    return jc, tc, out


def _x(S, d, seed=0, B=2):
    return np.random.default_rng(seed).normal(size=(B, S, d)) \
        .astype(np.float32)


def _close(t: torch.Tensor, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_layouts_and_seeded_init_follow_the_reference(cells, cell):
    jc, tc, ps = cells
    jp = ps[cell][0]
    shapes = {"mlstm": (txl.mlstm_param_shapes, jxl.mlstm_param_shapes),
              "slstm": (txl.slstm_param_shapes, jxl.slstm_param_shapes)}
    assert shapes[cell][0](tc) == shapes[cell][1](jc)
    init = txl.init_mlstm if cell == "mlstm" else txl.init_slstm
    a = init(torch.Generator().manual_seed(3), tc)
    b = init(torch.Generator().manual_seed(3), tc)
    assert set(a) == set(jp)
    for name, w in a.items():
        assert tuple(w.shape) == jp[name].shape, name
        assert str(w.dtype).split(".")[-1] == str(jp[name].dtype), name
        assert torch.equal(w, b[name])
    for name in ("norm_scale", "bf", "bi", "b"):
        if name in a:
            np.testing.assert_array_equal(a[name].numpy(),
                                          np.asarray(jp[name]))


@pytest.mark.parametrize("S", [1, CHUNK, S_TAIL])
def test_mlstm_forward_matches(cells, S):
    """One chunk (S <= attn_chunk) and two chunks with a remainder
    tail."""
    jc, tc, ps = cells
    jp, tp = ps["mlstm"]
    x = _x(S, jc.d_model, seed=S)
    _close(txl.mlstm_forward(tp, torch.from_numpy(x), tc),
           jxl.mlstm_forward(jp, jnp.asarray(x), jc))


def test_slstm_forward_and_state_match(cells):
    jc, tc, ps = cells
    jp, tp = ps["slstm"]
    x = _x(S_TAIL, jc.d_model, seed=1)
    tx = torch.from_numpy(x)
    want = jxl.slstm_forward(jp, jnp.asarray(x), jc)
    _close(txl.slstm_forward(tp, tx, tc), want)
    jstate = jxl.slstm_final_state(jp, jnp.asarray(x), jc)
    out, tstate = txl.slstm_forward_with_state(tp, tx, tc)
    _close(out, want)
    for st in (tstate, txl.slstm_final_state(tp, tx, tc)):
        assert set(st) == set(jstate) == {"c", "n", "h", "m"}
        for name in st:
            _close(st[name], jstate[name])


def test_mlstm_final_state_matches(cells):
    jc, tc, ps = cells
    jp, tp = ps["mlstm"]
    x = _x(S_TAIL, jc.d_model, seed=2)
    jstate = jxl.mlstm_final_state(jp, jnp.asarray(x), jc)
    tstate = txl.mlstm_final_state(tp, torch.from_numpy(x), tc)
    assert set(tstate) == set(jstate) == {"C", "n", "m"}
    for name in tstate:
        assert tuple(tstate[name].shape) == jstate[name].shape
        _close(tstate[name], jstate[name])


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_decode_steps_continue_the_prefix(cells, cell):
    """Decode steps from the final state of a 40-position prefix, and
    from the initial cache, against the reference's."""
    jc, tc, ps = cells
    jp, tp = ps[cell]
    j_fin = getattr(jxl, f"{cell}_final_state")
    t_fin = getattr(txl, f"{cell}_final_state")
    j_step = getattr(jxl, f"{cell}_decode_step")
    t_step = getattr(txl, f"{cell}_decode_step")
    x = _x(43, jc.d_model, seed=3)
    jcache = j_fin(jp, jnp.asarray(x[:, :40]), jc)
    tcache = t_fin(tp, torch.from_numpy(x[:, :40]), tc)
    for t in range(40, 43):
        want, jcache = j_step(jp, jnp.asarray(x[:, t:t + 1]), jcache, jc)
        got, tcache = t_step(tp, torch.from_numpy(x[:, t:t + 1]), tcache,
                             tc)
        _close(got, want)
        for name in tcache:
            _close(tcache[name], jcache[name])
    j0 = getattr(jxl, f"init_{cell}_cache")(jc, 2)
    t0 = getattr(txl, f"init_{cell}_cache")(tc, 2, torch.device("cpu"))
    assert set(t0) == set(j0)
    for name in t0:
        np.testing.assert_array_equal(t0[name].numpy(), np.asarray(j0[name]))
    assert float(t0["m"].max()) == float(np.float32(-1e30))
    want, _ = j_step(jp, jnp.asarray(x[:, :1]), j0, jc)
    got, _ = t_step(tp, torch.from_numpy(x[:, :1]), t0, tc)
    _close(got, want)
