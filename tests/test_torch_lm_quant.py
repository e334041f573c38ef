"""The LM quantization path against the JAX package on the CPU: the fake
quantizers of `models/lm.py` (exact), the mixture of experts
(`models/ffn.py`), `forward` and `loss_fn` over the six attention-only arch
configs, and the `roofline-lm` target.

Weights come from the reference's `init_params` / `init_moe` and cross
through `lm_params_from_numpy`; token batches are drawn with numpy.
Tolerances:

- `embed_band_boundaries`, `quant_embedding`, `_quant_block_weights` and
  `_maybe_quant_a`: exact at 2, 4, 8 and 32 bits (both packages round
  half to even in float32 over the same min/max);
- `moe_ffn`: expert ids and gates exact against the reference's `top_k`;
  positions, keep mask and slot maps exact against the reference's
  dispatch lines run in jnp (below); output within 1e-6 of its largest
  magnitude (a few float32 ulps: the expert products and the dense
  residual sum in another order), aux loss within 1e-6 relative; one
  case whose capacity drops pairs;
- `forward` / `loss_fn` under no spec, `no_lm_quant` and a mixed spec:
  loss, cross entropy and aux within 1e-5 relative, logits within 1e-5;
  prefill and decode of the MoE archs within 2e-4 (`test_torch_lm.py`'s
  band);
- the roofline: `build_workload` exact, `simulate`, `baseline` and the
  batched form within 1e-6 relative with `hbm_gbps=819.0` given to the
  port (the reference's TPU v5e preset)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_arch as j_get_arch
from repro.hero import targets as jtg
from repro.models import ffn as jffn
from repro.models import lm as jlm
from repro.models.common import MoEConfig as JMoEConfig
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.hero import targets as ttg
from repro_torch.models import ffn as tffn
from repro_torch.models import lm as tlm
from repro_torch.models.common import MoEConfig

ARCHS = ["qwen2-7b", "llama3-405b", "granite-34b", "nemotron-4-340b",
         "arctic-480b", "qwen3-moe-235b-a22b"]
MOE_ARCHS = ["arctic-480b", "qwen3-moe-235b-a22b"]
BITS = [2, 4, 8, 32]
REL = 1e-5
MOE_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny shapes gain nothing from more, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def arch_models(request):
    """(arch, reference config, port config, reference params, port
    params)."""
    arch = request.param
    jc, tc = j_get_arch(arch).smoke, get_arch(arch).smoke
    jp = jlm.init_params(jc, jax.random.PRNGKey(3))
    return arch, jc, tc, jp, lm_params_from_numpy(_np_tree(jp), device="cpu")


def _tokens(cfg, B=4, S=64, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _mixed_bits(cfg, seed=1):
    rng = np.random.default_rng(seed)
    L = jlm.total_layers(cfg)
    return (rng.integers(2, 9, cfg.n_embed_bands).astype(np.float32),
            rng.integers(2, 9, (L, jlm.N_GROUPS)).astype(np.float32),
            rng.integers(2, 9, (L, jlm.N_GROUPS)).astype(np.float32))


def _specs(jc, tc, kind):
    if kind == "none":
        return None, None
    if kind == "no_lm_quant":
        return jlm.no_lm_quant(jc), tlm.no_lm_quant(tc, device="cpu")
    eb, wb, ab = _mixed_bits(jc)
    return (jlm.LMQuantSpec(jnp.asarray(eb), jnp.asarray(wb), jnp.asarray(ab)),
            tlm.LMQuantSpec(*(torch.from_numpy(a) for a in (eb, wb, ab))))


def _equal(t: torch.Tensor, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# Registry and layout
# ---------------------------------------------------------------------------
def test_registry_holds_the_six_archs_with_the_reference_fields():
    assert ARCH_IDS == J_ARCH_IDS and set(ARCHS) <= set(ARCH_IDS)
    for arch in ARCHS:
        j, t = j_get_arch(arch), get_arch(arch)
        for cfg_j, cfg_t in ((j.model, t.model), (j.smoke, t.smoke)):
            assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
            assert cfg_t.n_params() == cfg_j.n_params()
            assert tlm.period(cfg_t) == jlm.period(cfg_j)
            assert tlm.total_layers(cfg_t) == jlm.total_layers(cfg_j)
            assert [tlm._has_moe(cfg_t, i) for i in range(tlm.period(cfg_t))] \
                == [jlm._has_moe(cfg_j, i) for i in range(jlm.period(cfg_j))]
        assert (t.source, dict(t.skips), dict(t.microbatch), t.moment_dtype) \
            == (j.source, dict(j.skips), dict(j.microbatch), j.moment_dtype)
    assert dataclasses.asdict(MoEConfig()) == dataclasses.asdict(JMoEConfig())


@pytest.mark.parametrize("vocab,n_bands", [(512, 4), (152_064, 8),
                                           (32_000, 8), (10, 8), (7, 7)])
def test_embed_band_boundaries_equal(vocab, n_bands):
    assert tlm.embed_band_boundaries(vocab, n_bands) \
        == jlm.embed_band_boundaries(vocab, n_bands)


def test_no_lm_quant_and_weight_groups_equal():
    for arch in ARCHS:
        jc, tc = j_get_arch(arch).smoke, get_arch(arch).smoke
        js, ts = jlm.no_lm_quant(jc), tlm.no_lm_quant(tc, device="cpu")
        for f in ("embed_bits", "w_bits", "a_bits"):
            _equal(getattr(ts, f), getattr(js, f))
        assert ts.paper_exact == js.paper_exact
    assert tlm._WEIGHT_GROUP == jlm._WEIGHT_GROUP
    assert tlm.N_GROUPS == jlm.N_GROUPS


# ---------------------------------------------------------------------------
# The fake quantizers: exact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("paper_exact", [True, False])
def test_quant_embedding_exact(bits, paper_exact):
    rng = np.random.default_rng(bits)
    table = rng.normal(size=(512, 64)).astype(np.float32)
    band_bits = np.full(4, bits, np.float32)
    band_bits[1] = 5  # one band at its own width
    want = jlm.quant_embedding(jnp.asarray(table), jnp.asarray(band_bits),
                               paper_exact)
    got = tlm.quant_embedding(torch.from_numpy(table),
                              torch.from_numpy(band_bits), paper_exact)
    _equal(got, want)
    lo, hi = tlm.embed_band_boundaries(512, 4)[:2]
    if bits == 32:  # band 0 stays full precision
        np.testing.assert_array_equal(got[lo:hi].numpy(), table[lo:hi])


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("arch", ["qwen2-7b", "arctic-480b"])
def test_quant_block_weights_exact(bits, arch):
    """One block's weights by group: attention, dense or MoE FFN with
    its dense residual; the router, norms and biases untouched."""
    jc = j_get_arch(arch).smoke
    jp = _np_tree(jlm.init_params(jc, jax.random.PRNGKey(bits)))
    jb = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["pos0"])
    tb = lm_params_from_numpy({"blocks": {"pos0": jax.tree_util.tree_map(
        lambda a: a[None], jb)}}, device="cpu")["blocks"][0]
    w_bits = np.asarray([bits, 6, bits, 3], np.float32)
    want = jlm._quant_block_weights(jax.tree_util.tree_map(jnp.asarray, jb),
                                    jnp.asarray(w_bits), True)
    got = tlm._quant_block_weights(tb, torch.from_numpy(w_bits), True)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat_w) == len(jax.tree_util.tree_leaves(jb))
    for path, leaf in flat_w:
        node = got
        for k in path:
            node = node[k.key]
        _equal(node, leaf)
    if "moe" in tb:
        assert got["moe"]["router"] is tb["moe"]["router"]


@pytest.mark.parametrize("bits", BITS)
def test_maybe_quant_a_exact(bits):
    rng = np.random.default_rng(10 + bits)
    x = (rng.normal(size=(4, 64, 64)) * 3 + 0.5).astype(np.float32)
    for arr in (x, np.maximum(x, 0.0)):  # relu2-like: non-negative
        want = jlm._maybe_quant_a(jnp.asarray(arr), jnp.float32(bits))
        got = tlm._maybe_quant_a(torch.from_numpy(arr),
                                 torch.tensor(float(bits)))
        _equal(got, want)


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------
def _reference_dispatch(expert_ids, T, m):
    """The reference `moe_ffn`'s dispatch lines (repro/models/ffn.py), in
    jnp, on the reference's own expert ids: global positions, keep mask
    and the slot -> token / gate maps."""
    E, k = m.n_experts, m.top_k
    G = m.dispatch_groups if T % max(m.dispatch_groups, 1) == 0 else 1
    Tg = T // G
    ids_g = expert_ids.reshape(G, Tg * k)
    onehot = jax.nn.one_hot(ids_g, E, dtype=jnp.int32)
    pos_local = jnp.cumsum(onehot, axis=1) - onehot
    counts = jnp.sum(onehot, axis=1)
    group_base = jnp.cumsum(counts, axis=0) - counts
    pos = jnp.take_along_axis(pos_local, ids_g[..., None], axis=2)[..., 0]
    base = jnp.take_along_axis(group_base, ids_g, axis=1)
    flat_pos = (pos + base).reshape(-1)
    flat_ids = expert_ids.reshape(-1)
    C = jffn.moe_capacity(T, m)
    keep = flat_pos < C
    safe_pos = jnp.where(keep, flat_pos, 0)
    tok_idx = jnp.repeat(jnp.arange(T), k)
    slot_tok = jnp.full((E, C), T, jnp.int32).at[flat_ids, safe_pos].min(
        jnp.where(keep, tok_idx, T), mode="drop")
    return flat_pos, keep, slot_tok, C


MOE_CASES = {
    "qwen3-moe": ("qwen3-moe-235b-a22b", {}),
    "arctic": ("arctic-480b", {}),
    "groups2": ("qwen3-moe-235b-a22b", dict(dispatch_groups=2)),
    "drops": ("arctic-480b", dict(capacity_factor=0.5, dispatch_groups=2)),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_matches_reference(case, monkeypatch):
    arch, change = MOE_CASES[case]
    jc, tc = j_get_arch(arch).smoke, get_arch(arch).smoke
    jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **change))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **change))
    jp = _np_tree(jffn.init_moe(jax.random.PRNGKey(7), jc))
    tp = lm_params_from_numpy({"blocks": {"pos0": jax.tree_util.tree_map(
        lambda a: a[None], jp)}}, device="cpu")["blocks"][0]
    B, S, d = 4, 32, jc.d_model
    x = np.random.default_rng(5).normal(size=(B, S, d)).astype(np.float32)

    seen = []
    top_k = jax.lax.top_k

    def recording_top_k(*a, **kw):
        out = top_k(*a, **kw)
        seen.append(out)
        return out
    monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
    want, want_aux = jffn.moe_ffn(jax.tree_util.tree_map(jnp.asarray, jp),
                                  jnp.asarray(x), jc)
    (j_gates, j_ids), = seen
    t_route = tffn.moe_route(tp, torch.from_numpy(x).reshape(B * S, d), tc)
    got, got_aux = tffn.moe_ffn(tp, torch.from_numpy(x), tc)

    _equal(t_route.expert_ids, j_ids)
    j_gates = j_gates / jnp.maximum(jnp.sum(j_gates, -1, keepdims=True), 1e-9)
    np.testing.assert_allclose(t_route.gate_vals.numpy(), np.asarray(j_gates),
                               rtol=0, atol=MOE_TOL)
    flat_pos, keep, slot_tok, C = _reference_dispatch(j_ids, B * S, jc.moe)
    assert t_route.capacity == C == tffn.moe_capacity(B * S, tc.moe)
    _equal(t_route.flat_pos, flat_pos)
    _equal(t_route.keep, keep)
    _equal(t_route.slot_tok, slot_tok)
    dropped = 1.0 - float(np.mean(np.asarray(keep)))
    assert t_route.dropped_share() == pytest.approx(dropped)
    if case == "drops":
        assert dropped > 0.2  # capacity 0.5 drops pairs
    else:
        assert dropped == 0.0
    # Each slot's gate is its kept pair's gate; empty slots hold 0.
    kept = torch.from_numpy(np.array(keep))
    filled = t_route.slot_tok < B * S
    assert int(kept.sum()) == int(filled.sum())
    assert torch.equal(torch.sort(t_route.slot_gate[filled]).values,
                       torch.sort(t_route.gate_vals.reshape(-1)[kept]).values)
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= MOE_TOL * scale
    assert float(got_aux) == pytest.approx(float(want_aux), rel=MOE_TOL)


def test_moe_capacity_and_param_shapes_equal():
    for n, m in ((1, MoEConfig()), (16, MoEConfig(n_experts=4, top_k=2)),
                 (4096, MoEConfig(n_experts=128, top_k=8)),
                 (333, MoEConfig(capacity_factor=0.5))):
        jm = JMoEConfig(**dataclasses.asdict(m))
        assert tffn.moe_capacity(n, m) == jffn.moe_capacity(n, jm)
    for arch in MOE_ARCHS:
        for which in ("smoke", "model"):
            jc = getattr(j_get_arch(arch), which)
            tc = getattr(get_arch(arch), which)
            assert tffn.moe_param_shapes(tc) == jffn.moe_param_shapes(jc)


def test_init_moe_is_seeded_with_the_reference_layout():
    tc = get_arch("arctic-480b").smoke
    a = tffn.init_moe(torch.Generator().manual_seed(3), tc)
    b = tffn.init_moe(torch.Generator().manual_seed(3), tc)
    j = jffn.init_moe(jax.random.PRNGKey(3), j_get_arch("arctic-480b").smoke)
    assert set(a) == set(j) and set(a["dense"]) == set(j["dense"])
    for name, w in a.items():
        if name != "dense":
            assert w.shape == j[name].shape and torch.equal(w, b[name])
            assert str(w.dtype).split(".")[-1] == str(j[name].dtype)


# ---------------------------------------------------------------------------
# forward / loss_fn
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["none", "no_lm_quant", "mixed"])
def test_forward_and_loss_match_reference(arch_models, kind):
    arch, jc, tc, jp, tp = arch_models
    js, ts = _specs(jc, tc, kind)
    toks = _tokens(jc)
    jbatch, tbatch = {"tokens": jnp.asarray(toks)}, \
        {"tokens": torch.from_numpy(toks)}
    j_logits, j_aux = jlm.forward(jp, jbatch, jc, spec=js)
    j_loss, j_m = jlm.loss_fn(jp, jbatch, jc, spec=js)
    with torch.no_grad():
        t_logits, t_aux = tlm.forward(tp, tbatch, tc, spec=ts)
        t_loss, t_m = tlm.loss_fn(tp, tbatch, tc, spec=ts)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=0, atol=REL)
    assert float(t_loss) == pytest.approx(float(j_loss), rel=REL)
    assert float(t_m["ce"]) == pytest.approx(float(j_m["ce"]), rel=REL)
    if arch in MOE_ARCHS:
        assert float(t_m["aux"]) > 0.0
        assert float(t_m["aux"]) == pytest.approx(float(j_m["aux"]), rel=REL)
        assert float(t_aux) == float(t_m["aux"])
    else:
        assert float(t_m["aux"]) == float(j_m["aux"]) == 0.0


def test_loss_with_explicit_labels_matches_reference(arch_models):
    arch, jc, tc, jp, tp = arch_models
    toks = _tokens(jc, B=2, S=16, seed=4)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -1  # no loss on the tail
    j_loss, _ = jlm.loss_fn(jp, {"tokens": jnp.asarray(toks),
                                 "labels": jnp.asarray(labels)}, jc)
    with torch.no_grad():
        t_loss, _ = tlm.loss_fn(tp, {"tokens": torch.from_numpy(toks),
                                     "labels": torch.from_numpy(labels)}, tc)
    assert float(t_loss) == pytest.approx(float(j_loss), rel=REL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_decode_match_reference(arch):
    """The MoE archs' serving path: prefill, then decode steps fed the
    reference's greedy tokens (`decode_step` routes one token a row)."""
    jc, tc = j_get_arch(arch).smoke, get_arch(arch).smoke
    jp = jlm.init_params(jc, jax.random.PRNGKey(8))
    tp = lm_params_from_numpy(_np_tree(jp), device="cpu")
    B, S, steps, tol = 2, 24, 4, 2e-4
    toks = _tokens(jc, B=B, S=S, seed=9)
    jl, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc, S + steps)
    with torch.no_grad():
        tl, tcache = tlm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc,
                                 S + steps)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol, rtol=tol)
    assert set(tcache) == set(jcache)
    for i in range(steps):
        jt = jnp.argmax(jl[:, -1], -1)[:, None]
        jl, jcache = jlm.decode_step(jp, jcache, jt, jnp.int32(S + i), jc)
        with torch.no_grad():
            tl, tcache = tlm.decode_step(tp, tcache, torch.from_numpy(
                np.array(jt)).long(), S + i, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol,
                                   rtol=tol)
    for pos in jcache:
        for leaf in ("k", "v"):
            np.testing.assert_allclose(tcache[pos][leaf].numpy(),
                                       np.asarray(jcache[pos][leaf]),
                                       atol=tol, rtol=tol)


def test_moe_every_other_layer_keeps_the_reference_cache_layout():
    """A period-2 layout (MoE on odd layers): params, the cache's
    `pos0`/`pos1` leaves and the logits against the reference's."""
    change = lambda c: dataclasses.replace(
        c, n_layers=4, moe=dataclasses.replace(c.moe, every_n_layers=2))
    jc = change(j_get_arch("qwen3-moe-235b-a22b").smoke)
    tc = change(get_arch("qwen3-moe-235b-a22b").smoke)
    jp = jlm.init_params(jc, jax.random.PRNGKey(2))
    tp = lm_params_from_numpy(_np_tree(jp), device="cpu")
    assert ["moe" in b for b in tp["blocks"]] == [False, True, False, True]
    toks = _tokens(jc, B=2, S=16, seed=3)
    jl, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc, 20)
    with torch.no_grad():
        tl, tcache = tlm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc,
                                 20)
        t_loss, _ = tlm.loss_fn(tp, {"tokens": torch.from_numpy(toks)}, tc)
    j_loss, _ = jlm.loss_fn(jp, {"tokens": jnp.asarray(toks)}, jc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4,
                               rtol=2e-4)
    assert float(t_loss) == pytest.approx(float(j_loss), rel=REL)
    for pos in ("pos0", "pos1"):
        assert tcache[pos]["k"].shape == jcache[pos]["k"].shape
        np.testing.assert_allclose(tcache[pos]["k"].numpy(),
                                   np.asarray(jcache[pos]["k"]), atol=2e-4)


# ---------------------------------------------------------------------------
# The roofline-lm target
# ---------------------------------------------------------------------------
def _policies(workload, K=5, seed=0):
    rng = np.random.default_rng(seed)
    nb = len(workload.band_rows)
    L, G = workload.n_layers, len(workload.group_elems)
    return (rng.integers(2, 9, (K, nb)).astype(np.float32),
            rng.integers(2, 9, (K, L, G)).astype(np.float32),
            rng.integers(2, 9, (K, L, G)).astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["smoke", "model"])
def test_roofline_lm_matches_reference(arch, which):
    jt = jtg.make_target("roofline-lm")
    tt = ttg.make_target("roofline-lm", hbm_gbps=819.0, device="cpu")
    jw = jt.build_workload(getattr(j_get_arch(arch), which))
    tw = tt.build_workload(getattr(get_arch(arch), which))
    assert (tw.arch, tw.n_layers, tw.d_model) == (jw.arch, jw.n_layers,
                                                  jw.d_model)
    np.testing.assert_array_equal(tw.band_rows, jw.band_rows)
    np.testing.assert_array_equal(tw.group_elems, jw.group_elems)
    eb, wb, ab = _policies(jw)
    for i in range(eb.shape[0]):
        want = jt.simulate(jw, eb[i], wb[i], ab[i])
        got = tt.simulate(tw, eb[i], wb[i], ab[i])
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-6), k
    for bits in (8, 4, 2):
        want, got = jt.baseline(jw, bits), tt.baseline(tw, bits)
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-6), k
    want = jt.batched(jw).simulate_batch(eb, wb, ab)
    got = tt.batched(tw).simulate_batch(eb, wb, ab)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-6)
    got_v = tt.batched(tw).vmappable()(*(torch.from_numpy(a)
                                         for a in (eb, wb, ab)))
    for k, v in want.items():
        np.testing.assert_allclose(got_v[k].numpy(), np.asarray(v), rtol=1e-6)


def test_roofline_lm_preset_is_the_cards_and_the_rate_cancels():
    """The port's preset is the H100's (3.35 TB/s, 989 TFLOP/s bf16), the
    reference's a TPU v5e's: seconds differ by the rate ratio, and every
    latency ratio to the 8-bit baseline (all the search reads) and every
    `model_bytes` are the same."""
    tt, jt = ttg.make_target("roofline-lm", device="cpu"), \
        jtg.make_target("roofline-lm")
    assert dataclasses.asdict(tt.hw) == {
        "chip": "nvidia-h100-sxm", "hbm_gbps": 3350.0,
        "peak_tflops_bf16": 989.0}
    assert tt.hw.hbm_bw == 3.35e12
    desc = tt.describe()
    assert (desc["name"], desc["family"], desc["device"]) == (
        "roofline-lm", "roofline-lm", "cpu")
    assert desc["config"] == dataclasses.asdict(tt.hw)
    cfg_t, cfg_j = get_arch("qwen2-7b").model, j_get_arch("qwen2-7b").model
    tw, jw = tt.build_workload(cfg_t), jt.build_workload(cfg_j)
    eb, wb, ab = _policies(jw, K=4, seed=2)
    got = tt.batched(tw).simulate_batch(eb, wb, ab)
    want = jt.batched(jw).simulate_batch(eb, wb, ab)
    t8, j8 = tt.baseline(tw, 8), jt.baseline(jw, 8)
    np.testing.assert_allclose(got["total_cycles"] / t8["total_cycles"],
                               np.asarray(want["total_cycles"])
                               / j8["total_cycles"], rtol=1e-6)
    np.testing.assert_allclose(got["model_bytes"],
                               np.asarray(want["model_bytes"]), rtol=1e-6)
    assert t8["total_cycles"] == pytest.approx(
        j8["total_cycles"] * 819.0 / 3350.0, rel=1e-6)
    with pytest.raises(TypeError):
        ttg.make_target("roofline-lm", hbm_gbs=1.0, device="cpu")
