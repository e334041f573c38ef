"""The port's LM serving path against the JAX package on the CPU: the
token pipeline (equal), the config registry (equal fields), the blocks
(norms, rotary embedding, FFNs), `prefill` and `decode_step` on carried-
over weights, and the greedy serve loop.

Weights come from the reference's `lm.init_params` and cross through
`lm_params_from_numpy`. Two configs: `qwen2-smoke` and one with
qwen2-7b's head geometry (14 query heads on 2 KV heads, so G = 7, and
head dim 128) at a small width. Tolerance for logits and caches: 2e-4,
the band in which the reference holds its own flash kernel against its
chunked attention (`tests/test_kernels.py`); greedy tokens must be
equal. The geometry config is also compared in bf16, the served dtype,
at bands set from its readings."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_arch as j_get_arch
from repro.data import TokenPipeline as JTokenPipeline
from repro.data import TokenPipelineConfig as JTokenPipelineConfig
from repro.launch.steps import make_decode_step as j_make_decode_step
from repro.launch.steps import make_prefill_step as j_make_prefill_step
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models import lm as jlm
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data import TokenPipeline, TokenPipelineConfig
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import ffn as tffn
from repro_torch.models import lm as tlm

TOL = 2e-4
GEOMETRY = dict(n_layers=2, d_model=256, n_heads=14, n_kv_heads=2, d_head=128)
OTHER_ARCHS = ["jamba-v0.1-52b", "xlstm-350m", "whisper-large-v3",
               "llava-next-mistral-7b"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny shapes gain nothing from more, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    j, t = j_get_arch("qwen2-7b").smoke, get_arch("qwen2-7b").smoke
    if name == "qwen2-geometry":
        j = dataclasses.replace(j, name=name, **GEOMETRY)
        t = dataclasses.replace(t, name=name, **GEOMETRY)
    return j, t


@pytest.fixture(scope="module", params=["qwen2-smoke", "qwen2-geometry"])
def models(request):
    """(reference config, port config, reference params, port params)."""
    jc, tc = _cfgs(request.param)
    jp = jlm.init_params(jc, jax.random.PRNGKey(1))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return jc, tc, jp, tp


def _close(t: torch.Tensor, j, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def _arch_batch(cfg, rng, B=2, S=16):
    """(reference batch, port batch) for a smoke config, as
    `tests/test_models_smoke.py::_batch` lays it out: S positions, the
    patch prefix among them for llava; whisper's frames at
    max_source_len."""
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.embed_frontend == "prefix_patches":
        b["patches"] = (rng.normal(size=(B, cfg.n_prefix_patches,
                                         cfg.d_model)) * 0.02) \
            .astype(np.float32)
        b["tokens"] = b["tokens"][:, :S - cfg.n_prefix_patches]
    elif cfg.embed_frontend == "stub_frames":
        b["frames"] = (rng.normal(size=(B, cfg.max_source_len, cfg.d_model))
                       * 0.02).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


# ---------------------------------------------------------------------------
# Data and configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (2, 1)])
def test_token_pipeline_batches_equal(n_hosts, host_id):
    kw = dict(vocab_size=152_064, seq_len=64, global_batch=4, seed=3,
              n_hosts=n_hosts, host_id=host_id)
    jpipe = JTokenPipeline(JTokenPipelineConfig(**kw))
    tpipe = TokenPipeline(TokenPipelineConfig(**kw))
    for step in range(3):
        np.testing.assert_array_equal(tpipe.batch(), jpipe.batch())
    np.testing.assert_array_equal(tpipe.batch(7), jpipe.batch(7))
    assert tpipe.state() == jpipe.state()


def test_registry_holds_qwen2_7b_with_the_reference_fields():
    j, t = j_get_arch("qwen2-7b"), get_arch("qwen2-7b")
    for cfg_j, cfg_t in ((j.model, t.model), (j.smoke, t.smoke)):
        assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
        assert cfg_t.n_params() == cfg_j.n_params()
        assert cfg_t.head_dim == cfg_j.head_dim
    assert t.model.param_dtype == torch.bfloat16
    assert t.smoke.param_dtype == torch.float32
    assert (t.source, dict(t.skips), dict(t.microbatch)) == \
        (j.source, dict(j.skips), dict(j.microbatch))


def test_registry_holds_every_reference_arch():
    """The ten ids in the reference's order, each with the reference's
    published and smoke fields and layout; an unknown id raises."""
    assert ARCH_IDS == J_ARCH_IDS
    for arch in OTHER_ARCHS:
        j, t = j_get_arch(arch), get_arch(arch)
        for cfg_j, cfg_t in ((j.model, t.model), (j.smoke, t.smoke)):
            assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
            assert cfg_t.n_params() == cfg_j.n_params()
            assert tlm.period(cfg_t) == jlm.period(cfg_j)
            assert tlm.total_layers(cfg_t) == jlm.total_layers(cfg_j)
            assert tlm._block_kinds(cfg_t) == jlm._block_kinds(cfg_j)
        assert (t.source, dict(t.skips), dict(t.microbatch)) == \
            (j.source, dict(j.skips), dict(j.microbatch))
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")


@pytest.mark.parametrize("pattern,change", [
    ("xlstm", dict(pattern="xlstm")),
    ("ssm", dict(pattern="jamba", attn_every=2)),
    ("patches", dict(embed_frontend="prefix_patches", n_prefix_patches=4)),
])
def test_block_families_on_qwen2_smoke_match_reference(pattern, change):
    """qwen2-7b's smoke config turned into each new family (mLSTM/sLSTM;
    Mamba beside attention; a patch prefix): the reference's weights give
    the reference's logits and loss."""
    jc = dataclasses.replace(j_get_arch("qwen2-7b").smoke, **change)
    tc = dataclasses.replace(get_arch("qwen2-7b").smoke, **change)
    jp = jlm.init_params(jc, jax.random.PRNGKey(6))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    jb, tb = _arch_batch(jc, np.random.default_rng(7))
    with torch.no_grad():
        logits, _ = tlm.forward(tp, tb, tc)
        loss, _ = tlm.loss_fn(tp, tb, tc)
    _close(logits, jlm.forward(jp, jb, jc)[0], 1e-5)
    assert float(loss) == pytest.approx(float(jlm.loss_fn(jp, jb, jc)[0]),
                                        rel=1e-5)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def test_norms_and_rope_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    bias = rng.normal(size=(32,)).astype(np.float32)
    tx, ts, tb = map(torch.from_numpy, (x, scale, bias))
    _close(tcommon.rms_norm(tx, ts), jcommon.rms_norm(x, scale), 1e-6)
    _close(tcommon.layer_norm(tx, ts, tb), jcommon.layer_norm(x, scale, bias),
           1e-5)
    pos = np.arange(3, 8)
    _close(tcommon.apply_rope(tx, torch.from_numpy(pos), 1e6),
           jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-5)


@pytest.mark.parametrize("ffn_type", ["swiglu", "geglu", "gelu", "relu2"])
def test_dense_ffn_matches(ffn_type):
    jc, tc = _cfgs("qwen2-smoke")
    jc = dataclasses.replace(jc, ffn_type=ffn_type)
    tc = dataclasses.replace(tc, ffn_type=ffn_type)
    jp = jffn.init_ffn(jax.random.PRNGKey(2), jc)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    assert set(tp) == set(tffn.ffn_param_shapes(tc))
    x = np.random.default_rng(1).normal(size=(3, 7, 64)).astype(np.float32)
    _close(tffn.ffn(tp, torch.from_numpy(x), tc), jffn.ffn(jp, x, jc), 1e-5)


@pytest.mark.parametrize("S,causal", [(33, True), (128, False)])
def test_full_sequence_attention_matches(models, S, causal):
    jc, tc, jp, tp = models
    x = np.random.default_rng(4).normal(size=(2, S, jc.d_model)) \
        .astype(np.float32)
    ja = jax.tree_util.tree_map(lambda a: a[1], jp["blocks"]["pos0"]["attn"])
    _close(tattn.attention(tp["blocks"][1]["attn"], torch.from_numpy(x), tc,
                           causal=causal),
           jattn.attention(ja, jnp.asarray(x), jc, causal=causal))


def test_decode_attention_step_matches(models):
    """One layer's decode step on a cache from `init_kv_cache`: output and
    cache against the reference's one-hot update and masked softmax."""
    jc, tc, jp, tp = models
    rng = np.random.default_rng(6)
    B, S_max, pos = 2, 24, 17
    x = rng.normal(size=(B, 1, jc.d_model)).astype(np.float32)
    kv = {n: rng.normal(size=(B, S_max, jc.n_kv_heads, jc.head_dim))
          .astype(np.float32) for n in ("k", "v")}
    ja = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["pos0"]["attn"])
    want, jcache = jattn.decode_attention(
        ja, jnp.asarray(x), {n: jnp.asarray(a) for n, a in kv.items()},
        jnp.int32(pos), jc)
    cache = tattn.init_kv_cache(tc, B, S_max, torch.device("cpu"))
    for n in ("k", "v"):
        cache[n].copy_(torch.from_numpy(kv[n]))
    got, tcache = tattn.decode_attention(tp["blocks"][0]["attn"],
                                         torch.from_numpy(x), cache, pos, tc)
    assert tcache["k"] is cache["k"]  # written in place
    _close(got, want)
    for n in ("k", "v"):
        _close(tcache[n], jcache[n])


def test_lm_params_from_numpy_carries_bfloat16_bits():
    jc = j_get_arch("qwen2-7b").smoke
    jc = dataclasses.replace(jc, dtype="bfloat16")
    jp = jax.tree_util.tree_map(np.asarray,
                                jlm.init_params(jc, jax.random.PRNGKey(0)))
    tp = lm_params_from_numpy(jp, device="cpu")
    assert len(tp["blocks"]) == jc.n_layers
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["embed"].view(torch.int16).numpy(),
                                  jp["embed"].view(np.int16))
    for l in range(jc.n_layers):
        for name, w in jp["blocks"]["pos0"]["attn"].items():
            t = tp["blocks"][l]["attn"][name]
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          w[l].view(np.int16))


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------
def test_prefill_and_decode_match_the_reference(models):
    jc, tc, jp, tp = models
    rng = np.random.default_rng(0)
    B, S, steps = 2, 40, 8
    toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    jl, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc, S + steps)
    tl, tcache = tlm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, tc,
                             S + steps)
    _close(tl, jl)
    for leaf in ("k", "v"):
        assert tcache["pos0"][leaf].shape == jcache["pos0"][leaf].shape
        _close(tcache["pos0"][leaf], jcache["pos0"][leaf])
    jt = jnp.argmax(jl[:, -1], -1)[:, None]
    tt = tserve.greedy(tl)[:, None]
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for i in range(steps):
        jl, jcache = jlm.decode_step(jp, jcache, jt, jnp.int32(S + i), jc)
        tl, tcache = tlm.decode_step(tp, tcache, tt, S + i, tc)
        _close(tl, jl)
        for leaf in ("k", "v"):
            _close(tcache["pos0"][leaf], jcache["pos0"][leaf])
        jt = jnp.argmax(jl[:, -1], -1)[:, None]
        tt = tserve.greedy(tl)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


# bf16 bands, about twice the readings on this geometry (seeds 1-4): max
# |diff| 0.03125, one ulp at |x| in [4, 8) (the matmuls accumulate in
# another order); mean |diff| 5.7e-3 for logits and 2.0e-3 for caches.
BF16_MAX, BF16_MEAN_LOGITS, BF16_MEAN_CACHE = 2 ** -4, 1.2e-2, 4e-3


def _bf16_close(t: torch.Tensor, j, mean_tol):
    d = np.abs(t.float().numpy() - np.asarray(j, np.float32))
    assert d.max() <= BF16_MAX and d.mean() <= mean_tol, (d.max(), d.mean())


def test_prefill_and_decode_match_the_reference_in_bfloat16():
    """The served dtype: qwen2-7b's head geometry in bf16 against the
    reference in bf16. Decode steps are fed the reference's greedy tokens,
    so every step compares like with like."""
    jc, tc = (dataclasses.replace(c, dtype="bfloat16")
              for c in _cfgs("qwen2-geometry"))
    jp = jlm.init_params(jc, jax.random.PRNGKey(1))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    rng = np.random.default_rng(1)
    B, S, steps = 2, 40, 8
    toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    jl, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc, S + steps)
    tl, tcache = tlm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, tc,
                             S + steps)
    assert tl.dtype == tcache["pos0"]["k"].dtype == torch.bfloat16
    agree = 0
    for i in range(steps + 1):
        if i:
            jl, jcache = jlm.decode_step(jp, jcache, jt, jnp.int32(S + i - 1),
                                         jc)
            tl, tcache = tlm.decode_step(tp, tcache, torch.from_numpy(
                np.array(jt)).long(), S + i - 1, tc)
        _bf16_close(tl, jl, BF16_MEAN_LOGITS)
        for leaf in ("k", "v"):
            _bf16_close(tcache["pos0"][leaf], jcache["pos0"][leaf],
                        BF16_MEAN_CACHE)
        jt = jnp.argmax(jl[:, -1], -1)[:, None]
        agree += int((tserve.greedy(tl).numpy() == np.asarray(jt)[:, 0]).sum())
    print(f"bf16 greedy tokens agree: {agree}/{B * (steps + 1)}")
    assert agree == B * (steps + 1)


def test_serve_loop_yields_the_reference_tokens(models):
    """The port's greedy loop against the reference's steps driven the way
    `repro.launch.serve` drives them, on the same weights and prompts."""
    jc, tc, jp, tp = models
    batch, prompt_len, gen = 2, 12, 6
    kw = dict(vocab_size=jc.vocab_size, seq_len=prompt_len,
              global_batch=batch)
    jpipe = JTokenPipeline(JTokenPipelineConfig(**kw))
    tpipe = TokenPipeline(TokenPipelineConfig(**kw))
    j_prefill = jax.jit(j_make_prefill_step(jc, prompt_len + gen))
    j_decode = jax.jit(j_make_decode_step(jc))
    t_prefill = make_prefill_step(tc, prompt_len + gen)
    t_decode = make_decode_step(tc)
    for _ in range(2):
        logits, cache = j_prefill(jp, {"tokens": jnp.asarray(jpipe.batch())})
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None]
        outs = [np.asarray(tok)]
        for i in range(gen - 1):
            logits, cache = j_decode(jp, cache, tok, jnp.int32(prompt_len + i))
            tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None]
            outs.append(np.asarray(tok))
        want = np.concatenate(outs, axis=1)
        got = tserve.generate(t_prefill, t_decode, tp,
                              torch.from_numpy(tpipe.batch()), gen)
        np.testing.assert_array_equal(got.numpy(), want)


def test_serve_main_runs_on_the_cpu(capsys):
    stats = tserve.main(["--smoke", "--device", "cpu", "--batch", "2",
                         "--prompt-len", "8", "--gen", "5", "--requests", "4"])
    assert (stats.requests, stats.tokens, stats.prefills,
            stats.decode_steps) == (4, 20, 2, 8)
    assert stats.device == "cpu" and len(stats.samples) == 2
    assert all(s.shape == (2, 5) for s in stats.samples)
    out = capsys.readouterr().out
    assert "served 4/4 requests" in out and "tok/s on cpu" in out


def test_init_params_is_seeded():
    cfg = get_arch("qwen2-7b").smoke
    a = tlm.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = tlm.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert torch.equal(a["blocks"][1]["ffn"]["w_out"],
                       b["blocks"][1]["ffn"]["w_out"])
    assert not torch.equal(a["blocks"][0]["attn"]["wq"],
                           a["blocks"][1]["attn"]["wq"])
    assert a["blocks"][0]["attn"]["bq"].abs().sum() == 0


# ---------------------------------------------------------------------------
# The other block families: jamba (Mamba + attention + MoE), xlstm (mLSTM /
# sLSTM), whisper (encoder-decoder), llava (patch prefix)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=OTHER_ARCHS)
def other(request):
    """(arch, reference config, port config, reference params, port
    params) of each family's smoke config."""
    arch = request.param
    jc, tc = j_get_arch(arch).smoke, get_arch(arch).smoke
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return arch, jc, tc, jp, tp


def _mixed(jc, seed=1):
    rng = np.random.default_rng(seed)
    L = jlm.total_layers(jc)
    bits = (rng.integers(2, 9, jc.n_embed_bands),
            rng.integers(2, 9, (L, jlm.N_GROUPS)),
            rng.integers(2, 9, (L, jlm.N_GROUPS)))
    return (jlm.LMQuantSpec(*(jnp.asarray(b, jnp.float32) for b in bits)),
            tlm.LMQuantSpec(*(torch.tensor(b, dtype=torch.float32)
                              for b in bits)))


@pytest.mark.parametrize("spec", ["none", "mixed"])
def test_other_families_forward_and_loss_match_reference(other, spec):
    """`forward` and `loss_fn` with no spec and under a mixed one: logits
    within 1e-5, loss and cross entropy within 1e-5 relative (MoE aux
    too)."""
    arch, jc, tc, jp, tp = other
    js, ts = _mixed(jc) if spec == "mixed" else (None, None)
    jb, tb = _arch_batch(jc, np.random.default_rng(2))
    j_logits, j_aux = jlm.forward(jp, jb, jc, spec=js)
    j_loss, j_m = jlm.loss_fn(jp, jb, jc, spec=js)
    with torch.no_grad():
        t_logits, t_aux = tlm.forward(tp, tb, tc, spec=ts)
        t_loss, t_m = tlm.loss_fn(tp, tb, tc, spec=ts)
    assert t_logits.shape == j_logits.shape
    _close(t_logits, j_logits, 1e-5)
    assert float(t_loss) == pytest.approx(float(j_loss), rel=1e-5)
    assert float(t_m["ce"]) == pytest.approx(float(j_m["ce"]), rel=1e-5)
    assert float(t_m["aux"]) == pytest.approx(float(j_m["aux"]), rel=1e-5)


def test_other_families_prefill_decode_matches_forward(other):
    """The port's mirror of `tests/test_models_smoke.py::
    test_prefill_decode_matches_forward`, held to the reference's own
    logits: prefill(t[:n]) then decode_step(t[n]) equals the reference's
    forward(t[:n+1]) at the last position, and prefill's last logits its
    forward's at the one before (2e-3)."""
    arch, jc, tc, jp, tp = other
    jb, tb = _arch_batch(jc, np.random.default_rng(1))
    n_text = tb["tokens"].shape[1]
    extra = jc.n_prefix_patches \
        if jc.embed_frontend == "prefix_patches" else 0
    want = np.asarray(jlm.forward(jp, jb, jc)[0], np.float32)
    pre = dict(tb, tokens=tb["tokens"][:, :n_text - 1])
    with torch.no_grad():
        lg_pre, cache = tlm.prefill(tp, pre, tc, n_text + extra)
        lg_dec, _ = tlm.decode_step(tp, cache, tb["tokens"][:, -1:].long(),
                                    n_text - 1 + extra, tc)
    np.testing.assert_allclose(lg_dec[:, 0].numpy(), want[:, -1], rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(lg_pre[:, -1].numpy(), want[:, -2], rtol=2e-3,
                               atol=2e-3)


def test_other_families_prefill_and_decode_match_reference(other):
    """`prefill` and three `decode_step`s fed the reference's greedy
    tokens: logits and every cache leaf (k, v; xk, xv; conv, ssm; C, n,
    m; c, n, h, m) against the reference's, in its layout."""
    arch, jc, tc, jp, tp = other
    jb, tb = _arch_batch(jc, np.random.default_rng(3))
    extra = jc.n_prefix_patches \
        if jc.embed_frontend == "prefix_patches" else 0
    S, steps = tb["tokens"].shape[1] + extra, 3
    jl, jcache = jlm.prefill(jp, jb, jc, S + steps)
    with torch.no_grad():
        tl, tcache = tlm.prefill(tp, tb, tc, S + steps)
    _close(tl, jl)
    for i in range(steps):
        jt = jnp.argmax(jl[:, -1], -1)[:, None]
        jl, jcache = jlm.decode_step(jp, jcache, jt, jnp.int32(S + i), jc)
        with torch.no_grad():
            tl, tcache = tlm.decode_step(tp, tcache, torch.from_numpy(
                np.array(jt)).long(), S + i, tc)
        _close(tl, jl)
    assert set(tcache) == set(jcache)
    for pos in jcache:
        assert set(tcache[pos]) == set(jcache[pos])
        for name in jcache[pos]:
            assert tuple(tcache[pos][name].shape) == jcache[pos][name].shape
            _close(tcache[pos][name], jcache[pos][name])


def test_other_families_init_and_cache_follow_the_reference_layout(other):
    """The port's own seeded weights and initial cache: the reference's
    tree, shapes and dtypes leaf for leaf."""
    arch, jc, tc, jp, _ = other
    tp = tlm.init_params(tc, torch.Generator().manual_seed(4), device="cpu")
    again = tlm.init_params(tc, torch.Generator().manual_seed(4),
                            device="cpu")
    ref = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")

    def walk(a, b, c):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                walk(a[k], b[k], c[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y, z in zip(a, b, c):
                walk(x, y, z)
        else:
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(a, c)

    walk(tp, ref, again)
    jcache = jlm.init_cache(jc, 2, 20)
    tcache = tlm.init_cache(tc, 2, 20, device="cpu")
    assert set(tcache) == set(jcache)
    for pos in jcache:
        assert set(tcache[pos]) == set(jcache[pos])
        for name, leaf in jcache[pos].items():
            np.testing.assert_array_equal(tcache[pos][name].numpy(),
                                          np.asarray(leaf))


def test_serve_main_runs_each_family_on_the_cpu():
    """`launch.serve` at smoke size: llava's prompts lead with zero
    patches (the cache sized for them), whisper's carry zero frames."""
    for arch in OTHER_ARCHS:
        stats = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "8", "--gen",
                             "4", "--requests", "2"])
        assert (stats.requests, stats.tokens, stats.decode_steps) \
            == (2, 8, 3)
        assert stats.samples[0].shape == (2, 4)


def test_serve_loop_on_patches_yields_the_reference_tokens():
    """llava's smoke config through the port's greedy loop against the
    reference's steps driven as `repro.launch.serve` drives them: zero
    patches, decode positions after them; the reference's cache is sized
    for them here (its server's `prompt_len + gen` is not)."""
    jc = j_get_arch("llava-next-mistral-7b").smoke
    tc = get_arch("llava-next-mistral-7b").smoke
    jp = jlm.init_params(jc, jax.random.PRNGKey(9))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    B, prompt_len, gen, P = 2, 10, 5, jc.n_prefix_patches
    toks = np.random.default_rng(9).integers(0, jc.vocab_size,
                                             (B, prompt_len))
    patches = np.zeros((B, P, jc.d_model), np.float32)
    logits, cache = jlm.prefill(jp, {"tokens": jnp.asarray(toks),
                                     "patches": jnp.asarray(patches)}, jc,
                                P + prompt_len + gen)
    tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None]
    outs = [np.asarray(tok)]
    for i in range(gen - 1):
        logits, cache = jlm.decode_step(jp, cache, tok,
                                        jnp.int32(P + prompt_len + i), jc)
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None]
        outs.append(np.asarray(tok))
    extra = tserve.frontend_inputs(tc, B, torch.device("cpu"))
    assert set(extra) == {"patches"} and extra["patches"].shape == (B, P, 64)
    got = tserve.generate(make_prefill_step(tc, P + prompt_len + gen),
                          make_decode_step(tc), tp, torch.from_numpy(toks),
                          gen, extra=extra)
    np.testing.assert_array_equal(got.numpy(), np.concatenate(outs, axis=1))
