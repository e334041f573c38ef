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

from repro.configs import get_arch as j_get_arch
from repro.data import TokenPipeline as JTokenPipeline
from repro.data import TokenPipelineConfig as JTokenPipelineConfig
from repro.launch.steps import make_decode_step as j_make_decode_step
from repro.launch.steps import make_prefill_step as j_make_prefill_step
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models import lm as jlm
from repro_torch.configs import get_arch
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


def test_other_archs_raise_naming_their_slice():
    with pytest.raises(KeyError, match="item 8"):
        get_arch("jamba-v0.1-52b")
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")


@pytest.mark.parametrize("pattern,change", [
    ("xlstm", dict(pattern="xlstm")),
    ("ssm", dict(pattern="jamba", attn_every=2)),
    ("patches", dict(embed_frontend="prefix_patches")),
])
def test_unported_blocks_raise(pattern, change):
    cfg = dataclasses.replace(get_arch("qwen2-7b").smoke, **change)
    with pytest.raises(NotImplementedError, match="item 8"):
        tlm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


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
