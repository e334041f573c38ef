"""LM training in the port against the JAX package on the CPU.

- `flash_attention_bwd_plain` (the backward kernel's plain version, from
  the forward's output and log-sum-exp) against `torch.autograd` of
  `flash_attention_plain` and against `jax.grad` of the reference's plain
  attention (`_sdpa_chunked`): causal, full, Sq != Sk, G > 1, float32 to
  1e-6 of the largest gradient (summation order), and bfloat16 inputs to
  2e-2 (the gradients are rounded to bf16, and the plain forward rounds p
  at another point than the backward's recomputed P).
- `make_train_step`: one step (two microbatches, clip, AdamW with f32
  moments, the launcher's lr 3e-4 and weight decay 0.1) of one smoke
  config a family (dense, MoE, jamba, xlstm, whisper, llava: the ten
  take 96 s alone, over this file's budget; all ten run on the card
  against the CPU in `chip_smoke.py`) on the reference's weights
  (`lm_params_from_numpy`)
  against the reference's `make_train_step`: loss and grad norm within
  1e-5 relative, the first moments (0.1 x the clipped gradient) within
  1e-5 of their largest entry, and every parameter after the update
  within 1e-5 where the reference's gradient exceeds 100 eps (1e-6).
  Below that the first AdamW step, lr * g / (|g| + eps), divides the
  gradients' rounding by eps: entries whose gradient is rounding noise
  (~1e-9 against a largest 1e-2: MoE experts, a Mamba out_proj, an sLSTM
  bias) move by up to lr * g/eps, 1.8e-5 apart at lr 3e-4 in these runs,
  and are held to 2 lr, the most two steps can differ.
- `ModelConfig.remat` on and off (one smoke config a family): the loss
  and gradients bit-equal, and autograd saves fewer bytes.
- `MomentCodec` and `adamw_update` for the param, f32, bf16 and int8
  moments against the reference's: int8 codes exact, scales within 1
  ulp, `torch.round`'s half-to-even.
- `compress` codes exact given the reference's uniforms.
- input specs equal in shape and dtype, `all_cells()` equal.
- `python -m repro_torch.launch.train --smoke --device cpu` resumes from
  its checkpoint and its loss falls; the `distributed_train` example.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import all_cells as j_all_cells
from repro.configs import get_arch as j_get_arch
from repro.configs import base as jbase
from repro.distributed import compression as jcomp
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import state_codec as jcodec
from repro_torch.configs import ARCH_IDS, SHAPES, all_cells, get_arch
from repro_torch.configs import base as tbase
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed import compression as tcomp
from repro_torch.kernels.flash_attention_kernel import (
    attention_lse_plain,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim import state_codec as tcodec
from repro_torch.tree_util import leaves_with_path

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny shapes gain nothing from more, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _rel(a, b) -> float:
    """Largest |a - b| over the largest |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# The backward's plain version
# ---------------------------------------------------------------------------
ATTN_CASES = [  # (causal, Sq, Sk, Hkv, G, hd)
    (True, 37, 37, 2, 1, 16),
    (True, 50, 50, 2, 3, 32),
    (False, 48, 48, 1, 2, 16),
    (False, 20, 45, 2, 2, 64),  # cross-attention: Sq != Sk
    (False, 70, 13, 1, 7, 16),
    # the edges of the card's tensor-core backward: a key length off its
    # 64-key tile, S * G (511) off its 64-row tile, padded head dims
    (False, 20, 70, 2, 1, 64),
    (True, 40, 40, 1, 3, 48),
    (True, 73, 73, 1, 7, 128),
    (False, 30, 70, 2, 2, 96),
]


def _attn_inputs(causal, Sq, Sk, Hkv, G, hd, seed=0):
    rng = np.random.default_rng(seed)
    B = 2
    q = rng.normal(size=(B, Sq, Hkv * G, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, hd)).astype(np.float32)
    do = rng.normal(size=(B, Sq, Hkv * G, hd)).astype(np.float32)
    return q, k, v, do


def _views(q, k, v, do, Hkv, G, dtype):
    """The port's kernel layout: q (B, Hkv, S, G, hd), k/v (B, Hkv, Sk,
    hd), as the model hands them over."""
    B, S, _, hd = q.shape
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    q5 = t(q).view(B, S, Hkv, G, hd).permute(0, 2, 1, 3, 4)
    k4, v4 = t(k).permute(0, 2, 1, 3), t(v).permute(0, 2, 1, 3)
    do5 = torch.from_numpy(do).view(B, S, Hkv, G, hd).permute(0, 2, 1, 3, 4)
    return q5, k4, v4, do5


def _back(g5: torch.Tensor) -> np.ndarray:
    """(B, Hkv, S, G, hd) -> (B, S, H, hd)."""
    B, Hkv, S, G, hd = g5.shape
    return _np(g5.permute(0, 2, 1, 3, 4).reshape(B, S, Hkv * G, hd))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_bwd_plain_matches_autograd_of_the_plain_forward(case, dtype):
    causal, Sq, Sk, Hkv, G, hd = case
    q, k, v, do = _attn_inputs(*case)
    q5, k4, v4, do5 = _views(q, k, v, do, Hkv, G, dtype)
    q5, k4, v4 = (t.requires_grad_(True) for t in (q5, k4, v4))
    out = flash_attention_plain(q5, k4, v4, causal)
    want = torch.autograd.grad(out, (q5, k4, v4), do5)
    lse = attention_lse_plain(q5.detach(), k4.detach(), causal)
    got = flash_attention_bwd_plain(q5.detach(), k4.detach(), v4.detach(),
                                    out.detach(), lse, do5, causal)
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel(_np(g), _np(w)) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_CASES[1::2])  # causal and Sq != Sk
def test_bwd_plain_matches_jax_grad_of_the_reference_attention(case, dtype):
    causal, Sq, Sk, Hkv, G, hd = case
    q, k, v, do = _attn_inputs(*case, seed=1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def loss(q_, k_, v_):
        out = jattn._sdpa_chunked(q_, k_, v_, causal, chunk=16)
        return jnp.sum(out.astype(jnp.float32) * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt))
    q5, k4, v4, do5 = _views(q, k, v, do, Hkv, G, dtype)
    out = flash_attention_plain(q5, k4, v4, causal)
    lse = attention_lse_plain(q5, k4, causal)
    dq, dk, dv = flash_attention_bwd_plain(q5, k4, v4, out, lse, do5, causal)
    got = (_back(dq), _np(dk.permute(0, 2, 1, 3)),
           _np(dv.permute(0, 2, 1, 3)))
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert _rel(g, np.asarray(w, np.float32)) <= tol


# ---------------------------------------------------------------------------
# One train step of every smoke config
# ---------------------------------------------------------------------------
A, MB, SEQ = 2, 2, 16


def _train_batch(model, seed: int = 3):
    """(A, MB, ...) numpy leaves: tokens, llava's patches, whisper's
    frames."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, model.vocab_size,
                                (A, MB, SEQ)).astype(np.int32)}
    if model.embed_frontend == "prefix_patches":
        b["patches"] = (rng.normal(size=(A, MB, model.n_prefix_patches,
                                         model.d_model)) * 0.02
                        ).astype(np.float32)
    elif model.embed_frontend == "stub_frames":
        b["frames"] = (rng.normal(size=(A, MB, model.max_source_len,
                                        model.d_model)) * 0.02
                       ).astype(np.float32)
    return b


FAMILIES = ("qwen2-7b", "qwen3-moe-235b-a22b", "jamba-v0.1-52b",
            "xlstm-350m", "whisper-large-v3", "llava-next-mistral-7b")


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_the_reference(arch):
    model = j_get_arch(arch).smoke
    params = jlm.init_params(model, jax.random.PRNGKey(0))
    batch = _train_batch(model)
    ocfg = dict(lr=3e-4, weight_decay=0.1)  # the launcher's
    j_step = jax.jit(j_make_train_step(model, JAdamWConfig(**ocfg),
                                       moment_dtype="float32"))
    j_params, j_opt, j_metrics = j_step(
        params, j_adamw_init(params, moment_dtype="float32"),
        {k: jnp.asarray(v) for k, v in batch.items()})

    t_model = get_arch(arch).smoke
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    step = make_train_step(t_model, AdamWConfig(**ocfg),
                           moment_dtype="float32")
    t_params, t_opt, t_metrics = step(
        tp, adamw_init(tp, moment_dtype="float32"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert int(t_opt.step) == 1
    for key in ("loss", "grad_norm"):
        assert t_metrics[key].dim() == 0
        np.testing.assert_allclose(float(t_metrics[key]),
                                   float(j_metrics[key]), rtol=REL)
    tree = lambda t: dict(leaves_with_path(lm_params_from_numpy(  # noqa
        jax.tree_util.tree_map(np.asarray, t), device="cpu")))
    want_mu, got_mu = tree(j_opt.mu), dict(leaves_with_path(t_opt.mu))
    want, got = tree(j_params), dict(leaves_with_path(t_params))
    assert got.keys() == want.keys() == got_mu.keys()
    top = max(float(w.abs().max()) for w in want_mu.values())
    gaps = {k: float((got_mu[k] - want_mu[k]).abs().max()) for k in got}
    assert max(gaps.values()) <= REL * top, gaps
    for k in got:
        gap = (got[k] - want[k]).abs()
        steady = want_mu[k].abs() / 0.1 > 100 * 1e-8  # |g| > 100 eps
        assert float(torch.where(steady, gap, 0.0).max()) <= 1e-5, k
        assert float(gap.max()) <= 2 * ocfg["lr"], k


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_keeps_the_gradient_and_saves_less(arch):
    """`ModelConfig.remat` (set in every config, as in the reference):
    each period's blocks run under `torch.utils.checkpoint`. Against remat
    off, from the same weights and microbatch: the loss and every gradient
    bit-equal, and autograd saves under half the bytes outside the
    checkpoints (`saved_tensors_hooks`: the periods' inputs and the head
    instead of every block's intermediates). The forward draws nothing
    from the RNG, so a period recomputed without restoring its RNG state
    computes what it did."""
    from repro_torch.models import lm
    from repro_torch.tree_util import map_with_path

    model = dataclasses.replace(get_arch(arch).smoke, dtype="float32")
    params = lm.init_params(model, torch.Generator().manual_seed(0),
                            device="cpu")
    mb = {k: torch.from_numpy(v[0]) for k, v in _train_batch(model).items()}
    runs = []
    for remat in (True, False):
        live = map_with_path(lambda _, t: t.detach().requires_grad_(True),
                             params)
        saved = [0]

        def pack(t):
            saved[0] += t.numel() * t.element_size()
            return t

        rng = torch.get_rng_state()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = lm.loss_fn(live, mb, dataclasses.replace(
                model, remat=remat))
        assert torch.equal(torch.get_rng_state(), rng)
        leaves = [t for _, t in leaves_with_path(live)]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        runs.append((loss, grads, saved[0]))
    (l1, g1, n1), (l2, g2, n2) = runs
    assert torch.equal(l1, l2)
    for a, b in zip(g1, g2):
        assert (a is None and b is None) or torch.equal(a, b)
    assert 0 < n1 < 0.5 * n2, (n1, n2)


# ---------------------------------------------------------------------------
# Moments, codecs, compression
# ---------------------------------------------------------------------------
def _moment_tree(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 33)).astype(np.float32),
            "norm": {"scale_param": rng.normal(size=(33,))
                     .astype(np.float32)},
            "blocks": {"bias": (rng.normal(size=(4, 5)) * 1e-3)
                       .astype(np.float32)}}


def test_int8_codec_matches_the_reference_and_rounds_half_to_even():
    x = _moment_tree()["w"]
    x[0, :4] = [127.0, 0.5, 1.5, -2.5]  # absmax 127: scale 1, ties at .5
    for sqrt in (False, True):
        jq = jcodec.MomentCodec("int8", sqrt_domain=sqrt).encode(
            jnp.asarray(np.abs(x) if sqrt else x), None)
        tq = tcodec.MomentCodec("int8", sqrt_domain=sqrt).encode(
            torch.from_numpy(np.abs(x) if sqrt else x), None)
        np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
        np.testing.assert_array_max_ulp(tq.scale.numpy(),
                                        np.asarray(jq.scale), maxulp=1)
        back = tcodec.MomentCodec("int8", sqrt_domain=sqrt).decode(tq)
        np.testing.assert_allclose(
            back.numpy(), np.asarray(jcodec.MomentCodec(
                "int8", sqrt_domain=sqrt).decode(jq)), rtol=1e-6)
    codes = tcodec.MomentCodec("int8").encode(torch.from_numpy(x), None)
    assert codes.codes[0, :4].tolist() == [127, 0, 2, -2]
    assert torch.round(torch.tensor([0.5, 1.5, 2.5, -0.5])).tolist() \
        == [0.0, 2.0, 2.0, -0.0]


@pytest.mark.parametrize("moment_dtype", ["param", "f32", "bf16", "int8"])
def test_adamw_moments_match_the_reference(moment_dtype):
    tree = _moment_tree()
    rng = np.random.default_rng(5)
    cfg = dict(lr=1e-2, weight_decay=0.1)
    j_p = jax.tree_util.tree_map(jnp.asarray, tree)
    t_p = jax.tree_util.tree_map(torch.from_numpy, tree)
    j_s = j_adamw_init(j_p, moment_dtype=moment_dtype)
    t_s = adamw_init(t_p, moment_dtype=moment_dtype)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
        j_p, j_s = j_adamw_update(jax.tree_util.tree_map(jnp.asarray, g),
                                  j_s, j_p, JAdamWConfig(**cfg),
                                  moment_dtype=moment_dtype)
        t_p, t_s = adamw_update(jax.tree_util.tree_map(torch.from_numpy, g),
                                t_s, t_p, AdamWConfig(**cfg),
                                moment_dtype=moment_dtype)
    assert int(t_s.step) == int(j_s.step) == 3
    for path, leaf in leaves_with_path(t_p):
        want = np.asarray(_get(j_p, path))
        np.testing.assert_allclose(leaf.numpy(), want, rtol=1e-6, atol=1e-7)
    for name in ("mu", "nu"):
        for path, leaf in _moment_leaves(getattr(t_s, name)):
            want = _get(getattr(j_s, name), path)
            if moment_dtype == "int8":
                np.testing.assert_array_equal(leaf.codes.numpy(),
                                              np.asarray(want.codes))
                np.testing.assert_array_max_ulp(
                    leaf.scale.numpy(), np.asarray(want.scale), maxulp=1)
            else:
                w = np.asarray(want)
                assert str(leaf.dtype).split(".")[-1] == w.dtype.name
                np.testing.assert_allclose(leaf.float().numpy(),
                                           w.astype(np.float32), rtol=1e-6,
                                           atol=1e-9)


@pytest.mark.parametrize("kind,sqrt", [("f32", False), ("bf16", False),
                                       ("int8", False), ("int8", True)])
def test_tree_codec_matches_the_reference(kind, sqrt):
    tree = _moment_tree(3)
    if sqrt:  # the second moment's domain: non-negative
        tree = jax.tree_util.tree_map(np.abs, tree)
    j_tree = jax.tree_util.tree_map(jnp.asarray, tree)
    t_tree = jax.tree_util.tree_map(torch.from_numpy, tree)
    jc = jcodec.MomentCodec(kind, sqrt_domain=sqrt)
    tc = tcodec.MomentCodec(kind, sqrt_domain=sqrt)
    j_enc = jcodec.tree_encode(jc, j_tree, j_tree)
    t_enc = tcodec.tree_encode(tc, t_tree, t_tree)
    for path, leaf in _moment_leaves(t_enc):
        want = _get(j_enc, path)
        if kind == "int8":
            np.testing.assert_array_equal(leaf.codes.numpy(),
                                          np.asarray(want.codes))
            np.testing.assert_array_max_ulp(
                leaf.scale.numpy(), np.asarray(want.scale), maxulp=1)
        else:
            assert str(leaf.dtype).split(".")[-1] == \
                np.asarray(want).dtype.name
            np.testing.assert_array_equal(
                leaf.float().numpy(), np.asarray(want).astype(np.float32))
    j_dec = jcodec.tree_decode(jc, j_enc)
    for path, leaf in _moment_leaves(tcodec.tree_decode(tc, t_enc)):
        assert leaf.dtype == torch.float32
        np.testing.assert_allclose(leaf.numpy(), np.asarray(_get(j_dec, path)),
                                   rtol=1e-6, atol=0)


def _get(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _moment_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _moment_leaves(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tree)]


def test_compress_codes_equal_given_the_reference_uniforms():
    tree = _moment_tree(2)
    key = jax.random.PRNGKey(9)
    j_ct = jcomp.compress(jax.tree_util.tree_map(jnp.asarray, tree), key)
    leaves, _ = jax.tree_util.tree_flatten(tree)
    keys = jax.random.split(key, len(leaves))
    j_codes = jax.tree_util.tree_leaves(j_ct.codes)
    j_scales = jax.tree_util.tree_leaves(j_ct.scales)
    for x, k, jc, js in zip(leaves, keys, j_codes, j_scales):
        u = np.asarray(jax.random.uniform(k, x.shape))
        codes, scale = tcomp._encode_leaf(torch.from_numpy(x),
                                          torch.from_numpy(u))
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
        np.testing.assert_array_max_ulp(scale.numpy(), np.asarray(js),
                                        maxulp=1)
    ct = tcomp.compress(jax.tree_util.tree_map(torch.from_numpy, tree),
                        torch.Generator().manual_seed(0))
    assert tcomp.compressed_bytes(ct) == jcomp.compressed_bytes(j_ct)
    for path, leaf in leaves_with_path(tcomp.decompress(ct)):
        x = _get(tree, path)
        step = np.abs(x).max(axis=-1, keepdims=True) / 127.0
        assert np.all(np.abs(leaf.numpy() - x) <= step * (1 + 1e-6))


# ---------------------------------------------------------------------------
# Configs: input specs and the cell grid
# ---------------------------------------------------------------------------
def _sds(x):
    return tuple(x.shape), np.dtype(x.dtype).name


def _tds(x):
    return tuple(x.shape), str(x.dtype).split(".")[-1]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_the_reference(arch):
    jm, tm = j_get_arch(arch).model, get_arch(arch).model
    for name in SHAPES:
        js, ts = J_SHAPES[name], SHAPES[name]
        pairs = [(jbase.train_input_specs(jm, js, 4),
                  tbase.train_input_specs(tm, ts, 4)),
                 (jbase.prefill_input_specs(jm, js),
                  tbase.prefill_input_specs(tm, ts)),
                 (jbase.decode_input_specs(jm, js),
                  tbase.decode_input_specs(tm, ts))]
        for j, t in pairs:
            assert j.keys() == t.keys()
            for k in j:
                assert t[k].device.type == "meta"
                assert _tds(t[k]) == _sds(j[k]), (arch, name, k)


def test_all_cells_match_the_reference():
    assert ARCH_IDS == J_ARCH_IDS
    assert [(s.arch_id, sh.name) for s, sh in all_cells()] == \
        [(s.arch_id, sh.name) for s, sh in j_all_cells()]


# ---------------------------------------------------------------------------
# The launcher and the example
# ---------------------------------------------------------------------------
def test_train_cli_resumes_and_the_loss_falls(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen2-7b", "--smoke", "--device", "cpu", "--seq-len", "32",
           "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--resume"]
    env = {"PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
           "PATH": "/usr/bin:/bin"}
    first = subprocess.run(cmd + ["--steps", "2"], capture_output=True,
                           text=True, env=env, timeout=120)
    assert first.returncode == 0, first.stderr
    second = subprocess.run(cmd + ["--steps", "4"], capture_output=True,
                            text=True, env=env, timeout=120)
    assert second.returncode == 0, second.stderr
    assert "resumed at step 2 (data step 4)" in second.stdout
    losses = [float(line.split()[3]) for line in
              (first.stdout + second.stdout).splitlines()
              if line.startswith("step")]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_4"]


def test_distributed_train_example_runs_on_the_cpu(tmp_path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "distributed_train",
        ROOT / "examples" / "torch" / "distributed_train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    params = mod.main(["--device", "cpu", "--steps", "2", "--ckpt-dir",
                       str(tmp_path)])
    assert all(torch.isfinite(l).all() for _, l in leaves_with_path(params))
