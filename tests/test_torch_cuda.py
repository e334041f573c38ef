"""The port's CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no CPU mode, so without a card every test here
skips. On a machine with one (and without JAX, which this file does not
import), run them with

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the matmuls, gather, fused encode from points and from baked
corners (F in {1, 2, 4, 8}) and march are exact, and so are the three
serve tiers against each other; compositing, unfused and fused with the
gathers, is within 1e-5 (the early exit drops less than t_eps per
channel) and bit-stable. Attention
against its plain versions: 1e-4 in float32 (summation order), and in
bfloat16 3e-2 (flash) and 2e-2 (decode), the bands of
`tests/test_kernels.py` (p is rounded to bf16 at another maximum); the
tile-edge and split-edge cases are held to 5e-3 in bfloat16, the limit
`chip_smoke.py` holds both kernels to at the serve shapes. Training on
the card against the CPU: the loss within 1e-5 relative and every leaf
within 5e-5 after five steps (another summation order in the tables'
backward and the matmuls);
fused `evaluate_psnr` against its plain versions within 1e-4 dB. The
search: the device cache walk equal to the host walk and the numpy
oracle at the paper trace size, a card simulator's cycles within 1e-6
relative of a host one's, a 4-level env's episode on the card
against the CPU (misses equal, cycles within 1e-6, PSNR within 1e-3
dB), and one tiny closed-loop cell on the card against the CPU (the
same bits, rewards within 1e-4, PSNR within 1e-3 dB, latency within
1e-6 relative). The distributed search on the card: a thread pool's
sweep equal to the sequential run, launches included, and the
population split over the visible cards equal to the plain env
exactly. The LM search on the card: `loss_fn` of the MoE and dense
smoke configs under a mixed spec within 1e-5 relative of the CPU's
(flash attention once per layer), and the LM bundle's proxy losses
within 1e-6 relative of the CPU's on the same weights. Full attention
(`ops.full_attention`: Sq queries against Sk keys, whisper's encoder and
cross-attention shapes among them) against its plain version, 1e-4 in
float32 and 5e-3 in bfloat16; the jamba, xlstm, whisper and llava smoke
configs' forward, prefill and decode step within 1e-3 of the CPU's in
float32, with the attention launches each makes. Kernel 6's backward
against its plain version (1e-5 of the largest gradient in float32, 2e-2
in bfloat16) and bit-stable, its log-sum-exp within 1e-5, autograd
through `ops` on the card equal to the CPU's within 1e-5, the bare
forward and kernel 7 refusing a gradient they would drop, and one train
step of six smoke configs card against CPU."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention_kernel as dak
from repro_torch.kernels import ops
from repro_torch.kernels.alpha_composite import alpha_composite_plain
from repro_torch.kernels.decode_attention_kernel import (
    decode_attention_cuda,
    decode_attention_plain,
    split_len,
)
from repro_torch.kernels.flash_attention_kernel import (
    flash_attention_cuda,
    flash_attention_plain,
    full_attention_plain,
)
from repro_torch.kernels.hash_encode import (
    hash_encode_corners_plain,
    hash_encode_points_plain,
)
from repro_torch.kernels.hash_encoding_kernel import hash_gather_plain
from repro_torch.kernels.quant_matmul import (
    quant_matmul_packed_plain,
    quant_matmul_plain,
)
from repro_torch.kernels.ray_march import ray_march_plain
from repro_torch.kernels.repack import repack_tile_native
from repro_torch.nerf import hash_encoding as he
from repro_torch.nerf import occupancy as occ_mod
from repro_torch.nerf.render import RenderConfig
from repro_torch.quant.packing import pack_codes

pytestmark = pytest.mark.cuda


def _chip_smoke():
    """`chip_smoke.py`, for the inputs it drives the kernels with."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("bits", [1, 3, 4, 8])
@pytest.mark.parametrize("layout", ["planar", "tile:128"])
def test_quant_matmul_packed_kernel_exact(card, bits, layout):
    rng = np.random.default_rng(bits)
    for m, k, n in [(1, 1, 1), (37, 45, 5), (300, 129, 70)]:
        x = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
        q = rng.integers(-(2 ** (bits - 1)) - 1, 2 ** (bits - 1), (k, n))
        w = pack_codes(q, bits, scale=0.01, device=card)
        w = repack_tile_native(w) if layout != "planar" else w
        xc = x.to(card)
        for zx in (17, 128, -128):
            got = ops.quant_matmul_packed(xc, w, 0.05, w.scale, zx)
            want = quant_matmul_packed_plain(xc, w, 0.05, w.scale, zx)
            assert torch.equal(got, want)
            cpu = quant_matmul_packed_plain(x, _cpu_packed(w), 0.05,
                                            w.scale.cpu(), zx)
            assert torch.equal(got.cpu(), cpu)


def _cpu_packed(w):
    import dataclasses

    return dataclasses.replace(w, words=w.words.cpu(), scale=w.scale.cpu(),
                               offset=w.offset.cpu())


def test_hash_gather_kernel_exact(card):
    rng = np.random.default_rng(1)
    T = 6_098_925
    table = torch.from_numpy(rng.normal(size=(T, 2)).astype(np.float32))
    idx = rng.integers(0, T, 100_003).astype(np.int32)
    idx[:5] = [-1, T, T + 3, -(2 ** 31), 2 ** 31 - 1]
    idx_c, table_c = torch.from_numpy(idx).to(card), table.to(card)
    got = ops.hash_gather(idx_c, table_c)
    assert torch.equal(got, hash_gather_plain(idx_c, table_c))
    assert not got[:5].any()


def test_ray_march_kernel_exact(card):
    rng = np.random.default_rng(2)
    G, R = 32, 600
    occ = torch.from_numpy((rng.uniform(size=(G, G, G)) < 0.4)
                           .astype(np.float32)).to(card)
    o = rng.uniform(-1.3, 1.3, (R, 3)).astype(np.float32)
    d = (rng.uniform(-0.4, 0.4, (R, 3)) - o).astype(np.float32)
    faces = (np.arange(G + 1) / G - 0.5).astype(np.float32)
    o[:64] = rng.choice(faces, (64, 3))
    d[:64] = 0.0
    d[np.arange(64), np.arange(64) % 3] = 1.0
    o[np.arange(64), np.arange(64) % 3] = -1.0
    d[64:70] = 0.0
    d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-30)
    t = torch.from_numpy(np.linspace(0.2, 2.5, 32, dtype=np.float32)).to(card)
    oc, dc = torch.from_numpy(o).to(card), torch.from_numpy(d).to(card)
    want = ray_march_plain(occ, oc, dc, t)
    for early in (True, False):
        assert torch.equal(ops.ray_march(occ, oc, dc, t, early), want)


def test_alpha_composite_kernel_close(card):
    rng = np.random.default_rng(3)
    R, S = 700, 32
    scale = rng.choice([0.0, 0.5, 5.0, 300.0], (R, 1))
    sigma = torch.from_numpy((rng.exponential(1.0, (R, S)) * scale)
                             .astype(np.float32)).to(card)
    delta = torch.full((R, S), 0.07, device=card)
    delta[:, -1] = 1e10
    rgb = torch.from_numpy(rng.uniform(size=(R, S, 3)).astype(np.float32)) \
        .to(card)
    pc, pa = alpha_composite_plain(sigma, rgb, delta)
    for early in (False, True):
        c, a = ops.alpha_composite(sigma, rgb, delta, early, 1e-6)
        assert (c - pc).abs().max().item() <= 1e-5
        assert (a - pa).abs().max().item() <= 1e-5


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = torch.zeros((4, 8), dtype=torch.int8, device=card)
    w = pack_codes(np.zeros((8, 3), np.int64), 4, device=card)
    with pytest.raises(TypeError):
        ops.quant_matmul_packed(x.to(torch.int32), w, 1.0, w.scale, 0)
    with pytest.raises(ValueError):
        ops.hash_gather(torch.zeros(8, dtype=torch.int32, device=card),
                        torch.zeros((4, 2), device=card).t())
    with pytest.raises(ValueError):
        ops.alpha_composite(torch.zeros((4, 3), device=card),
                            torch.zeros((4, 3, 3), device=card),
                            torch.zeros((4, 3), device=card).t().contiguous()
                            .t())


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (37, 45, 5), (129, 257, 65),
                                   (16384, 64, 64)])
def test_quant_matmul_kernel_exact(card, m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8))
    for zx in (0, 17, 128, -128):
        got = ops.quant_matmul(x.to(card), w.to(card), 0.037, 0.011, zx)
        assert torch.equal(got, quant_matmul_plain(x.to(card), w.to(card),
                                                   0.037, 0.011, zx))
        assert torch.equal(got.cpu(), quant_matmul_plain(x, w, 0.037, 0.011,
                                                         zx))


def _model_views(rng, card, B, S, Hkv, G, hd, dtype):
    """q, k, v as the model hands them over: views of (B, S, H, hd) and
    (B, S, Hkv, hd) tensors."""
    q = torch.from_numpy(rng.normal(size=(B, S, Hkv * G, hd))
                         .astype(np.float32)).to(card, dtype)
    k = torch.from_numpy(rng.normal(size=(B, S, Hkv, hd))
                         .astype(np.float32)).to(card, dtype)
    v = torch.from_numpy(rng.normal(size=(B, S, Hkv, hd))
                         .astype(np.float32)).to(card, dtype)
    return (q.view(B, S, Hkv, G, hd).permute(0, 2, 1, 3, 4),
            k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3))


@pytest.mark.parametrize("b,hkv,g,s,hd", [(1, 1, 1, 64, 16), (2, 2, 4, 96, 32),
                                          (1, 4, 2, 130, 64),
                                          (2, 4, 7, 257, 128),
                                          (1, 2, 3, 256, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_close(card, b, hkv, g, s, hd, dtype):
    rng = np.random.default_rng(s + hd)
    q, k, v = _model_views(rng, card, b, s, hkv, g, hd, dtype)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for causal in (True, False) if s % 128 == 0 else (True,):
        got = ops.flash_attention(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal)
        assert got.shape == (b, hkv, s, g, hd) and got.dtype == torch.float32
        assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("b,hkv,g,s,hd", [(1, 1, 1, 32, 16), (2, 4, 3, 100, 16),
                                          (2, 2, 8, 257, 64),
                                          (4, 4, 7, 1056, 128),
                                          # whisper's cross decode, llava's
                                          (4, 20, 1, 1500, 64),
                                          (4, 8, 4, 1056, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_close(card, b, hkv, g, s, hd, dtype):
    rng = np.random.default_rng(b + s)
    q = torch.from_numpy(rng.normal(size=(b, hkv, g, hd))
                         .astype(np.float32)).to(card, dtype)
    cache = [torch.from_numpy(rng.normal(size=(b, s, hkv, hd))
                              .astype(np.float32)).to(card, dtype)
             for _ in range(2)]
    k, v = (c.permute(0, 2, 1, 3) for c in cache)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for length in (1, s - 5, s):
        got = ops.decode_attention(q, k, v, length)
        want = decode_attention_plain(q, k, v, length)
        assert got.dtype == dtype and got.shape == (b, hkv, g, hd)
        assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_lse_form(card, dtype):
    """Kernel 7's partial form against its plain version: the f32 output
    and the log-sum-exp of the masked scores, at lengths across the
    splits and at 0 (zero and -inf, given as an int and on the card);
    the same call without `lse` still agrees with the plain version in
    the input's dtype."""
    rng = np.random.default_rng(21)
    q, k, v = _decode_case(rng, card, 4, 4, 7, 1056, 128, dtype)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for length in (1, 517, 1051, 1056):
        out, lse = ops.decode_attention(q, k, v, length, lse=True)
        w_out, w_lse = decode_attention_plain(q, k, v, length, lse=True)
        assert out.dtype == lse.dtype == torch.float32
        assert (out - w_out).abs().max().item() <= tol
        assert (lse - w_lse).abs().max().item() <= 1e-4 * \
            w_lse.abs().max().item()
        whole = ops.decode_attention(q, k, v, length)
        want = decode_attention_plain(q, k, v, length)
        assert whole.dtype == dtype
        assert (whole.float() - want.float()).abs().max().item() <= tol
    for n in (0, torch.tensor(0, device=card)):
        out, lse = ops.decode_attention(q, k, v, n, lse=True)
        assert torch.equal(out, torch.zeros_like(out))
        assert torch.equal(lse, torch.full_like(lse, -torch.inf))
        assert torch.equal(ops.decode_attention(q, k, v, n),
                           torch.zeros_like(q))


@pytest.mark.parametrize("blocks", [1, 2, 4])
def test_decode_attention_kernel_blocks_combine_to_the_whole(card, blocks):
    """The cache cut into blocks of positions, some wholly past the token:
    kernel 7's partial form on each, merged by `combine_partials`, equals
    kernel 7 over the whole cache (f32, 1e-5)."""
    from repro_torch.distributed.sharding import combine_partials

    rng = np.random.default_rng(blocks)
    q, k, v = _decode_case(rng, card, 2, 4, 7, 1056, 128, torch.float32)
    n = 1056 // blocks
    for length in (1, 300, 1056):
        parts = [ops.decode_attention(
            q, k[:, :, r * n:(r + 1) * n], v[:, :, r * n:(r + 1) * n],
            min(max(length - r * n, 0), n), lse=True)
            for r in range(blocks)]
        got = combine_partials(torch.stack([o for o, _ in parts]),
                               torch.stack([l for _, l in parts]))
        want = ops.decode_attention(q, k, v, length)
        assert (got - want).abs().max().item() <= 1e-5


def test_decode_attention_kernel_masks_future(card):
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(1, 2, 2, 16)).astype(np.float32)) \
        .to(card)
    k = torch.from_numpy(rng.normal(size=(1, 2, 200, 16)).astype(np.float32)) \
        .to(card)
    v = torch.from_numpy(rng.normal(size=(1, 2, 200, 16)).astype(np.float32)) \
        .to(card)
    base = ops.decode_attention(q, k, v, 70)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 70:] = 99.0
    v2[:, :, 70:] = float("nan")  # never read
    poisoned = ops.decode_attention(q, k2, v2, torch.tensor(70, device=card))
    assert torch.equal(base, poisoned)


def test_attention_wrappers_refuse_what_the_kernels_do_not_take(card):
    q = torch.zeros((1, 1, 8, 2, 16), device=card, dtype=torch.float16)
    k = torch.zeros((1, 1, 8, 16), device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.flash_attention(q, k, k)
    q = torch.zeros((1, 1, 8, 2, 256), device=card)
    k = torch.zeros((1, 1, 8, 256), device=card)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k)  # head dim > 128
    qd = torch.zeros((1, 1, 17, 16), device=card)
    kd = torch.zeros((1, 1, 8, 16), device=card)
    with pytest.raises(ValueError):
        ops.decode_attention(qd, kd, kd, 4)  # G > 16
    with pytest.raises(ValueError):
        ops.decode_attention(qd[:, :, :2], kd.transpose(2, 3)
                             .contiguous().transpose(2, 3), kd, 4)


BF16_EDGE_TOL = 5e-3


@pytest.mark.parametrize("s", [1, 63, 64, 65, 129, 1000])
@pytest.mark.parametrize("g", [1, 7, 8])
@pytest.mark.parametrize("hd", [16, 40, 128])
def test_flash_attention_bf16_tile_edges(card, s, g, hd):
    """The tensor-core route at the edges of its 64-key tiles and 128-row
    query tiles, with hd zero-padded in shared memory (40 is not a
    multiple of 16), causal and full (the kernel masks keys >= S itself;
    `ops` keeps the reference's S % 128 rule for full attention)."""
    rng = np.random.default_rng(1000 * s + 10 * g + hd)
    q, k, v = _model_views(rng, card, 2, s, 2, g, hd, torch.bfloat16)
    for causal in (True, False):
        got = flash_attention_cuda(q, k, v, causal)
        want = flash_attention_plain(q, k, v, causal)
        assert got.shape == (2, 2, s, g, hd) and got.dtype == torch.float32
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= BF16_EDGE_TOL


def test_flash_attention_bf16_refuses_unaligned_views(card):
    B, S, Hkv, G, hd = 1, 64, 2, 2, 16
    rng = np.random.default_rng(7)
    q, k, v = _model_views(rng, card, B, S, Hkv, G, hd, torch.bfloat16)
    flat = torch.zeros(B * S * Hkv * hd + 1, dtype=torch.bfloat16,
                       device=card)
    shifted = flat[1:].view(B, S, Hkv, hd).permute(0, 2, 1, 3)  # 2-byte start
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(q, shifted, v)
    wide = torch.zeros((B, S, Hkv, hd + 4), dtype=torch.bfloat16, device=card)
    odd = wide[..., :hd].permute(0, 2, 1, 3)  # h-stride 20: not 16 bytes
    with pytest.raises(ValueError, match="stride"):
        ops.flash_attention(q, k, odd)
    with pytest.raises(ValueError, match="16-byte"):
        ops.decode_attention(q[:, :, 0], shifted, v, 8)
    # float32 keeps the CUDA-core route, which takes any strides.
    widef = torch.randn((B, S, Hkv, hd + 3), device=card)
    qf, kf = q.float(), widef[..., :hd].permute(0, 2, 1, 3)  # h-stride 19
    got = ops.flash_attention(qf, kf, kf)
    assert (got - flash_attention_plain(qf, kf, kf)).abs().max() <= 1e-4


@pytest.mark.parametrize("b,hkv,g,sq,sk,hd", [
    (1, 4, 1, 1500, 1500, 64),  # whisper's encoder (4 of its 20 heads)
    (2, 4, 1, 64, 1500, 64),  # its cross-attention over 1,500 frames
    (1, 4, 1, 1024, 1500, 64),  # ... of a served 1,024-token prompt
    (1, 4, 1, 1001, 1001, 64),  # the last key tile holds 41 keys
    (2, 4, 1, 64, 1001, 64),
    (1, 1, 1, 1, 1, 16), (2, 2, 3, 33, 130, 128), (1, 2, 7, 200, 7, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_attention_kernel_close(card, b, hkv, g, sq, sk, hd, dtype):
    """`ops.full_attention` on the card (kernel 6, non-causal, its own key
    length) against `full_attention_plain`, on the model's views."""
    rng = np.random.default_rng(sq + sk + hd)
    q, _, _ = _model_views(rng, card, b, sq, hkv, g, hd, dtype)
    _, k, v = _model_views(rng, card, b, sk, hkv, 1, hd, dtype)
    n = flash_attention_cuda.launches
    got = ops.full_attention(q, k, v)
    want = full_attention_plain(q, k, v)
    assert flash_attention_cuda.launches - n == 1
    assert got.shape == (b, hkv, sq, g, hd) and got.dtype == torch.float32
    tol = 1e-4 if dtype == torch.float32 else BF16_EDGE_TOL
    assert (got - want).abs().max().item() <= tol


def test_flash_attention_refuses_causal_over_other_key_lengths(card):
    rng = np.random.default_rng(0)
    q, _, _ = _model_views(rng, card, 1, 64, 2, 2, 16, torch.float32)
    _, k, v = _model_views(rng, card, 1, 65, 2, 1, 16, torch.float32)
    with pytest.raises(ValueError, match="causal"):
        flash_attention_cuda(q, k, v, causal=True)
    assert (flash_attention_cuda(q, k, v, causal=False)
            - full_attention_plain(q, k, v)).abs().max() <= 1e-4


def _decode_case(rng, card, b, hkv, g, s, hd, dtype):
    q = torch.from_numpy(rng.normal(size=(b, hkv, g, hd))
                         .astype(np.float32)).to(card, dtype)
    cache = [torch.from_numpy(rng.normal(size=(b, s, hkv, hd))
                              .astype(np.float32)).to(card, dtype)
             for _ in range(2)]
    return q, cache[0].permute(0, 2, 1, 3), cache[1].permute(0, 2, 1, 3)


@pytest.mark.parametrize("b,hkv", [(1, 1), (16, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_split_edges(card, b, hkv, dtype):
    """Lengths on and beside the edges of the kernel's splits, given as an
    int and as a tensor on the card, for B * Hkv = 1 and 64."""
    g, s, hd = 7, 1056, 128
    rng = np.random.default_rng(b * hkv)
    q, k, v = _decode_case(rng, card, b, hkv, g, s, hd, dtype)
    sp = split_len(b * hkv, s, g, hd, q.element_size(),
                   torch.cuda.get_device_properties(card)
                   .multi_processor_count)
    tol = 1e-4 if dtype == torch.float32 else BF16_EDGE_TOL
    for length in sorted({1, sp - 1, sp, sp + 1, 2 * sp - 1, 2 * sp,
                          2 * sp + 1, s - sp, s - 1, s}):
        want = decode_attention_plain(q, k, v, length).float()
        for arg in (length, torch.tensor(length, device=card)):
            got = ops.decode_attention(q, k, v, arg)
            assert got.dtype == dtype and got.shape == (b, hkv, g, hd)
            err = (got.float() - want).abs().max().item()
            assert err <= tol, (length, err)


def test_decode_attention_back_to_back_calls_reset_tickets(card):
    """Three calls queued without a sync, at different shapes and lengths
    (two of them sharing cached scratch): each matches its plain version,
    and every ticket is back at 0 afterwards."""
    rng = np.random.default_rng(11)
    cases = [(2, 4, 7, 1056, 128, 1040), (1, 2, 3, 300, 64, 17),
             (2, 4, 7, 1056, 128, 49)]
    inputs = [_decode_case(rng, card, b, h, g, s, hd, torch.bfloat16)
              for b, h, g, s, hd, _ in cases]
    outs = [ops.decode_attention(q, k, v, c[-1])
            for (q, k, v), c in zip(inputs, cases)]
    torch.cuda.synchronize()
    for (q, k, v), c, got in zip(inputs, cases, outs):
        want = decode_attention_plain(q, k, v, c[-1])
        assert (got.float() - want.float()).abs().max().item() <= BF16_EDGE_TOL
    for _, _, tickets in dak._SCRATCH.values():
        assert not tickets.any()


def test_decode_attention_one_launch_per_call(card):
    rng = np.random.default_rng(12)
    q, k, v = _decode_case(rng, card, 1, 2, 4, 200, 64, torch.bfloat16)
    ops.decode_attention(q, k, v, 100)
    torch.cuda.synchronize()
    n = decode_attention_cuda.launches
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.decode_attention(q, k, v, 150)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert decode_attention_cuda.launches == n + 1
    assert len(kernels) == 1 and "decode_kernel" in kernels[0], kernels


# ---------------------------------------------------------------------------
# The quantized matmuls at the edges of their tensor-core tiles
# ---------------------------------------------------------------------------
QMM_KS = (1, 8, 31, 33, 40, 64, 257)
QMM_NS = (1, 3, 8, 16, 65, 200)
QMM_MS = (1, 15, 16, 127, 16385)
QMM_ZXS = (-128, 0, 17, 127)


def _codes(rng, shape):
    return torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8))


def _packed_on(rng, card, k, n, bits, layout):
    """Codes over the paper-exact grid [-2^(b-1) - 1, 2^(b-1) - 1]."""
    q = rng.integers(-(2 ** (bits - 1)) - 1, 2 ** (bits - 1), (k, n))
    w = pack_codes(q, bits, scale=float(rng.uniform(1e-3, 1e-1)), device=card)
    return repack_tile_native(w) if layout != "planar" else w


def _assert_qmm_exact(got, want, what):
    assert got.shape == want.shape and got.dtype == torch.float32, what
    assert torch.equal(got, want), (what, (got - want).abs().max().item())


@pytest.mark.parametrize("k", QMM_KS)
@pytest.mark.parametrize("n", QMM_NS)
def test_quant_matmul_packed_tile_edges(card, k, n):
    """Every M edge, bits 1-8, both layouts, four zero points: K around
    the 32-code MMA step and past one 256-code chunk, N around the
    8-column MMA tile and past one 64-column block tile."""
    rng = np.random.default_rng(100 * k + n)
    for m in QMM_MS:
        x = _codes(rng, (m, k)).to(card)
        for bits in range(1, 9):
            for layout in ("planar", "tile:128"):
                w = _packed_on(rng, card, k, n, bits, layout)
                for zx in QMM_ZXS:
                    _assert_qmm_exact(
                        ops.quant_matmul_packed(x, w, 0.037, w.scale, zx),
                        quant_matmul_packed_plain(x, w, 0.037, w.scale, zx),
                        (m, k, n, bits, layout, zx))


@pytest.mark.parametrize("k", QMM_KS)
@pytest.mark.parametrize("n", QMM_NS)
def test_quant_matmul_tile_edges(card, k, n):
    rng = np.random.default_rng(200 * k + n)
    w = _codes(rng, (k, n)).to(card)
    for m in QMM_MS:
        x = _codes(rng, (m, k)).to(card)
        for zx in QMM_ZXS:
            _assert_qmm_exact(ops.quant_matmul(x, w, 0.037, 0.011, zx),
                              quant_matmul_plain(x, w, 0.037, 0.011, zx),
                              (m, k, n, zx))


@pytest.mark.parametrize("shift", [1, 2, 4, 8, 40])
@pytest.mark.parametrize("k", [33, 40, 64, 257])
def test_quant_matmul_takes_x_views_off_16_byte_boundaries(card, shift, k):
    """x starting `shift` bytes into a buffer (x_big[1:] with K = 40 starts
    40 bytes in): the kernels copy x as wide as its alignment allows."""
    rng = np.random.default_rng(shift + k)
    m, n = 1000, 64
    buf = _codes(rng, (m * k + shift,)).to(card)
    x = buf[shift:].view(m, k)
    assert x.is_contiguous() and x.data_ptr() % 16 == shift % 16
    w = _codes(rng, (k, n)).to(card)
    wq = _packed_on(rng, card, k, n, 4, "tile:128")
    for zx in (-128, 17):
        _assert_qmm_exact(ops.quant_matmul(x, w, 0.5, 0.25, zx),
                          quant_matmul_plain(x, w, 0.5, 0.25, zx), shift)
        _assert_qmm_exact(ops.quant_matmul_packed(x, wq, 0.5, wq.scale, zx),
                          quant_matmul_packed_plain(x, wq, 0.5, wq.scale, zx),
                          shift)
    x_big = _codes(rng, (m + 1, k)).to(card)
    _assert_qmm_exact(ops.quant_matmul(x_big[1:], w, 0.5, 0.25, 3),
                      quant_matmul_plain(x_big[1:], w, 0.5, 0.25, 3), "row 1")


@pytest.mark.parametrize("m,k,n", [(262144, 64, 64), (200000, 40, 3),
                                   (120000, 600, 70)])
def test_quant_matmul_blocks_walk_several_m_tiles(card, m, k, n):
    """More 128-row tiles than three times the grid of about two blocks an
    SM (qmm_tile.cuh): each block walks at least three."""
    n_sm = torch.cuda.get_device_properties(card).multi_processor_count
    assert -(-m // 128) > 3 * 2 * n_sm
    rng = np.random.default_rng(m + k + n)
    x = _codes(rng, (m, k)).to(card)
    w = _codes(rng, (k, n)).to(card)
    wq = _packed_on(rng, card, k, n, 6, "planar")
    _assert_qmm_exact(ops.quant_matmul(x, w, 0.02, 0.03, -7),
                      quant_matmul_plain(x, w, 0.02, 0.03, -7), "unpacked")
    _assert_qmm_exact(ops.quant_matmul_packed(x, wq, 0.02, wq.scale, -7),
                      quant_matmul_packed_plain(x, wq, 0.02, wq.scale, -7),
                      "packed")


def test_quant_matmul_back_to_back_calls_on_different_weights(card):
    """Calls queued without a sync on one x with different weights (and
    shapes): each block stages its own weight, so nothing carries over."""
    rng = np.random.default_rng(21)
    x = _codes(rng, (16384, 64)).to(card)
    ws = [_codes(rng, (64, n)).to(card) for n in (64, 64, 16, 64, 3)]
    wqs = [_packed_on(rng, card, 64, n, b, lay) for n, b, lay in
           ((64, 4, "tile:128"), (64, 4, "tile:128"), (64, 8, "planar"),
            (16, 2, "tile:128"), (64, 4, "planar"))]
    outs = [ops.quant_matmul(x, w, 0.1, 0.2, 5) for w in ws]
    outs_p = [ops.quant_matmul_packed(x, w, 0.1, w.scale, 5) for w in wqs]
    torch.cuda.synchronize()
    for w, got in zip(ws, outs):
        _assert_qmm_exact(got, quant_matmul_plain(x, w, 0.1, 0.2, 5), "w")
    for w, got in zip(wqs, outs_p):
        _assert_qmm_exact(got, quant_matmul_packed_plain(x, w, 0.1, w.scale, 5),
                          "wq")


# ---------------------------------------------------------------------------
# The fused hash encode: bit-equal to its plain version
# ---------------------------------------------------------------------------
def _encode_points(which, hc, card):
    if which == "serve":
        return CS.serve_points(512, card)[0]
    if which == "edges":
        return torch.from_numpy(CS.encode_edge_points(hc, 1024)).to(card)
    rng = np.random.default_rng(13)
    return torch.from_numpy(rng.uniform(size=(16384, 3))
                            .astype(np.float32)).to(card)


@pytest.mark.parametrize("codes", [False, True])
@pytest.mark.parametrize("which", ["serve", "edges", "random"])
def test_hash_encode_kernel_exact_paper(card, which, codes):
    """Paper width (16 levels, 5 direct, 11 hashed, the 6,098,925-row
    table with subnormal-scale rows), f32 encodings or int8 codes."""
    from repro_torch.configs.ngp import paper

    hc = paper().hash
    table, meta, act = CS.encode_inputs(np.random.default_rng(14), hc, card)
    pts = _encode_points(which, hc, card)
    a = act if codes else None
    got = ops.hash_encode_points(pts, table, meta, a)
    want = hash_encode_points_plain(pts, table, meta, a)
    assert got.dtype == (torch.int8 if codes else torch.float32)
    assert torch.equal(got, want)


def test_hash_encode_kernel_exact_off_32_offsets_and_past_the_table(card):
    """Level offsets that are not multiples of 32, odd B, and a table cut
    short so that some corner rows fall past its end (zero rows)."""
    hc = he.HashEncodingConfig(n_levels=6, log2_table_size=10,
                               base_resolution=5, max_resolution=90)
    meta = he.level_meta(hc, card)
    assert (meta[1:, 3] % 32 != 0).any()
    rng = np.random.default_rng(15)
    rows = int(meta[:, 2].sum())
    table = torch.from_numpy(rng.normal(size=(rows, 2)).astype(np.float32))
    pts = torch.from_numpy(np.concatenate([
        rng.uniform(size=(1001, 3)), CS.encode_edge_points(hc, 50)])
        .astype(np.float32)).to(card)
    for t in (table, table[:-50]):
        t = t.to(card)
        _, _, act = CS.encode_inputs(rng, hc, card)
        for a in (None, act):
            assert torch.equal(ops.hash_encode_points(pts, t, meta, a),
                               hash_encode_points_plain(pts, t, meta, a))


def test_hash_encode_wrapper_refuses_what_the_kernel_does_not_take(card):
    meta = he.level_meta(he.HashEncodingConfig(n_levels=2), card)
    pts = torch.zeros((4, 3), device=card)
    table = torch.zeros((1000, 2), device=card)
    with pytest.raises(ValueError):  # F = 3
        ops.hash_encode_points(pts, torch.zeros((1000, 3), device=card), meta)
    with pytest.raises(ValueError):  # rows off their 8-byte boundary
        ops.hash_encode_points(pts, table.view(-1)[1:-1].view(-1, 2), meta)
    with pytest.raises(TypeError):
        ops.hash_encode_points(pts, table, meta.to(torch.int64))
    with pytest.raises(ValueError):
        ops.hash_encode_points(pts[:, :2].contiguous(), table, meta)


# ---------------------------------------------------------------------------
# The encode from baked corners: bit-equal to its plain version
# ---------------------------------------------------------------------------
def _corner_inputs(card, hc, seed, subnormal=True):
    """A table at `hc`'s widths (every 97th row subnormal-scale, so corner
    products go subnormal), its offsets and activation grid, and the baked
    corners of random and grid-edge points with 1 % of the indices
    outside the table."""
    rng = np.random.default_rng(seed)
    table, meta, act = CS.encode_inputs(rng, hc, card, subnormal)
    pts = torch.from_numpy(np.concatenate([
        rng.uniform(size=(5000, 3)), CS.encode_edge_points(hc, 256)])
        .astype(np.float32)).to(card)
    idx, w, off = CS.corner_case(rng, pts, hc, table, meta)
    return idx, w, table, off, act


@pytest.mark.parametrize("codes", [False, True])
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_hash_encode_corners_kernel_exact(card, F, codes):
    """16 levels (direct and hashed) on a 2^14-row table of F features a
    level: bit-equal to the plain version, out-of-table rows and
    subnormal corner products included."""
    hc = he.HashEncodingConfig(n_levels=16, n_features=F,
                               log2_table_size=14, base_resolution=16,
                               max_resolution=2048)
    idx, w, table, off, act = _corner_inputs(card, hc, 50 + F)
    a = act if codes else None
    got = ops.hash_encode_corners(idx, w, table, off, a)
    want = hash_encode_corners_plain(idx, w, table, off, a)
    assert got.dtype == (torch.int8 if codes else torch.float32)
    assert got.shape == (idx.shape[1], 16 * F)
    assert torch.equal(got, want)


@pytest.mark.parametrize("L", [1, 5, 6])
def test_hash_encode_corners_kernel_exact_levels_off_the_block(card, L):
    """Level counts that do not divide the 256-thread block (its last
    threads idle), a ragged last block, offsets that are not multiples of
    32, and a table cut short so that corner rows fall past its end."""
    hc = he.HashEncodingConfig(n_levels=L, log2_table_size=10,
                               base_resolution=5, max_resolution=90)
    rng = np.random.default_rng(54 + L)
    table, meta, act = CS.encode_inputs(rng, hc, card)
    pts = torch.from_numpy(rng.uniform(size=(1001, 3)).astype(np.float32))
    idx, w, off = CS.corner_case(rng, pts.to(card), hc, table, meta)
    for t in (table, table[:-50]):
        for a in (None, act):
            assert torch.equal(ops.hash_encode_corners(idx, w, t, off, a),
                               hash_encode_corners_plain(idx, w, t, off, a))


def test_hash_encode_corners_kernel_exact_paper(card):
    """Paper width (the 6,098,925-row table) on one slot's serve points:
    f32 encodings and codes, and the same bits as the points kernel on
    the in-table corners."""
    from repro_torch.configs.ngp import paper

    hc = paper().hash
    table, meta, act = CS.encode_inputs(np.random.default_rng(51), hc, card)
    pts = CS.serve_points(512, card)[0]
    idx, w = CS.corner_case(np.random.default_rng(52), pts, hc, table, meta,
                            bad_share=0.0)[:2]
    off = meta[:, 3].contiguous()
    for a in (None, act):
        got = ops.hash_encode_corners(idx, w, table, off, a)
        assert torch.equal(got, hash_encode_corners_plain(idx, w, table,
                                                          off, a))
        assert torch.equal(got, ops.hash_encode_points(pts, table, meta, a))


def test_hash_encode_corners_wrapper_refuses_what_the_kernel_does_not_take(
        card):
    hc = he.HashEncodingConfig(n_levels=4, log2_table_size=9,
                               base_resolution=4, max_resolution=32)
    idx, w, table, off, _ = _corner_inputs(card, hc, 53, subnormal=False)
    L, B, _ = idx.shape
    n = idx.numel()
    shifted_idx = torch.zeros(n + 1, dtype=torch.int32, device=card)
    shifted_w = torch.zeros(n + 1, device=card)
    with pytest.raises(ValueError):  # 4 bytes off the 16-byte boundary
        ops.hash_encode(shifted_idx[1:].view(L, B, 8), w, table, off)
    with pytest.raises(ValueError):
        ops.hash_encode(idx, shifted_w[1:].view(L, B, 8), table, off)
    with pytest.raises(ValueError):  # not contiguous
        ops.hash_encode(idx.transpose(0, 1).contiguous().transpose(0, 1), w,
                        table, off)
    with pytest.raises(ValueError):  # one offset short
        ops.hash_encode(idx, w, table, off[:-1])
    with pytest.raises(ValueError):  # F = 3
        ops.hash_encode(idx, w, torch.zeros((table.shape[0], 3),
                                            device=card), off)
    with pytest.raises(ValueError):  # rows off their 8-byte boundary
        ops.hash_encode(idx, w, table.view(-1)[1:-1].view(-1, 2), off)
    with pytest.raises(TypeError):
        ops.hash_encode(idx, w, table, off.to(torch.int64))
    with pytest.raises(RuntimeError):  # no backward
        ops.hash_encode(idx, w, table.clone().requires_grad_(True), off)


# ---------------------------------------------------------------------------
# The warp-per-ray march: bit-equal to its plain version and the host oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("R", [200, 512])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 64])
def test_ray_march_warp_per_ray_exact(card, S, R):
    """`march_rays`' camera and edge rays (cell and box faces, zero
    directions, starts inside the box), the early exit on and off."""
    rng = np.random.default_rng(S * 1000 + R)
    G = 32
    occ_np = (rng.uniform(size=(G, G, G)) < 0.5).astype(np.float32)
    o, d = CS.march_rays(rng, R)
    rcfg = RenderConfig(n_samples=S)
    t = torch.from_numpy(occ_mod.ray_t_samples(rcfg)).to(card)
    occ = torch.from_numpy(occ_np).to(card)
    oc, dc = torch.from_numpy(o).to(card), torch.from_numpy(d).to(card)
    want = ray_march_plain(occ, oc, dc, t)
    grid = occ_mod.OccupancyGrid(occ=occ, resolution=G, threshold=0.5,
                                 occupied_fraction=float(occ_np.mean()))
    host, _ = occ_mod.sample_active_mask(grid, o, d, rcfg)
    for early in (True, False):
        got = ops.ray_march(occ, oc, dc, t, early)
        assert torch.equal(got, want)
        assert np.array_equal(got.cpu().numpy() > 0.5, host)


def test_fused_field_runs_the_fused_encode_and_no_corner_ops(card,
                                                            monkeypatch):
    """On the card the staged field query encodes through the one kernel:
    the per-level corner math and the bare gather are never called, and
    the result matches the CPU's plain versions."""
    from repro_torch.kernels.hash_encode import hash_encode_points_cuda
    from repro_torch.kernels.hash_encoding_kernel import hash_gather_cuda
    from repro_torch.nerf import fast_render as fr
    from repro_torch.nerf import ngp

    cfg = ngp.NGPConfig(
        hash=he.HashEncodingConfig(n_levels=4, log2_table_size=9,
                                   base_resolution=4, max_resolution=32),
        hidden_dim=16, color_hidden_dim=16, geo_feat_dim=7, sh_degree=2)
    params = ngp.init_ngp(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    params["hash"] = {k: v * 1e3 for k, v in params["hash"].items()}
    rng = np.random.default_rng(16)
    pts = torch.from_numpy(rng.uniform(size=(500, 3)).astype(np.float32))
    d = rng.normal(size=(500, 3)).astype(np.float32)
    dirs = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    _, _, taps = ngp.ngp_apply(params, pts, dirs, cfg, None,
                               return_taps=True)
    spec = ngp.NGPQuantSpec(
        hash_bits=torch.tensor([8.0, 6.0, 4.0, 8.0]),
        weight_bits=torch.full((5,), 4.0), act_bits=torch.full((5,), 8.0),
        act_ranges=torch.tensor([[float(taps[n].min()), float(taps[n].max())]
                                 for n in ngp.ngp_linear_names(cfg)]))
    want = fr.fused_ngp_apply(fr.build_fused_pack(params, cfg, spec), pts,
                              dirs, cfg)
    on_card = {k: {n: t.to(card) for n, t in v.items()}
               for k, v in params.items()}
    pack = fr.build_fused_pack(on_card, cfg, ngp.NGPQuantSpec(
        *(t.to(card) for t in (spec.hash_bits, spec.weight_bits,
                               spec.act_bits, spec.act_ranges))))
    assert pack.modes[0] == "int"

    def refuse(*args, **kwargs):
        raise AssertionError("a per-level corner op ran on the card path")

    monkeypatch.setattr(fr, "level_corner_data", refuse)
    monkeypatch.setattr("repro_torch.kernels.hash_encode.corner_data", refuse)
    monkeypatch.setattr(ops, "hash_gather", refuse)
    n_enc = hash_encode_points_cuda.launches
    n_gather = hash_gather_cuda.launches
    got = fr.fused_ngp_apply(pack, pts.to(card), dirs.to(card), cfg)
    torch.cuda.synchronize()
    assert hash_encode_points_cuda.launches == n_enc + 1
    assert hash_gather_cuda.launches == n_gather
    for g, w in zip(got, want):
        assert (g.cpu() - w).abs().max().item() <= 1e-5


# ---------------------------------------------------------------------------
# The fused gather-composite: within 1e-5 of its plain version, bit-stable
# ---------------------------------------------------------------------------
def _composite_case(card, rng, R, S, take_dtype, B_extra=0):
    """Compacted field outputs of R rays x S samples: rays from empty to
    opaque, one opaque wall (every sample huge), one empty ray (no active
    sample), the rest half active; `take` the rank of each active sample."""
    active = rng.uniform(size=(R, S)) < 0.5
    active[0] = True  # the opaque wall
    active[1] = False  # the empty ray
    active = active.reshape(-1)
    B = int(active.sum()) + B_extra
    rank = np.cumsum(active) - 1
    scale = rng.choice([0.0, 0.5, 5.0, 300.0], B)
    sigma_b = rng.exponential(1.0, B) * scale
    sigma_b[:S] = 1e4  # ray 0's samples take the first S rows
    t = occ_mod.ray_t_samples(RenderConfig(n_samples=S))
    delta = np.append(np.diff(t), np.float32(1e10)).astype(np.float32)
    to = lambda a, dt=torch.float32: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(dt).to(card)
    return (to(sigma_b), to(rng.uniform(size=(B, 3))), to(rank, take_dtype),
            to(active, torch.bool), to(delta))


@pytest.mark.parametrize("take_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("R,S", [(512, 32), (300, 64), (77, 5), (40, 100)])
def test_gather_composite_kernel_close_and_bit_stable(card, R, S, take_dtype):
    from repro_torch.kernels.gather_composite import gather_composite_plain

    rng = np.random.default_rng(R * S)
    args = _composite_case(card, rng, R, S, take_dtype)
    for white_bg in (True, False):
        pc, pa = gather_composite_plain(*args, white_bg)
        for early in (False, True):
            c, a = ops.gather_composite(*args, white_bg, early, 1e-6)
            c2, a2 = ops.gather_composite(*args, white_bg, early, 1e-6)
            assert torch.equal(c, c2) and torch.equal(a, a2)
            assert (c - pc).abs().max().item() <= 1e-5
            assert (a - pa).abs().max().item() <= 1e-5
            assert a[0].item() == pytest.approx(1.0, abs=1e-6)  # the wall
            assert a[1].item() == 0.0  # the empty ray
            assert c.shape == (R, 3) and a.shape == (R, 1)


def test_gather_composite_kernel_ands_the_march_mask(card):
    from repro_torch.kernels.gather_composite import gather_composite_plain

    rng = np.random.default_rng(5)
    sigma_b, rgb_b, take, valid, delta = _composite_case(card, rng, 256, 32,
                                                         torch.int32)
    march = (torch.rand(valid.shape, device=card) < 0.7).to(torch.float32)
    got = ops.gather_composite(sigma_b, rgb_b, take, valid, delta, True,
                               True, active=march)
    want = gather_composite_plain(sigma_b, rgb_b, take, valid & (march > 0.5),
                                  delta, True)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-5
    again = ops.gather_composite(sigma_b, rgb_b, take,
                                 valid & (march > 0.5), delta, True, True)
    for g, w in zip(got, again):
        assert torch.equal(g, w)


def test_gather_composite_wrapper_refuses_what_the_kernel_does_not_take(card):
    from repro_torch.kernels.gather_composite import gather_composite_cuda

    rng = np.random.default_rng(6)
    args = list(_composite_case(card, rng, 64, 32, torch.int64))
    with pytest.raises(ValueError):  # a CPU tensor
        gather_composite_cuda(args[0].cpu(), *args[1:], True)
    for i, bad in ((1, args[1][:, :2].contiguous()), (3, args[3][:-1]),
                   (4, args[4][:-1]), (2, args[2].to(torch.int16)),
                   (3, args[3].to(torch.uint8))):
        case = list(args)
        case[i] = bad
        with pytest.raises((TypeError, ValueError)):
            ops.gather_composite(*case, True)


# ---------------------------------------------------------------------------
# The fused encode at F in {1, 4, 8}
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("codes", [False, True])
@pytest.mark.parametrize("F", [1, 4, 8])
def test_hash_encode_kernel_exact_other_feature_counts(card, F, codes):
    """16 levels (direct and hashed) on a 2^14-row table of F features a
    level: bit-equal to the plain version on edge and random points."""
    hc = he.HashEncodingConfig(n_levels=16, n_features=F,
                               log2_table_size=14, base_resolution=16,
                               max_resolution=2048)
    rng = np.random.default_rng(30 + F)
    table, meta, act = CS.encode_inputs(rng, hc, card)
    assert table.shape[1] == F
    pts = torch.from_numpy(np.concatenate([
        rng.uniform(size=(5000, 3)), CS.encode_edge_points(hc, 256)])
        .astype(np.float32)).to(card)
    a = act if codes else None
    got = ops.hash_encode_points(pts, table, meta, a)
    assert torch.equal(got, hash_encode_points_plain(pts, table, meta, a))
    assert got.shape == (pts.shape[0], 16 * F)


# ---------------------------------------------------------------------------
# The serve tiers: hit, warp and march give the same bits on the card
# ---------------------------------------------------------------------------
def test_serve_tiers_bit_equal_on_the_card(card):
    """A paper-width field (random weights) on one 512-ray slot: the plan
    hit (baked corners through the corners kernel), the warp (a nearby
    pose's conservative indices) and the march give the same colours, bit
    for bit, and the hit tier launches the corners kernel once, and no
    bare gather and no march."""
    from repro_torch.configs.ngp import paper
    from repro_torch.kernels.hash_encode import hash_encode_corners_cuda
    from repro_torch.kernels.hash_encoding_kernel import hash_gather_cuda
    from repro_torch.kernels.ray_march import ray_march_cuda
    from repro_torch.nerf import fast_render as fr
    from repro_torch.nerf import pose_cache as pc

    cfg = paper()
    art = CS.build_artifact(cfg, card)
    (ro, rd), = CS.request_rays(1, 64, held_out=True)
    ro, rd = ro[:512], rd[:512]
    rcfg = art.rcfg
    spec = art.spec()
    args = (art.params, art.pack, spec, art.occ)
    kw = dict(cfg=cfg, rcfg=rcfg, mode="fused", early_stop=True)
    margin = pc.PoseGridConfig().margin(art.occ)
    plan = pc.build_warp_plan(art.occ, ro, rd, rcfg, cfg, margin)
    o, d = torch.from_numpy(ro).to(card), torch.from_numpy(rd).to(card)
    march, need = fr.slot_march(*args, o, d, cfg, rcfg, "fused", None, True)
    n_gather, n_march = hash_gather_cuda.launches, ray_march_cuda.launches
    n_corners = hash_encode_corners_cuda.launches
    hit = fr.slot_plan(*args, o, d, plan.plan_row, **kw)
    torch.cuda.synchronize()
    assert hash_encode_corners_cuda.launches == n_corners + 1
    assert hash_gather_cuda.launches == n_gather
    assert ray_march_cuda.launches == n_march
    warp = fr.slot_warp(*args, o, d, plan.inv_take, plan.take,
                        plan.valid_cons, **kw)
    assert int(need) > 0
    assert torch.equal(hit, march) and torch.equal(warp, march)
    o_j = o + 1e-4
    assert pc.warp_deviation(o_j.cpu().numpy(), rd, plan.ref_o, plan.ref_d,
                             rcfg) <= margin
    warp_j = fr.slot_warp(*args, o_j, d, plan.inv_take, plan.take,
                          plan.valid_cons, **kw)
    march_j, _ = fr.slot_march(*args, o_j, d, cfg, rcfg, "fused", None, True)
    assert torch.equal(warp_j, march_j)


# ---------------------------------------------------------------------------
# Training and the PSNR half of the reward on the card
# ---------------------------------------------------------------------------
def test_train_steps_card_against_cpu(card):
    """Five train steps at the 4-level test config on the card and on the
    CPU from the same parameters, batches and jitter: the loss within
    1e-5 relative and every leaf within 5e-5 (`chip_smoke.py`'s
    `train_card_vs_cpu`, which raises beyond them)."""
    loss_gap, leaf_gap = CS.train_card_vs_cpu(card)
    assert loss_gap <= 1e-5 and leaf_gap <= 5e-5


def test_fused_evaluate_psnr_card_against_plain_versions(card):
    """A briefly trained 4-level field, a culling grid and the mixed
    policy: fused `evaluate_psnr` on the card (plan path and march path)
    against the same evaluation on the CPU (the plain versions), within
    1e-4 dB; the plan path launches the corners kernel and no march, the
    march path the fused encode and the march, and neither the bare
    gather."""
    from repro_torch.kernels.hash_encode import (
        hash_encode_corners_cuda,
        hash_encode_points_cuda,
    )
    from repro_torch.kernels.hash_encoding_kernel import hash_gather_cuda
    from repro_torch.kernels.ray_march import ray_march_cuda
    from repro_torch.nerf import train as tt
    from repro_torch.nerf.dataset import make_dataset
    from repro_torch.nerf.hash_encoding import HashEncodingConfig
    from repro_torch.nerf.ngp import NGPConfig
    from repro_torch.nerf.scenes import SceneConfig

    cfg = NGPConfig(hash=HashEncodingConfig(n_levels=4, log2_table_size=9,
                                            base_resolution=4,
                                            max_resolution=32),
                    hidden_dim=16, color_hidden_dim=16, geo_feat_dim=7,
                    sh_degree=2)
    rcfg, cpu = RenderConfig(n_samples=16), torch.device("cpu")
    ds = make_dataset(SceneConfig(image_hw=16, n_train_views=4,
                                  n_test_views=2), device=cpu)
    params, _ = tt.train_ngp(ds, cfg, rcfg,
                             tt.TrainConfig(steps=60, batch_rays=256),
                             device=cpu)
    grid = occ_mod.bake_occupancy(params, cfg, resolution=16, threshold=1.0)
    ranges = CS.calibrate_ranges(params, ds, cfg, rcfg)
    _, spec = CS.mixed_spec(cfg, ranges)
    dev_params = CS.to_device(params, card)
    dev_grid = occ_mod.OccupancyGrid(
        occ=grid.occ.to(card), resolution=grid.resolution,
        threshold=grid.threshold, occupied_fraction=grid.occupied_fraction)
    _, dev_spec = CS.mixed_spec(cfg, ranges.to(card))
    budget = tt.FastRenderEngine(params, cfg, rcfg, spec=spec, occ=grid,
                                 device=cpu).test_views_budget(ds)
    for b in (None, budget):
        want = tt.evaluate_psnr(params, ds, cfg, rcfg, spec, occ=grid,
                                mode="fused", budget=b, device=cpu)
        counters = (hash_encode_corners_cuda, hash_encode_points_cuda,
                    ray_march_cuda, hash_gather_cuda)
        n = tuple(c.launches for c in counters)
        got = tt.evaluate_psnr(dev_params, ds, cfg, rcfg, dev_spec,
                               occ=dev_grid, mode="fused", budget=b,
                               device=card)
        torch.cuda.synchronize()
        ran = tuple(c.launches - m for c, m in zip(counters, n))
        assert abs(got - want) <= 1e-4, (b, got, want)
        assert tuple(r > 0 for r in ran) == (
            (True, False, False, False) if b is None
            else (False, True, True, False)), ran


# ---------------------------------------------------------------------------
# The search on the card
# ---------------------------------------------------------------------------
def test_device_cache_stats_equal_the_oracle_at_the_paper_trace(card):
    """The paper config's trace of 1,024 rays (2.1 M grid-cache accesses a
    policy, `EnvConfig()`'s size): the device form's statistics of 12
    coarse-bit combinations in one call equal the host form's, and the
    copied float64 oracle's walk for three of them; a card simulator
    equals a host one on 12 whole policies."""
    from repro_torch.configs.ngp import paper
    from repro_torch.hwsim import (
        BatchedNeuRexSimulator,
        HWConfig,
        NeuRexSimulator,
        build_trace,
    )
    from repro_torch.hwsim.batched import (
        build_trace_constants,
        grid_cache_stats,
        grid_cache_stats_host,
    )

    cfg, hw = paper(), HWConfig()
    rng = np.random.RandomState(0)
    ro = rng.randn(1024, 3).astype(np.float32) * 0.3
    rd = rng.randn(1024, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    trace = build_trace(cfg, RenderConfig(), ro, rd, device=card)
    tc = build_trace_constants(trace, hw, 2, cfg.hash.resolutions())
    assert tc.n_points * 8 * tc.n_coarse == 2 ** 21
    bits = rng.randint(1, 9, (12, 16)).astype(np.float32)
    bits[0] = 8.0
    eb8 = (bits[:, :8] * 2).astype(np.int64)
    hits, misses, cold = grid_cache_stats(torch.from_numpy(eb8).to(card),
                                          tc, hw)
    got = torch.stack([hits, misses, cold], dim=-1).cpu().tolist()
    for i in range(12):
        assert tuple(got[i]) == grid_cache_stats_host(eb8[i], tc, hw)
    oracle = NeuRexSimulator(hw, backend="numpy")
    eight = [8.0] * 5
    for i in range(3):
        st = oracle.simulate(trace, bits[i], eight, eight,
                             resolutions=cfg.hash.resolutions()).grid_cache
        assert tuple(got[i]) == (st.hits, st.misses, st.cold_misses)
    wb = rng.randint(1, 9, (12, 5)).astype(np.float32)
    sims = [BatchedNeuRexSimulator(trace, hw, resolutions=cfg.hash
                                   .resolutions(), device=d)
            for d in (card, torch.device("cpu"))]
    a, b = (s.simulate_batch(bits, wb, wb) for s in sims)
    np.testing.assert_array_equal(a["grid_misses"], b["grid_misses"])
    np.testing.assert_array_equal(a["model_bytes"], b["model_bytes"])
    np.testing.assert_allclose(a["total_cycles"], b["total_cycles"],
                               rtol=1e-6)


def test_search_env_card_against_cpu(card):
    """A 4-level env on the card and on the CPU from the same field:
    `evaluate_bits(bits, finetune_steps=0)` gives equal misses, cycles
    within 1e-6 relative and PSNR within 1e-3 dB (`chip_smoke.py`'s
    `search_card_vs_cpu`, which raises beyond them)."""
    CS.search_card_vs_cpu(card)


def test_closed_loop_cell_card_against_cpu(card):
    """One tiny closed-loop cell (2 iterations at K = 8) on the card and on
    the CPU from the same trained field: the same proposals' bits,
    rewards within 1e-4, proxy PSNR within 1e-3 dB and latency within
    1e-6 relative (`tests/test_torch_search.py`'s bands)."""
    from repro_torch.core.batched_env import BatchedEnvConfig, BatchedQuantEnv
    from repro_torch.core.closed_loop import (
        ClosedLoopConfig,
        HeroSearchRun,
        SceneScale,
        build_scene_bundle,
        scene_bundle,
        scene_env,
    )
    from repro_torch.tree_util import tree_map

    tiny = SceneScale.tiny()
    cpu = build_scene_bundle("chair", tiny, seed=0, device="cpu")
    env = scene_env(tree_map(lambda t: t.to(card), cpu.env.params),
                    cpu.env.dataset, tiny, seed=0, device=card)
    gpu = scene_bundle(env, BatchedQuantEnv(
        env, BatchedEnvConfig(proxy_rays=tiny.proxy_rays, seed=0),
        device=card))
    cfg = ClosedLoopConfig(scenes=("chair",), budget_fracs=(0.8,), seed=7,
                           scale=tiny, n_iterations=2, population=8,
                           verbose=False)
    outs = []
    for bundle, dev in ((cpu, "cpu"), (gpu, card)):
        run = HeroSearchRun(cfg, {"chair": bundle}, device=dev)
        outs.append(run.run_cell(run.cell_specs()[0]))
    want, got = outs
    assert len(got.points) == len(want.points) == 16
    for g, w in zip(got.points, want.points):
        assert g["bits"] == w["bits"]
        assert abs(g["reward"] - w["reward"]) <= 1e-4
        assert abs(g["psnr"] - w["psnr"]) <= 1e-3
        assert abs(g["latency"] - w["latency"]) <= 1e-6 * abs(w["latency"])
        assert g["model_bytes"] == w["model_bytes"]
    assert got.best_bits == want.best_bits


def _tiny_card_bundle(card, seed=0, scene="chair"):
    from repro_torch.core.closed_loop import SceneScale, build_scene_bundle

    return build_scene_bundle(scene, SceneScale.tiny(), seed=seed,
                              device=card)


def test_thread_pool_on_the_card_equals_the_sequential_run(card):
    """Two thread workers run the cells of one tiny bundle at once on the
    card: the frontier, the cells' bits and the gather-composite's launch
    count equal the sequential run's."""
    from repro_torch.core.closed_loop import (
        ClosedLoopConfig,
        HeroSearchRun,
        SceneScale,
    )
    from repro_torch.distributed.orchestrator import run_orchestrated
    from repro_torch.kernels.gather_composite import gather_composite_cuda

    bundles = {"chair": _tiny_card_bundle(card)}
    cfg = ClosedLoopConfig(scenes=("chair",), budget_fracs=(1.0, 0.8, 0.7),
                           seed=7, scale=SceneScale.tiny(), n_iterations=2,
                           population=8, verbose=False)
    n = gather_composite_cuda.launches
    seq = HeroSearchRun(cfg, bundles, device=card).run()
    seq_launches = gather_composite_cuda.launches - n
    n = gather_composite_cuda.launches
    pool = run_orchestrated(HeroSearchRun(cfg, bundles, device=card),
                            workers=2, worker_kind="thread")
    assert gather_composite_cuda.launches - n == seq_launches > 0
    assert CS.same_results(pool, seq)
    assert pool.policies_evaluated == seq.policies_evaluated == 48


def test_sharded_population_on_the_card_equals_the_plain_env(card):
    """`sharded=True` splits over every visible card; its evaluations and
    its fused `policy_latency` simulation equal the plain env's exactly."""
    from repro_torch.core.batched_env import BatchedQuantEnv

    b = _tiny_card_bundle(card)
    split = BatchedQuantEnv(b.env, b.benv.bcfg, sharded=True, device=card)
    assert split.n_shards == torch.cuda.device_count()
    bits = np.random.RandomState(3).randint(1, 9, size=(7, b.env.n_units))
    got, want = split.evaluate_population(bits), b.benv.evaluate_population(
        bits)
    for key in ("psnr", "latency_cycles", "model_bytes", "reward"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    fused, memo = split.simulate_batch(bits), b.benv.simulate_batch(bits)
    assert fused.keys() == memo.keys()
    for key in memo:
        np.testing.assert_array_equal(fused[key], memo[key], err_msg=key)


@pytest.mark.parametrize("arch", ["qwen2-7b", "nemotron-4-340b",
                                  "arctic-480b", "qwen3-moe-235b-a22b"])
def test_lm_loss_under_a_spec_card_against_cpu(card, arch):
    from repro_torch.configs import get_arch
    from repro_torch.models import lm

    cfg = get_arch(arch).smoke
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    p_dev = CS.to_device(p_cpu, card)
    rng = np.random.default_rng(2)
    L = lm.total_layers(cfg)
    bits = (rng.integers(2, 9, cfg.n_embed_bands),
            rng.integers(2, 9, (L, lm.N_GROUPS)),
            rng.integers(2, 9, (L, lm.N_GROUPS)))
    spec = lambda dev: lm.LMQuantSpec(*(torch.tensor(b, dtype=torch.float32,
                                                     device=dev)
                                        for b in bits))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64))).long()
    n = flash_attention_cuda.launches
    with torch.no_grad():
        got, m_dev = lm.loss_fn(p_dev, {"tokens": toks.to(card)}, cfg,
                                spec=spec(card))
        torch.cuda.synchronize()
        want, m_cpu = lm.loss_fn(p_cpu, {"tokens": toks}, cfg,
                                 spec=spec("cpu"))
    assert flash_attention_cuda.launches - n == cfg.n_layers
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert float(m_dev["aux"]) == pytest.approx(float(m_cpu["aux"]),
                                                rel=1e-5, abs=0.0)


def test_lm_bundle_proxy_losses_card_against_cpu(card):
    from repro_torch.workloads.lm import (
        LMBatchedEnv,
        LMQuantEnv,
        LMWorkload,
        lm_bundle,
    )

    b = LMWorkload().build_bundle("qwen2-7b", device=card)
    cpu_env = LMQuantEnv("qwen2-7b", b.env.ecfg, device="cpu",
                         params=CS.to_device(b.env.params, "cpu"))
    cpu = lm_bundle(cpu_env, LMBatchedEnv(cpu_env))
    bits = np.random.RandomState(4).randint(2, 9, size=(6, b.env.n_units))
    np.testing.assert_allclose(b.benv.proxy_losses(b.env.params, bits),
                               cpu.benv.proxy_losses(cpu_env.params, bits),
                               rtol=1e-6)
    assert b.env.base_loss_proxy == pytest.approx(cpu_env.base_loss_proxy,
                                                  rel=1e-6)
    got, want = b.benv.simulate_batch(bits), cpu.benv.simulate_batch(bits)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m",
                                  "whisper-large-v3",
                                  "llava-next-mistral-7b"])
def test_other_block_families_card_against_cpu(card, arch):
    """The smoke config in float32 on the card and the CPU, same weights
    and inputs (whisper's frames short of max_source_len): forward,
    prefill and one decode step within 1e-3, every cache leaf too, and
    the attention launches of a forward and a decode step
    (`chip_smoke.py`'s `item8_smoke_card_vs_cpu`, which raises)."""
    diffs = CS.item8_smoke_card_vs_cpu(card, CS.counters(), arch)
    assert max(diffs.values()) <= 1e-3


# ---------------------------------------------------------------------------
# Kernel 6's backward and the gradient guards
# ---------------------------------------------------------------------------
BWD_CASES = [(1, 1, 1, 37, 37, 16, True), (2, 2, 3, 130, 130, 64, True),
             (2, 4, 7, 100, 100, 128, True), (1, 2, 2, 65, 65, 32, False),
             (2, 3, 1, 20, 1001, 64, False), (1, 2, 7, 129, 64, 128, False),
             # whisper's cross and encoder shapes: a 28-key last tile
             (1, 2, 1, 128, 1500, 64, False),
             (1, 2, 1, 1500, 1500, 64, False),
             # qwen2-7b's grouping: S * G (511, 7,168) off the 64-row tile
             (1, 2, 7, 73, 73, 128, True), (1, 2, 7, 1024, 1024, 128, True),
             # head dims padded to 64 and 128 in shared memory
             (2, 2, 3, 100, 100, 48, True), (1, 2, 2, 90, 200, 96, False)]


@pytest.mark.parametrize("b,hkv,g,sq,sk,hd,causal", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_kernel_close(card, b, hkv, g, sq, sk, hd,
                                               causal, dtype):
    """dq, dk, dv against `flash_attention_bwd_plain` on the forward
    kernel's output and log-sum-exp: the largest error over the largest
    |gradient| within 1e-5 in float32 and 2e-2 in bfloat16, the
    log-sum-exp within 1e-5 of `attention_lse_plain`, and a second call
    bit-equal (no atomics)."""
    from repro_torch.kernels.flash_attention_kernel import (
        attention_lse_plain,
        flash_attention_bwd_cuda,
        flash_attention_bwd_plain,
    )

    gen = torch.Generator(device=card).manual_seed(sq + hd)
    q, k, v, do = CS.bwd_inputs(gen, card, b, hkv, g, hd, sq, sk, dtype)
    lse = torch.empty((b, hkv, sq, g), device=card)
    out = flash_attention_cuda(q, k, v, causal, lse)
    want_lse = attention_lse_plain(q, k, causal)
    assert (lse - want_lse).abs().max().item() <= 1e-5
    got = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal)
    want = flash_attention_bwd_plain(q, k, v, out, want_lse, do, causal)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, w, x in zip(got, want, (q, k, v)):
        assert a.shape == x.shape and a.dtype == dtype
        err = ((a.float() - w.float()).abs().max()
               / w.float().abs().max()).item()
        assert err <= tol
    again = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal)
    assert all(torch.equal(a, x) for a, x in zip(got, again))


def test_flash_attention_backward_bf16_refuses_unaligned_views(card):
    """The backward's tensor-core route copies 16-byte pieces of q, k and
    v rows, as the forward does: a view that starts off a 16-byte boundary
    or has a stride that is not a multiple of 8 elements raises before any
    launch; float32 keeps the CUDA-core route, which takes any strides."""
    from repro_torch.kernels.flash_attention_kernel import (
        flash_attention_bwd_cuda,
        flash_attention_bwd_plain,
    )

    B, S, Hkv, G, hd = 1, 64, 2, 2, 16
    rng = np.random.default_rng(7)
    q, k, v = _model_views(rng, card, B, S, Hkv, G, hd, torch.bfloat16)
    out = torch.zeros((B, Hkv, S, G, hd), device=card)
    lse = torch.zeros((B, Hkv, S, G), device=card)
    do = torch.zeros_like(out)
    flat = torch.zeros(B * S * Hkv * hd + 1, dtype=torch.bfloat16,
                       device=card)
    shifted = flat[1:].view(B, S, Hkv, hd).permute(0, 2, 1, 3)  # 2-byte start
    wide = torch.zeros((B, S, Hkv, hd + 4), dtype=torch.bfloat16, device=card)
    odd = wide[..., :hd].permute(0, 2, 1, 3)  # h-stride 20: not 16 bytes
    n = flash_attention_bwd_cuda.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd_cuda(q, shifted, v, out, lse, do)
    with pytest.raises(ValueError, match="stride"):
        flash_attention_bwd_cuda(q, k, odd, out, lse, do)
    assert flash_attention_bwd_cuda.launches == n
    widef = torch.randn((B, S, Hkv, hd + 3), device=card)
    qf, kf = q.float(), widef[..., :hd].permute(0, 2, 1, 3)  # h-stride 19
    lsef = torch.empty((B, Hkv, S, G), device=card)
    outf = flash_attention_cuda(qf, kf, kf, True, lsef)
    dof = torch.randn((B, Hkv, S, G, hd), device=card)
    got = flash_attention_bwd_cuda(qf, kf, kf, outf, lsef, dof)
    want = flash_attention_bwd_plain(qf, kf, kf, outf, lsef, dof)
    for a, w in zip(got, want):
        assert ((a - w).abs().max() / w.abs().max()).item() <= 1e-5


def test_gradient_flows_through_the_attention_kernels(card):
    """A loss through `ops.flash_attention` and `ops.full_attention` on
    the card: autograd reaches q, k and v through the backward kernel
    (one launch a call), equal to the plain versions' autograd on the
    CPU within 1e-5 of the largest gradient."""
    from repro_torch.kernels.flash_attention_kernel import (
        flash_attention_bwd_cuda,
    )

    rng = np.random.default_rng(7)
    for causal, sk in ((True, 96), (False, 200)):
        q = rng.normal(size=(2, 2, 96, 3, 32)).astype(np.float32)
        k = rng.normal(size=(2, 2, sk, 32)).astype(np.float32)
        v = rng.normal(size=(2, 2, sk, 32)).astype(np.float32)
        grads = []
        for dev in (card, torch.device("cpu")):
            ts = [torch.from_numpy(a).to(dev).requires_grad_(True)
                  for a in (q, k, v)]
            f = (lambda *t: ops.flash_attention(*t, causal=True)) if causal \
                else ops.full_attention
            before = flash_attention_bwd_cuda.launches
            loss = (f(*ts) ** 2).sum()
            grads.append([g.cpu() for g in torch.autograd.grad(loss, ts)])
            if dev == card:
                assert flash_attention_bwd_cuda.launches == before + 1
        for a, w in zip(*grads):
            assert ((a - w).abs().max() / w.abs().max()).item() <= 1e-5


def test_attention_kernels_refuse_a_gradient_they_would_drop(card):
    """`flash_attention_cuda` (the bare forward launch) and the decode
    kernel raise on an input that requires a gradient under grad mode,
    and run under `no_grad`."""
    rng = np.random.default_rng(3)
    q, k, v = _model_views(rng, card, 1, 64, 2, 2, 16, torch.float32)
    qg = q.detach().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_cuda(qg, k, v, True)
    qd = torch.zeros((1, 2, 2, 16), device=card, requires_grad=True)
    kd = torch.zeros((1, 2, 8, 16), device=card)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(qd, kd, kd, 4)
    with torch.no_grad():
        flash_attention_cuda(qg, k, v, True)
        ops.decode_attention(qd, kd, kd, 4)


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen3-moe-235b-a22b",
                                  "whisper-large-v3", "llava-next-mistral-7b",
                                  "jamba-v0.1-52b", "xlstm-350m"])
def test_train_step_card_against_cpu(card, arch):
    """One `make_train_step` step of the smoke config in float32 on the
    card and the CPU (`chip_smoke.py`'s `train_step_card_vs_cpu`, which
    raises): losses and grad norm within 1e-5 relative (MoE and xlstm: as
    `losses_agree` says), parameters within 1e-5 where the gradient
    exceeds 100 eps, kernel 6 and its backward once per attention call."""
    gaps = CS.train_step_card_vs_cpu(card, CS.counters(), arch)
    assert gaps["rel"] <= 1e-3
