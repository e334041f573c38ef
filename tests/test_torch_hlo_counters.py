"""The port's step counters against the reference's HLO counters.

`repro_torch.distributed.hlo_counters` records one step at one rank as it
runs (a `TorchDispatchMode` over aten ops and collectives) where the
reference walks compiled HLO (`repro.distributed.hlo_counters`). Held
here:

- the dot FLOPs of one train step (one microbatch of 2 x 64 tokens,
  f32 moments) of every smoke config, on the plain route at one device,
  equal the reference's loop-aware count of its compiled step, exactly,
  but for two stated closed forms: jamba's Mamba contracts hs (B, S,
  d_inner, n) with C over n, and the gradient of hs is an outer product,
  a product with K = 1 here (a `bmm`) and an elementwise multiply there
  (2 B S d_inner n a Mamba layer more here); xlstm's sLSTM starts from a
  zero state that needs no gradient, so the port's autograd skips the
  first position's recurrent product dh, which the reference's scan
  computes every iteration (2 B H dh 4dh an sLSTM layer less here);
- on tensors without data (the card's route), kernel 6 and its backward
  count their cost from `kernels/cost.py` once a call, and the plain
  attention's products are never recorded;
- the collectives' link bytes and counts of the reference's
  `test_counters_collective_model` (an all-gather, an all-reduce and a
  permute of f32[128, 128] over groups of 4 of 8 ranks), issued over a
  fake process group, equal the reference's, by `analyze` and by
  `hlo_analysis.parse_collectives`;
- `RooflineTerms` and `roofline_terms` equal the reference's under the
  same explicit chip;
- the trip-count stand-ins of the three time loops (the sLSTM's
  positions, the mLSTM's query chunks, the Mamba scan's chunks) equal
  the fully traced loops: FLOPs, bytes and each op's calls exactly, the
  peak of live bytes within 1 %, with and without the period's
  rematerialisation (forward, recompute and backward).
"""
import contextlib
import dataclasses

import pytest
import torch

ARCHS = ("qwen3-moe-235b-a22b", "arctic-480b", "llama3-405b", "qwen2-7b",
         "granite-34b", "nemotron-4-340b", "llava-next-mistral-7b",
         "whisper-large-v3", "jamba-v0.1-52b", "xlstm-350m")
B, S = 2, 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny shapes gain nothing from more, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_dot_flops(arch: str) -> float:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch
    from repro.distributed.hlo_counters import analyze
    from repro.launch.steps import make_train_step
    from repro.models import lm
    from repro.optim import AdamWConfig, adamw_init

    cfg = get_arch(arch).smoke
    params = lm.param_specs(cfg)
    opt = jax.eval_shape(lambda p: adamw_init(p, "f32"), params)
    batch = {"tokens": jax.ShapeDtypeStruct((1, B, S), jnp.int32)}
    dt = jnp.dtype(cfg.dtype)
    if cfg.embed_frontend == "prefix_patches":
        batch["patches"] = jax.ShapeDtypeStruct(
            (1, B, cfg.n_prefix_patches, cfg.d_model), dt)
    if cfg.embed_frontend == "stub_frames":
        batch["frames"] = jax.ShapeDtypeStruct(
            (1, B, cfg.max_source_len, cfg.d_model), dt)
    step = make_train_step(cfg, AdamWConfig(lr=1e-4, weight_decay=0.1))
    hlo = jax.jit(step).lower(params, opt, batch).compile().as_text()
    return analyze(hlo, 1).dot_flops


def _step_trace(cfg, kernels="ops", A=1, fake=False):
    """The recorded one-device train step of `cfg` over A microbatches of
    B x S tokens (zeros), f32 moments; on tensors without data where
    `fake`."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.hlo_counters import Recorder
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init

    with FakeTensorMode() if fake else contextlib.nullcontext():
        params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        opt = adamw_init(params, "float32")
        batch = {"tokens": torch.zeros((A, B, S), dtype=torch.int32)}
        if cfg.embed_frontend == "prefix_patches":
            batch["patches"] = torch.zeros(
                (A, B, cfg.n_prefix_patches, cfg.d_model),
                dtype=cfg.param_dtype)
        if cfg.embed_frontend == "stub_frames":
            batch["frames"] = torch.zeros(
                (A, B, cfg.max_source_len, cfg.d_model),
                dtype=cfg.param_dtype)
        step = make_train_step(cfg, AdamWConfig(lr=1e-4, weight_decay=0.1),
                               moment_dtype="float32")
        with Recorder(kernels=kernels) as rec:
            rec.hold((params, opt, batch))
            step(params, opt, batch)
    return rec.trace


def _closed_form(cfg) -> float:
    """The port's dot FLOPs less the reference's (see the docstring)."""
    from repro_torch.models.common import layer_kind
    from repro_torch.models.ssm import ssm_dims

    kinds = [layer_kind(cfg, l) for l in range(cfg.n_layers)]
    din, _, n = ssm_dims(cfg)
    H, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    return (kinds.count("mamba") * 2.0 * B * S * din * n
            - kinds.count("slstm") * 2.0 * B * H * dh * 4 * dh)


@pytest.mark.parametrize("arch", ARCHS)
def test_dot_flops_equal_the_reference_counter(arch):
    from repro_torch.configs import get_arch
    from repro_torch.distributed.hlo_counters import analyze

    cfg = get_arch(arch).smoke
    got = analyze(_step_trace(cfg)).dot_flops
    want = _reference_dot_flops(arch)
    assert got == want + _closed_form(cfg)
    if arch == "qwen2-7b":
        assert got == 113_246_208
    if arch not in ("jamba-v0.1-52b", "xlstm-350m"):
        assert _closed_form(cfg) == 0


def test_kernel_6_counts_its_cost_on_the_cards_route():
    from repro_torch.configs import get_arch
    from repro_torch.kernels import cost

    cfg = get_arch("qwen2-7b").smoke
    trace = _step_trace(cfg, kernels="cost", fake=True)
    Hkv, G, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    fwd = cost.flash_attention(B, Hkv, G, hd, S, S, True, 4, lse=True)
    bwd = cost.flash_attention_bwd(B, Hkv, G, hd, S, S, True, 4)
    recs = {r.op: r for r in trace.records if r.kind == "kernel"}
    # kernel 6 once a layer forward and once again in each period's
    # recompute (remat), its backward once a layer
    n_fwd, n_bwd = trace.calls("kernel.flash_attention"), \
        trace.calls("kernel.flash_attention_bwd")
    assert (n_fwd, n_bwd) == (2 * cfg.n_layers, cfg.n_layers)
    agg = trace.aggregate()
    f = agg[("kernel.flash_attention", "kernel", 1)]
    b = agg[("kernel.flash_attention_bwd", "kernel", 1)]
    assert f[1] == n_fwd * fwd.ops and f[3] == n_fwd * fwd.bytes
    assert b[1] == n_bwd * bwd.ops and b[3] == n_bwd * bwd.bytes
    assert set(recs) == {"kernel.flash_attention",
                         "kernel.flash_attention_bwd"}
    # the plain version's (B, Hkv, S, G, S) scores are never recorded
    assert trace.calls("aten.bmm") == 0


_HLO = """
HloModule test

ENTRY %main (p: f32[128,128]) -> f32[128,128] {
  %p = f32[128,128]{1,0} parameter(0)
  %ag = f32[128,128]{1,0} all-gather(%p), replica_groups=[2,4]<=[8], dimensions={0}
  %ar = f32[128,128]{1,0} all-reduce(%ag), replica_groups=[2,4]<=[8], to_apply=%add
  ROOT %cp = f32[128,128]{1,0} collective-permute(%ar), source_target_pairs={{0,1}}
}
"""


def test_collective_link_bytes_equal_the_reference():
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro.distributed.hlo_counters import analyze as ref_analyze
    from repro_torch.distributed.hlo_analysis import (
        op_census,
        parse_collectives,
    )
    from repro_torch.distributed.hlo_counters import Recorder, analyze
    from repro_torch.launch.mesh import fake_mesh

    with fake_mesh((2, 4), ("a", "b")) as mesh, FakeTensorMode():
        g = mesh.group("b")
        block = torch.empty((32, 128))
        whole = torch.empty((128, 128))
        with Recorder() as rec:
            dist.all_gather_into_tensor(whole, block, group=g)
            dist.all_reduce(whole, group=g)
            dist.broadcast(whole, src=0, group=g)
    assert not dist.is_initialized()
    got, want = analyze(rec.trace, 8), ref_analyze(_HLO, 8)
    assert got.coll_bytes == want.coll_bytes
    assert got.coll_counts == want.coll_counts
    assert got.link_bytes == want.link_bytes
    # (the reference's own `parse_collectives` skips a ROOT line, so its
    # loop-aware counter is the one to hold against)
    stats = parse_collectives(rec.trace, 8)
    assert (stats.counts, stats.bytes_by_kind, stats.wire_bytes) == \
        (want.coll_counts, want.coll_bytes, want.link_bytes)
    assert [n for _, _, n in stats.details] == [4, 4, 4]
    assert op_census(rec.trace) == {}  # no aten op ran


def test_roofline_terms_equal_the_reference():
    from repro.distributed import hlo_analysis as ref
    from repro_torch.distributed import hlo_analysis as port

    kw = dict(name="x", peak_flops_bf16=123e12, hbm_bw=2.5e12, ici_bw=75e9,
              hbm_bytes=40e9)
    assert [f.name for f in dataclasses.fields(port.ChipSpec)] == \
        [f.name for f in dataclasses.fields(ref.ChipSpec)]
    terms = dict(compute_s=0.3, memory_s=0.7, collective_s=0.2,
                 hlo_flops=5e15, hlo_bytes=2e13, collective_bytes=9e10,
                 model_flops=3e15)
    a, b = port.RooflineTerms(**terms), ref.RooflineTerms(**terms)
    assert a.as_dict() == b.as_dict() and a.step_time_s == b.step_time_s
    stats = dict(counts={"all-gather": 3}, bytes_by_kind={"all-gather": 4e9},
                 wire_bytes=4e9, details=[("all-gather", 4e9, 16)])
    cost = {"flops": 8e15, "bytes accessed": 6e13}
    for flag in (True, False):
        x = port.roofline_terms(cost, port.CollectiveStats(**stats), 256,
                                port.ChipSpec(**kw), 2e15, flag)
        y = ref.roofline_terms(cost, ref.CollectiveStats(**stats), 256,
                               ref.ChipSpec(**kw), 2e15, flag)
        assert x.as_dict() == y.as_dict()
    h100 = port.ChipSpec()
    assert (h100.peak_flops_bf16, h100.hbm_bw, h100.hbm_bytes) == \
        (989e12, 3.35e12, 80e9)


def _mixer(name: str):
    """(config, parameters requiring gradients, the mixer's forward, the
    sequence length) at a short length with more iterations than the
    stand-in measures (sLSTM 12 positions, mLSTM 6 query chunks of 8,
    Mamba 6 chunks of 128)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import xlstm_blocks as xl

    arch, init, fwd, seq = {
        "slstm": ("xlstm-350m", xl.init_slstm, xl.slstm_forward, 12),
        "mlstm": ("xlstm-350m", xl.init_mlstm, xl.mlstm_forward, 48),
        "mamba": ("jamba-v0.1-52b", ssm_mod.init_ssm, ssm_mod.ssm_forward,
                  768)}[name]
    cfg = dataclasses.replace(get_arch(arch).smoke, attn_chunk=8)
    params = {k: v.requires_grad_(True) for k, v in
              init(torch.Generator().manual_seed(0), cfg).items()}
    return cfg, params, (lambda p, x: fwd(p, x, cfg)), seq


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", ["slstm", "mlstm", "mamba"])
def test_trip_counted_loops_equal_the_full_loops(name, remat):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.checkpoint import checkpoint

    from repro_torch.distributed.hlo_counters import Recorder, analyze

    mode = FakeTensorMode()
    with mode:
        cfg, params, fwd, seq = _mixer(name)
    traces = []
    for loops in (False, True):
        with mode:
            x0 = torch.empty((2, seq, cfg.d_model), requires_grad=True)
            with Recorder(loops=loops) as rec:
                rec.hold((params, x0))
                x = x0 * 1.0
                y = checkpoint(fwd, params, x, use_reentrant=False) \
                    if remat else fwd(params, x)
                torch.autograd.grad(y.sum(), [x0, *params.values()])
        traces.append(rec.trace)
    full, standin = traces
    assert full.aggregate() == standin.aggregate()
    a, b = analyze(full), analyze(standin)
    assert (a.flops, a.bytes, a.dot_flops) == (b.flops, b.bytes, b.dot_flops)
    assert abs(standin.peak_bytes / full.peak_bytes - 1.0) <= 0.01
    # the stand-in stood in: its records are sums of calls
    assert any(r.calls > 1 for r in standin.records)
    assert not any(r.calls > 1 for r in full.records)


def test_the_recorder_follows_live_bytes():
    from repro_torch.distributed.hlo_counters import Recorder

    a = torch.zeros(1000)
    with Recorder() as rec:
        rec.hold(a)
        b = a * 2.0
        c = b.view(10, 100)
        del b
        d = c + 1.0
        peak_then = rec.peak_bytes
        del c, d
        live = rec.live_bytes
    assert rec.trace.held_bytes == 4000
    assert rec.trace.peak_bytes == peak_then == 12000
    assert live == 4000
