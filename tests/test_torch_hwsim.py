"""The cost half of the reward: the port's NeuRex simulator against the JAX
package's on the same rays and policies (numpy arrays carried across).

- the trace (corner indices, entries, subgrid ids, layer dims) exactly;
- the direct-mapped cache statistics exactly: the port's torch form and
  numpy host form against the reference's numpy walk, its jnp form (both
  of its branches: the fused int32 key and the stable argsort) and the
  sequential oracle, and on a trace whose coarse addresses pass int32,
  where the reference's on-device form refuses (`vmappable()` is None)
  and the port's int64 form stays exact;
- the batched simulator at K = 32 against the reference's float64 numpy
  oracle (misses exact, cycles within 1e-3) and against its batched f32
  path (within 1e-6 relative, `model_bytes` exact);
- the scalar simulator and the four NeRF hardware targets."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.hwsim as jh
from repro.hero import targets as jtg
from repro.hwsim import cache as jc
from repro.hwsim import systolic as jsys
from repro.nerf import hash_encoding as jhe
from repro.nerf import ngp as jngp
from repro.nerf import render as jr
from repro_torch import hwsim as th
from repro_torch.convert import trace_from_numpy
from repro_torch.hero import targets as ttg
from repro_torch.hwsim import batched as thb
from repro_torch.hwsim import cache as tc
from repro_torch.hwsim import systolic as tsys
from repro_torch.nerf import hash_encoding as the
from repro_torch.nerf import ngp as tngp
from repro_torch.nerf import render as tr

HASH = dict(n_levels=4, log2_table_size=9, base_resolution=4,
            max_resolution=32)
MLP = dict(hidden_dim=16, color_hidden_dim=16, geo_feat_dim=7, sh_degree=2)
J_CFG = jngp.NGPConfig(hash=jhe.HashEncodingConfig(**HASH), **MLP)
T_CFG = tngp.NGPConfig(hash=the.HashEncodingConfig(**HASH), **MLP)
# Two coarse levels through the grid cache, two fine through the subgrid
# buffer; the 8 KB cache overflows at 8-bit entries.
J_HW, T_HW = jh.HWConfig(coarse_levels=2), th.HWConfig(coarse_levels=2)
ORACLE_RTOL = 1e-3
F32_RTOL = 1e-6
FLOAT_KEYS = ("lookup_cycles", "grid_miss_cycles", "subgrid_prefetch_cycles",
              "encode_cycles", "mlp_compute_cycles", "total_cycles",
              "cycles_per_ray", "dram_bytes", "grid_accesses",
              "grid_hit_rate")
INT_KEYS = ("grid_hits", "grid_misses", "grid_cold_misses")


def _rays(n: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    ro = rng.randn(n, 3).astype(np.float32) * 0.1
    rd = rng.randn(n, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


@pytest.fixture(scope="module")
def traces():
    """(reference trace, port trace) of the same 48 rays of 8 samples."""
    ro, rd = _rays(48)
    return (jh.build_trace(J_CFG, jr.RenderConfig(n_samples=8), ro, rd),
            th.build_trace(T_CFG, tr.RenderConfig(n_samples=8), ro, rd,
                           device="cpu"))


@pytest.fixture(scope="module")
def policies():
    """32 random integer policies (hash, weight, activation bits)."""
    rng = np.random.RandomState(7)
    K, n_mlp = 32, 5
    return (rng.randint(1, 9, (K, HASH["n_levels"])).astype(np.float32),
            rng.randint(1, 9, (K, n_mlp)).astype(np.float32),
            rng.randint(1, 9, (K, n_mlp)).astype(np.float32))


def _stats(cs):
    return (cs.accesses, cs.hits, cs.misses, cs.cold_misses)


def _assert_traces_equal(a, b):
    assert len(a.level_indices) == len(b.level_indices)
    for x, y in zip(a.level_indices, b.level_indices):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.subgrid_ids, b.subgrid_ids)
    assert a.subgrid_ids.dtype == b.subgrid_ids.dtype
    assert list(a.level_entries) == list(b.level_entries)
    assert [tuple(d) for d in a.mlp_dims] == [tuple(d) for d in b.mlp_dims]
    assert list(a.mlp_names) == list(b.mlp_names)
    assert (a.n_rays, a.n_samples) == (b.n_rays, b.n_samples)


@pytest.mark.parametrize("log2_table_size,subgrid", [(9, 4), (6, 2)])
def test_trace_equals_reference(log2_table_size, subgrid):
    """At T = 2^9 the finest level is hashed; at 2^6 all but the coarsest
    two are, so both index formulas are held to the reference's."""
    h = dict(HASH, log2_table_size=log2_table_size)
    jcfg = jngp.NGPConfig(hash=jhe.HashEncodingConfig(**h), **MLP)
    tcfg = tngp.NGPConfig(hash=the.HashEncodingConfig(**h), **MLP)
    ro, rd = _rays(96, seed=3)
    want = jh.build_trace(jcfg, jr.RenderConfig(n_samples=16), ro, rd,
                          subgrid_resolution=subgrid)
    got = th.build_trace(tcfg, tr.RenderConfig(n_samples=16), ro, rd,
                         subgrid_resolution=subgrid, device="cpu")
    _assert_traces_equal(got, want)
    assert not all(tcfg.hash.is_direct(l) for l in range(4))
    _assert_traces_equal(trace_from_numpy(want), want)


def _stream(seed: int, n: int, span: int, reuse: float):
    """Byte addresses with temporal reuse: a share `reuse` of accesses
    repeat one of the last 64."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, span, size=n).astype(np.int64)
    rep = rng.rand(n) < reuse
    back = rng.randint(1, 65, size=n)
    for i in np.nonzero(rep)[0]:
        if i >= back[i]:
            a[i] = a[i - back[i]]
    return a


# (seed, accesses, address span, reuse, cache lines, line bytes): the
# first three take the reference jnp form's fused int32 key
# (n_lines * (n + 1) < 2^31), the last two its stable-argsort branch.
STREAMS = [
    (0, 4096, 1 << 16, 0.3, 128, 64),
    (1, 20000, 1 << 20, 0.6, 16, 32),
    (2, 1, 1 << 10, 0.0, 4, 16),
    (3, 4096, 1 << 30, 0.5, 1 << 20, 64),
    (4, 9000, 1 << 24, 0.2, 1 << 18, 8),
]


@pytest.mark.parametrize("seed,n,span,reuse,n_lines,line_bytes", STREAMS)
def test_cache_stats_equal_reference_and_sequential_oracle(
        seed, n, span, reuse, n_lines, line_bytes):
    a = _stream(seed, n, span, reuse)
    fused_key = n_lines * (n + 1) < 2**31
    assert fused_key == (seed < 3)
    want = jc.simulate_direct_mapped(a, n_lines, line_bytes)
    seq = jc.DirectMappedCache(n_lines, line_bytes).run(a)
    jnp_form = [int(v) for v in jc.direct_mapped_stats(
        jnp.asarray(a, jnp.int32), n_lines, line_bytes)]
    host = tc.simulate_direct_mapped(a, n_lines, line_bytes)
    dev = [int(v) for v in tc.direct_mapped_stats(torch.from_numpy(a),
                                                  n_lines, line_bytes)]
    port_seq = tc.DirectMappedCache(n_lines, line_bytes).run(a)
    triple = (want.hits, want.misses, want.cold_misses)
    assert (seq.hits, seq.misses, seq.cold_misses) == triple
    assert tuple(jnp_form) == triple
    assert (host.hits, host.misses, host.cold_misses) == triple
    assert host.accesses == want.accesses == n
    assert tuple(dev) == triple
    assert (port_seq.hits, port_seq.misses, port_seq.cold_misses) == triple
    if n > 1:
        assert 0 < want.hits < n  # the stream exercises hits and misses


def test_device_form_batches_over_leading_axes():
    """(2, 3, N) streams -> (2, 3) statistics, each equal to its walk."""
    streams = np.stack([_stream(s, 2048, 1 << 14, 0.4) for s in range(6)])
    hits, misses, cold = tc.direct_mapped_stats(
        torch.from_numpy(streams.reshape(2, 3, -1)), 32, 64)
    assert hits.shape == misses.shape == cold.shape == (2, 3)
    for i, a in enumerate(streams):
        st = tc.simulate_direct_mapped(a, 32, 64)
        assert (int(hits.reshape(-1)[i]), int(misses.reshape(-1)[i]),
                int(cold.reshape(-1)[i])) == (st.hits, st.misses,
                                              st.cold_misses)


def _wide_trace(module, entries: int):
    """A trace of 2 coarse levels of `entries` entries each: 8-bit entries
    of 2 features span 2 * entries bytes a level, so at 2^28 entries the
    coarse span * 8 passes 2^31."""
    rng = np.random.RandomState(5)
    P = 512
    return module.NGPTrace(
        n_rays=64, n_samples=8,
        level_indices=[rng.randint(0, entries, P * 8).astype(np.int32)
                       for _ in range(3)],
        level_entries=[entries, entries, 4096],
        subgrid_ids=rng.randint(0, 64, P).astype(np.int64),
        mlp_dims=[(6, 16), (16, 8), (11, 16), (16, 16), (16, 3)],
        mlp_names=["sigma/0", "sigma/1", "color/0", "color/1", "color/2"],
    )


def test_trace_past_int32_stays_exact_where_the_reference_refuses():
    """The reference's on-device form works in int32 and refuses this trace
    (`vmappable()` is None); the port's int64 device form is exact on it,
    equal to its host form and to the reference's float64 oracle."""
    jt = _wide_trace(jh.trace, 1 << 28)
    t = trace_from_numpy(jt)
    jb = jh.BatchedNeuRexSimulator(jt, J_HW, n_features=2)
    assert jb.vmappable() is None
    rng = np.random.RandomState(1)
    hb = rng.randint(1, 9, (6, 3)).astype(np.float32)
    wb = rng.randint(1, 9, (6, 5)).astype(np.float32)
    ab = rng.randint(1, 9, (6, 5)).astype(np.float32)
    tcon = thb.build_trace_constants(t, T_HW, 2)
    eb8 = torch.from_numpy(np.round(hb[:, :2] * 2).astype(np.int64))
    hits, misses, cold = thb.grid_cache_stats(eb8, tcon, T_HW)
    fused = th.BatchedNeuRexSimulator(t, T_HW, device="cpu").vmappable()(
        torch.from_numpy(hb), torch.from_numpy(wb), torch.from_numpy(ab))
    oracle = jh.NeuRexSimulator(J_HW, backend="numpy")
    for i in range(6):
        want = oracle.simulate(jt, hb[i], wb[i], ab[i]).grid_cache
        assert thb.grid_cache_stats_host(eb8[i].numpy(), tcon, T_HW) == (
            want.hits, want.misses, want.cold_misses)
        assert (int(hits[i]), int(misses[i]), int(cold[i])) == (
            want.hits, want.misses, want.cold_misses)
        assert int(fused["grid_misses"][i]) == want.misses


def test_batched_simulator_matches_the_numpy_oracle(traces, policies):
    """K = 32 in one call against the reference's float64 oracle, policy by
    policy: the cache statistics exactly, every cycle term within 1e-3,
    `model_bytes` exactly. The port's own numpy oracle equals the
    reference's term for term."""
    jt, t = traces
    hb, wb, ab = policies
    got = th.BatchedNeuRexSimulator(t, T_HW, device="cpu").simulate_batch(
        hb, wb, ab)
    oracle = jh.NeuRexSimulator(J_HW, backend="numpy")
    port_oracle = th.NeuRexSimulator(T_HW, backend="numpy")
    for i in range(hb.shape[0]):
        want = oracle.simulate(jt, hb[i], wb[i], ab[i])
        assert port_oracle.simulate(t, hb[i], wb[i], ab[i]).as_dict() \
            == want.as_dict()
        st = want.grid_cache
        assert (int(got["grid_hits"][i]), int(got["grid_misses"][i]),
                int(got["grid_cold_misses"][i])) == (st.hits, st.misses,
                                                     st.cold_misses)
        assert float(got["model_bytes"][i]) == want.model_bytes
        for key in ("lookup_cycles", "grid_miss_cycles",
                    "subgrid_prefetch_cycles", "encode_cycles",
                    "mlp_compute_cycles", "total_cycles", "cycles_per_ray",
                    "dram_bytes"):
            assert float(got[key][i]) == pytest.approx(
                getattr(want, key), rel=ORACLE_RTOL), (i, key)
        assert float(got["grid_hit_rate"][i]) == pytest.approx(
            st.hit_rate, rel=ORACLE_RTOL)
    assert 0 < int(got["grid_misses"].min())


def _assert_metrics_match(got, want):
    for key in FLOAT_KEYS:
        np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                   np.asarray(want[key], np.float64),
                                   rtol=F32_RTOL, err_msg=key)
    for key in INT_KEYS:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
    np.testing.assert_array_equal(np.asarray(got["model_bytes"], np.float64),
                                  np.asarray(want["model_bytes"], np.float64))


def test_batched_simulator_matches_the_reference_batched_path(traces,
                                                              policies):
    """Against the reference's f32 batched path: every metric within 1e-6
    relative, the integer statistics and `model_bytes` exactly; the pure
    per-policy function (`vmappable()`) and its K-batched form agree."""
    jt, t = traces
    hb, wb, ab = policies
    want = jh.BatchedNeuRexSimulator(jt, J_HW).simulate_batch(hb, wb, ab)
    sim = th.BatchedNeuRexSimulator(t, T_HW, device="cpu")
    _assert_metrics_match(sim.simulate_batch(hb, wb, ab), want)
    fn = sim.vmappable()
    batch = fn(torch.from_numpy(hb), torch.from_numpy(wb),
               torch.from_numpy(ab))
    _assert_metrics_match({k: v.numpy() for k, v in batch.items()}, want)
    one = fn(torch.from_numpy(hb[3]), torch.from_numpy(wb[3]),
             torch.from_numpy(ab[3]))
    assert int(one["grid_misses"]) == int(want["grid_misses"][3])
    assert float(one["total_cycles"]) == pytest.approx(
        float(want["total_cycles"][3]), rel=F32_RTOL)


def test_stats_memo_dedups_coarse_combos(traces):
    """Policies sharing coarse-level bits share one cache simulation, and
    a cleared memo recomputes the same statistics."""
    _, t = traces
    sim = th.BatchedNeuRexSimulator(t, T_HW, device="cpu")
    K = 10
    hb = np.full((K, 4), 8.0, np.float32)
    hb[:, 2:] = np.random.RandomState(0).randint(1, 9, (K, 2))
    wb = np.full((K, 5), 8.0, np.float32)
    first = sim.simulate_batch(hb, wb, wb)
    assert sim.cache_stats_memo_size() == 1
    sim.clear_stats_memo()
    again = sim.simulate_batch(hb, wb, wb)
    np.testing.assert_array_equal(first["grid_misses"], again["grid_misses"])
    assert sim.cache_stats_memo_size() == 1


@pytest.mark.parametrize("mode", ["stripes", "max"])
def test_mlp_cycles_match_reference(mode):
    dims = [(32, 64), (64, 16), (40, 64), (64, 64), (64, 3)]
    rng = np.random.RandomState(2)
    wb = rng.randint(1, 9, (6, 5)).astype(np.float32)
    ab = rng.randint(1, 9, (6, 5)).astype(np.float32)
    jcfg, tcfg = jh.HWConfig(serial_mode=mode), th.HWConfig(serial_mode=mode)
    got = tsys.mlp_cycles_torch(32768, dims, torch.from_numpy(wb),
                                torch.from_numpy(ab), tcfg).numpy()
    for i in range(6):
        want = float(jsys.mlp_cycles_jnp(32768, dims, jnp.asarray(wb[i]),
                                         jnp.asarray(ab[i]), jcfg))
        assert float(got[i]) == pytest.approx(want, rel=F32_RTOL)
        exact, _ = jsys.mlp_cycles(32768, dims, wb[i], ab[i], jcfg)
        assert tsys.mlp_cycles(32768, dims, wb[i], ab[i], tcfg)[0] == exact


def test_scalar_simulator_matches_reference(traces, policies):
    """The scalar API (the batched path underneath) against the reference's
    default scalar simulator, breakdown by breakdown."""
    jt, t = traces
    hb, wb, ab = policies
    jsim = jh.NeuRexSimulator(J_HW)
    tsim = th.NeuRexSimulator(T_HW, device="cpu")
    assert tsim.backend == "torch"
    for i in range(4):
        want = jsim.simulate(jt, hb[i], wb[i], ab[i])
        got = tsim.simulate(t, hb[i], wb[i], ab[i])
        assert _stats(got.grid_cache) == _stats(want.grid_cache)
        assert got.model_bytes == want.model_bytes
        for k, v in want.as_dict().items():
            assert got.as_dict()[k] == pytest.approx(v, rel=F32_RTOL), k
    base = tsim.baseline(t, 8, n_features=2)
    want = jsim.baseline(jt, 8, n_features=2)
    assert base.total_cycles == pytest.approx(want.total_cycles,
                                              rel=F32_RTOL)
    assert _stats(base.grid_cache) == _stats(want.grid_cache)


NERF_TARGETS = ["neurex", "neurex-edge", "neurex-cloud", "roofline-edge"]


@pytest.mark.parametrize("name", NERF_TARGETS)
def test_targets_match_reference(name, policies):
    """Each NeRF target by name (with the cross-family `coarse_levels`
    knob every call site passes): its workload, scalar `simulate`,
    `baseline` and `batched` evaluator against the reference target's."""
    jtarget = jtg.make_target(name, coarse_levels=2)
    ttarget = ttg.make_target(name, coarse_levels=2, device="cpu")
    ro, rd = _rays(40, seed=9)
    jw = jtarget.build_workload(J_CFG, jr.RenderConfig(n_samples=8), ro, rd)
    tw = ttarget.build_workload(T_CFG, tr.RenderConfig(n_samples=8), ro, rd)
    _assert_traces_equal(tw, jw)
    hb, wb, ab = policies
    for i in range(3):
        want = jtarget.simulate(jw, hb[i], wb[i], ab[i])
        got = ttarget.simulate(tw, hb[i], wb[i], ab[i])
        assert _stats(got.grid_cache) == _stats(want.grid_cache)
        assert got.model_bytes == want.model_bytes
        for k, v in want.as_dict().items():
            assert got.as_dict()[k] == pytest.approx(v, rel=F32_RTOL), k
    b_want, b_got = jtarget.baseline(jw, 8), ttarget.baseline(tw, 8)
    assert b_got.total_cycles == pytest.approx(b_want.total_cycles,
                                               rel=F32_RTOL)
    want = jtarget.batched(jw).simulate_batch(hb, wb, ab)
    got = ttarget.batched(tw).simulate_batch(hb, wb, ab)
    _assert_metrics_match(got, {k: np.asarray(v) for k, v in want.items()})
    desc = ttarget.describe()
    assert desc["name"] == name and desc["device"] == "cpu"
    assert desc["config"] == jtarget.describe()["config"]


def test_registry_lists_the_nerf_targets_and_refuses_roofline_lm():
    """All five of the reference's targets are registered (the four NeRF
    ones and `roofline-lm`, since the LM workload); an unknown name is
    refused."""
    assert sorted(ttg.list_targets()) == sorted(NERF_TARGETS
                                                + ["roofline-lm"])
    assert sorted(ttg.list_targets()) == sorted(jtg.list_targets())
    assert isinstance(ttg.make_target("roofline-lm", device="cpu"),
                      ttg.LMRooflineTarget)
    with pytest.raises(KeyError, match="unknown hardware target"):
        ttg.make_target("tpu", device="cpu")
    with pytest.raises(TypeError):
        ttg.make_target("neurex", grid_cache_kbytes=4, device="cpu")
    target = ttg.make_target("neurex-edge", device="cpu")
    assert ttg.resolve_target(target) is target
    assert isinstance(target, ttg.HardwareTarget)
    assert ttg.resolve_target(None, device="cpu").name == "neurex"
