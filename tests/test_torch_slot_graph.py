"""A march slot's launches as one CUDA graph (`hero/engine.py`
`SlotGraph`, `FusedDeviceStep._march`).

On the CPU every march slot runs eagerly: `stats()["slot_graphs"]` counts
them and no capture, `hero.slot` spans say how each slot ran, the launch
tally of a capture leaves the counters alone until a replay adds it, and
`level_meta` is made once per (config, device). The graph bookkeeping
(one key a scene, artifact and budget; warm-up, drops on budget growth,
reload and eviction; one pool for every scene's graphs, its bytes charged
to the cache) runs on the CPU too, with a stand-in for the graph that
runs the chain again where the card would replay it.

On the card (`-m cuda`; these skip without one, and the file imports no
JAX, so it runs there with `--noconftest`): an engine whose march slots
capture and replay renders the colours of the same engine with graphs
off, bit for bit, over a short item, a forced budget growth from 128
(which recaptures) and an artifact reload (which drops the old graphs);
every colour also equals eager `slot_march` without a budget, so no
sample was dropped; each replayed slot advances the kernels' `launches`
counters as an eager slot does. A second scene's graph captures into the
first one's pool, which hardly grows.
"""
import copy
import importlib.util
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.hero import engine as teng
from repro_torch.hero.scheduler import EngineConfig
from repro_torch.kernels._launch import add_launches, count_launch, tallied
from repro_torch.nerf.hash_encoding import (
    HashEncodingConfig,
    level_meta,
    level_rows,
)
from repro_torch.nerf.ngp import NGPConfig


def _chip_smoke():
    """`chip_smoke.py`, for its artifact and camera rays."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
CPU = torch.device("cpu")
TINY = NGPConfig(hash=HashEncodingConfig(n_levels=4, log2_table_size=9,
                                         base_resolution=4,
                                         max_resolution=32),
                 hidden_dim=16, color_hidden_dim=16, geo_feat_dim=7,
                 sh_degree=2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tiny_art():
    return CS.build_artifact(TINY, CPU)


def _rays(hw: int, view: int = 0):
    """(rays_o, rays_d) of held-out camera view `view`, hw x hw rays."""
    return CS.request_rays(view + 1, hw, held_out=True)[view]


def _engine(art, device, **over):
    kw = dict(dict(slots=2, slot_rays=64, budget=None), **over)
    return teng.ServeEngine({"chair": art}, EngineConfig(**kw),
                            device=device)


# ---------------------------------------------------------------------------
# The CPU: eager slots, their counts, spans and the launch tally
# ---------------------------------------------------------------------------
def test_level_meta_is_made_once_per_config_and_device():
    hc = HashEncodingConfig(n_levels=3, log2_table_size=7)
    a = level_meta(hc, CPU)
    assert level_meta(hc, torch.empty(1).device) is a
    assert a.dtype == torch.int32
    assert a.tolist() == [list(r) for r in level_rows(hc)]
    other = level_meta(HashEncodingConfig(n_levels=2), CPU)
    assert other is not a and other.shape == (2, 4)


def test_cpu_march_slots_run_eagerly_and_are_counted(tiny_art):
    """Off the card nothing is captured: every march slot is eager, and
    `reset_stats` zeroes the counts."""
    eng = _engine(tiny_art, CPU, pose_cache=False)
    ro, rd = _rays(16)  # 256 rays: 4 items, 2 steps
    eng.render(ro, rd, scene="chair")
    eng.render(ro[:100], rd[:100], scene="chair")  # 2 items, one short
    assert eng.stats()["slot_graphs"] == {"captures": 0, "replays": 0,
                                          "eager": 6, "bytes": 0}
    assert eng._stepper._graphs == {}
    eng.reset_stats()
    assert eng.stats()["slot_graphs"] == {"captures": 0, "replays": 0,
                                          "eager": 0, "bytes": 0}


def test_engine_without_a_fused_stepper_has_no_slot_graphs():
    eng = teng.ServeEngine(None, EngineConfig(),
                           device_step=lambda s, a, ro, rd: ro)
    assert eng.stats()["slot_graphs"] is None


def test_hero_slot_spans_carry_how_the_slot_ran(tiny_art):
    """`graph` is "eager" on the CPU in every tier: three visits of one
    pose give march, march (plans built), hit."""
    eng = _engine(tiny_art, CPU)
    ro, rd = _rays(16)
    with spans.recording() as rec:
        for _ in range(3):
            eng.render(ro, rd, scene="chair")
    slots = [s.attrs for s in rec.spans if s.name == "hero.slot"]
    assert [a["tier"] for a in slots] == ["march"] * 8 + ["hit"] * 4
    assert all(a["graph"] == "eager" for a in slots)


def test_tally_leaves_the_counters_until_a_replay_adds_it():
    def wrapper():
        pass
    wrapper.launches = 0
    with tallied() as tally:
        count_launch(wrapper)
        count_launch(wrapper)
        with pytest.raises(RuntimeError):
            with tallied():
                pass
        # Another thread's launches are its own: counted as they run.
        t = threading.Thread(target=count_launch, args=(wrapper,))
        t.start()
        t.join()
    assert tally == {wrapper: 2} and wrapper.launches == 1
    count_launch(wrapper)
    assert wrapper.launches == 2 and tally == {wrapper: 2}
    for _ in range(3):
        add_launches(tally)
    assert wrapper.launches == 8


# ---------------------------------------------------------------------------
# The graph bookkeeping on the CPU, with a stand-in for the graph
# ---------------------------------------------------------------------------
class ReplayByRunning:
    """`SlotGraph`'s protocol off the card: the "capture" runs the chain
    once under a tally, and each "replay" runs it again; `shared` is a
    token that stands for the pool."""

    NBYTES = 1000

    @staticmethod
    def shared(device):
        return object()

    def __init__(self, run, artifact, device, shared):
        self.artifact, self.run, self.nbytes = artifact, run, self.NBYTES
        self.pool = shared
        with tallied() as self.launches:
            run()

    def replay(self):
        out = self.run()
        add_launches(self.launches)
        return out


@pytest.fixture
def graphed(monkeypatch):
    """An engine maker whose stepper takes the graph path on the CPU."""
    monkeypatch.setattr(teng, "SlotGraph", ReplayByRunning)

    def make(art, **over):
        eng = _engine(art, CPU, pose_cache=False, **over)
        eng._stepper._graphed = True
        return eng
    return make


def _counts(eng):
    st = eng.stats()["slot_graphs"]
    return st["captures"], st["replays"], st["eager"]


def test_first_slot_at_a_key_warms_the_next_captures_then_replays(
        tiny_art, graphed):
    eng = graphed(tiny_art)
    plain = _engine(tiny_art, CPU, pose_cache=False)
    ro, rd = _rays(16)
    base = eng.stats()["cache"]["resident_bytes"]
    with spans.recording() as rec:
        first = eng.render(ro, rd, scene="chair")  # 2 steps of 2 slots
    assert _counts(eng) == (1, 2, 1)
    assert [s.attrs["graph"] for s in rec.spans if s.name == "hero.slot"] \
        == ["eager", "capture", "replay", "replay"]
    again = eng.render(ro, rd, scene="chair")
    assert _counts(eng) == (1, 6, 1)
    short = eng.render(ro[:70], rd[:70], scene="chair")  # padded 2nd item
    assert _counts(eng) == (1, 8, 1)
    want = plain.render(ro, rd, scene="chair")
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(again, want)
    np.testing.assert_array_equal(
        short, plain.render(ro[:70], rd[:70], scene="chair"))
    st = eng.stats()
    assert st["slot_graphs"]["bytes"] == ReplayByRunning.NBYTES
    assert st["cache"]["resident_bytes"] == base + ReplayByRunning.NBYTES
    assert list(eng._stepper._graphs) == [("chair", id(tiny_art), None)]
    eng.reset_stats()
    assert _counts(eng) == (0, 0, 0)
    assert eng.stats()["slot_graphs"]["bytes"] == ReplayByRunning.NBYTES


def test_budget_growth_drops_the_scenes_graphs_and_warms_again(
        tiny_art, graphed):
    """From a budget of 128 the first slot overflows: it grows and
    renders again at the new key, eagerly. Rays shifted off the box need
    few samples; centred ones need more, so the budget grows again and
    the graphs of the old budget go. The colours equal an engine with no
    budget throughout (nothing dropped)."""
    eng = graphed(tiny_art, budget=128)
    plain = _engine(tiny_art, CPU, pose_cache=False)
    stepper = eng._stepper
    ro, rd = _rays(16)
    far = (ro + np.float32(0.8), rd)

    def render(o, d):
        got = eng.render(o, d, scene="chair")
        np.testing.assert_array_equal(got,
                                      plain.render(o, d, scene="chair"))

    def captured():
        return sorted(k[2] for k, g in stepper._graphs.items()
                      if g is not None)

    for _ in range(3):
        render(*far)
    b_far = eng.budget_of("chair")
    assert eng.retraces >= 1 and b_far > 128
    assert captured() == [b_far]
    for v in range(4):
        render(*_rays(16, v))
    b = eng.budget_of("chair")
    assert b > b_far and {k[2] for k in stepper._graphs} == {b}
    for _ in range(2):
        render(ro, rd)
    assert captured() == [b]
    with spans.recording() as rec:
        eng.render(ro, rd, scene="chair")
    assert [s.attrs["graph"] for s in rec.spans if s.name == "hero.slot"] \
        == ["replay"] * 4


def test_reload_and_eviction_drop_the_scenes_graphs(tiny_art, graphed):
    eng = graphed(tiny_art)
    ro, rd = _rays(16)
    for _ in range(2):
        eng.render(ro, rd, scene="chair")
    stepper = eng._stepper
    assert stepper.graph_bytes() == ReplayByRunning.NBYTES
    # A reload: another artifact object for the scene. Its old graph was
    # the last, so the pool went with it and the new graph has its own.
    pool = stepper._graphs[("chair", id(tiny_art), None)].pool
    art2 = copy.copy(tiny_art)
    eng._cache.add("chair", art2)
    eng.render(ro, rd, scene="chair")
    assert list(stepper._graphs) == [("chair", id(art2), None)]
    assert stepper._graphs[("chair", id(art2), None)].pool is not pool
    assert stepper.graph_bytes() == ReplayByRunning.NBYTES
    # The new artifact warmed up, then captured; nothing of the old one.
    assert _counts(eng) == (2, 8, 2)
    # Eviction's hook drops them.
    stepper.drop_scene_plans("chair")
    assert stepper._graphs == {} and stepper.graph_bytes() == 0
    assert eng.stats()["slot_graphs"]["bytes"] == 0


def test_scenes_share_one_pool_until_the_last_graph_goes(tiny_art, graphed):
    """Two scenes' graphs capture into one pool; the pool's bytes are
    charged once, stay while any graph lives and go with the last."""
    art2 = copy.copy(tiny_art)
    eng = teng.ServeEngine({"chair": tiny_art, "lego": art2},
                           EngineConfig(slots=2, slot_rays=64, budget=None,
                                        pose_cache=False), device=CPU)
    stepper = eng._stepper
    stepper._graphed = True
    base = eng.stats()["cache"]["resident_bytes"]
    ro, rd = _rays(16)
    for scene in ("chair", "lego"):
        eng.render(ro, rd, scene=scene)
    graphs = stepper._graphs
    assert sorted(k[0] for k in graphs) == ["chair", "lego"]
    pools = {g.pool for g in graphs.values()}
    assert len(pools) == 1 and pools == {stepper._shared}
    st = eng.stats()
    assert st["slot_graphs"]["bytes"] == 2 * ReplayByRunning.NBYTES
    assert st["cache"]["resident_bytes"] == base + 2 * ReplayByRunning.NBYTES
    stepper.drop_scene_plans("chair")
    assert list(graphs) == [("lego", id(art2), None)]
    assert stepper.graph_bytes() == 2 * ReplayByRunning.NBYTES
    stepper.drop_scene_plans("lego")
    assert stepper._shared is None and stepper.graph_bytes() == 0


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_slot_graphs_on_the_card_keep_the_bits_and_the_launch_counts(card):
    """A paper-width field (random weights) through two engines, graphs
    on and off, over the same requests: colours bit-equal, and equal to
    eager `slot_march` without a budget; captures after warm-up, replays
    after that, a recapture after the budget grows, the old artifact's
    graphs gone after a reload; a replayed slot launches the march, the
    encode, five packed matmuls and the composite, as an eager one does."""
    from repro_torch.configs.ngp import paper
    from repro_torch.kernels.gather_composite import gather_composite_cuda
    from repro_torch.kernels.hash_encode import hash_encode_points_cuda
    from repro_torch.kernels.quant_matmul import quant_matmul_packed_cuda
    from repro_torch.kernels.ray_march import ray_march_cuda
    from repro_torch.nerf.fast_render import slot_march

    wrappers = (ray_march_cuda, hash_encode_points_cuda,
                quant_matmul_packed_cuda, gather_composite_cuda)
    cfg = paper()
    art = CS.build_artifact(cfg, card)
    R = 4096
    kw = dict(slots=4, slot_rays=R, budget=128, pose_cache=False)
    eng = teng.ServeEngine({"chair": art}, EngineConfig(**kw), device=card)
    ref = teng.ServeEngine({"chair": art}, EngineConfig(**kw), device=card)
    assert eng._stepper._graphed
    ref._stepper._graphed = False
    rcfg = teng.dataclasses.replace(art.rcfg, stratified=False)

    def unbudgeted(ro, rd):
        """Eager `slot_march` of each item without a budget."""
        out = []
        for s in range(0, ro.shape[0], R):
            o = torch.from_numpy(np.ascontiguousarray(ro[s:s + R])).to(card)
            d = torch.from_numpy(np.ascontiguousarray(rd[s:s + R])).to(card)
            out.append(slot_march(art.params, art.pack, art.spec(), art.occ,
                                  o, d, cfg, rcfg, "fused", None,
                                  True)[0].cpu().numpy())
        return np.concatenate(out)

    def both(ro, rd):
        """Render on both engines; the graphed engine's colours, its
        slots' `graph` attrs, and each engine's launches by wrapper."""
        n0 = [w.launches for w in wrappers]
        with spans.recording() as rec:
            got = eng.render(ro, rd, scene="chair")
        n1 = [w.launches for w in wrappers]
        want = ref.render(ro, rd, scene="chair")
        n2 = [w.launches for w in wrappers]
        np.testing.assert_array_equal(got, want)
        hows = [s.attrs["graph"] for s in rec.spans if s.name == "hero.slot"]
        return (got, hows, [b - a for a, b in zip(n0, n1)],
                [b - a for a, b in zip(n1, n2)])

    # Frames whose items fill the slots (128 x 128 = 4 items) and one
    # with a short item (3 x 4,096 + 1,000 rays). Rays shifted off the box
    # need few samples (at most 12,893 a slot: the budget settles below
    # 19,456), centred ones up to 56,652 (the field's occupancy is full,
    # so these counts are geometry's alone).
    views = [_rays(128, v) for v in range(3)]
    far = (views[0][0] + np.float32(0.8), views[0][1])
    short = (views[1][0][:3 * R + 1000], views[1][1][:3 * R + 1000])
    got, _, _, _ = both(*far)
    np.testing.assert_array_equal(got, unbudgeted(*far))
    assert eng.retraces >= 1  # grown from 128
    b_far = eng.budget_of("chair")
    assert b_far == ref.budget_of("chair")

    def captured():
        return sorted(k[1:] for k, g in eng._stepper._graphs.items()
                      if g is not None)

    order = {"eager": 0, "capture": 1, "replay": 2}

    def settle(o, d):
        """Render three times: the slots go from eager (warm-up) to one
        capture to replays, never back, and the last render replays
        every slot. Returns the last render."""
        seen = []
        for _ in range(3):
            last = both(o, d)
            seen += last[1]
        runs = [order[h] for h in seen]
        assert runs == sorted(runs) and runs.count(1) <= 1, seen
        assert seen[-4:] == ["replay"] * 4
        return last

    _, _, n_eng, n_ref = settle(*far)
    assert n_eng == n_ref == [4, 4, 20, 4]  # 1, 1, 5 and 1 a slot
    assert captured() == [(id(art), b_far)]
    st = eng.stats()["slot_graphs"]
    assert st["captures"] >= 1 and st["bytes"] > 0
    assert ref.stats()["slot_graphs"]["captures"] == 0
    assert eng.stats()["cache"]["resident_bytes"] \
        == ref.stats()["cache"]["resident_bytes"] + st["bytes"]

    # Centred views need more: the budget grows, the graphs at the old
    # budget go, and the slots warm up and capture again at the new one.
    for o, d in views:
        got, _, _, _ = both(o, d)
        np.testing.assert_array_equal(got, unbudgeted(o, d))
    b = eng.budget_of("chair")
    assert b > b_far
    settle(*views[0])
    assert captured() == [(id(art), b)]
    got, hows, n_eng, n_ref = both(*short)
    assert hows == ["replay"] * 4 and n_eng == n_ref == [4, 4, 20, 4]
    np.testing.assert_array_equal(got, unbudgeted(*short))

    # A reload: the old artifact's graphs go before the next step renders.
    art2 = copy.copy(art)
    for e in (eng, ref):
        e._cache.add("chair", art2)
    _, hows, _, _ = both(*views[0])
    assert hows == ["eager", "capture", "replay", "replay"]
    assert captured() == [(id(art2), b)]
    eng._stepper.drop_scene_plans("chair")
    assert eng._stepper.graph_bytes() == 0


@pytest.mark.cuda
def test_two_scenes_share_one_graph_pool_on_the_card(card):
    """One engine, two scenes: the second scene's graph captures into the
    first one's pool, which grows by at most an eighth (the graph's
    outputs), and the pool's bytes are charged once to `resident_bytes`.
    Both scenes' colours equal an engine with graphs off, bit for bit."""
    from repro_torch.configs.ngp import paper

    art = CS.build_artifact(paper(), card)
    arts = {"chair": art, "lego": copy.copy(art)}
    kw = dict(slots=4, slot_rays=4096, budget=None, pose_cache=False)
    eng = teng.ServeEngine(arts, EngineConfig(**kw), device=card)
    ref = teng.ServeEngine(arts, EngineConfig(**kw), device=card)
    ref._stepper._graphed = False
    ro, rd = _rays(128)  # 4 items: eager, capture, replay, replay
    pool = []
    for scene in arts:
        for _ in range(2):
            np.testing.assert_array_equal(eng.render(ro, rd, scene=scene),
                                          ref.render(ro, rd, scene=scene))
        pool.append(eng.stats()["slot_graphs"]["bytes"])
    st = eng.stats()
    print(f"pool bytes after one scene {pool[0]}, after two {pool[1]}")
    assert st["slot_graphs"] == {"captures": 2, "replays": 12, "eager": 2,
                                 "bytes": pool[1]}
    assert 0 < pool[0] and pool[1] - pool[0] <= pool[0] // 8
    assert st["cache"]["resident_bytes"] \
        == ref.stats()["cache"]["resident_bytes"] + pool[1]
    eng._stepper.drop_scene_plans("chair")
    assert eng._stepper.graph_bytes() == pool[1]
    eng._stepper.drop_scene_plans("lego")
    assert eng._stepper.graph_bytes() == 0
