"""Serving parity: a schema-v2 `QuantArtifact` written by the JAX package
is loaded, re-saved and served by the port on the CPU.

Held to: manifests (sha256s included) equal to the reference's; a
schema-v1 directory upgraded to schema 2 with the v2 colours; served
frames within PSNR >= 60 dB of the reference service on the same rays (a
1-ulp difference can flip a rare activation code); sample budgets and
active counts exact; march == scatter byte for byte inside the port; the
pose-cache tiers (miss, build, hit, warp) and their plan bytes step for
step with the reference engine's, hit == warp == march == no pose cache
byte for byte; the reference's scheduler traces reproduced exactly
by the port's engine through the same fake clock and fake device; and
the engine's spans (a `hero.sync` at each device read), which leave all
of that unchanged."""
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.hero import artifact as jart
from repro.hero import engine as jeng
from repro.hero import scheduler as jsched
from repro.hero import service as jsvc
from repro.nerf import fast_render as jfr
from repro.nerf import hash_encoding as jhe
from repro.nerf import ngp as jngp
from repro.nerf import occupancy as jocc
from repro.nerf import scenes as jscenes
from repro.nerf.render import RenderConfig as JRenderConfig
from repro.quant.policy import QuantPolicy, UnitKind
from repro_torch import spans
from repro_torch.hero import artifact as tart
from repro_torch.hero import engine as teng
from repro_torch.hero import scheduler as tsched
from repro_torch.hero import service as tsvc
from repro_torch.nerf import fast_render as tfr
from repro_torch.nerf import occupancy as tocc
from repro_torch.nerf import scenes as tscenes

CFG = jngp.NGPConfig(
    hash=jhe.HashEncodingConfig(n_levels=4, log2_table_size=9,
                                base_resolution=4, max_resolution=32),
    hidden_dim=16, color_hidden_dim=16, geo_feat_dim=7, sh_degree=2,
)
RCFG = JRenderConfig(n_samples=12)
SLOT_RAYS = 64


def _psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
    return float("inf") if mse == 0 else -10.0 * np.log10(mse)


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    """A tiny artifact written by the JAX package: init, calibrate, pack a
    mixed int policy, bake the occupancy, save."""
    params = jngp.init_ngp(jax.random.PRNGKey(0), CFG)
    params["hash"] = {k: v * 1e3 for k, v in params["hash"].items()}
    rng = np.random.RandomState(0)
    pts = jnp.asarray(rng.uniform(size=(256, 3)).astype(np.float32))
    dirs = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (256, 1))
    _, _, taps = jngp.ngp_apply(params, pts, dirs, CFG, return_taps=True)
    ranges = jnp.asarray(
        [[float(jnp.min(taps[n])), float(jnp.max(taps[n]))]
         for n in jngp.ngp_linear_names(CFG)], jnp.float32)
    units = jngp.make_quant_units(CFG)
    kind_bits = {UnitKind.HASH_LEVEL: 6, UnitKind.WEIGHT: 4,
                 UnitKind.ACTIVATION: 8}
    bits = [kind_bits[u.kind] for u in units]
    spec = jngp.spec_from_policy(
        CFG, QuantPolicy.uniform(units, 8).with_bits(bits), ranges)
    occ = jocc.bake_occupancy(params, CFG, resolution=8, threshold=1.0,
                              supersample=1, dilate=0)
    assert 0.0 < occ.occupied_fraction < 1.0
    art = jart.QuantArtifact(
        scene="chair", bits=bits, cfg=CFG, rcfg=RCFG,
        scene_cfg={"name": "chair", "image_hw": 16}, params=params,
        act_ranges=ranges, pack=jfr.build_fused_pack(params, CFG, spec),
        occ=occ, hardware={"name": "neurex-edge"},
        metrics={"psnr": 31.5, "model_bytes": 1234.0})
    path = tmp_path_factory.mktemp("ref") / "art"
    art.save(path)
    return path


@pytest.fixture(scope="module")
def request_rays():
    sc = jscenes.SceneConfig(image_hw=16, n_train_views=3)
    train, _ = jscenes.camera_poses(sc)
    out = []
    for c2w in train:
        ro, rd = tscenes.camera_rays(c2w, 16, sc.focal_mult * 16)
        jro, jrd = jscenes.camera_rays(jnp.asarray(c2w), 16, sc.focal_mult * 16)
        np.testing.assert_allclose(ro.numpy(), np.asarray(jro), atol=1e-6)
        np.testing.assert_allclose(rd.numpy(), np.asarray(jrd), atol=1e-6)
        out.append((np.asarray(jro), np.asarray(jrd)))
    return out


# ---------------------------------------------------------------------------
# The artifact crosses over
# ---------------------------------------------------------------------------
def test_port_loads_and_resaves_identical_manifest(ref_dir, tmp_path):
    art = tart.QuantArtifact.load(ref_dir, device="cpu")
    assert art.pack.layout == "tile:128"
    assert art.pack.modes == ("int",) * 5
    art.save(tmp_path / "port")
    want = json.loads((ref_dir / "manifest.json").read_text())
    got = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert got == want
    with np.load(ref_dir / "arrays.npz") as a, \
            np.load(tmp_path / "port" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    ref = jart.QuantArtifact.load(ref_dir)
    assert art.stored_model_bytes() == ref.stored_model_bytes()
    assert art.resident_bytes() == ref.resident_bytes()
    assert art.cache_key() == ref.cache_key()
    # A port-written directory loads in the JAX package, too.
    back = jart.QuantArtifact.load(tmp_path / "port")
    assert back.stored_model_bytes() == ref.stored_model_bytes()


def _write_v1_dir(artifact, path):
    """Materialize the legacy schema-1 layout (int8 weight codes + f32
    w_deq carrier + float-carrier hash tables) from a v2 artifact of the
    JAX package, with a valid v1 manifest: a copy of the helper of
    `tests/test_hero_api.py`."""
    from repro.hero.artifact import _SEP, _sha
    from repro.quant.packing import PackedTensor

    arrays = {"act_ranges": np.asarray(artifact.act_ranges)}
    for top, sub in artifact.params.items():
        for k, v in sub.items():
            arrays[f"params{_SEP}{top}{_SEP}{k}"] = np.asarray(v)
    for name, lyr in artifact.pack.layers.items():
        for k, v in lyr.items():
            if isinstance(v, PackedTensor):
                arrays[f"pack{_SEP}{name}{_SEP}w_codes"] = np.clip(
                    np.asarray(v.codes()), -128, 127
                ).astype(np.int8)
                arrays[f"pack{_SEP}{name}{_SEP}w_deq"] = np.asarray(
                    v.dequantize()
                )
                arrays[f"pack{_SEP}{name}{_SEP}sw"] = np.asarray(v.scale)
            else:
                arrays[f"pack{_SEP}{name}{_SEP}{k}"] = np.asarray(v)
    for name, t in artifact.pack.hash_tables.items():
        tt = t.dequantize() if isinstance(t, PackedTensor) else t
        arrays[f"packtab{_SEP}{name}"] = np.asarray(tt)
    arrays["occ"] = np.asarray(artifact.occ.occ)

    manifest = {
        "schema_version": 1,
        "scene": artifact.scene,
        "bits": [int(b) for b in artifact.bits],
        "cfg": dataclasses.asdict(artifact.cfg),
        "rcfg": dataclasses.asdict(artifact.rcfg),
        "scene_cfg": artifact.scene_cfg,
        "pack_modes": list(artifact.pack.modes),
        "occ": {
            "resolution": artifact.occ.resolution,
            "threshold": artifact.occ.threshold,
            "occupied_fraction": artifact.occ.occupied_fraction,
        },
        "hardware": artifact.hardware,
        "metrics": artifact.metrics,
        "arrays": {
            k: {"shape": list(v.shape), "dtype": str(v.dtype),
                "sha256": _sha(v)}
            for k, v in arrays.items()
        },
    }
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "arrays.npz", "wb") as f:
        np.savez(f, **arrays)
    (path / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return path


def test_bad_sha256_and_v1_refuse(ref_dir, tmp_path):
    """A corrupted array refuses by its sha256, in a v2 directory and in a
    v1 one: integrity is checked before the v1 upgrade."""
    bad = tmp_path / "bad"
    shutil.copytree(ref_dir, bad)
    man = json.loads((bad / "manifest.json").read_text())
    man["arrays"]["occ"]["sha256"] = "0" * 16
    (bad / "manifest.json").write_text(json.dumps(man))
    with pytest.raises(ValueError, match="sha256"):
        tart.QuantArtifact.load(bad, device="cpu")
    v1 = _write_v1_dir(jart.QuantArtifact.load(ref_dir), tmp_path / "v1")
    man = json.loads((v1 / "manifest.json").read_text())
    man["arrays"]["occ"]["sha256"] = "0" * 16
    (v1 / "manifest.json").write_text(json.dumps(man))
    with pytest.raises(ValueError, match="sha256"):
        tart.QuantArtifact.load(v1, device="cpu")


def test_v1_directory_upgrades_to_schema_2_and_serves_the_v2_colours(
        ref_dir, request_rays, tmp_path):
    """A v1 directory loads as schema 2, re-packed from its params into the
    words the v2 directory stores, with `model_bytes` re-measured; it
    serves the v2 load's colours byte for byte and re-saves as v2."""
    v1 = _write_v1_dir(jart.QuantArtifact.load(ref_dir), tmp_path / "v1")
    up = tart.QuantArtifact.load(v1, device="cpu")
    v2 = tart.QuantArtifact.load(ref_dir, device="cpu")
    assert up.schema_version == 2
    assert up.metrics["model_bytes"] == up.stored_model_bytes() \
        == v2.stored_model_bytes()
    want = jart.QuantArtifact.load(v1)
    assert up.metrics == want.metrics
    assert up.pack.modes == v2.pack.modes
    for name, lyr in v2.pack.layers.items():
        assert torch.equal(up.pack.layers[name]["wq"].words, lyr["wq"].words)
    frames = []
    for art in (up, v2):
        svc = tsvc.RenderService(art, tsvc.ServeConfig(slot_rays=SLOT_RAYS),
                                 device="cpu")
        frames.append([svc.render(ro, rd) for ro, rd in request_rays])
    for a, b in zip(*frames):
        np.testing.assert_array_equal(a, b)
    up.save(tmp_path / "resaved")
    man = json.loads((tmp_path / "resaved" / "manifest.json").read_text())
    assert man["schema_version"] == 2


# ---------------------------------------------------------------------------
# Served frames
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def served(ref_dir, request_rays):
    jsv = jsvc.RenderService(jart.QuantArtifact.load(ref_dir),
                             jsvc.ServeConfig(slot_rays=SLOT_RAYS))
    tsv = tsvc.RenderService(tart.QuantArtifact.load(ref_dir, device="cpu"),
                             tsvc.ServeConfig(slot_rays=SLOT_RAYS),
                             device="cpu")
    out = []
    for svc in (jsv, tsv):
        rids = [svc.submit(ro, rd) for ro, rd in request_rays]
        svc.drain()
        out.append(([svc.result(r) for r in rids], svc.stats()))
    return out


def test_service_frames_match_reference_psnr(served, request_rays):
    (j_frames, j_stats), (t_frames, t_stats) = served
    for jf, tf, (ro, _) in zip(j_frames, t_frames, request_rays):
        assert tf.shape == jf.shape == (ro.shape[0], 3)
        assert np.isfinite(tf).all()
        assert _psnr(tf, jf) >= 60.0
    assert t_stats["sample_budget"] == j_stats["sample_budget"]
    assert t_stats["budget_retraces"] == j_stats["budget_retraces"]
    for k in ("requests_completed", "items_rendered", "rays_rendered",
              "device_steps"):
        assert t_stats[k] == j_stats[k]


def test_slot_active_counts_and_colors_match_reference(ref_dir,
                                                       request_rays):
    ja = jart.QuantArtifact.load(ref_dir)
    ta = tart.QuantArtifact.load(ref_dir, device="cpu")
    ro, rd = request_rays[0]
    for s in range(0, ro.shape[0], SLOT_RAYS):
        o, d = ro[s:s + SLOT_RAYS], rd[s:s + SLOT_RAYS]
        j_col, j_need = jfr._slot_march_impl(
            ja.params, ja.pack, ja.spec(), ja.occ, jnp.asarray(o),
            jnp.asarray(d), cfg=ja.cfg, rcfg=ja.rcfg, mode="fused",
            budget=SLOT_RAYS * RCFG.n_samples, use_pallas=False,
            early_stop=True)
        t_col, t_need = tfr.slot_march(
            ta.params, ta.pack, ta.spec(), ta.occ, torch.tensor(o),
            torch.tensor(d), ta.cfg, ta.rcfg, "fused",
            SLOT_RAYS * RCFG.n_samples, True)
        host, _ = tocc.sample_active_mask(ta.occ, o, d, ta.rcfg)
        assert int(t_need) == int(j_need) == int(host.sum())
        assert _psnr(t_col.numpy(), np.asarray(j_col)) >= 60.0
    jb = jocc.cull_budget(ja.occ, ro, rd, RCFG, SLOT_RAYS)
    assert tocc.cull_budget(ta.occ, ro, rd, ta.rcfg, SLOT_RAYS) == jb


def test_march_equals_scatter_byte_for_byte(ref_dir, request_rays):
    ta = tart.QuantArtifact.load(ref_dir, device="cpu")
    ro, rd = (torch.tensor(a[:SLOT_RAYS]) for a in request_rays[1])
    host, _ = tocc.sample_active_mask(ta.occ, ro.numpy(), rd.numpy(), ta.rcfg)
    need = int(host.sum())
    assert need > 0
    # A budget that covers every sample, and one that overflows.
    for budget in (None, max(1, need // 2)):
        out = [tfr.fast_render_rays(ta.params, ro, rd, ta.cfg, ta.rcfg,
                                    ta.spec(), ta.occ, "fused", ta.pack,
                                    budget, compaction=c)[0]
               for c in ("march", "scatter")]
        assert torch.equal(out[0], out[1])


def test_engine_render_frame_matches_reference(ref_dir, request_rays):
    ja = jart.QuantArtifact.load(ref_dir)
    ta = tart.QuantArtifact.load(ref_dir, device="cpu")
    ro, rd = request_rays[2]
    want = np.asarray(ja.engine(chunk=128).render_frame(ro, rd))
    got = ta.engine(chunk=128).render_frame(ro, rd).numpy()
    assert _psnr(got, want) >= 60.0


# ---------------------------------------------------------------------------
# The pose-cache tiers: hit / warp / march, against the reference engine
# ---------------------------------------------------------------------------
def _view(i: int):
    """(rays_o, rays_d) numpy of held-out camera view `i` of four (16x16
    rays: 4 items at slot_rays=64), the reference's camera rays (both
    engines get the same floats)."""
    sc = jscenes.SceneConfig(image_hw=16, n_test_views=4)
    _, test = jscenes.camera_poses(sc)
    ro, rd = jscenes.camera_rays(jnp.asarray(test[i]), 16,
                                 sc.focal_mult * 16)
    return np.asarray(ro).reshape(-1, 3), np.asarray(rd).reshape(-1, 3)


def _tier_engines(ref_dir, **over):
    """(port engine, reference engine, port engine without the pose
    cache) over the same artifact directory."""
    kw = dict(slots=4, slot_rays=SLOT_RAYS, **over)
    ta = tart.QuantArtifact.load(ref_dir, device="cpu")
    ja = jart.QuantArtifact.load(ref_dir)
    return (teng.ServeEngine({ta.scene: ta}, tsched.EngineConfig(**kw),
                             device="cpu"),
            jeng.ServeEngine({ja.scene: ja}, jsched.EngineConfig(**kw)),
            teng.ServeEngine({ta.scene: ta}, tsched.EngineConfig(
                pose_cache=False, **kw), device="cpu"))


def test_engine_tiers_follow_the_reference_and_keep_the_bits(ref_dir):
    """One pose revisited: miss -> miss + build -> hit, then in-cell
    jitter -> warp. `pose_stats()` equals the reference engine's after
    every request; hit, warp and march colours equal the engine without
    the pose cache byte for byte."""
    assert tsched.EngineConfig().pose_cache is True
    eng, ref, plain = _tier_engines(ref_dir)
    ro, rd = _view(0)
    occ = tart.QuantArtifact.load(ref_dir, device="cpu").occ
    assert tocc.sample_active_mask(occ, ro, rd, RCFG)[0].sum() > 50

    def visit(o, d):
        got = eng.render(o, d, scene="chair")
        ref.render(o, d, scene="chair")
        st = eng.stats()["pose_cache"]
        assert st == ref.stats()["pose_cache"]
        assert eng.stats()["cache"]["resident_bytes"] \
            == ref.stats()["cache"]["resident_bytes"]
        return got, st

    want = plain.render(ro, rd, scene="chair")
    march, st = visit(ro, rd)
    assert (st["misses"], st["builds"], st["cells"]) == (4, 0, 1)
    again, st = visit(ro, rd)
    assert (st["builds"], st["hits"]) == (4, 0) and st["bytes"] > 0
    hit, st = visit(ro, rd)
    assert (st["hits"], st["builds"]) == (4, 4)
    for got in (march, again, hit):
        np.testing.assert_array_equal(got, want)
    assert plain.stats()["pose_cache"] is None

    stepper = eng._stepper
    key0 = stepper.pose_key("chair", ro, rd)
    warped = None
    for eps in (1e-4, -1e-4, 5e-5, -5e-5):
        ro_j = ro + np.float32(eps)
        if stepper.pose_key("chair", ro_j, rd) != key0:
            continue
        before = stepper.pose_stats()["warps"]
        got, st = visit(ro_j, rd)
        if st["warps"] > before:
            warped = (ro_j, got)
            break
    assert warped is not None, "no jitter landed in the warp tier"
    ro_j, warp = warped
    assert st["warps"] == 4
    np.testing.assert_array_equal(warp, plain.render(ro_j, rd, scene="chair"))


def test_engine_plan_bytes_charged_to_resident(ref_dir):
    eng, ref, _ = _tier_engines(ref_dir)
    ro, rd = _view(1)
    base = eng.stats()["cache"]["resident_bytes"]
    for _ in range(2):  # the second visit bakes the plans
        eng.render(ro, rd, scene="chair")
        ref.render(ro, rd, scene="chair")
    st = eng.stats()
    assert st["pose_cache"]["bytes"] > 0
    assert st["pose_cache"]["bytes"] == eng._stepper.plan_bytes() \
        == ref.stats()["pose_cache"]["bytes"]
    assert st["cache"]["resident_bytes"] == base + st["pose_cache"]["bytes"]


def test_engine_fresh_poses_build_nothing_and_scatter_has_no_tiers(ref_dir):
    eng, ref, _ = _tier_engines(ref_dir)
    for i in range(4):
        for e in (eng, ref):
            e.render(*_view(i), scene="chair")
    st = eng.stats()["pose_cache"]
    assert st == ref.stats()["pose_cache"]
    assert st["builds"] == 0 and st["bytes"] == 0 and st["hits"] == 0
    assert st["cells"] == 4 and st["misses"] == 16
    scatter, _, _ = _tier_engines(ref_dir, compaction="scatter")
    scatter.render(*_view(2), scene="chair")
    assert scatter.stats()["pose_cache"] is None


# ---------------------------------------------------------------------------
# The scheduler: reference traces through the fake clock and fake device
# ---------------------------------------------------------------------------
class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeArtifact:
    def __init__(self, scene, nbytes=100):
        self.scene, self._nbytes = scene, nbytes

    def resident_bytes(self):
        return self._nbytes


class FakeDevice:
    def __init__(self, clock, cost):
        self.clock, self.cost, self.calls = clock, cost, []

    def __call__(self, scene, artifact, ro, rd):
        self.calls.append((scene, ro.shape))
        self.clock.t += self.cost
        return ro * 2.0 + 1.0


def _rays(rng, n):
    return (rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            rng.uniform(-1, 1, (n, 3)).astype(np.float32))


def _sc_batching(eng, clk, rng):
    rids = [eng.submit(*_rays(rng, n), scene="a") for n in (6, 4, 9)]
    eng.drain()
    return rids


def _sc_multi_scene(eng, clk, rng):
    rids = []
    for scene, n in [("A", 8), ("B", 8), ("A", 4), ("C", 5), ("B", 3)]:
        rids.append(eng.submit(*_rays(rng, n), scene=scene))
        clk.t += 1.0
    eng.drain()
    return rids


def _sc_lru(eng, clk, rng):
    rids = []
    for scene in "abcac":
        rids.append(eng.submit(*_rays(rng, 4), scene=scene))
        eng.drain()
    return rids


def _sc_deadlines(eng, clk, rng):
    r0 = eng.submit(*_rays(rng, 12), scene="a", deadline=2.5)
    r1 = eng.submit(*_rays(rng, 4), scene="a")
    r2 = eng.submit(*_rays(rng, 8), scene="a", deadline=100.0)
    eng.drain()
    return [r0, r1, r2]


def _sc_admission(eng, clk, rng):
    rids = [eng.submit(*_rays(rng, 8), scene="a")]
    try:
        eng.submit(*_rays(rng, 12), scene="a")
    except (jsched.AdmissionFull, tsched.AdmissionFull) as e:
        rids.append(type(e).__name__)
    rids.append(eng.submit(*_rays(rng, 4), scene="a"))
    eng.step()
    clk.t += 0.5
    eng.drain()
    return rids


def _sc_streaming(eng, clk, rng):
    rid = eng.submit(*_rays(rng, 11), scene="a")
    spans = []
    while eng.step():
        spans.append([(s, e, c.tolist()) for s, e, c in eng.poll(rid)])
    return [rid, spans]


SCENARIOS = {
    "batching": (_sc_batching, ("a",), dict(slots=3, slot_rays=4)),
    "multi_scene": (_sc_multi_scene, ("A", "B", "C"),
                    dict(slots=2, slot_rays=4)),
    "lru": (_sc_lru, (), dict(slots=1, slot_rays=4, cache_bytes=250)),
    "deadlines": (_sc_deadlines, ("a",), dict(slots=1, slot_rays=4)),
    "admission": (_sc_admission, ("a",), dict(slots=2, slot_rays=4,
                                              max_pending=3)),
    "streaming": (_sc_streaming, ("a",), dict(slots=1, slot_rays=4)),
}


def _run(scenario, engine_mod, sched_mod):
    fn, scenes, kw = SCENARIOS[scenario]
    clk = FakeClock()
    dev = FakeDevice(clk, cost=1.0)
    cfg = sched_mod.EngineConfig(trace_events=4096, **kw)
    loader = (lambda s: FakeArtifact(s)) if not scenes else None
    eng = engine_mod.ServeEngine(
        {s: FakeArtifact(s) for s in scenes} or None, cfg, loader=loader,
        clock=clk, device_step=dev)
    rids = fn(eng, clk, np.random.RandomState(7))
    results = {}
    for r in rids:
        if isinstance(r, int):
            try:
                results[r] = eng.result(r).tolist()
            except Exception as e:  # expired / already freed
                results[r] = type(e).__name__
    stats = eng.stats()
    stats.pop("pose_cache", None)
    return eng.events, dev.calls, rids, results, stats


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_scheduler_traces_equal_reference(scenario):
    want = _run(scenario, jeng, jsched)
    got = _run(scenario, teng, tsched)
    assert got == want
    assert want[0]  # the scenario produced events


# ---------------------------------------------------------------------------
# The engine's spans (`repro_torch.spans`)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_recording_leaves_traces_and_stats_alone(scenario):
    """An open recording changes nothing the engine does: events, device
    calls, results and `stats()` equal a run without one."""
    want = _run(scenario, teng, tsched)
    with spans.recording() as rec:
        got = _run(scenario, teng, tsched)
    assert got == want
    assert any(s.name == "hero.step" for s in rec.spans)


def test_engine_span_tree_and_queue_ages_on_the_fake_clock():
    clk = FakeClock()
    dev = FakeDevice(clk, cost=1.0)
    eng = teng.ServeEngine({"a": FakeArtifact("a")},
                           tsched.EngineConfig(slots=2, slot_rays=4),
                           clock=clk, device_step=dev)
    rng = np.random.RandomState(3)
    with spans.recording() as rec:
        r0 = eng.submit(*_rays(rng, 6), scene="a")
        clk.t += 1.0
        r1 = eng.submit(*_rays(rng, 4), scene="a")
        clk.t += 0.5
        eng.drain()
    tree = [(s.name, s.parent, s.attrs) for s in rec.spans]
    step1 = {"scene": "a", "items": ((r0, 0, 1.5), (r0, 1, 1.5))}
    step2 = {"scene": "a", "items": ((r1, 0, 1.5),)}  # taken at 2.5
    assert tree == [
        ("hero.submit", -1, {"rid": r0, "n_items": 2}),
        ("hero.submit.pose_key", 0, {}),
        ("hero.submit", -1, {"rid": r1, "n_items": 1}),
        ("hero.submit.pose_key", 2, {}),
        ("hero.step", -1, step1),
        ("hero.step.pack", 4, {}),
        ("hero.step.scatter", 4, {}),
        ("hero.step", -1, step2),
        ("hero.step.pack", 7, {}),
        ("hero.step.scatter", 7, {}),
        ("hero.step", -1, {}),  # the idle step that ends the drain
    ]
    # A fake device makes no device reads: no `hero.sync`.
    assert eng.result(r0).shape == (6, 3) and eng.result(r1).shape == (4, 3)


def test_fused_step_reads_the_device_twice_a_march_slot(ref_dir):
    """A real `FusedDeviceStep` on the CPU: each march slot reads its
    active count and its colours (two `hero.sync`s under its `hero.slot`);
    a hit slot reads its colours only."""
    eng, _, _ = _tier_engines(ref_dir)
    ro, rd = _view(3)
    plain = eng.render(ro, rd, scene="chair")  # one visit: no plans yet
    with spans.recording() as rec:
        got = eng.render(ro, rd, scene="chair")  # misses, builds plans
    np.testing.assert_array_equal(got, plain)
    slots = [i for i, s in enumerate(rec.spans) if s.name == "hero.slot"]
    assert [rec.spans[i].attrs for i in slots] == [
        {"rid": 1, "seq": k, "tier": "march"} for k in range(4)]
    for i in slots:
        kids = [s.name for s in rec.spans if s.parent == i]
        assert kids == ["hero.sync", "hero.sync"]
    steps = sum(s.name == "hero.step" and "items" in s.attrs
                for s in rec.spans)
    assert steps == 1
    assert sum(s.name == "hero.sync" for s in rec.spans) == 8
    assert sum(s.name == "hero.step.pack" for s in rec.spans) == 2
    with spans.recording() as rec:
        eng.render(ro, rd, scene="chair")
    tiers = [s.attrs["tier"] for s in rec.spans if s.name == "hero.slot"]
    assert tiers == ["hit"] * 4
    assert sum(s.name == "hero.sync" for s in rec.spans) == 4
