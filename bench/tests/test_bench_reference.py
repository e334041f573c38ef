"""Each plain reference against the port at the smoke sizes on the CPU,
and each control against the cell's limit."""
import numpy as np
import pytest
import torch

from bench.drivers import lm, ngp
from bench.lib import cameras
from bench.reference import lm as lm_ref
from bench.reference import ngp as ngp_ref
from smoke import (limits, lm_config, lm_control_config, ngp_config,
                   ngp_traffic)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def nerf():
    cfg = ngp_config()
    inputs = ngp.make_inputs(cfg, 2**31 + 11, CPU)
    tr = ngp_traffic("orbit-fresh-800")
    tr.update(image_hw=48, engine={"slots": 2, "slot_rays": 768})
    engine = ngp.build_engine(cfg, tr, inputs, CPU)
    qf = ngp_ref.quantize_field(inputs["weights"], cfg, cfg["bits"],
                                inputs["act_ranges"])
    return cfg, inputs, engine, qf, cameras.pixel_dirs(48, 1.2 * 48)


def reference(nerf, ro, rd, dtype=torch.float32):
    cfg, inputs, _, qf, _ = nerf
    return ngp_ref.render_rays(
        qf, inputs["grid"], torch.from_numpy(np.ascontiguousarray(ro)),
        torch.from_numpy(np.ascontiguousarray(rd)), cfg["render"],
        dtype=dtype).numpy()


def test_nerf_tiers_match_the_reference(nerf):
    """March, hit and warp tiers of the engine against the reference."""
    _, _, engine, _, dirs = nerf
    c2w = cameras.look_at(0.7, 0.4, 1.3)
    ro, rd = cameras.frame_rays(c2w, dirs)
    shift = cameras.jitter_shift(c2w, dirs, 0.05, 0.05)
    ro_j = cameras.frame_rays(c2w, dirs, shift)[0]
    before = dict(engine.stats()["pose_cache"])
    served = [engine.render(ro, rd, scene="chair") for _ in range(3)]
    served.append(engine.render(ro_j, rd, scene="chair"))
    after = engine.stats()["pose_cache"]
    slots = -(-ro.shape[0] // engine.cfg.slot_rays)  # work items a frame
    assert {k: after[k] - before[k] for k in ("hits", "warps", "misses")} \
        == {"hits": slots, "warps": slots, "misses": 2 * slots}
    want, want_j = reference(nerf, ro, rd), reference(nerf, ro_j, rd)
    assert (want.min(axis=1) < 0.99).mean() > 0.1  # the chair is in view
    lim = limits("ngp-fresh-800")
    for got, ref in zip(served, [want] * 3 + [want_j]):
        big, mean = ngp_ref.pixel_errors(got, ref)
        assert big <= lim["rgb_max_abs"] and mean <= lim["rgb_mean_abs"]


def test_nerf_control_fails_the_limit(nerf):
    *_, dirs = nerf
    ro, rd = cameras.frame_rays(cameras.look_at(2.1, 0.3, 1.3), dirs)
    big, mean = ngp_ref.pixel_errors(
        reference(nerf, ro, rd, torch.bfloat16), reference(nerf, ro, rd))
    lim = limits("ngp-fresh-800")
    assert big > lim["rgb_max_abs"] or mean > lim["rgb_mean_abs"]


@pytest.fixture(scope="module")
def llava():
    cfg = lm_config()
    model = lm.model_config(cfg)
    params = lm.make_weights(model, 2**31 + 13, CPU)
    return cfg, model, params


def test_lm_logits_match_the_reference(llava):
    """The port's prefill logits and its decode step's against the plain
    forward over the same positions."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    cfg, model, params = llava
    tokens, patches = lm.batch_inputs(model, 5, 0, 3, 12, CPU)
    P = model.n_prefix_patches
    with torch.inference_mode():
        logits, cache = make_prefill_step(model, P + 14)(
            params, {"tokens": tokens, "patches": patches})
        nxt = logits[:, -1].argmax(-1, keepdim=True)
        step, _ = make_decode_step(model)(params, cache, nxt, P + 12)
    seqs = [(patches[i], torch.cat([tokens[i], nxt[i]])) for i in range(3)]
    ref = lm_ref.logits_at(params, cfg, seqs, [range(P + 13)] * 3)
    for i in range(3):
        assert torch.allclose(logits[i], ref[i][:P + 12], atol=1e-4)
        assert torch.allclose(step[i, -1], ref[i][P + 12], atol=1e-4)


def test_lm_control_fails_the_limit():
    cfg = lm_control_config()
    model = lm.model_config(cfg)
    params = lm.make_weights(model, 3, CPU)
    tokens, patches = lm.batch_inputs(model, 6, 0, 6, 48, CPU)
    seqs = [(patches[i], tokens[i]) for i in range(6)]
    at = [range(16, 64)] * 6
    ref = lm_ref.logits_at(params, cfg, seqs, at)
    low = lm_ref.logits_at(params, cfg, seqs, at, precision="fp8")
    gap = max(float(lm_ref.control_gaps(r, lw).max())
              for r, lw in zip(ref, low))
    assert gap > limits("llava-vqa-offline")["logit_gap_max"]
    assert max(float(lm_ref.served_gaps(r, r.argmax(-1)).max())
               for r in ref) == 0.0
