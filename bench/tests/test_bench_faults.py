"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (the driver, at the smoke sizes on the
CPU: no look for a card) with one fault planted in the program and sees
`correct` false; the unbroken run is correct. The cells' faults: an
answer or a token altered where it is produced, half of a batch left
out, and for the LM a decode step that leaves its cache unchanged. No
cell runs across chips, so no exchange can be left out."""
import numpy as np
import pytest
import torch

from bench.control import control_checks
from bench.drivers import lm, ngp
from bench.lib.outcome import Outcome
from smoke import limits, lm_config, lm_traffic, ngp_config, ngp_traffic

CPU = torch.device("cpu")
NGP_CELLS = [("ngp-fresh-800", "orbit-fresh-800"),
             ("ngp-revisit-800", "hotset-zipf-800")]


def ngp_run(workload, traffic, control=False):
    return ngp.run(ngp_config(), ngp_traffic(traffic), limits(workload),
                   2**31 + 21, 0.5, False, CPU, control=control)


def lm_run():
    return lm.run(lm_config(), lm_traffic(), limits("llava-vqa-offline"),
                  2**31 + 22, 0.5, False, CPU)


@pytest.mark.parametrize("workload,traffic", NGP_CELLS)
def test_ngp_sound_run_is_correct(workload, traffic):
    out = ngp_run(workload, traffic)
    assert out.correct, {k: (c.value, c.limit) for k, c in out.checks.items()}


def test_reservoir_samples_the_whole_stream_by_seed():
    """The checked frames are a uniform sample of all frames answered, not
    of the first ones: late frames are drawn as often as early ones."""
    picks = []
    for seed in range(400):
        r = ngp.Reservoir(3, np.random.default_rng([seed, 1]))
        for i in range(1000):
            r.offer(i)
        again = ngp.Reservoir(3, np.random.default_rng([seed, 1]))
        for i in range(1000):
            again.offer(i)
        assert r.items == again.items and len(set(r.items)) == 3
        picks += r.items
    late = np.mean(np.array(picks) >= 500)
    assert 0.45 < late < 0.55 and max(picks) >= 990


@pytest.mark.parametrize("workload,traffic", NGP_CELLS)
def test_ngp_control_comes_out_not_correct(workload, traffic):
    """The control (the reference in bfloat16 in the program's place)
    judged by the cell's own checks fails them; the program passes."""
    out = ngp_run(workload, traffic, control=True)
    assert out.correct
    assert not all(c.ok for c in control_checks(out, limits(workload))
                   .values())


def test_control_that_gives_no_number_has_failed():
    out = Outcome(setup_s=1.0, window_s=1.0, attempted=1, failed=0,
                  memory_peak_bytes=0)
    checks = control_checks(out, limits("llava-vqa-offline"))
    assert checks and not any(c.ok for c in checks.values())


def test_lm_sound_run_is_correct():
    out = lm_run()
    assert out.correct, {k: (c.value, c.limit) for k, c in out.checks.items()}


def altered(colors, items):
    colors = np.array(colors)
    colors[0, :64] += 0.05  # one work item's first rays, every step
    return colors


def half_left_out(colors, items):
    colors = np.array(colors)
    colors[len(items) // 2:] = 0.0  # the later slots never rendered
    return colors


@pytest.mark.parametrize("fault", [altered, half_left_out])
@pytest.mark.parametrize("workload,traffic", NGP_CELLS)
def test_ngp_faults_are_caught(monkeypatch, workload, traffic, fault):
    from repro_torch.hero.engine import FusedDeviceStep

    real = FusedDeviceStep.step_items

    def broken(self, scene, artifact, items, ro, rd):
        return fault(real(self, scene, artifact, items, ro, rd), items)
    monkeypatch.setattr(FusedDeviceStep, "step_items", broken)
    assert not ngp_run(workload, traffic).correct


def test_lm_altered_token_is_caught(monkeypatch):
    from repro_torch.launch import serve

    real = serve.greedy

    def broken(logits):
        tok = real(logits).clone()
        tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok
    monkeypatch.setattr(serve, "greedy", broken)
    assert not lm_run().correct


def test_lm_half_batch_left_out_is_caught(monkeypatch):
    from repro_torch.models import lm as model_lm

    real = model_lm.decode_step

    def broken(params, cache, tokens, pos, cfg, placement=None):
        logits, cache = real(params, cache, tokens, pos, cfg, placement)
        logits = logits.clone()
        logits[tokens.shape[0] // 2:] = 0.0
        return logits, cache
    monkeypatch.setattr(model_lm, "decode_step", broken)
    assert not lm_run().correct


def test_lm_cache_left_unchanged_is_caught(monkeypatch):
    from repro_torch.models import lm as model_lm

    real = model_lm.decode_step

    def broken(params, cache, tokens, pos, cfg, placement=None):
        kept = {k: {n: t.clone() for n, t in v.items()}
                for k, v in cache.items()}
        logits, _ = real(params, cache, tokens, pos, cfg, placement)
        for k, v in kept.items():
            for n, t in v.items():
                cache[k][n].copy_(t)  # the step's state returned unchanged
        return logits, cache
    monkeypatch.setattr(model_lm, "decode_step", broken)
    assert not lm_run().correct
