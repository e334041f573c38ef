"""Metric arithmetic on synthetic spans, counters and timelines."""
import json

import pytest

from bench import run
from bench.lib import costs
from bench.lib.outcome import Check, Outcome
from bench.lib.trace import Trace, timeline
from smoke import ROOT


def outcome(**kw):
    base = dict(setup_s=12.5, window_s=10.0, attempted=20, failed=0,
                memory_peak_bytes=1 << 30)
    base.update(kw)
    return Outcome(**base)


def value(name, out):
    return run.reader(name)(out)


def test_frames_latency_and_steps():
    out = outcome(counters={"frames": 400, "pose_hits": 30,
                            "pose_warps": 10, "pose_misses": 60},
                  records={"frame_ms": [float(i) for i in range(1, 101)],
                           "step_s": [0.01, 0.02, 0.03]})
    assert value("frames_per_s", out) == 40.0
    assert value("frame_p95_ms", out) == pytest.approx(95.05)
    assert value("ngp.step_ms", out) == pytest.approx(20.0)
    assert value("ngp.pose_hit_share", out) == pytest.approx(40.0)
    assert value("setup_s", out) == 12.5
    assert value("lm_tokens_per_s", out) is None


def test_lm_rates():
    out = outcome(counters={"tokens": 300_000, "prefill_positions": 250_000,
                            "decode_steps": 62},
                  records={"prefill_s": [1.0, 1.5], "decode_s": [0.9, 1.1]})
    assert value("lm_tokens_per_s", out) == 30_000.0
    assert value("lm.prefill_us_per_token", out) == pytest.approx(10.0)
    assert value("lm.decode_step_ms", out) == pytest.approx(2000 / 62)
    assert value("frames_per_s", out) is None


def test_timeline_union_gaps_and_names():
    dev = [(100.0, 200.0, "ka"), (150.0, 250.0, "kb"), (400.0, 500.0, "ka"),
           (50.0, 120.0, "first")]
    cpu = [(0.0, 1000.0, "loop"), (250.0, 400.0, "aten::copy_")]
    t = timeline(dev, cpu, lo=80.0, hi=1000.0, wall=0.00092)
    assert t.busy_s == pytest.approx((250 - 80 + 100) * 1e-6)
    assert t.by_name["ka"] == (2, pytest.approx(200e-6))
    assert t.by_name["first"] == (1, pytest.approx(40e-6))
    assert t.gaps[0] == ("loop", pytest.approx(500e-6))
    assert t.gaps[1] == ("aten::copy_", pytest.approx(150e-6))
    assert t.seconds("ka", "kb") == pytest.approx(300e-6)
    br = t.breakdown()
    assert br["device_ops"][0][0] == "ka" and len(br["idle_gaps"]) == 2


def test_trace_shares_and_rooflines():
    tr = Trace(window_s=2.0, busy_s=0.5,
               by_name={"qmm_packed_kernel<4>": (10, 0.2),
                        "ray_march_kernel": (2, 0.05),
                        "flash_tc_kernel": (32, 0.4),
                        "decode_kernel<bf16>": (64, 0.1),
                        "elementwise": (5, 0.3)},
               gaps=[])
    out = outcome(trace=tr, work={"ngp_field_s": 0.125,
                                  "attention_s": 0.25,
                                  "ngp_field_ops": 1979e12 * 0.5,
                                  "lm_flops": 989e12 * 2.5})
    assert value("idle_share.ngp", out) == pytest.approx(75.0)
    assert value("idle_share.lm", out) == pytest.approx(75.0)
    assert value("roofline.ngp_field", out) == pytest.approx(50.0)
    assert value("roofline.attention", out) == pytest.approx(50.0)
    assert value("mfu.ngp", out) == pytest.approx(5.0)
    assert value("mfu.lm", out) == pytest.approx(25.0)
    assert value("roofline.ngp_field", outcome()) is None


def test_costs_least_time():
    ops, nbytes, unit = costs.quant_matmul_packed(1000, 64, 64, 256)
    assert ops == 2 * 1000 * 64 * 64 and unit == "int8"
    assert nbytes == 1000 * 64 + 1024 + 1000 * 64 * 4 + 16
    assert costs.least_s(0.0, 3.35e12, "f32") == pytest.approx(1.0)
    assert costs.least_s(989e12, 0.0, "bf16") == pytest.approx(1.0)
    ops, _, unit = costs.flash_attention(1, 1, 1, 128, 64, 64, True, 2)
    assert ops == 4.0 * 64 * 64 * 128 / 2 and unit == "bf16"


def test_result_line_keys_and_order():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = outcome(counters={"frames": 100}, records={"frame_ms": [1.0, 2.0]},
                  checks={"rgb_max_abs": Check(0.0, 1e-3)})
    names = [m["name"] for m in run.metrics_of(manifest, "ngp-fresh-800",
                                               False)]
    assert set(names) == {"frames_per_s", "frame_p95_ms", "setup_s"}

    class Dev:  # `result_line` names the card; here a stand-in
        pass
    import torch
    real = torch.cuda.get_device_name
    torch.cuda.get_device_name = lambda d: "stand-in"
    try:
        line = run.result_line(manifest, "ngp-fresh-800", False, out, Dev(),
                               1)
    finally:
        torch.cuda.get_device_name = real
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"]["frames_per_s"] == {"value": 10.0,
                                               "unit": "frames/s"}
    assert line["checks"] == {"rgb_max_abs": {"value": 0.0, "limit": 1e-3}}


def test_check_fails_on_nan_and_excess():
    assert not Check(float("nan"), 1.0).ok
    assert not Check(1.5, 1.0).ok and Check(1.0, 1.0).ok
    assert not outcome(checks={}).correct
    assert not outcome(failed=1, checks={"x": Check(0.0, 1.0)}).correct
