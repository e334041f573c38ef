"""The port's rescale planning and straggler watchdog
(`repro_torch.distributed.fault_tolerance`): `tests/test_fault_tolerance.py`'s
cases, and `plan_rescale` equal to the JAX package's over a grid of mesh
changes. (Gradient compression, that file's other half, is not ported.)"""
import dataclasses
import time

import pytest

from repro.distributed import fault_tolerance as jft
from repro_torch.distributed.fault_tolerance import StepWatchdog, plan_rescale


def test_plan_rescale_preserves_global_batch():
    p = plan_rescale(global_batch=256, microbatch_per_shard=1,
                     old_dp=32, new_dp=16)
    assert p.new_accum == 16 and p.global_batch == 256
    p2 = plan_rescale(global_batch=256, microbatch_per_shard=1,
                      old_dp=16, new_dp=32)
    assert p2.new_accum == 8 and p2.global_batch == 256
    with pytest.raises(ValueError):
        plan_rescale(global_batch=100, microbatch_per_shard=1,
                     old_dp=16, new_dp=32)


def test_plan_rescale_equals_reference_on_a_grid():
    """Every (global batch, microbatch, old and new world size, old
    accumulation) of a small grid: the same plan, or the same refusal."""
    n = 0
    for gb in (1, 4, 6, 12, 64, 100, 256):
        for mb in (1, 2, 4):
            for old_dp in (1, 2, 3, 4, 8):
                for new_dp in (1, 2, 3, 4, 8):
                    for old_accum in (None, 1, 2):
                        args = (gb, mb, old_dp, new_dp, old_accum)
                        try:
                            want = jft.plan_rescale(*args)
                        except ValueError as e:
                            with pytest.raises(ValueError) as got:
                                plan_rescale(*args)
                            assert str(got.value) == str(e)
                            continue
                        got = plan_rescale(*args)
                        assert dataclasses.asdict(got) \
                            == dataclasses.asdict(want), args
                        assert got.global_batch == want.global_batch
                        n += 1
    assert n > 200


def test_watchdog_flags_straggler():
    flagged = []
    wd = StepWatchdog(slo_factor=5.0,
                      on_slow=lambda s, dt, med: flagged.append(s))
    for step in range(8):
        wd.start()
        time.sleep(0.012 if step != 6 else 0.2)
        slow = wd.stop(step)
        assert slow == (step == 6)
    assert flagged == [6]


# ---------------------------------------------------------------------------
# StepWatchdog direct unit tests (fake clock, no sleeps)
# ---------------------------------------------------------------------------
class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def test_watchdog_fake_clock_slo_boundary_is_strict():
    """With 5 recorded 1.0s steps the median is 1.0; at slo_factor=2 a
    2.0s step sits EXACTLY on the SLO and is NOT slow — only strictly
    above trips it."""
    clk = _FakeClock()
    wd = StepWatchdog(slo_factor=2.0, clock=clk)
    for step in range(5):
        wd.start()
        clk.advance(1.0)
        assert wd.stop(step) is False
    assert wd.median() == 1.0
    assert wd.is_slow(2.0) is False  # dt == factor * median: on the line
    assert wd.is_slow(2.0 + 1e-9) is True

    wd.start()
    clk.advance(2.0)
    assert wd.stop(5) is False  # boundary via the wrap API too
    wd.start()
    clk.advance(2.5)
    assert wd.stop(6) is True
    assert wd.slow_steps == [6]


def test_watchdog_no_verdict_before_min_samples():
    """A cold watchdog never flags: the first steps build the median."""
    clk = _FakeClock()
    wd = StepWatchdog(slo_factor=2.0, min_samples=3, clock=clk)
    assert wd.median() is None
    assert wd.is_slow(1e9) is False  # no median -> no verdict
    for step, dt in enumerate([0.1, 100.0]):  # wild variance, too few
        wd.start()
        clk.advance(dt)
        assert wd.stop(step) is False
    wd.record(0.1)
    assert wd.median() == 0.1  # 3 samples: verdicts begin
    assert wd.is_slow(0.3) is True


def test_watchdog_record_is_pure_query_vs_mutation():
    """is_slow never mutates the window; record never flags."""
    wd = StepWatchdog(slo_factor=2.0, min_samples=2, clock=_FakeClock())
    wd.record(1.0)
    wd.record(1.0)
    for _ in range(10):
        assert wd.is_slow(5.0) is True  # repeated probes, same answer
    assert wd.median() == 1.0  # probes did not pollute the window
    wd.record(5.0)  # a recorded slow duration shifts the median...
    assert wd.median() == 1.0  # ...only per the rolling sort (median holds)
    assert wd.slow_steps == []  # record() itself never flags


def test_watchdog_rolling_window_evicts_oldest():
    wd = StepWatchdog(slo_factor=2.0, window=4, min_samples=2,
                      clock=_FakeClock())
    for dt in (10.0, 10.0, 1.0, 1.0, 1.0, 1.0):
        wd.record(dt)  # the two 10.0s fall out of the window
    assert wd.median() == 1.0
    assert wd.is_slow(2.5) is True


def test_watchdog_stop_before_start_raises():
    wd = StepWatchdog(clock=_FakeClock())
    with pytest.raises(RuntimeError, match="before start"):
        wd.stop(0)


def test_plan_rescale_down_to_one_survivor():
    """Total loss of all but one worker: the survivor absorbs the whole
    global batch as accumulation — schedule preserved exactly."""
    p = plan_rescale(global_batch=8, microbatch_per_shard=1,
                     old_dp=4, new_dp=1, old_accum=2)
    assert p.new_dp == 1 and p.new_accum == 8
    assert p.global_batch == 8  # identical schedule, one worker
    # And the orchestrator's padded-capacity path: 3 -> 2 workers.
    cap = 3 * 1
    cap += (-cap) % 2
    p2 = plan_rescale(global_batch=cap, microbatch_per_shard=1,
                      old_dp=3, new_dp=2, old_accum=1)
    assert p2.new_accum == 2 and p2.global_batch == 4
