"""The readers of the program's spans (`bench/lib/spans.py`) on synthetic
timelines and spans, and `bench/spans_probe.py` end to end on the CPU at
the smoke sizes."""
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from bench.lib import spans as sl
from bench.lib.trace import timeline
from bench.spans_probe import HOST_ONLY, probe
from smoke import lm_config, lm_traffic, ngp_config, ngp_traffic

DEV = [(100.0, 200.0, "ka"), (400.0, 500.0, "kb")]


def recording(spans):
    """A stand-in for `repro_torch.spans.Recording`: spans given as
    (name, start µs, end µs, attrs)."""
    return SimpleNamespace(
        spans=[SimpleNamespace(name=n, start_ns=int(s * 1e3),
                               end_ns=int(t * 1e3), attrs=a, parent=-1)
               for n, s, t, a in spans],
        dropped=0)


def window(rec=None, host=()):
    lo, hi = 0.0, 1000.0
    return sl.Window(trace=timeline(DEV, list(host), lo, hi, 1e-3), lo=lo,
                     hi=hi, idle=sl.idle_intervals(DEV, lo, hi),
                     host=list(host), rec=rec)


def test_each_reader_reads_none_without_a_recording():
    w = window()
    assert sl.metrics(w) == {}
    assert all(read(w) is None for read in sl.READERS.values())
    assert sl.clock_margins_us(w) is None
    # A recording with no span of a name reads None for that name alone.
    w = window(recording([("lm.decode", 0.0, 50.0, {})]))
    assert set(sl.metrics(w)) == {"lm.decode_host_ms", "lm.idle_in_decode_ms"}


def test_idle_stretches_straddling_a_span_are_cut_at_its_edges():
    w = window(recording([
        ("hero.submit", 150.0, 450.0, {"rid": 0, "n_items": 2}),
        ("hero.submit", 940.0, 945.0, {"rid": 2, "n_items": 1}),
        ("hero.step", 600.0, 900.0,
         {"scene": "a", "items": ((0, 0, 0.25), (0, 1, 0.5))}),
        ("hero.step", 950.0, 1000.0,
         {"scene": "a", "items": ((1, 0, 0.0), (2, 0, 3.0))}),
    ] + [("hero.sync", 610.0 + k, 610.5 + k, {}) for k in range(16)]))
    assert w.idle == [(0.0, 100.0), (200.0, 400.0), (500.0, 1000.0)]
    m = sl.metrics(w)
    # Inside hero.submit [150, 450]: idle 200..400 only (the ops at
    # 100..200 and 400..500 cover its edges); [940, 945] all idle.
    assert m["ngp.idle_in_submit_ms"] == pytest.approx((0.2 + 0.005) / 2)
    assert m["ngp.submit_ms"] == pytest.approx((0.3 + 0.005) / 2)
    assert m["ngp.idle_in_step_ms"] == pytest.approx((0.3 + 0.05) / 2)
    # Request 1 was submitted before the window and request 2 in its
    # second half: their items are left out.
    assert m["ngp.queue_wait_ms"] == pytest.approx(1e3 * (0.25 + 0.5) / 2)
    assert m["ngp.syncs_per_step"] == 8.0
    split = sl.idle_split(w, ("hero.submit", "hero.step"))
    assert split["idle"] == pytest.approx(0.8)
    assert split["outside"] == pytest.approx(0.1 + 0.1 + 0.04 + 0.005)
    assert split["hero.submit"] + split["hero.step"] + split["outside"] \
        == pytest.approx(split["idle"])


def test_queue_wait_reads_none_where_a_wait_outlasts_the_window():
    """A request of the window's first half with an item still queued at
    its end: the wait is longer than the window holds, so no reading,
    not the mean of the shorter waits."""
    submits = [("hero.submit", 100.0, 110.0, {"rid": 0, "n_items": 1}),
               ("hero.submit", 300.0, 310.0, {"rid": 1, "n_items": 2})]
    took = [("hero.step", 600.0, 700.0,
             {"scene": "a", "items": ((0, 0, 0.5), (1, 0, 0.3))})]
    assert sl.queue_wait_ms(window(recording(submits + took))) is None
    took.append(("hero.step", 800.0, 900.0,
                 {"scene": "a", "items": ((1, 1, 0.5),)}))
    assert sl.queue_wait_ms(window(recording(submits + took))) == \
        pytest.approx(1e3 * (0.5 + 0.3 + 0.5) / 3)
    # No request in the first half: nothing to read.
    late = [("hero.submit", 600.0, 610.0, {"rid": 2, "n_items": 1}),
            ("hero.step", 700.0, 800.0, {"items": ((2, 0, 0.1),)})]
    assert sl.queue_wait_ms(window(recording(late))) is None


def test_probe_exits_without_a_result_where_there_is_no_card():
    root = Path(__file__).resolve().parents[2]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = subprocess.run(
        [sys.executable, str(root / "bench" / "spans_probe.py"),
         "--workload", "ngp-fresh-800", "--seed", "1"],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert done.returncode == 2 and done.stdout == ""
    assert "needs a CUDA card" in done.stderr


def test_lm_readers_and_overlapping_spans_count_once():
    w = window(recording([("lm.prefill", 50.0, 150.0, {}),
                          ("lm.decode", 300.0, 700.0, {}),
                          ("lm.decode", 600.0, 800.0, {})]))
    m = sl.metrics(w)
    assert m["lm.idle_in_prefill_ms"] == pytest.approx(0.05)
    # The union of the two decodes is 300..800: idle 300..400, 500..800.
    assert m["lm.idle_in_decode_ms"] == pytest.approx(0.4 / 2)
    assert m["lm.decode_host_ms"] == pytest.approx(0.3)


def test_nesting_and_clock_margins():
    host = [(0.0, 500.0, "engine.submit"), (10.0, 490.0, "hero.submit"),
            (600.0, 700.0, "hero.submit"), (5.0, 9.0, "hero.step")]
    w = window(recording([("hero.submit", 8.0, 495.0, {}),
                          ("hero.submit", 601.0, 699.0, {})]), host)
    assert sl.unnested(w, "hero.submit", "engine.submit") == 1
    assert sl.unnested(w, "hero.step", "engine.step") == 1
    least, most = sl.clock_margins_us(w)
    assert least == pytest.approx(-1.0) and most == pytest.approx(5.0)


def test_union_and_overlap():
    assert sl.union([(5, 6), (1, 3), (2, 4), (7, 7)]) == [(1, 4), (5, 6)]
    assert sl.overlap([(0, 10)], [(2, 3), (9, 12), (2.5, 4)]) == 3.0
    assert sl.idle_intervals([(-5.0, 5.0, "k")], 0.0, 10.0) == [(5.0, 10.0)]


@pytest.mark.parametrize("kind", ["ngp", "lm"])
def test_probe_runs_on_the_cpu_and_its_spans_nest(kind):
    if kind == "ngp":
        config, traffic = ngp_config(), ngp_traffic("orbit-fresh-800")
    else:
        config, traffic = lm_config(), lm_traffic()
    res = probe(kind, config, traffic, 2**31 + 5, 0.2, 1,
                torch.device("cpu"))
    reading, off, on, plain_off, plain_on = res["windows"][:5]
    plan = [("reading", True), ("traced", False), ("traced", True),
            ("plain", False), ("plain", True)]
    if kind == "ngp":
        plan.append(("queue", True))
    assert [(w["window"], w["recorded"]) for w in res["windows"]] == plan
    names = {n for n in sl.READERS if n.startswith(kind + ".")}
    # A short window may hold no whole queue wait: that reads None.
    wait = {"ngp.queue_wait_ms"}
    for w in (reading, on):
        assert names - wait <= set(w["metrics"]) <= names
        assert all(v == 0 for v in w["unnested"].values())
        assert w["clock_margins_us"][0] >= 0
        split = w["idle_split"]
        parts = sum(v for k, v in split.items() if k != "idle")
        assert parts == pytest.approx(split["idle"], rel=1e-9)
        assert w["dropped"] == 0
    assert "metrics" not in off and "metrics" not in plain_off
    assert names & set(HOST_ONLY) - wait <= set(plain_on["metrics"])
    assert "idle_pct" not in plain_on and res["ops_differ"] == {}
    assert set(res["cost"]) == {"traced.on", "traced.off", "plain.on",
                                "plain.off"}
    if kind == "ngp":
        assert reading["metrics"]["ngp.syncs_per_step"] == 4.0  # 2 slots
        assert plain_on["metrics"]["ngp.syncs_per_step"] == 4.0
        queue = res["windows"][-1]
        assert set(queue["metrics"]) == names & set(HOST_ONLY)
        assert queue["metrics"]["ngp.queue_wait_ms"] > 0
    else:
        assert res["spans"]["lm.decode"][0] == traffic["trace_batches"] * (
            traffic["gen_tokens"] - 1)
