"""The port's span recorder (`repro_torch.spans`) and the LM server's
spans, on the CPU: the closed recorder does nothing; an open one keeps
names, nesting and attributes, drops what passes its cap, and
shares the profiler's host clock; `generate` opens one `lm.prefill` and
one `lm.decode` a step and gives the same tokens with the recording open.
"""
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import spans
from repro_torch.configs import get_arch
from repro_torch.launch.serve import frontend_inputs, generate
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import lm


def test_closed_recorder_records_nothing_and_shares_one_object():
    a, b = spans.span("x", k=1), spans.span("y")
    assert a is b is spans.NO_SPAN and not a.live
    with a as s:
        s.set(k=2)
    with spans.recording() as rec:
        pass
    assert rec.spans == [] and rec.dropped == 0
    assert spans.span("z") is spans.NO_SPAN  # closed again


def test_nesting_parents_attrs_and_summary():
    with spans.recording() as rec:
        with spans.span("outer", scene="a") as o:
            assert o.live
            with spans.span("inner", i=0):
                time.sleep(0.002)
            with spans.span("inner", i=1) as s:
                s.set(tier="march")
                with spans.span("leaf"):
                    pass
            o.set(items=(1, 2))
        with spans.span("outer"):
            pass
    names = [(s.name, s.parent) for s in rec.spans]
    assert names == [("outer", -1), ("inner", 0), ("inner", 0),
                     ("leaf", 2), ("outer", -1)]
    assert rec.spans[0].attrs == {"scene": "a", "items": (1, 2)}
    assert rec.spans[2].attrs == {"i": 1, "tier": "march"}
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
    o, i0, i1, leaf = rec.spans[:4]
    assert o.start_ns <= i0.start_ns and i1.end_ns <= o.end_ns
    summ = rec.summary()
    assert summ["outer"][0] == 2 and summ["inner"][0] == 2
    assert summ["inner"][1] >= 0.002
    own = o.seconds - i0.seconds - i1.seconds
    assert summ["outer"][2] == pytest.approx(own + rec.spans[4].seconds)
    assert summ["inner"][2] == pytest.approx(
        i0.seconds + i1.seconds - leaf.seconds)


def test_one_recording_at_a_time():
    with spans.recording() as rec:
        with spans.span("a"):
            with pytest.raises(RuntimeError):
                with spans.recording():
                    pass
    assert [s.name for s in rec.spans] == ["a"]
    assert spans.span("b") is spans.NO_SPAN  # the refusal closed nothing


def test_cap_drops_and_counts_the_overflow():
    with spans.recording(max_spans=3) as rec:
        with spans.span("a"):
            with spans.span("b"):
                pass
            with spans.span("c"):
                with spans.span("d") as d:  # past the cap
                    assert d is spans.NO_SPAN
                    with spans.span("e"):
                        pass
        with spans.span("f"):
            pass
    assert [s.name for s in rec.spans] == ["a", "b", "c"]
    assert rec.dropped == 3


def test_threads_keep_their_own_parents():
    barrier = threading.Barrier(2, timeout=10)

    def work(tag):
        with spans.span(f"t{tag}"):
            barrier.wait()
            with spans.span(f"t{tag}.child"):
                barrier.wait()

    with spans.recording() as rec:
        ts = [threading.Thread(target=work, args=(k,)) for k in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in ts)
    by_name = {s.name: i for i, s in enumerate(rec.spans)}
    for k in range(2):
        assert rec.spans[by_name[f"t{k}.child"]].parent == by_name[f"t{k}"]
        assert rec.spans[by_name[f"t{k}"]].parent == -1


def test_spans_bracket_their_profiler_events():
    """Under a CPU profile each recorded span enters `record_function`;
    the span's own times bracket the event's within 100 µs."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):  # the profiler's first range is slow
            pass
        with spans.recording() as rec:
            for k in range(5):
                with spans.span(f"p{k}"):
                    with spans.span(f"p{k}.child"):
                        time.sleep(0.0005)
    # Outside a recording, nothing enters the profiler.
    with profile(activities=[ProfilerActivity.CPU]) as quiet:
        with spans.span("silent"):
            pass
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for s in rec.spans:
        e = events[s.name]
        assert s.start_ns <= e.start_ns() <= s.start_ns + 100_000
        assert s.end_ns - 100_000 <= e.end_ns() <= s.end_ns
    assert not any(e.name() == "silent"
                   for e in quiet.profiler.kineto_results.events())


@pytest.fixture(scope="module")
def llava_smoke():
    model = get_arch("llava-next-mistral-7b").smoke
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = lm.init_params(model, gen, device="cpu")
    return model, params


def test_generate_opens_a_prefill_and_a_decode_a_step(llava_smoke):
    model, params = llava_smoke
    B, S, gen = 2, 6, 5
    extra = frontend_inputs(model, B, torch.device("cpu"))
    P = extra["patches"].shape[1]
    tokens = torch.randint(0, model.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    prefill = make_prefill_step(model, P + S + gen)
    decode = make_decode_step(model)
    with torch.inference_mode():
        plain = generate(prefill, decode, params, tokens, gen, None, extra)
        with spans.recording() as rec:
            seen = generate(prefill, decode, params, tokens, gen, None, extra)
            marks = []
            generate(prefill, decode, params, tokens, gen, marks, extra)
    assert torch.equal(plain, seen)
    first = rec.spans[:gen]
    assert [s.name for s in first] == ["lm.prefill"] + ["lm.decode"] * (
        gen - 1)
    assert first[0].attrs == {"batch": B, "positions": P + S}
    assert [s.attrs["pos"] for s in first[1:]] == list(
        range(P + S, P + S + gen - 1))
    assert all(s.parent == -1 for s in rec.spans)
    # With marks, each of its two synchronisations is an `lm.sync`.
    assert [s.name for s in rec.spans[gen:]] == (
        ["lm.prefill", "lm.sync"] + ["lm.decode"] * (gen - 1) + ["lm.sync"])
    assert len(marks) == 2
