"""The program's own spans on a traced window's timeline.

The port records spans at its layer boundaries (`repro_torch.spans`:
`hero.submit`, `hero.step` and their children in the serve engine,
`lm.prefill` and `lm.decode` in the LM server; `hero.sync` around
each of the engine's blocking device reads). `traced_spans` runs a
call under the profiler as `bench.lib.trace.traced` does, with the
program's recording open inside the window only, and keeps what the
readers below need: every idle stretch of the window, the host ranges,
and the recording. `metrics` reads the eight per-layer numbers the
spans give:

| metric | definition (the traced window) |
| --- | --- |
| `ngp.submit_ms` | mean duration of `hero.submit` |
| `ngp.queue_wait_ms` | mean `queue_age_s` of the items `hero.step` took * |
| `ngp.syncs_per_step` | count of `hero.sync` over the count of `hero.step` |
| `ngp.idle_in_submit_ms` | device-idle time inside `hero.submit`, per span |
| `ngp.idle_in_step_ms` | device-idle time inside `hero.step`, per span |
| `lm.decode_host_ms` | mean duration of `lm.decode` (the enqueue of a step) |
| `lm.idle_in_decode_ms` | device-idle time inside `lm.decode`, per span |
| `lm.idle_in_prefill_ms` | device-idle time inside `lm.prefill`, per span |

* Of the requests submitted in the window's first half, and only where
every item of them was taken inside the window: items queued before the
window also aged while the profiler started, and a wait longer than the
rest of the window reads None, never a shorter wait. The fresh cell's
waits outlast half of its 24-step traced window, so a recorded window
without the profiler and ten times as long reads them
(`bench/spans_probe.py`'s `queue` window). "Inside" is the intersection of
the window's idle stretches with the union of that name's spans. A run
whose recording was not open, or a program without spans, reads None
for each.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from bench.lib.trace import WINDOW, Trace, timeline

Interval = Tuple[float, float]


@dataclasses.dataclass
class Window:
    trace: Optional[Trace]  # what `bench.lib.trace.traced` reads
    lo: float  # the window's range on the profiler's (host) clock, µs
    hi: float
    idle: List[Interval]  # every stretch with no device op, µs
    host: List[Tuple[float, float, str]]  # host ranges (µs) by name
    rec: object = None  # the program's `spans.Recording`, or None
    wall: float = 0.0  # the window's length by the host clock, s

    def spans(self, name: str) -> List[Interval]:
        """(start, end) in µs of the recorded spans `name`, in order."""
        if self.rec is None:
            return []
        return [(s.start_ns * 1e-3, s.end_ns * 1e-3) for s in self.rec.spans
                if s.name == name and s.end_ns is not None]


def traced_spans(fn: Callable[[], None], device: torch.device,
                 record: bool = True, n_gaps: int = 10) -> Window:
    """Run `fn` as `bench.lib.trace.traced` does (the same `Trace`), with
    the program's span recording open inside the window when `record`
    and the program has one."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from bench.lib.device import sync

    try:
        from repro_torch import spans as program
    except ImportError:  # a program without spans records nothing
        program = None
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    rec = None
    sync(device)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            if record and program is not None:
                with program.recording() as rec:
                    fn()
            else:
                fn()
            sync(device)
            wall = time.perf_counter() - t0
    cpu, dev, lo, hi = [], [], None, None
    for e in prof.profiler.kineto_results.events():
        span = (e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.name())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append(span)
        elif span[2] == WINDOW:
            lo, hi = span[:2]
        else:
            cpu.append(span)
    if lo is None:
        raise RuntimeError("the profiler recorded no window range")
    return Window(trace=timeline(dev, cpu, lo, hi, wall, n_gaps), lo=lo,
                  hi=hi, idle=idle_intervals(dev, lo, hi), host=cpu,
                  rec=rec, wall=wall)


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of `intervals` as sorted, disjoint intervals."""
    out: List[Interval] = []
    for s, t in sorted(intervals):
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def overlap(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """Length of the intersection of two unions of intervals."""
    a, b = union(a), union(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_intervals(dev: Sequence[Tuple[float, float, str]], lo: float,
                   hi: float) -> List[Interval]:
    """The stretches of [lo, hi] in which no device span (start, end,
    name) ran."""
    out, edge = [], lo
    for s, t in union([(max(s, lo), min(t, hi)) for s, t, _ in dev]):
        if s > edge:
            out.append((edge, s))
        edge = max(edge, t)
    if hi > edge:
        out.append((edge, hi))
    return out


def idle_in(w: Window, name: str) -> Optional[float]:
    """Device-idle ms inside the spans `name`, per span."""
    sp = w.spans(name)
    return 1e-3 * overlap(w.idle, sp) / len(sp) if sp else None


def mean_ms(w: Window, name: str) -> Optional[float]:
    sp = w.spans(name)
    return 1e-3 * sum(t - s for s, t in sp) / len(sp) if sp else None


def queue_wait_ms(w: Window) -> Optional[float]:
    """Mean engine-clock age of the items `hero.step` took, in ms, over
    the requests submitted in the window's first half. The items queued
    before the window also aged while the profiler started, so they are
    left out; where one of those requests still has an item queued at the
    window's end, its wait is longer than the window can hold, and the
    reading is None rather than the shorter waits alone."""
    if w.rec is None:
        return None
    mid_ns = 1e3 * (w.lo + w.hi) / 2
    want = {s.attrs["rid"]: s.attrs["n_items"] for s in w.rec.spans
            if s.name == "hero.submit" and "rid" in s.attrs
            and s.start_ns < mid_ns}
    ages: Dict[int, List[float]] = {rid: [] for rid in want}
    for s in w.rec.spans:
        if s.name == "hero.step":
            for rid, _, age in s.attrs.get("items", ()):
                if rid in ages:
                    ages[rid].append(age)
    if not want or any(len(ages[r]) < n for r, n in want.items()):
        return None
    flat = [a for r in want for a in ages[r]]
    return 1e3 * sum(flat) / len(flat)


def syncs_per_step(w: Window) -> Optional[float]:
    steps = len(w.spans("hero.step"))
    return len(w.spans("hero.sync")) / steps if steps else None


READERS: Dict[str, Callable[[Window], Optional[float]]] = {
    "ngp.submit_ms": lambda w: mean_ms(w, "hero.submit"),
    "ngp.queue_wait_ms": queue_wait_ms,
    "ngp.syncs_per_step": syncs_per_step,
    "ngp.idle_in_submit_ms": lambda w: idle_in(w, "hero.submit"),
    "ngp.idle_in_step_ms": lambda w: idle_in(w, "hero.step"),
    "lm.decode_host_ms": lambda w: mean_ms(w, "lm.decode"),
    "lm.idle_in_decode_ms": lambda w: idle_in(w, "lm.decode"),
    "lm.idle_in_prefill_ms": lambda w: idle_in(w, "lm.prefill"),
}


def metrics(w: Window) -> Dict[str, float]:
    """The eight metrics that the window's spans give (those with nothing
    to read left out)."""
    out = {}
    for name, read in READERS.items():
        v = read(w)
        if v is not None:
            out[name] = v
    return out


def idle_split(w: Window, names: Sequence[str]) -> Dict[str, float]:
    """The window's idle ms inside each of `names`' spans, outside all of
    them, and in all (`idle`), each computed on its own: the parts close
    where the names' spans do not overlap."""
    idle = union(w.idle)
    out = {n: 1e-3 * overlap(idle, w.spans(n)) for n in names}
    inside = union([iv for n in names for iv in w.spans(n)])
    outside, edge = [], w.lo
    for s, t in inside:
        outside.append((edge, s))
        edge = t
    outside.append((edge, w.hi))
    out["outside"] = 1e-3 * overlap(idle, outside)
    out["idle"] = 1e-3 * sum(t - s for s, t in idle)
    return out


def unnested(w: Window, inner: str, outer: str) -> int:
    """How many host ranges `inner` lie inside no host range `outer`."""
    outs = [(s, t) for s, t, n in w.host if n == outer]
    return sum(not any(a <= s and t <= b for a, b in outs)
               for s, t, n in w.host if n == inner)


def clock_margins_us(w: Window) -> Optional[Interval]:
    """(least, most) margin in µs by which a recorded span's own start and
    end enclose its `record_function` range on the profiler's timeline
    (the k-th span of a name against the k-th range of it); None without
    spans. The least is negative where the two clocks disagree."""
    if w.rec is None:
        return None
    host: Dict[str, List[Interval]] = {}
    for s, t, n in sorted(w.host):
        host.setdefault(n, []).append((s, t))
    seen: Dict[str, int] = {}
    margins = []
    for sp in w.rec.spans:
        k = seen.get(sp.name, 0)
        seen[sp.name] = k + 1
        ranges = host.get(sp.name, [])
        if k < len(ranges) and sp.end_ns is not None:
            s, t = ranges[k]
            margins += [s - sp.start_ns * 1e-3, sp.end_ns * 1e-3 - t]
    return (min(margins), max(margins)) if margins else None
