"""A traced window: `torch.profiler` over a call, read into what the
per-layer metrics and the breakdown need."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"


@dataclasses.dataclass
class Trace:
    window_s: float  # the traced window's length (host clock)
    busy_s: float  # union of the intervals in which a device op ran
    by_name: Dict[str, Tuple[int, float]]  # device op -> (count, seconds)
    gaps: List[Tuple[str, float]]  # longest idle gaps, by host activity

    def seconds(self, *parts: str) -> float:
        """Device seconds of the ops whose name holds one of `parts`."""
        return sum(t for n, (_, t) in self.by_name.items()
                   if any(p in n for p in parts))

    def idle_pct(self) -> float:
        """Share of the window in which no device op ran, in %."""
        return 100.0 * max(0.0, 1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> Dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:10]
        return {"device_ops": [[n, t] for n, (_, t) in ops],
                "idle_gaps": [[n, t] for n, t in self.gaps[:10]]}


def idle_share(out) -> Optional[float]:
    """Share of the traced window in which no operation ran on the device,
    in %, or None for a run without a trace: the reader of every
    `idle_share.<group>` metric."""
    t = out.trace
    return None if t is None or t.window_s <= 0 else t.idle_pct()


def traced(fn: Callable[[], None], device: torch.device,
           n_gaps: int = 10) -> Trace:
    """Run `fn` under the profiler (host and, on the card, CUDA activity)
    inside a `bench.window` range and read the device timeline within
    it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from bench.lib.device import sync

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            fn()
            sync(device)
            wall = time.perf_counter() - t0
    cpu, dev, lo, hi = [], [], None, None
    # The raw events (ns): building the profiler's event tree for a few
    # hundred thousand launches takes minutes.
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
    return timeline(dev, cpu, lo, hi, wall, n_gaps)


def timeline(dev: List[Tuple[float, float, str]],
             cpu: List[Tuple[float, float, str]], lo: float, hi: float,
             wall: float, n_gaps: int = 10) -> Trace:
    """Read device spans (start, end, name) in µs, clipped to the window
    [lo, hi]: the union of their intervals, seconds by name, and the
    longest stretches with no device op, each named by the host op that
    ran at its middle."""
    dev = sorted((max(s, lo), min(t, hi), n) for s, t, n in dev
                 if t > lo and s < hi)
    by_name: Dict[str, Tuple[int, float]] = {}
    busy, edge, gaps = 0.0, lo, []
    for s, t, n in dev:
        c, total = by_name.get(n, (0, 0.0))
        by_name[n] = (c + 1, total + (t - s) * 1e-6)
        if s > edge:
            gaps.append((edge, s))
        busy += max(0.0, t - max(s, edge))
        edge = max(edge, t)
    if hi > edge:
        gaps.append((edge, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n_gaps]
    return Trace(window_s=wall, busy_s=busy * 1e-6, by_name=by_name,
                 gaps=[(host_activity(cpu, (a + b) / 2), (b - a) * 1e-6)
                       for a, b in gaps])


def host_activity(cpu: List[Tuple[float, float, str]], at: float) -> str:
    """The innermost host op running at time `at` (µs), or "host"."""
    inner = [(t - s, n) for s, t, n in cpu if s <= at <= t]
    return min(inner)[1] if inner else "host"
