"""Spans of the port's serving paths, on the profiler's clock.

A span is a named stretch of host time at a layer boundary: the serve
engine's `hero.submit` and `hero.step` with their children, among them
`hero.sync` around each blocking device read of the step path, and the
LM server's `lm.prefill` and `lm.decode` (the names are listed where
they are opened, `hero/engine.py` and `launch/serve.py`). A count of
events is the count of their spans: a step's blocking reads are its
`hero.sync` spans.

They cost nothing worth measuring until a recording is open: `span`
returns one shared no-op object after one test of a module flag. An
operator records them around their own serving loop:

    from repro_torch import spans

    with spans.recording() as rec:
        for _ in range(100):
            engine.step()
    for name, (n, total_s, self_s) in rec.summary().items():
        print(f"{name}: {n} spans, {total_s:.3f} s, self {self_s:.3f} s")
    rec.summary()["hero.sync"][0]  # blocking reads in those steps
    rec.spans[0].attrs             # e.g. the items the first step took

Each `Span` keeps its name, `start_ns` and `end_ns`, the index in
`rec.spans` of the span that was open around it on the same thread
(`parent`, -1 at the top) and its attributes. Times are epoch
nanoseconds (`time.time_ns()`), the host clock of `torch.profiler`'s
events: where a profile runs too, each recorded span also enters
`record_function(name)`, so the program's spans lie on the profile's
timeline beside the device's work, and a span's interval brackets its
`record_function` event. The spans of one recording stay in memory, at
most `max_spans` of them; the rest are counted in `rec.dropped`.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Tuple

import torch

MAX_SPANS = 1 << 20


class Span:
    """One recorded span, and the context manager that closes it."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "attrs", "_stack",
                 "_rf")
    live = True

    def __init__(self, name: str, parent: int, attrs: Dict,
                 stack: List[int]):
        self.name, self.parent, self.attrs = name, parent, attrs
        self._stack = stack
        self._rf = None
        self.end_ns: Optional[int] = None
        self.start_ns = time.time_ns()
        if torch.autograd._profiler_enabled():
            self._rf = torch.autograd.profiler.record_function(name)
            self._rf.__enter__()

    def set(self, **attrs) -> None:
        """Add attributes known only once the span is open."""
        self.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self.end_ns = time.time_ns()
        self._stack.pop()
        return False


class _NoSpan:
    """What `span` returns with no recording open: does nothing."""

    __slots__ = ()
    live = False

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


class Recording:
    """The spans recorded while `recording()` was open."""

    def __init__(self, max_spans: int = MAX_SPANS):
        self.spans: List[Span] = []
        self.max_spans = max_spans
        self.dropped = 0  # spans past `max_spans`, not kept
        self._stacks: Dict[int, List[int]] = {}  # thread -> open spans
        self._lock = threading.Lock()

    def _start(self, name: str, attrs: Dict):
        stack = self._stacks.setdefault(threading.get_ident(), [])
        with self._lock:
            i = len(self.spans)
            if i >= self.max_spans:
                self.dropped += 1
                return NO_SPAN
            sp = Span(name, stack[-1] if stack else -1, attrs, stack)
            self.spans.append(sp)
        stack.append(i)
        return sp

    def summary(self) -> Dict[str, Tuple[int, float, float]]:
        """name -> (spans, total seconds, self seconds) over the closed
        spans; self time is a span's duration less its children's."""
        child = [0] * len(self.spans)
        for sp in self.spans:
            if sp.end_ns is not None and sp.parent >= 0:
                child[sp.parent] += sp.end_ns - sp.start_ns
        out: Dict[str, Tuple[int, float, float]] = {}
        for i, sp in enumerate(self.spans):
            if sp.end_ns is None:
                continue
            n, total, own = out.get(sp.name, (0, 0.0, 0.0))
            d = sp.end_ns - sp.start_ns
            out[sp.name] = (n + 1, total + d * 1e-9,
                            own + (d - child[i]) * 1e-9)
        return out


_open: Optional[Recording] = None


def span(name: str, **attrs):
    """A context manager timing the block it wraps, as a child of the
    span open around it on this thread; a shared no-op with no recording
    open."""
    rec = _open
    if rec is None:
        return NO_SPAN
    return rec._start(name, attrs)


@contextmanager
def recording(max_spans: int = MAX_SPANS) -> Iterator[Recording]:
    """Record every span of the process while open (one recording at a
    time)."""
    global _open
    if _open is not None:
        raise RuntimeError("a span recording is already open")
    rec = Recording(max_spans)
    _open = rec
    try:
        yield rec
    finally:
        _open = None
