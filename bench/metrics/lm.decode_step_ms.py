"""Milliseconds a decode step: the synchronised host time of every batch's
decode steps in the window over their count."""


def read(out):
    s, n = out.records.get("decode_s"), out.counters.get("decode_steps")
    return 1e3 * sum(s) / n if s and n else None
