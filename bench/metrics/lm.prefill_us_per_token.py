"""Microseconds a prompt position: the synchronised host time of every
prefill in the window over the positions they prefilled."""


def read(out):
    s, n = out.records.get("prefill_s"), out.counters.get("prefill_positions")
    return 1e6 * sum(s) / n if s and n else None
