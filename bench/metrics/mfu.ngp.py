"""The whole step's share of the card's int8 peak: the five quantized
linears' operations over the active samples of the window's frames, over
the window's time at 1,979 TOP/s."""
from bench.lib.costs import PEAK_OPS


def read(out):
    ops = out.work.get("ngp_field_ops")
    return None if not ops else 100.0 * ops / (out.window_s
                                               * PEAK_OPS["int8"])
