"""The whole step's share of the card's bf16 peak: the model FLOPs of the
window's batches by the configuration (`bench/drivers/lm.py`,
`model_flops`), over the window's time at 989 TFLOP/s."""
from bench.lib.costs import PEAK_OPS


def read(out):
    flops = out.work.get("lm_flops")
    return None if not flops else 100.0 * flops / (out.window_s
                                                   * PEAK_OPS["bf16"])
