"""Attention's kernels against their roofline in the traced window: the
least time of the batches' causal prefill attention and cache decode
(`bench/lib/costs.py`, from the shapes), over the device time of kernel
6's and kernel 7's launches, by name."""
KERNELS = ("flash_tc_kernel", "flash_tcp_kernel", "flash_f32_kernel",
           "decode_kernel")


def read(out):
    need = out.work.get("attention_s")
    if out.trace is None or not need:
        return None
    took = out.trace.seconds(*KERNELS)
    return 100.0 * need / took if took > 0 else None
