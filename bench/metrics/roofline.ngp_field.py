"""The field's kernels against their roofline in the traced window: the
least time the work of the window's slots needs (the active samples'
encode, five quantized linears, march and gather-composite, counted by
`bench/lib/costs.py` from what the inputs need), over the device time of
the kernels that did it, by name."""
KERNELS = ("qmm_packed_kernel", "hash_encode_kernel",
           "hash_encode_corners_kernel", "ray_march_kernel",
           "gather_composite_kernel")


def read(out):
    need = out.work.get("ngp_field_s")
    if out.trace is None or not need:
        return None
    took = out.trace.seconds(*KERNELS)
    return 100.0 * need / took if took > 0 else None
