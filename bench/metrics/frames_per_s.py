"""Frames completed in the window over the window's whole time (the
window closes at the first engine step that ends after its length)."""


def read(out):
    n = out.counters.get("frames")
    return None if not n else n / out.window_s
