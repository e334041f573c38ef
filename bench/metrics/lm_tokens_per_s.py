"""Prompt positions (patches and text) and generated tokens of the
batches completed in the window, over the window's whole time (the
window closes at the first batch end after its length)."""


def read(out):
    n = out.counters.get("tokens")
    return None if not n else n / out.window_s
