"""Mean host milliseconds of a `ServeEngine.step()` over the window."""


def read(out):
    s = out.records.get("step_s")
    return 1e3 * sum(s) / len(s) if s else None
