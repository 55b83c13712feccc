"""device_idle_pct: 1 - the union of device intervals over the traced
steps' span (first step's start to last step's end on the host), in %."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
