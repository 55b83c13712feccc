"""solve_roofline: the least time of a solve (perfbench/work.py, from
the skeleton) over the device time of the work the solve call launched
(the profiler's launch correlation), in %. Nothing where the card has no
peaks in perfbench/peaks.json."""

from perfbench.work import least_seconds


def read(run):
    t, w = run.trace, run.work.get("solve")
    if t is None or w is None or run.peak is None:
        return None
    dev = t.device_s_by_span.get("solve")
    if not dev:
        return None
    return 100.0 * least_seconds(w, run.peak) / (dev / t.steps)
