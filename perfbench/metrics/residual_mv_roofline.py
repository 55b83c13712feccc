"""residual_mv_roofline: the least time of a step's refinement mat-vecs
(their bytes, from the step module's work: `matvecs` of the refined
solve, perfbench/steps/refine.py, over the card's bytes/s in
perfbench/peaks.json; the mat-vecs are bound by bytes) over the device
time the port launched in its `refine.residual` spans (K5 and K2 over
the whole matrix, and the subtraction from b), in %. Nothing where the
steps refine nothing, the port has no such span or the card has no
peaks."""

from perfbench import harness


def read(run):
    w = getattr(run.work.get("solve"), "matvecs", None)
    if w is None or not w.bytes or run.peak is None:
        return None
    ms = harness.reader("refine_residual_ms")(run)
    if ms is None:
        return None
    return 100.0 * (w.bytes / run.peak[1]) / (ms * 1e-3)
