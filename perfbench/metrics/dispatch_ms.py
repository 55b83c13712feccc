"""dispatch_ms: host ms inside the port's factor and solve calls before
they return (the solver facade and the PLANNED runners enqueueing their
launches), by the host clock around the step's "factor" and "solve"
spans, mean per step of the measured window."""


def read(run):
    if not run.steps or "factor" not in run.span_s:
        return None
    return (run.span_s["factor"] + run.span_s.get("solve", 0.0)) \
        / run.steps * 1e3
