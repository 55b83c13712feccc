"""input_copy_ms: device ms per step of the work the port launched in
its `factor.input` and `solve.input` spans (the factor's copy of its
input and the padding's fill, the solve's copy of its right-hand side;
baspacho_tpu_torch/trace.py), the union of those records' intervals,
given to the innermost span by launch correlation, over the program
segment's profiled steps (perfbench/segment.py). Nothing where the port
has no such span."""

from perfbench import segment
from perfbench.trace import union

SPANS = ("baspacho.factor.input", "baspacho.solve.input")


def read(run):
    s = segment.of(run)
    t = None if s is None else s.trace
    if t is None:
        return None
    iv = [x for name in SPANS for x in t.port_iv.get(name, [])]
    if not iv:
        return None
    return union(iv) * 1e-6 / t.steps * 1e3
