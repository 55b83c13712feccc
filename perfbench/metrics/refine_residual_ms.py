"""refine_residual_ms: device ms per step of the work the port launched
in its `refine.residual` spans (each refinement round's block mat-vec,
K5 with K2 for the rows below, and the subtraction from the right-hand
side; baspacho_tpu_torch/trace.py), the union of those records'
intervals over the program segment's profiled steps
(perfbench/segment.py). Nothing where the port has no such span."""

from perfbench import segment
from perfbench.trace import union

SPAN = segment.PORT_PREFIX + "refine.residual"


def read(run):
    s = segment.of(run)
    t = None if s is None else s.trace
    iv = None if t is None else t.port_iv.get(SPAN)
    if not iv:
        return None
    return union(iv) * 1e-6 / t.steps * 1e3
