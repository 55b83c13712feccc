"""refine_ms: device ms per step of the work the port launched inside its
`refine` span (Solver.solve_refined: the casts, the residuals' mat-vecs
and the solves nested in it; baspacho_tpu_torch/trace.py), the union of
those records' intervals over the program segment's profiled steps
(perfbench/segment.py). The segment gives each record to the innermost
span by name only, so the nested `solve` and `solve.input` records count
here only where every solve of the counted steps lies inside `refine`.
Nothing where the port has no such span."""

from perfbench import segment
from perfbench.trace import union

INSIDE = ("refine", "refine.residual", "refine.cast", "solve",
          "solve.input")


def read(run):
    s = segment.of(run)
    t = None if s is None else s.trace
    if t is None:
        return None
    spans = s.counted.spans
    if not any(name == "refine" for name, *_ in spans):
        return None
    if any(name == "solve" and (p is None or spans[p][0] != "refine")
           for name, _, _, p, _ in spans):
        return None
    iv = [x for name in INSIDE
          for x in t.port_iv.get(segment.PORT_PREFIX + name, [])]
    if not iv:
        return None
    return union(iv) * 1e-6 / t.steps * 1e3
