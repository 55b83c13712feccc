"""The mixed direct/iterative solve of examples/pcg_sample.py (the
reference's PCG_Sample.cpp) through the port's entry points, shared by
tests/test_torch_pcg.py and chip_smoke.py:

  factor_up_to(t) -> solve_l_up_to -> preconditioner init -> pcg on the
  corner with add_mv_from(part, t) as the operator -> solve_lt_up_to

t is a span index, by default the end of the sparse elimination range.
"""

from __future__ import annotations

import torch

from .. import optimizer


def pcg_flow(solver, data, rhs, precond: str, t=None, tol: float = 1e-10,
             max_iters: int = 100, mark=None):
    """Solves M x = rhs (1-D) for the matrix held in `data` with the
    preconditioner named `precond` (a class of
    baspacho_tpu_torch.optimizer). `mark(stage)`, when given, is called
    after the stages "up_to" (factor_up_to and solve_l_up_to), "init"
    and "pcg". Returns (x, iterations, final |r|^2)."""
    if t is None:
        t = solver.sparse_elim_ranges[-1]
    o = solver.span_vector_offset(t)
    part = solver.factor_up_to(data, t)
    v = solver.solve_l_up_to(part, t, rhs)
    pre = getattr(optimizer, precond)(solver, t)
    if mark:
        mark("up_to")
    pre.init(part)
    if mark:
        mark("init")

    def embed(x):
        full = torch.zeros_like(v)
        full[o:] = x
        return full

    x, r2, it = optimizer.pcg(
        lambda r: pre.apply(embed(r))[o:],
        lambda p: solver.add_mv_from(part, t, embed(p),
                                     torch.zeros_like(v))[o:],
        v[o:], tol, max_iters)
    if mark:
        mark("pcg")
    v = v.clone()
    v[o:] = x
    return solver.solve_lt_up_to(part, t, v), it, float(r2)
