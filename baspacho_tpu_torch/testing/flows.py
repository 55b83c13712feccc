"""Flows through the port's entry points, shared by the tests that hold
them against the JAX package and by chip_smoke.py, which runs them on
the card.

pcg_flow: the mixed direct/iterative solve of examples/pcg_sample.py
(the reference's PCG_Sample.cpp):

  factor_up_to(t) -> solve_l_up_to -> preconditioner init -> pcg on the
  corner with add_mv_from(part, t) as the operator -> solve_lt_up_to

t is a span index, by default the end of the sparse elimination range.

ba_optimizer, ba_settings: Levenberg-Marquardt on a BAL problem
(examples/optimize_ba.py, the reference's OptimizeBaAtLarge.cpp):
build_ba_optimizer -> build_solver -> optimize, directly or with the
partial factor + PCG.
"""

from __future__ import annotations

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
    x, it, r2 = optimizer.mixed_solve(
        solver, data, rhs, getattr(optimizer, precond), t, tol, max_iters,
        mark=mark)
    return x, it, float(r2)


def ba_settings(backend, max_iters: int, pcg: bool = False, **kw):
    """OptimizerSettings of the BA flows: the direct solve, or the partial
    factor + PCG with BlockJacobiPrecond (tol 1e-10, 80 iterations, as
    tests/test_bal.py runs it)."""
    if pcg:
        kw = {"use_pcg": True, "precond": optimizer.BlockJacobiPrecond,
              "pcg_tol": 1e-10, "pcg_max_iters": 80, **kw}
    return optimizer.OptimizerSettings(max_iters=max_iters, backend=backend,
                                       **kw)


def ba_optimizer(problem, settings, device, huber: float = -1.0,
                 mark=None):
    """The BA optimizer of a BAL problem, solver built: build_ba_optimizer
    (Schur-eliminated points, the first camera held by a prior) on
    `device`, then build_solver(settings). `mark` is the optimizer's
    stage callback during the build (Optimizer.mark). LM is then
    opt.optimize(settings)."""
    from ..bal import build_ba_optimizer
    opt, _, _ = build_ba_optimizer(problem, huber=huber, device=device)
    opt.mark = mark
    opt.build_solver(settings)
    opt.mark = None
    return opt


def dense_normal_equations(opt, values):
    """(g, H) = (J^T r, J^T J) of the whole graph at `values`, computed
    densely, independently of the assembly: one forward-mode Jacobian of
    all residuals, concatenated, with respect to one tangent vector of
    all variables in user order, then mapped into the solver's internal
    order (H in the layout of skel.densify(hdata, fill_upper_half=True)).
    Trivial losses only (the weights are not differentiated). numpy f64."""
    import numpy as np
    import torch

    fams = opt.families
    live = [i for i, f in enumerate(fams) if not f.fixed]
    sizes = [fams[i].count * fams[i].tangent_dim for i in live]
    starts = dict(zip(live, np.cumsum([0] + sizes[:-1]).tolist()))

    def residuals(delta):
        vals = []
        for i, f in enumerate(fams):
            v = values[i]
            if i in starts:
                d = delta[starts[i]:starts[i] + sizes[live.index(i)]]
                v = torch.func.vmap(f.tangent_step)(
                    v, d.reshape(f.count, f.tangent_dim))
            vals.append(v)
        out = []
        for ff, (ixs, _) in zip(opt.factor_families, opt._plans):
            vs = tuple(vals[f][ix] for (f, _), ix in zip(ff.slots, ixs))
            out.append(torch.func.vmap(
                lambda v, c: ff.residual_fn(*v, *c))(vs, ff.consts)
                .reshape(-1))
        return torch.cat(out)

    delta = torch.zeros(sum(sizes), dtype=values[0].dtype,
                        device=values[0].device)
    J = torch.func.jacfwd(residuals)(delta).cpu().double().numpy()
    r = residuals(delta).cpu().double().numpy()
    # user-order tangent index -> internal vector index
    acc = opt.solver.accessor()
    internal = np.concatenate([
        (np.asarray(acc.param_start(opt._fam_base[i] +
                                    np.arange(fams[i].count)))[:, None] +
         np.arange(fams[i].tangent_dim)).reshape(-1) for i in live])
    g = np.zeros(opt.solver.order)
    g[internal] = J.T @ r
    H = np.zeros((opt.solver.order, opt.solver.order))
    H[np.ix_(internal, internal)] = J.T @ J
    return g, H


def k6_vs_twin(opt, terms, dtype):
    """K6 against its plain twin on an optimizer's assembly: `terms`
    from opt.jacobians, cast to `dtype`, through kernels.grad_hess twice
    and grad_hess_twin once, each into fresh buffers. Returns (max |k -
    t| / max |t| over the Hessian data and the gradient, max |k - t|,
    whether the two kernel runs gave the same bits)."""
    import torch

    from ..ops import kernels
    s, dev = opt.solver, terms[0][1].device
    bufs = [(torch.zeros(s.data_size, dtype=dtype, device=dev),
             torch.zeros(s.order, dtype=dtype, device=dev))
            for _ in range(3)]
    for (_, W), (_, plan) in zip(terms, opt._plans):
        W = W.to(dtype).contiguous()
        kernels.grad_hess(W, *bufs[0], plan)
        kernels.grad_hess_twin(W, *bufs[1], plan)
        kernels.grad_hess(W, *bufs[2], plan)
    rel, absd = 0.0, 0.0
    for k, t in zip(bufs[0], bufs[1]):
        d = float((k - t).abs().max())
        rel, absd = max(rel, d / float(t.abs().max())), max(absd, d)
    bitwise = all(torch.equal(a, b) for a, b in zip(bufs[0], bufs[2]))
    return rel, absd, bitwise
