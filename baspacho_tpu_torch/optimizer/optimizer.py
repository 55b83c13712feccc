"""Levenberg-Marquardt optimizer over a typed factor graph.

Port of baspacho_tpu/optimizer/optimizer.py (the reference's
examples/Optimizer.h): variables live in homogeneous families of stacked
(N, data_dim) tensors with a manifold trait, factors in factor families
(one residual function vmapped over the family's factors), Jacobians
come from forward-mode autodiff through the retraction
(torch.func.vmap(torch.func.jacfwd(...))), and the gradient / Hessian
assembly is K6 (ops/kernels.py `grad_hess`, csrc/grad_hess.cu): a
segmented reduction over a destination-sorted plan built once per
optimizer (ops/assembly.py), without atomics, so the assembled buffers
are the same bits from run to run. The LM accept / reject loop runs on
the host with one readback per trial cost, as in the JAX package.

Schur trick: families registered in `elim_families` are ordered first
and their span range is passed to create_solver as a sparse elimination
range (landmark elimination in BA). The solve can run the partial factor
+ PCG on the reduced system with a choice of preconditioner (reference
Optimizer.h:670-764 "solveFunction").

The optimizer runs on the CUDA card unless a device is named
(`Optimizer(device=...)`; solver.resolve_device): without a card and
without a device, build_solver raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import kernels
from ..ops.assembly import build_family_assembly
from ..solver import BackendType, Settings, create_solver, resolve_device
from ..sparse_structure import _csr_from_pairs
from .pcg import pcg
from .preconditioner import IdentityPrecond
from .soft_loss import TrivialLoss


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


class VariableFamily:
    """Homogeneous stacked variables. Euclidean by default; pass
    `tangent_dim`/`tangent_step` for manifold types (e.g. SE3)."""

    def __init__(self, values, tangent_dim: Optional[int] = None,
                 tangent_step: Optional[Callable] = None,
                 fixed: bool = False, name: str = ""):
        self.values = _tensor(values)
        assert self.values.ndim == 2
        self.count = self.values.shape[0]
        self.data_dim = self.values.shape[1]
        self.tangent_dim = tangent_dim or self.data_dim
        self.tangent_step = tangent_step or (lambda v, d: v + d)
        self.fixed = fixed
        self.name = name


@dataclass
class _FactorFamily:
    residual_fn: Callable            # (*var_values, *consts) -> (rdim,)
    slots: List[Tuple[int, np.ndarray]]  # (family_id, (F,) indices)
    consts: tuple
    loss: object
    rdim: int


@dataclass
class OptimizerSettings:
    max_iters: int = 50
    init_damping: float = 1e-5
    damping_up: float = 4.0
    damping_down: float = 0.5
    max_damping: float = 1e8
    cost_rel_tol: float = 1e-8
    step_norm_tol: float = 1e-10
    use_pcg: bool = False            # partial factor + PCG on the corner
    pcg_tol: float = 1e-6
    pcg_max_iters: int = 50
    precond: Callable = IdentityPrecond  # precond factory (solver, span)
    backend: BackendType = BackendType.REF
    verbose: bool = False
    # also add lambda to the damped diagonal: diag * (1 + lambda) +
    # lambda, the reference's lambda * (1 + diag) (Optimizer.h:599-606).
    # The JAX package multiplies only, which leaves the zero block of a
    # variable no factor touches singular (BAL 871's last camera): off
    # by default, so the port follows the JAX package
    damp_additive: bool = False


def mixed_solve(solver, data, rhs, precond, t: int, tol: float,
                max_iters: int, mark=None):
    """Solves M x = rhs by the partial factor up to span t and PCG on the
    corner (reference Optimizer.h:670-764, PCG_Sample.cpp):
    factor_up_to(t) -> solve_l_up_to -> preconditioner init -> pcg with
    add_mv_from(part, t) as the operator -> solve_lt_up_to. `precond` is
    a preconditioner factory (solver, span). `mark(stage)`, when given,
    is called after the stages "up_to", "init" and "pcg". Returns (x,
    iterations, final |r|^2)."""
    o = solver.span_vector_offset(t)
    part = solver.factor_up_to(data, t)
    v = solver.solve_l_up_to(part, t, rhs)
    pre = precond(solver, t)
    if mark:
        mark("up_to")
    pre.init(part)
    if mark:
        mark("init")

    def embed(x):
        full = torch.zeros_like(v)
        full[o:] = x
        return full

    x, r2, it = pcg(
        lambda r: pre.apply(embed(r))[o:],
        lambda p: solver.add_mv_from(part, t, embed(p),
                                     torch.zeros_like(v))[o:],
        v[o:], tol, max_iters)
    if mark:
        mark("pcg")
    v = v.clone()
    v[o:] = x
    return solver.solve_lt_up_to(part, t, v), it, r2


class Optimizer:
    # factors per chunk of the Jacobian evaluation: vmap(jacfwd) over a
    # whole 2.6M-observation family would hold tens of GB of forward-mode
    # intermediates. Chunks write into one preallocated buffer and K6
    # runs once over the family, so the result does not depend on it.
    CHUNK_OBS = 131072

    def __init__(self, device=None):
        self.families: List[VariableFamily] = []
        self.factor_families: List[_FactorFamily] = []
        self.elim_families: List[int] = []
        self._device_arg = device
        # called with a stage name at each stage boundary, for timing:
        # "create_solver", "assembly_plans" in build_solver; "jacobians",
        # "assembly", "damp_factor", "solve", "retract_cost" in the LM
        # loop. None to skip
        self.mark: Optional[Callable[[str], None]] = None

    def _mark(self, stage: str) -> None:
        if self.mark is not None:
            self.mark(stage)

    # -- graph construction ---------------------------------------------
    def add_variable_family(self, family: VariableFamily) -> int:
        self.families.append(family)
        return len(self.families) - 1

    def add_factor_family(self, residual_fn: Callable,
                          slots: Sequence[Tuple[int, Sequence[int]]],
                          consts: tuple = (), loss=None) -> int:
        slots = [(int(f), np.asarray(ix, dtype=np.int64))
                 for f, ix in slots]
        n = len(slots[0][1])
        for _, ix in slots:
            assert len(ix) == n
        consts = tuple(_tensor(c) for c in consts)
        # probe residual dimension on the first factor
        vals = [self.families[f].values[int(ix[0])] for f, ix in slots]
        r = residual_fn(*vals, *(c[0] for c in consts))
        rdim = int(r.shape[0])
        self.factor_families.append(_FactorFamily(
            residual_fn=residual_fn, slots=slots, consts=consts,
            loss=loss or TrivialLoss(), rdim=rdim))
        return len(self.factor_families) - 1

    def set_elimination_families(self, family_ids: Sequence[int]) -> None:
        """These families' variables are ordered first and Schur-eliminated
        inside the solver (sparse elimination range)."""
        self.elim_families = list(family_ids)

    # -- solver construction --------------------------------------------
    def _global_order(self):
        """Order families: eliminated first, then the rest (fixed families
        get no params)."""
        order = list(self.elim_families) + \
            [i for i in range(len(self.families))
             if i not in self.elim_families]
        fam_base = {}
        sizes = []
        nxt = 0
        for fi in order:
            fam = self.families[fi]
            if fam.fixed:
                continue
            fam_base[fi] = nxt
            nxt += fam.count
            sizes.extend([fam.tangent_dim] * fam.count)
        return fam_base, np.array(sizes, dtype=np.int64), order

    def build_solver(self, settings: OptimizerSettings):
        """The solver of the graph's Hessian structure on the optimizer's
        device (default: the CUDA card; without one it raises), and the
        assembly plans. Moves the variables, consts and indices there."""
        self.device = resolve_device(self._device_arg)
        fam_base, param_sizes, order = self._global_order()
        self._fam_base = fam_base
        n = len(param_sizes)
        rows = [np.arange(n, dtype=np.int64)]
        cols = [np.arange(n, dtype=np.int64)]
        for ff in self.factor_families:
            gids = [fam_base[f] + ix for f, ix in ff.slots
                    if not self.families[f].fixed]
            for a in range(len(gids)):
                for b in range(a + 1, len(gids)):
                    hi = np.maximum(gids[a], gids[b])
                    lo = np.minimum(gids[a], gids[b])
                    rows.append(hi)
                    cols.append(lo)
        ss = _csr_from_pairs(np.concatenate(rows), np.concatenate(cols), n)

        elim_count = sum(self.families[f].count for f in self.elim_families
                         if not self.families[f].fixed)
        elim_ranges = [0, elim_count] if elim_count else []
        self.solver = create_solver(
            Settings(backend=settings.backend), param_sizes, ss,
            sparse_elim_ranges=elim_ranges, device=self.device)
        self._mark("create_solver")
        self.elim_end_span = elim_count
        for fam in self.families:
            fam.values = fam.values.to(self.device)
        for ff in self.factor_families:
            ff.consts = tuple(c.to(self.device) for c in ff.consts)
        self._build_assembly_plans()
        self._mark("assembly_plans")
        return self.solver

    def _build_assembly_plans(self):
        """Per factor family: the factors' variable indices on the device
        and K6's plan (ops/assembly.py): internal vector offsets and
        Hessian block (offset, stride, flip) from the solver's permuted
        accessor, sorted by destination."""
        acc = self.solver.accessor()
        dev = self.device
        self._plans = []
        for ff in self.factor_families:
            F = len(ff.slots[0][1])
            vec_offs = []
            for f, ix in ff.slots:
                if self.families[f].fixed:
                    vec_offs.append(None)
                    continue
                gid = self._fam_base[f] + ix
                vec_offs.append(np.asarray(acc.param_start(gid),
                                           dtype=np.int64))
            pairs = []
            live = [k for k, v in enumerate(vec_offs) if v is not None]
            for a_i, k in enumerate(live):
                for l in live[a_i:]:
                    fk, ixk = ff.slots[k]
                    fl, ixl = ff.slots[l]
                    gk = self._fam_base[fk] + ixk
                    gl = self._fam_base[fl] + ixl
                    if k == l:
                        off, stride = acc.diag_block_offset(gk)
                        flip = np.zeros(len(gk), dtype=bool)
                    else:
                        off, stride, flip = acc.block_offsets(gk, gl)
                    pairs.append((k, l, off, stride, flip))
            tdims = [self.families[f].tangent_dim for f, _ in ff.slots]
            ixs = [torch.from_numpy(ix).to(dev) for _, ix in ff.slots]
            self._plans.append((ixs, build_family_assembly(
                F, ff.rdim, tdims, vec_offs, pairs, dev)))

    # -- cost / grad / hessian ------------------------------------------
    def _family_terms(self, values_list, ff: _FactorFamily, ixs, a: int,
                      b: int):
        """Factors a..b of a family: their per-factor cost val(|r|^2) and
        the weighted residual and per-slot Jacobians (vmap of jacfwd
        through each slot's tangent step at zero)."""
        vals = tuple(values_list[f][ix[a:b]]
                     for (f, _), ix in zip(ff.slots, ixs))
        consts = tuple(c[a:b] for c in ff.consts)
        steps = [self.families[f].tangent_step for f, _ in ff.slots]
        tdims = [self.families[f].tangent_dim for f, _ in ff.slots]
        dtype = vals[0].dtype

        def local(deltas, vs, cs):
            stepped = [s(v, d) for s, v, d in zip(steps, vs, deltas)]
            r = ff.residual_fn(*stepped, *cs)
            return r, r

        def one(vs, cs):
            zeros = tuple(torch.zeros(td, dtype=dtype, device=vs[0].device)
                          for td in tdims)
            jacs, r = torch.func.jacfwd(local, argnums=0, has_aux=True)(
                zeros, vs, cs)
            return r, jacs

        r, jacs = torch.func.vmap(one)(vals, consts)
        s = torch.sum(r * r, dim=-1)
        sw = torch.sqrt(ff.loss.weight(s))
        return (ff.loss.val(s), r * sw[:, None],
                [j * sw[:, None, None] for j in jacs])

    def compute_cost(self, values_list):
        """Total cost sum over factors of 0.5 * loss(|r|^2), as a 0-d
        tensor on the device."""
        total = 0.0
        for ff, (ixs, _) in zip(self.factor_families, self._plans):
            vals = tuple(values_list[f][ix]
                         for (f, _), ix in zip(ff.slots, ixs))
            r = torch.func.vmap(lambda vs, c: ff.residual_fn(*vs, *c))(
                vals, tuple(ff.consts))
            total = total + 0.5 * torch.sum(
                ff.loss.val(torch.sum(r * r, dim=-1)))
        return total

    def jacobians(self, values_list):
        """Per factor family, (per-factor cost val(|r|^2) (F,), W (F,
        rdim, tdw)): the live slots' weighted Jacobians side by side and
        the weighted residual as the last column, in the values' dtype,
        evaluated CHUNK_OBS factors at a time."""
        out = []
        for ff, (ixs, plan) in zip(self.factor_families, self._plans):
            F = len(ff.slots[0][1])
            live = [k for k, (f, _) in enumerate(ff.slots)
                    if not self.families[f].fixed]
            dt = values_list[ff.slots[0][0]].dtype
            W = torch.empty((F, ff.rdim, plan.tdw), dtype=dt,
                            device=self.device)
            vals = torch.empty(F, dtype=dt, device=self.device)
            for a in range(0, F, self.CHUNK_OBS):
                b = min(F, a + self.CHUNK_OBS)
                v, r, jacs = self._family_terms(values_list, ff, ixs, a, b)
                vals[a:b] = v
                c = 0
                for k in live:
                    td = jacs[k].shape[-1]
                    W[a:b, :, c:c + td] = jacs[k]
                    c += td
                W[a:b, :, c] = r
            out.append((vals, W))
        return out

    def assemble(self, terms, dtype):
        """(cost, grad, hdata) from `jacobians`' output: K6 once per
        family, in family order, into zeroed buffers."""
        solver = self.solver
        hdata = torch.zeros(solver.data_size, dtype=dtype,
                            device=self.device)
        grad = torch.zeros(solver.order, dtype=dtype, device=self.device)
        cost = 0.0
        for (vals, W), (_, plan) in zip(terms, self._plans):
            kernels.grad_hess(W.to(dtype).contiguous(), hdata, grad, plan)
            cost = cost + 0.5 * torch.sum(vals)
        return cost, grad, hdata

    def compute_grad_hess(self, values_list, dtype=None):
        """(cost, grad, hdata): the Jacobians, then K6."""
        dt = dtype or values_list[0].dtype
        terms = self.jacobians(values_list)
        self._mark("jacobians")
        out = self.assemble(terms, dt)
        self._mark("assembly")
        return out

    # -- diagnostics ------------------------------------------------------
    def verify_jacobians(self, epsilon: float = 1e-5,
                         max_relative_error: float = 1e-3,
                         n_check: int = 100, verbose: bool = False) -> bool:
        """Check each factor family's Jacobians against central finite
        differences through the manifold retraction, on up to `n_check`
        factors per family (reference Optimizer.h:247-320
        verifyJacobians). Returns True when every column's relative error
        stays below `max_relative_error`."""
        ok = True
        for fi, ff in enumerate(self.factor_families):
            F = len(ff.slots[0][1])
            m = min(F, n_check)
            steps = [self.families[f].tangent_step for f, _ in ff.slots]
            tdims = [self.families[f].tangent_dim for f, _ in ff.slots]

            def local(deltas, vs, cs):
                stepped = [s(v, d) for s, v, d in zip(steps, vs, deltas)]
                return ff.residual_fn(*stepped, *cs)

            max_rel = [np.zeros(td) for td in tdims]
            for k in range(m):
                vs = tuple(self.families[f].values[int(ix[k])]
                           for f, ix in ff.slots)
                cs = tuple(c[k] for c in ff.consts)
                dt, dev = vs[0].dtype, vs[0].device
                zeros = tuple(torch.zeros(td, dtype=dt, device=dev)
                              for td in tdims)
                jacs = torch.func.jacfwd(local, argnums=0)(zeros, vs, cs)
                for i, td in enumerate(tdims):
                    jac = jacs[i].detach().cpu().double().numpy()
                    for t in range(td):
                        dp = [torch.zeros(d, dtype=dt, device=dev)
                              for d in tdims]
                        dp[i][t] = epsilon
                        rp = local(tuple(dp), vs, cs).cpu().double().numpy()
                        dp[i][t] = -epsilon
                        rm = local(tuple(dp), vs, cs).cpu().double().numpy()
                        num = (rp - rm) / (2 * epsilon)
                        rel = np.linalg.norm(num - jac[:, t]) / (
                            np.linalg.norm(num) + epsilon)
                        max_rel[i][t] = max(max_rel[i][t], rel)
            fam_ok = all(float(mr.max(initial=0.0)) <= max_relative_error
                         for mr in max_rel)
            ok = ok and fam_ok
            if verbose or not fam_ok:
                print(f"factor family {fi}: checked {m}/{F} factors, "
                      f"max col rel errors "
                      f"{[np.round(mr, 6).tolist() for mr in max_rel]} "
                      f"{'OK' if fam_ok else 'FAIL'}")
        return ok

    # -- step -----------------------------------------------------------
    def apply_step(self, values_list, step_vec):
        """Retract tangent step (internal ordering) onto each family."""
        if getattr(self, "_step_idx", None) is None:
            acc = self.solver.accessor()
            self._step_idx = []
            for fi, fam in enumerate(self.families):
                if fam.fixed:
                    self._step_idx.append(None)
                    continue
                gid = self._fam_base[fi] + np.arange(fam.count)
                vec_off = np.asarray(acc.param_start(gid), dtype=np.int64)
                self._step_idx.append(torch.from_numpy(
                    vec_off[:, None] + np.arange(fam.tangent_dim)[None, :])
                    .to(self.device))
        out = list(values_list)
        for fi, fam in enumerate(self.families):
            idx = self._step_idx[fi]
            if idx is None:
                continue
            out[fi] = torch.func.vmap(fam.tangent_step)(values_list[fi],
                                                        step_vec[idx])
        return out

    def _solve(self, hdata, grad, settings: OptimizerSettings):
        """The LM step: a direct factor + solve, or the partial factor +
        PCG on the corner (mixed_solve). Returns (step, PCG iterations or
        None)."""
        solver = self.solver
        if not settings.use_pcg or self.elim_end_span == 0:
            f = solver.factor(hdata)
            self._mark("damp_factor")
            return solver.solve(f, -grad), None
        x, it, _ = mixed_solve(
            solver, hdata, -grad, settings.precond, self.elim_end_span,
            settings.pcg_tol, settings.pcg_max_iters,
            mark=lambda st: st == "up_to" and self._mark("damp_factor"))
        return x, it

    # -- LM loop --------------------------------------------------------
    def optimize(self, settings: OptimizerSettings = OptimizerSettings()):
        if not hasattr(self, "solver"):
            self.build_solver(settings)
        values = [f.values for f in self.families]
        lam = settings.init_damping
        stats = {"iters": 0, "costs": [], "pcg_iters": []}
        cost, grad, hdata = self.compute_grad_hess(values)
        cost = float(cost)
        stats["costs"].append(cost)
        damp_idx = torch.from_numpy(self.solver.skel.damp_indices()) \
            .to(self.device)
        for it in range(settings.max_iters):
            accepted = False
            new_cost = cost  # stays = cost if no trial step ever runs
            while lam <= settings.max_damping:
                damped = hdata.clone()
                damped[damp_idx] *= 1.0 + lam
                if settings.damp_additive:
                    damped[damp_idx] += lam
                step, pcg_it = self._solve(damped, grad, settings)
                self._mark("solve")
                if pcg_it is not None:
                    stats["pcg_iters"].append(pcg_it)
                new_values = self.apply_step(values, step)
                new_cost = float(self.compute_cost(new_values))
                self._mark("retract_cost")
                if np.isfinite(new_cost) and new_cost < cost:
                    accepted = True
                    break
                lam *= settings.damping_up
            if settings.verbose:
                print(f"iter {it}: cost {cost:.6e} -> {new_cost:.6e} "
                      f"lambda {lam:.1e} "
                      f"{':)' if accepted else ':('}")
            if not accepted:
                break
            step_norm = float(torch.linalg.norm(step))
            rel_decrease = (cost - new_cost) / max(abs(cost), 1e-30)
            values = new_values
            cost = new_cost
            stats["costs"].append(cost)
            stats["iters"] = it + 1
            lam = max(lam * settings.damping_down, 1e-12)
            cost2, grad, hdata = self.compute_grad_hess(values)
            if rel_decrease < settings.cost_rel_tol or \
                    step_norm < settings.step_norm_tol:
                break
        for fam, v in zip(self.families, values):
            fam.values = v
        stats["final_cost"] = cost
        return stats
