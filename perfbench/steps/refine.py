"""refine: the solver's share of one LM iteration in mixed precision on a
structure fixed at set-up, one closed-loop client.

A step re-damps the held matrix (kept in the configuration's
"matrix_dtype", float64) with the step's lambda, as refactor does, casts
it to the factor's precision (the configuration's "dtype", float32),
factors the cast (Solver.factor), brings the solution of the held
right-hand side, one column, back to the matrix's precision by iterative
refinement (Solver.solve_refined with the traffic's rounds: a solve, then
each round a residual b - A x by the block mat-vec at the matrix's
precision and a correcting solve at the factor's), and synchronises.
Every step does the same work whatever the seed.

Traffic file keys: "step" ("refine"), "lambda_log10" ([lo, hi], as
refactor's), "rounds" (refinement rounds, 0 or more).
"""

import math
from dataclasses import dataclass
from typing import Optional

import torch

from perfbench import program
from perfbench import work as wk
from perfbench.reference.inputs import lambdas, make_inputs
from perfbench.reference.residual import relative_residuals

KEYS = {"why", "step", "lambda_log10", "rounds"}
LAMBDA_COUNT = 64
DTYPES = {"float64": torch.float64, "float32": torch.float32}


def check(traffic: dict) -> None:
    if set(traffic) != KEYS:
        raise ValueError(f"refine traffic keys: {sorted(traffic)}, "
                         f"expected {sorted(KEYS)}")
    rounds = traffic["rounds"]
    if not isinstance(rounds, int) or rounds < 0:
        raise ValueError(f"refine rounds: {rounds!r}, expected an int >= 0")


@dataclass
class RefinedSolve(wk.Work):
    """The least work of a refined solve (its solves and mat-vecs), and
    of its mat-vecs alone. (No string annotations: the harness loads this
    module by its path, and a dataclass looks string annotations up in
    its module's entry of sys.modules, which is set only after.)"""
    matvecs: Optional[wk.Work] = None


def matvec_work(n, r, nrhs: int, batch: int, itemsize: int) -> wk.Work:
    """One block mat-vec out + A x of the symmetric matrix stored as its
    lower half: each stored element of the lower half (nnz(L), the
    factor's pattern, never the padded buffer) read once and used twice
    off the diagonal, x and out read and the result written once."""
    order = int(sum(n))
    nnz = wk.nnz_l(n, r)
    return wk.Work(float(2 * (2 * nnz - order) * nrhs * batch),
                   float((nnz + 3 * order * nrhs) * itemsize * batch))


class Mix:
    """The inputs of one seed on a loaded Cell (its pattern, solver,
    batch, the factor's dtype and the configuration's matrix_dtype), and
    its steps."""

    def __init__(self, cell, traffic: dict, seed: int):
        check(traffic)
        self.cell = cell
        self.rounds = traffic["rounds"]
        self.lams = lambdas(seed, LAMBDA_COUNT, traffic["lambda_log10"])
        high = DTYPES[cell.cfg["matrix_dtype"]]
        with cell.stage("inputs"):
            self.inputs = make_inputs(cell.pattern, cell.cfg["batch"], seed,
                                      cell.device)
        with cell.stage("pack"):
            self.held, self.vperm = program.pack(cell.solver, cell.pattern,
                                                 self.inputs, high)
            self.rhs = torch.empty_like(self.inputs.rhs, dtype=high)
            self.rhs[:, self.vperm] = self.inputs.rhs.to(high)
            self.diag_idx = program.damp_indices(cell.solver)
            self.diag = self.held[:, self.diag_idx].clone()
            self.damped = torch.empty_like(self.held)
            self.low = torch.empty_like(self.held,
                                        dtype=DTYPES[cell.dtype])

    def lam(self, i: int) -> float:
        return self.lams[i % len(self.lams)]

    def step(self, i: int, span) -> torch.Tensor:
        """Step i, each part inside `span(name)`; returns the solution
        (batch, order, 1) in the solver's numbering, at the matrix's
        precision."""
        lam = self.lam(i)
        solver = self.cell.solver
        with span("redamp"):
            self.damped.copy_(self.held)
            self.damped[:, self.diag_idx] = self.diag * (1 + lam) + lam
            self.low.copy_(self.damped)
        with span("factor"):
            f = solver.factor(self.low)
        with span("solve"):
            x = solver.solve_refined(self.damped, f, self.rhs,
                                     iterations=self.rounds)
        with span("sync"):
            self.cell.sync()
        return x

    def work(self) -> dict:
        """The least work of one step, by part: the factor at its
        precision; the refined solve's rounds + 1 solves at the factor's
        precision and its rounds mat-vecs at the matrix's."""
        n, r = program.lump_shapes(self.cell.solver)
        b = self.cell.cfg["batch"]
        low, high = self.low.element_size(), self.damped.element_size()
        solve = wk.solve_work(n, r, 1, b, low)
        mv = matvec_work(n, r, 1, b, high)
        k = self.rounds
        return {"factor": wk.factor_work(n, r, b, low),
                "solve": RefinedSolve(
                    (k + 1) * solve.flops + k * mv.flops,
                    (k + 1) * solve.bytes + k * mv.bytes,
                    wk.Work(k * mv.flops, k * mv.bytes))}

    def release(self) -> None:
        """Frees the matrix buffers before the reference runs."""
        self.held = self.damped = self.low = self.diag = self.rhs = None

    def judge(self, i: int, x: torch.Tensor) -> float:
        """The widest relative residual |A_lambda x - b| / |b| over the
        batch of step i's solution `x`, by the plain reference; inf where
        x is not finite."""
        res = relative_residuals(self.inputs, self.lam(i),
                                 x[:, self.vperm].to(torch.float64))
        return float(res.max()) if bool(torch.isfinite(res).all()) \
            else math.inf
