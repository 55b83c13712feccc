"""refactor: the solver's share of one LM iteration on a structure fixed
at set-up, one closed-loop client (an LM optimiser reads each step back
before it takes the next).

A step re-damps the held matrix of every system of the batch with the
step's lambda (each diagonal scalar d becomes d * (1 + lambda) + lambda,
the port's additive LM damping), factors it (Solver.factor), solves the
held right-hand side, one column (Solver.solve), and synchronises. Every
step does the same work whatever the seed.

Traffic file keys: "step" ("refactor"), "lambda_log10" ([lo, hi]: lambda
is log-uniform over 10**lo .. 10**hi; LAMBDA_COUNT values are drawn from
the seed and cycled over the steps).
"""

from __future__ import annotations

import math

import torch

from perfbench import program
from perfbench import work as wk
from perfbench.reference.inputs import lambdas, make_inputs
from perfbench.reference.residual import relative_residuals

KEYS = {"why", "step", "lambda_log10"}
LAMBDA_COUNT = 64
DTYPES = {"float64": torch.float64, "float32": torch.float32}


def check(traffic: dict) -> None:
    if set(traffic) != KEYS:
        raise ValueError(f"refactor traffic keys: {sorted(traffic)}, "
                         f"expected {sorted(KEYS)}")


class Mix:
    """The inputs of one seed on a loaded Cell (its pattern, solver,
    batch and dtype), and its steps."""

    def __init__(self, cell, traffic: dict, seed: int):
        check(traffic)
        self.cell = cell
        self.lams = lambdas(seed, LAMBDA_COUNT, traffic["lambda_log10"])
        dtype = DTYPES[cell.dtype]
        with cell.stage("inputs"):
            self.inputs = make_inputs(cell.pattern, cell.cfg["batch"], seed,
                                      cell.device)
        with cell.stage("pack"):
            self.held, self.vperm = program.pack(cell.solver, cell.pattern,
                                                 self.inputs, dtype)
            self.rhs = torch.empty_like(self.inputs.rhs, dtype=dtype)
            self.rhs[:, self.vperm] = self.inputs.rhs.to(dtype)
            self.diag_idx = program.damp_indices(cell.solver)
            self.diag = self.held[:, self.diag_idx].clone()
            self.damped = torch.empty_like(self.held)

    def lam(self, i: int) -> float:
        return self.lams[i % len(self.lams)]

    def step(self, i: int, span) -> torch.Tensor:
        """Step i, each part inside `span(name)`; returns the solution
        (batch, order, 1) in the solver's numbering."""
        lam = self.lam(i)
        solver = self.cell.solver
        with span("redamp"):
            self.damped.copy_(self.held)
            self.damped[:, self.diag_idx] = self.diag * (1 + lam) + lam
        with span("factor"):
            f = solver.factor(self.damped)
        with span("solve"):
            x = solver.solve(f, self.rhs)
        with span("sync"):
            self.cell.sync()
        return x

    def work(self) -> dict:
        """The least work of one step, by part (perfbench/work.py)."""
        n, r = program.lump_shapes(self.cell.solver)
        b, item = self.cell.cfg["batch"], self.rhs.element_size()
        return {"factor": wk.factor_work(n, r, b, item),
                "solve": wk.solve_work(n, r, 1, b, item)}

    def release(self) -> None:
        """Frees the matrix buffers before the reference runs."""
        self.held = self.damped = self.diag = self.rhs = None

    def judge(self, i: int, x: torch.Tensor) -> float:
        """The widest relative residual |A_lambda x - b| / |b| over the
        batch of step i's solution `x`, by the plain reference; inf where
        x is not finite."""
        res = relative_residuals(self.inputs, self.lam(i),
                                 x[:, self.vperm].to(torch.float64))
        return float(res.max()) if bool(torch.isfinite(res).all()) \
            else math.inf
