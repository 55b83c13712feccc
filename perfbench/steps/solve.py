"""solve: many solves on one factor, one closed-loop client (an implicit
backward pass or a run of marginal queries reads each solution before it
asks the next).

Set-up re-damps the held matrix once with a lambda drawn from the seed
(as refactor's steps do) and factors it (Solver.factor). A step solves
the next of the seed's right-hand sides on that factor, one column
(Solver.solve), and synchronises. Every step does the same work whatever
the seed.

Traffic file keys: "step" ("solve"), "lambda_log10" ([lo, hi]: the one
lambda is log-uniform over 10**lo .. 10**hi), "rhs_count" (right-hand
sides drawn from the seed, cycled over the steps).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import program
from perfbench import work as wk
from perfbench.reference.inputs import lambdas, make_inputs
from perfbench.reference.residual import damped_matvec

KEYS = {"why", "step", "lambda_log10", "rhs_count"}
DTYPES = {"float64": torch.float64, "float32": torch.float32}


def check(traffic: dict) -> None:
    if set(traffic) != KEYS:
        raise ValueError(f"solve traffic keys: {sorted(traffic)}, "
                         f"expected {sorted(KEYS)}")
    n = traffic["rhs_count"]
    if not isinstance(n, int) or n < 1:
        raise ValueError(f"solve rhs_count: {n!r}, expected an int >= 1")


def right_hand_sides(seed: int, count: int, batch: int, order: int,
                     device) -> torch.Tensor:
    """(count, batch, order, 1) float64 values in [-1, 1), in the user
    numbering, from a stream of the seed that the matrix's values do not
    use."""
    state = np.random.SeedSequence([int(seed) % (1 << 63), 3])
    g = torch.Generator(device=device)
    g.manual_seed(int(state.generate_state(1, np.uint64)[0]) >> 1)
    return torch.rand((count, batch, order, 1), generator=g, device=device,
                      dtype=torch.float64) * 2 - 1


class Mix:
    """The inputs of one seed on a loaded Cell, its factor (taken in
    set-up), its right-hand sides and its steps."""

    def __init__(self, cell, traffic: dict, seed: int):
        check(traffic)
        self.cell = cell
        self.seed, self.count = seed, traffic["rhs_count"]
        self.lam = lambdas(seed, 1, traffic["lambda_log10"])[0]
        dtype = DTYPES[cell.dtype]
        batch = cell.cfg["batch"]
        with cell.stage("inputs"):
            self.inputs = make_inputs(cell.pattern, batch, seed, cell.device)
            b = right_hand_sides(seed, self.count, batch,
                                 cell.solver.skel.order, cell.device)
        with cell.stage("pack"):
            held, self.vperm = program.pack(cell.solver, cell.pattern,
                                            self.inputs, dtype)
            idx = program.damp_indices(cell.solver)
            held[:, idx] = held[:, idx] * (1 + self.lam) + self.lam
            self.rhs = torch.empty_like(b, dtype=dtype)
            self.rhs[:, :, self.vperm] = b.to(dtype)
            del b
        with cell.stage("factor"):
            self.factor = cell.solver.factor(held)
        self.b = None

    def step(self, i: int, span) -> torch.Tensor:
        """Step i, each part inside `span(name)`; returns its solution
        (batch, order, 1) in the solver's numbering."""
        with span("solve"):
            x = self.cell.solver.solve(self.factor,
                                       self.rhs[i % self.count])
        with span("sync"):
            self.cell.sync()
        return x

    def work(self) -> dict:
        """The least work of one step: its solve (perfbench/work.py); the
        factor is set-up."""
        n, r = program.lump_shapes(self.cell.solver)
        w = wk.solve_work(n, r, 1, self.cell.cfg["batch"],
                          self.rhs.element_size())
        return {"solve": w}

    def release(self) -> None:
        """Frees the factor and the right-hand sides before the reference
        runs."""
        self.factor = self.rhs = None

    def judge(self, i: int, x: torch.Tensor) -> float:
        """The widest relative residual |A_lambda x - b| / |b| over the
        batch of step i's solution `x`, against the step's own right-hand
        side, by the plain reference; inf where x is not finite."""
        if self.b is None:   # drawn again, once, after release
            self.b = right_hand_sides(self.seed, self.count,
                                      self.inputs.batch,
                                      self.inputs.rhs.shape[1],
                                      self.inputs.rhs.device)
        b = self.b[i % self.count]
        r = damped_matvec(self.inputs, self.lam,
                          x[:, self.vperm].to(torch.float64)) - b
        res = torch.linalg.vector_norm(r, dim=1) / \
            torch.linalg.vector_norm(b, dim=1)
        if not bool(torch.isfinite(res).all()):
            return math.inf
        return float(res.max())
