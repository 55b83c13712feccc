"""Faults planted in the timed path, to show that the check fails them:
each takes a loaded Cell and replaces its solver's factor or solve.
The control (the program's own float32 path) is not a fault: it is a
dtype (harness.run_cell's `dtype`)."""

from __future__ import annotations

import torch


def unchanged_factor(cell) -> None:
    """The factor returns its input: the state is left unchanged."""
    cell.solver.factor = lambda data: data.clone()


def unchanged_solve(cell) -> None:
    """The solve returns its right-hand side unchanged."""
    cell.solver.solve = lambda f, rhs: rhs.clone()


def half_batch(cell) -> None:
    """Only the first half of the batch is solved; the rest is left as
    its right-hand side."""
    solve = cell.solver.solve

    def half(f, rhs):
        h = (rhs.shape[0] + 1) // 2
        return torch.cat([solve(f[:h], rhs[:h]), rhs[h:]])

    cell.solver.solve = half


def altered(cell) -> None:
    """One entry of one system's solution is changed where it is
    produced."""
    solve = cell.solver.solve

    def alter(f, rhs):
        x = solve(f, rhs)
        x[-1, x.shape[1] // 2, 0] += 1.0
        return x

    cell.solver.solve = alter


FAULTS = {f.__name__: f for f in (unchanged_factor, unchanged_solve,
                                  half_batch, altered)}


def remove(cell) -> None:
    """The solver's own factor and solve again."""
    for name in ("factor", "solve"):
        cell.solver.__dict__.pop(name, None)


def applies(name: str, batch: int) -> bool:
    return name != "half_batch" or batch > 1
