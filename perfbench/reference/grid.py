"""GRID: the upstream BaSpaCho benchmark's banded-grid topology.

A frozen copy of `SparseMatGenerator.gen_grid`
(baspacho_tpu_torch/testing/mat_gen.py), kept here so that the
benchmark's structures never move with the program: node (i, j) of a
width x height grid couples with each neighbour within `conn_max_dist`,
each coupling kept with probability `fill`, drawn in the same order from
the same RandomState.
"""

from __future__ import annotations

import numpy as np

from .pattern import Pattern, lower_pattern


def grid_columns(width: int, height: int, fill: float,
                 conn_max_dist: int = 1, seed: int = 37) -> list:
    """Lower-half columns as sets of rows (each column holds itself)."""
    rng = np.random.RandomState(seed)
    columns = [{i} for i in range(width * height)]
    for i in range(width):
        i2b, i2e = max(i - conn_max_dist, 0), min(i + conn_max_dist + 1,
                                                  width)
        for j in range(height):
            j2b = max(j - conn_max_dist, 0)
            j2e = min(j + conn_max_dist + 1, height)
            off = i * height + j
            block = np.arange(i2b, i2e)[:, None] * height + \
                np.arange(j2b, j2e)[None, :]
            block = block.ravel()
            block = block[block != off]
            if fill < 1.0:
                block = block[rng.rand(len(block)) < fill]
            for off2 in block.tolist():
                columns[min(off, off2)].add(max(off, off2))
    return columns


def pattern(params: dict) -> Pattern:
    """The configuration's block pattern: every node a parameter of
    `block` scalars, no elimination range."""
    cols = grid_columns(params["width"], params["height"], params["fill"],
                        params.get("conn_max_dist", 1), params["seed"])
    n = len(cols)
    rows = np.concatenate([np.fromiter(c, dtype=np.int64, count=len(c))
                           for c in cols])
    colix = np.repeat(np.arange(n, dtype=np.int64),
                      [len(c) for c in cols])
    sizes = np.full(n, params["block"], dtype=np.int64)
    return lower_pattern(sizes, rows, colix, elim_end=0)
