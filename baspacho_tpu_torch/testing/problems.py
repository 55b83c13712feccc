"""Test and benchmark problems shared by the port's tests and
chip_smoke.py.

Each function takes the package to build with (`baspacho_tpu_torch`, or
`baspacho_tpu` in the tests that hold the port against it) and returns a
PLANNED solver, so both packages analyse the same structure the same
way. Data are made with numpy from a seed.
"""

from __future__ import annotations

import numpy as np

from .mat_gen import SparseMatGenerator
from .utils import random_spd_data


def _planned(pkg, param_sizes, ss, elim_ranges=(), **kw):
    return pkg.create_solver(pkg.Settings(backend=pkg.BackendType.PLANNED),
                             param_sizes, ss,
                             sparse_elim_ranges=list(elim_ranges), **kw)


def build_flat(pkg, seed, n=30, fill=0.08, schur=0, elim_ranges=(),
               psize=(1, 4), **kw):
    """The flat random problem of tests/test_planned_backend.py:12-24."""
    gen = SparseMatGenerator.gen_flat(n, fill, seed=seed)
    if schur:
        gen.add_schur_set(schur, 0.12)
    ss = gen.to_structure()
    rng = np.random.RandomState(seed)
    param_sizes = rng.randint(psize[0], psize[1], size=ss.order)
    return _planned(pkg, param_sizes, ss, elim_ranges, **kw)


def build_gen(pkg, gen, block=3, **kw):
    return _planned(pkg, np.full(gen.size, block), gen.to_structure(), **kw)


def meri7(pkg, **kw):
    """MERI n=7 as bench.py:197-201 builds it (the reference's meridian
    benchmark, BASELINE.md:23)."""
    gen = SparseMatGenerator.gen_meridians(7, 150, 0.2, 10, 20, 2, 2,
                                           seed=37)
    return build_gen(pkg, gen, **kw)


def grid100(pkg, **kw):
    """GRID 100x100 as bench.py:192-195 builds it."""
    return build_gen(pkg, SparseMatGenerator.gen_grid(100, 100, 0.25,
                                                      seed=37), **kw)


# the five small problems the tests hold the port against the JAX
# package on
SMALL = {
    "flat": lambda pkg, **kw: build_flat(pkg, 0, **kw),
    "elim_range": lambda pkg, **kw: build_flat(
        pkg, 0, n=15, fill=0.2, schur=60, elim_ranges=[0, 60], **kw),
    "meri2": lambda pkg, **kw: build_gen(
        pkg, SparseMatGenerator.gen_meridians(2, 40, 0.2, 10, 20, 2, 2,
                                              seed=3), **kw),
    "meri3": lambda pkg, **kw: build_gen(
        pkg, SparseMatGenerator.gen_meridians(3, 150, 0.2, 10, 20, 2, 2,
                                              seed=3), **kw),
    "grid10": lambda pkg, **kw: build_gen(
        pkg, SparseMatGenerator.gen_grid(10, 10, 0.25, seed=3), **kw),
}


def spd_data(solver, seed, dtype=np.float64) -> np.ndarray:
    """Damped random SPD data in the solver's layout, as bench.py:430-432
    makes it (diagonal raised by 1.5 x order)."""
    data = random_spd_data(solver.data_size, solver.order, seed,
                           np.float64)
    return np.asarray(solver.skel.damp(data, 0.0, solver.order * 1.5),
                      dtype=dtype)
