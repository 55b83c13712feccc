"""Test and benchmark problems shared by the port's tests and
chip_smoke.py.

Each function takes the package to build with (`baspacho_tpu_torch`, or
`baspacho_tpu` in the tests that hold the port against it) and returns a
PLANNED solver, so both packages analyse the same structure the same
way. The port's solvers run on the CPU unless a `device` is passed (the
JAX package's create_solver takes none). Data are made with numpy from a
seed.
"""

from __future__ import annotations

import numpy as np

from .mat_gen import SparseMatGenerator
from .utils import random_spd_data


_PORT = __name__.split(".")[0]


def _planned(pkg, param_sizes, ss, elim_ranges=(), **kw):
    if pkg.__name__ == _PORT:
        kw.setdefault("device", "cpu")
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


def flat1000(pkg, **kw):
    """FLAT n=1000 as bench.py:172-174 builds it: one 3,000-wide
    supernode (padded width 3072)."""
    return build_gen(pkg, SparseMatGenerator.gen_flat(1000, 0.1, seed=37),
                     **kw)


def _flat_schur(pkg, schur, **kw):
    gen = SparseMatGenerator.gen_flat(1000, 0.1, seed=37)
    gen.add_schur_set(schur, 0.02)
    return build_gen(pkg, gen, elim_ranges=[0, schur], **kw)


def flat_schur5k(pkg, **kw):
    """FLAT n=1000 + a 5,000-block Schur set, as bench.py:176-181."""
    return _flat_schur(pkg, 5000, **kw)


def flat_schur50k(pkg, **kw):
    """The reference's headline Schur configuration, FLAT n=1000 + a
    50,000-block Schur set, as bench.py:183-190: a dense level of 50,000
    width-3 lumps, then the 3,000-wide lump."""
    return _flat_schur(pkg, 50000, **kw)


def wide_dense(pkg, **kw):
    """A small problem with both a wide supernode and a dense level:
    gen_flat(200, 0.25) + a 1,500-block Schur set, eliminated first
    (order 5,100; one 600-wide lump, padded width 1024)."""
    gen = SparseMatGenerator.gen_flat(200, 0.25, seed=3)
    gen.add_schur_set(1500, 0.05)
    return build_gen(pkg, gen, elim_ranges=[0, 1500], **kw)


def wide_below(pkg, **kw):
    """A wide supernode with below rows: two dense blocks of 180 and 40
    params over a 20-param separator, which is ordered last
    (`elim_last_ids`). Order 720; level 0 holds the 540-wide lump (padded
    1024) and the 120-wide one, each with 36 below rows (padded 64) on
    overlapping parts of the separator; level 1 is the separator."""
    na, nb, ns = 180, 40, 20
    gen = SparseMatGenerator(na + nb + ns, seed=5)
    s0 = na + nb
    gen.connect_ranges(0, na, 0, na, 1.0)
    gen.connect_ranges(na, s0, na, s0, 1.0)
    gen.connect_ranges(0, na, s0, s0 + 12, 0.5)
    gen.connect_ranges(na, s0, s0 + 8, s0 + ns, 0.5)
    gen.connect_ranges(s0, s0 + ns, s0, s0 + ns, 0.5)
    return build_gen(pkg, gen, elim_last_ids=list(range(s0, s0 + ns)),
                     **kw)


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
