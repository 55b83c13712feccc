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


# ----------------------------------------------------------------------
# factor graphs of the optimizer layer. `O` is the optimizer module of
# the package to build with (baspacho_tpu_torch.optimizer, or
# baspacho_tpu.optimizer in the tests); `opt_kw` goes to its Optimizer
# (the port's takes `device`). Residuals use only operators both
# packages' arrays share.
# ----------------------------------------------------------------------
def spring_chain(O, n=12, seed=0, outlier_loss=None, **opt_kw):
    """The 1-D spring chain of tests/test_optimizer.py:17-35 (reference
    examples/OptimizeSimple.cpp): x_i pulled to unit spacing, x_0
    anchored at 0; with `outlier_loss`, also an outlier factor pulling
    x_4 to 100 under that loss (test_optimizer.py:84-95)."""
    rng = np.random.RandomState(seed)
    opt = O.Optimizer(**opt_kw)
    xs = opt.add_variable_family(O.VariableFamily(rng.rand(n, 1) * 10,
                                                  name="x"))
    opt.add_factor_family(lambda a, b: (b - a) - 1.0,
                          [(xs, np.arange(n - 1)), (xs, np.arange(1, n))])
    opt.add_factor_family(lambda a: a, [(xs, np.array([0]))])
    if outlier_loss is not None:
        opt.add_factor_family(lambda a: a - 100.0, [(xs, np.array([4]))],
                              loss=outlier_loss)
    return opt, xs


def se3_ba(O, n_cams=4, n_pts=30, seed=0, **opt_kw):
    """The SE3 bundle adjustment of tests/test_optimizer.py:98-142:
    cameras as SE3 poses (identity rotations), points in R^3 seen by
    every camera through a pinhole, points Schur-eliminated, the first
    camera held by a prior. The observations are computed in numpy (with
    identity rotations the pose only translates), so both packages get
    the same bits."""
    rng = np.random.RandomState(seed)
    pts_gt = rng.rand(n_pts, 3) * 2 + np.array([0, 0, 4.0])
    cams_gt = []
    for i in range(n_cams):
        t = np.array([i * 0.5 - n_cams * 0.25, 0.1 * rng.randn(), 0.0])
        cams_gt.append(np.array([0, 0, 0, 1.0, *t]))
    cams_gt = np.stack(cams_gt)
    obs_cam = np.repeat(np.arange(n_cams), n_pts)
    obs_pt = np.tile(np.arange(n_pts), n_cams)
    p = pts_gt[obs_pt] + cams_gt[obs_cam, 4:]
    obs_uv = p[:, :2] / p[:, 2:3]

    def project(cam, pt):
        q = O.SE3.transform(cam, pt)
        return q[:2] / q[2]

    opt = O.Optimizer(**opt_kw)
    pts = opt.add_variable_family(O.VariableFamily(
        pts_gt + rng.randn(n_pts, 3) * 0.05, name="pts"))
    cams = opt.add_variable_family(O.VariableFamily(
        cams_gt, tangent_dim=6, tangent_step=O.SE3.tangent_step,
        name="cams"))
    opt.add_factor_family(lambda pt, cam, uv: project(cam, pt) - uv,
                          [(pts, obs_pt), (cams, obs_cam)], consts=(obs_uv,))
    opt.add_factor_family(lambda cam, target: 10.0 * (cam - target),
                          [(cams, np.array([0]))], consts=(cams_gt[:1],))
    opt.set_elimination_families([pts])
    return opt, pts, cams


# BAL 871 x 527,480 as bench.py:564-566 (`bal_full`) makes it: the shape
# of the public BAL dataset's Venice-871 problem, synthetic
BAL871 = dict(n_cams=871, n_pts=527480, track_len=5, seed=1,
              track_mode="window", window=24, loop_frac=0.03, noise=1.0)
