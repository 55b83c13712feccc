"""work.py's counts equal a brute-force count of a dense Cholesky over
the factor's pattern on tiny skeletons."""

import numpy as np
import pytest

from perfbench import program, work
from perfbench.reference import bal, grid


def dense_pattern(skel) -> np.ndarray:
    """Boolean pattern of L (lower, diagonal included) from the skeleton:
    each lump's columns hold its own diagonal block's lower half and the
    rows of its chains below it."""
    n = skel.order
    L = np.zeros((n, n), dtype=bool)
    ss = skel.span_start
    for l in range(skel.num_lumps):
        c0, c1 = skel.lump_start[l], skel.lump_start[l + 1]
        for ch in range(skel.chain_col_ptr[l], skel.chain_col_ptr[l + 1]):
            s = skel.chain_row_span[ch]
            L[ss[s]:ss[s + 1], c0:c1] = True
    return np.tril(L)


def brute_force(L: np.ndarray, nrhs: int) -> tuple:
    """Scalar right-looking Cholesky over the pattern: per column a
    square root, a division per entry below, a multiply-subtract (2) per
    pair of entries below; each solve pass per column a division and a
    multiply-subtract per entry below."""
    factor = solve = 0
    for j in range(L.shape[0]):
        below = np.nonzero(L[j + 1:, j])[0] + j + 1
        c = len(below)
        factor += 1 + c
        for a in range(c):
            for b in range(a + 1):
                assert L[below[a], below[b]], "update outside the pattern"
                factor += 2
        solve += 2 * (1 + 2 * c) * nrhs
    return factor, solve


SOLVERS = {
    "grid": lambda: program.analyse(grid.pattern(dict(
        width=5, height=6, fill=0.5, block=2, seed=4)), "cpu"),
    "bal": lambda: program.analyse(bal.pattern(dict(
        n_cams=6, n_pts=25, track_len=3, window=4, loop_frac=0.2,
        seed=2)), "cpu"),
}


@pytest.mark.parametrize("name", sorted(SOLVERS))
@pytest.mark.parametrize("nrhs", [1, 3])
def test_counts_match_brute_force(name, nrhs):
    s = SOLVERS[name]()
    n, r = program.lump_shapes(s)
    L = dense_pattern(s.skel)
    flops, solve_flops = brute_force(L, nrhs)
    f = work.factor_work(n, r, 3, 8)
    v = work.solve_work(n, r, nrhs, 3, 8)
    assert f.flops == 3 * flops
    assert v.flops == 3 * solve_flops
    assert work.nnz_l(n, r) == int(L.sum())
    assert f.bytes == 3 * 2 * 8 * int(L.sum())
    assert v.bytes == 3 * 8 * (int(L.sum()) + 2 * s.order * nrhs)


def test_least_seconds_takes_the_larger_bound():
    w = work.Work(flops=67e12, bytes=3.35e12 / 2)
    assert work.least_seconds(w, (67e12, 3.35e12)) == 1.0
    assert work.peaks("NVIDIA H100 80GB HBM3", "float64") == (67e12,
                                                              3.35e12)
    assert work.peaks("some other card", "float64") is None
