"""K1-wide's schedule (csrc/wide_factor.cu) evaluated in numpy in the
kernels' order, against the plain twin `wide_factor_twin` and the JAX
routine it ports, PlannedBackend._factor_bucket (_blocked_factor +
_blocked_lower_inv + _embed_inv), f64 on the CPU.

Per diagonal tile k of 128 columns, three grids over every panel:
  wide_tile    step k - 1's update of the tile's own lower triangle,
               then the tile's blocked factor and inverse by 32-column
               sub-blocks, both right-looking (the next diagonal block
               one step ahead);
  wide_rows    32-row jobs: x = a . X_k^T for the rows below the tile,
               and block row k of the inverse, stored transposed:
               X^T[rows, k0:k1] = -T^T X_k^T, T^T the partial sums that
               earlier steps left there;
  wide_update  64 x 64 tiles of the trailing lower tile triangle (but
               tile k + 1's) and of the below rows, C -= x x^T on real
               lower elements only;
               and of the inverse's partial sums, T^T[c][r] (+)=
               X^T[c][k0:k1] . x_r for c < k1 and the trailing rows r of
               the real 128-column blocks (written, not added, by the
               first step that reaches them).
Every product sums its columns in 32-column chunks, in order. The model
also checks which elements each grid writes: each once a step, and
nothing of the strict upper triangle read before it is written (the
input's strict upper is NaN in one case)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baspacho_tpu as J
from baspacho_tpu.ops.planned_backend import LumpBucket
from baspacho_tpu_torch.ops import kernels
from baspacho_tpu_torch.testing.problems import SMALL
from same_native import one_native_library  # noqa: F401 (autouse)

torch.set_num_threads(1)

RTOL = 1e-10  # f64: XLA, torch and the model sum in different orders, and
#               the stored inverse amplifies rounding
NB, SUB, ROWS, TILE = 128, 32, 32, 64  # wide_factor.cu kNb, kSub, kRows,
#                                        warp_tiles.cuh kTile

# cp, rp, real widths, real below rows, NaN in the input's strict upper
CASES = {
    "below_rows": (1024, 64, (1000, 700), (60, 33), False),
    "empty_last_tile_nan_upper": (1024, 96, (896, 530), (96, 1), True),
    "full_width_no_below": (1024, 0, (1024,), (0,), False),
}

def tri_tile(t):
    """warp_tiles.cuh tri_tile: tile t of a lower tile triangle."""
    f = np.float32
    i = int((np.sqrt(f(8.0) * f(t) + f(1.0)) - f(1.0)) * f(0.5))
    while (i + 1) * (i + 2) // 2 <= t:
        i += 1
    while i * (i + 1) // 2 > t:
        i -= 1
    return i, t - i * (i + 1) // 2


def chunked(a, b, k):
    """a[:, :k] b[:, :k]^T summed by 32-column chunks in order, as mma32
    and gram_tile do."""
    acc = np.zeros((a.shape[0], b.shape[0]))
    for m0 in range(0, k, SUB):
        acc += a[:, m0:min(m0 + SUB, k)] @ b[:, m0:min(m0 + SUB, k)].T
    return acc


def _warp_chol_inv(A, dx, p0, pw):
    """warp_chol_inv on the pw x pw block at (p0, p0): L on and below the
    diagonal, X^T above, diag X in dx, both right-looking."""
    D = A[p0:p0 + pw, p0:p0 + pw]
    L = np.tril(D)
    with np.errstate(invalid="ignore", divide="ignore"):
        for k in range(pw):
            L[k, k] = np.sqrt(L[k, k])
            L[k + 1:, k] /= L[k, k]
            L[k + 1:, k + 1:] -= np.tril(np.outer(L[k + 1:, k],
                                                  L[k + 1:, k]))
        X, s = np.zeros((pw, pw)), np.zeros((pw, pw))
        for k in range(pw):
            dk = 1.0 / L[k, k]
            X[k, :k], X[k, k] = -s[k, :k] * dk, dk
            s[k + 1:] += np.outer(L[k + 1:, k], X[k])
    D[...] = L + np.triu(X.T, 1)
    dx[p0:p0 + pw] = np.diag(X)


def x_of(A, dx):
    """X (lower, 1 / diag L on the diagonal) from a stored X^T block."""
    return np.triu(A, 1).T + np.diag(dx)


def tile_model(T, w):
    """wide_tile on one diagonal tile (its lower triangle read, real
    width w): the stored tile (zero outside w) and dx (zero past w). At
    sub-block p: the diagonal block's factor and inverse, the rows below
    it, the trailing update, and the inverse carried forward: X^T[j][p] =
    -T^T[j][p] X_p^T from the partial sums T^T stored in its place, then
    T^T[j][i] (+)= X^T[j][p] L[i][p]^T for the later blocks i. Sub-block
    p + 1's diagonal block is factored once its own update is done; the
    rest runs beside it, which changes no sum."""
    A, dx = np.zeros((NB, NB)), np.zeros(NB)
    A[:w, :w] = np.tril(T[:w, :w])
    nb = -(-w // SUB)
    blk = lambda i: slice(i * SUB, (i + 1) * SUB)
    for p in range(nb):
        p0, q0 = p * SUB, (p + 1) * SUB
        _warp_chol_inv(A, dx, p0, min(SUB, w - p0))
        with np.errstate(invalid="ignore"):
            Xp = x_of(A[blk(p), blk(p)], dx[blk(p)])
            A[q0:, p0:q0] = chunked(A[q0:, p0:q0], Xp, SUB)
            m = nb - p - 1
            for t in range(m * (m + 1) // 2):
                I, J_ = tri_tile(t)
                r, c = q0 + I * SUB, q0 + J_ * SUB
                A[r:r + SUB, c:c + SUB] -= chunked(
                    A[r:r + SUB, p0:q0], A[c:c + SUB, p0:q0], SUB)
            for j in range(p + 1):
                if j < p:
                    A[blk(j), blk(p)] = -chunked(A[blk(j), blk(p)], Xp, SUB)
                xt = A[blk(j), blk(p)] if j < p else Xp.T
                for i in range(p + 1, nb):
                    acc = chunked(xt, A[blk(i), blk(p)], SUB)
                    A[blk(j), blk(i)] = acc if j == p else \
                        acc + A[blk(j), blk(i)]
    A[w:], A[:, w:] = 0.0, 0.0
    return A, dx


def rows_jobs(cp, rp, k0, n, nr):
    """wide_rows_kernel's jobs of one panel at step k: (kind, first row,
    real rows); kind "x" (rows below the tile) or "inv" (block row k of
    the inverse, rows of X^T). Jobs past the real rows are dropped, as
    the kernel returns from them."""
    k1, w = k0 + NB, max(0, min(NB, n - k0))
    nd, nbl = (cp - k1) // ROWS, -(-rp // ROWS)
    out = []
    for j in range(nd + nbl + k0 // ROWS):
        if j < nd + nbl:
            r0 = k1 + j * ROWS if j < nd else cp + (j - nd) * ROWS
            cnt = min(ROWS, n - r0 if j < nd else nr - (j - nd) * ROWS)
            if cnt > 0 and w > 0:
                out.append(("x", r0, cnt))
        else:
            out.append(("inv", (j - nd - nbl) * ROWS, ROWS))
    return out


def update_tiles(cp, rp, k0, n, nr):
    """wide_update_kernel's tiles of one panel at step k: the written
    elements of each, as (panel rows, panel columns) index arrays. The
    lower triangle of tile k + 1 is left to that tile (tile_pre)."""
    k1, w = k0 + NB, max(0, min(NB, n - k0))
    m = (cp - k1) // TILE
    tri = m * (m + 1) // 2
    nd = n - k1
    out = []
    for t in range(tri + -(-rp // TILE) * m):
        I, J_ = tri_tile(t) if t < tri else (m + (t - tri) // m,
                                             (t - tri) % m)
        r0, c0, below = I * TILE, J_ * TILE, I >= m
        if w == 0 or c0 >= nd or (r0 - m * TILE >= nr if below
                                  else r0 >= nd) or (not below and r0 < NB):
            continue  # ... or a part of tile k + 1, which updates itself
        R, C = np.meshgrid(np.arange(r0, r0 + TILE),
                           np.arange(c0, c0 + TILE), indexing="ij")
        ok = (C < nd) & ((R - m * TILE < nr) if below
                         else (R < nd) & (C <= R))
        out.append((r0, c0, k1 + R[ok], k1 + C[ok]))
    return out


def inv_tiles(cp, k0, n):
    """wide_update_kernel's tiles of the inverse's partial sums at step k:
    (first row c0 of X^T, first trailing row r0) of each 64 x 64 tile."""
    k1, w = k0 + NB, max(0, min(NB, n - k0))
    m, rend = (cp - k1) // TILE, -(-n // NB) * NB
    return [(I * TILE, J_ * TILE) for I in range(k1 // TILE)
            for J_ in range(m) if w > 0 and J_ * TILE < rend - k1]


def tile_pre(P, k0, n):
    """wide_tile's first part for k0 > 0: step k - 1's update of the
    tile's own lower triangle, over the previous block's columns, as the
    update grid would sum it."""
    w = max(0, min(NB, n - k0))
    if k0 == 0 or w == 0:
        return
    x = P[k0:k0 + NB, k0 - NB:k0].copy()
    x[w:] = 0.0
    with np.errstate(invalid="ignore"):
        acc = chunked(x, x, NB)
    low = np.tril(np.ones((NB, NB), dtype=bool))
    P[k0:k0 + NB, k0:k0 + NB][low] -= acc[low]


def wide_model(panel, n, nr, cp, rp):
    """One panel ((cp + rp) x cp, as stored) through the kernels'
    schedule; returns the stored panel. Checks each step's writes."""
    P, dx = panel.copy(), np.zeros(cp)
    for k0 in range(0, cp, NB):
        k1, w = k0 + NB, max(0, min(NB, n - k0))
        tile_pre(P, k0, n)
        P[k0:k1, k0:k1], dx[k0:k1] = tile_model(P[k0:k1, k0:k1], w)
        Xk = x_of(P[k0:k1, k0:k1], dx[k0:k1])
        wrote = np.zeros(P.shape, dtype=int)
        with np.errstate(invalid="ignore"):
            for kind, r0, cnt in rows_jobs(cp, rp, k0, n, nr):
                out = P[r0:r0 + cnt, k0:k1]
                if kind == "x":
                    out[...] = chunked(out, Xk, w)
                elif w == 0:
                    out[...] = 0.0
                else:
                    out[...] = -chunked(out, Xk, w)
                wrote[r0:r0 + cnt, k0:k1] += 1
            assert wrote.max() <= 1
            x = P[k1:, k0:k1].copy()  # the trailing row space
            x[cp - k1 + nr:] = 0.0  # rows past the real ones read as zero
            xt = P[:k1, k0:k1].copy()  # X^T of block k above the diagonal
            xt[k0:] = x_of(P[k0:k1, k0:k1], dx[k0:k1]).T
            wrote[...] = 0
            for r0, c0, R, C in update_tiles(cp, rp, k0, n, nr):
                acc = chunked(x[r0:r0 + TILE], x[c0:c0 + TILE], w)
                P[R, C] -= acc[R - k1 - r0, C - k1 - c0]
                wrote[R, C] += 1
            for c0, r0 in inv_tiles(cp, k0, n):
                acc = chunked(xt[c0:c0 + TILE], x[r0:r0 + TILE], w)
                out = P[c0:c0 + TILE, k1 + r0:k1 + r0 + TILE]
                out[...] = acc if c0 >= k0 else out + acc
                wrote[c0:c0 + TILE, k1 + r0:k1 + r0 + TILE] += 1
            assert wrote.max() <= 1
    return P


def bucket(case):
    """A compact bucket (panels side by side, row stride cp): SPD lower
    triangles (a a^T + n I), random below rows, zero padding; the strict
    upper of each diagonal block NaN in the cases that ask for it."""
    cp, rp, cols, nrow, nan_upper = CASES[case]
    rng = np.random.RandomState(cp + rp + len(cols))
    h = cp + rp
    panels = np.zeros((len(cols), h, cp))
    for j, (n, r) in enumerate(zip(cols, nrow)):
        a = rng.rand(n, n) - 0.5
        panels[j, :n, :n] = np.tril(a @ a.T + n * np.eye(n))
        panels[j, cp:cp + r, :n] = rng.rand(r, n) - 0.5
        if nan_upper:
            panels[j, :cp][np.triu_indices(cp, 1)] = np.nan
    return panels, np.array(cols), np.array(nrow), cp, rp


def run_twin(data, cols, nrow, cp, rp):
    """wide_factor on the CPU (its twin) on a (batch, B h cp) buffer."""
    B, h = len(cols), cp + rp
    off_h = tuple(j * h * cp for j in range(B))
    t = lambda a: torch.tensor(a, dtype=torch.int64)
    got = torch.from_numpy(data.copy())
    kernels.wide_factor(got, t(off_h), t(nrow), t(cols), cp, rp, off_h,
                        tuple(int(c) for c in cols))
    return got.numpy()


def run_jax(panels, cols, nrow, cp, rp):
    """The JAX package's _factor_bucket on the same bucket (its stored
    panels); the strict upper triangle of its input is not read."""
    js = SMALL["meri2"](J)
    B, h = len(cols), cp + rp
    lb = LumpBucket(rp=rp, cp=cp, off=np.arange(B) * h * cp, rows=nrow,
                    cols=cols, vec_off=np.zeros(B, np.int64))
    ext = jnp.asarray(np.concatenate([panels.reshape(-1), np.zeros(2)]))
    out, _ = jax.jit(lambda e: js.backend._factor_bucket(e, lb))(ext)
    return np.asarray(out[:-2]).reshape(B, h, cp)


def rel(a, b):
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("case", list(CASES))
def test_wide_model_matches_twin_and_factor_bucket(case):
    """The model of the grids against the twin and J's _factor_bucket:
    L, the full Linv^T above the diagonal, x below, zero padding."""
    panels, cols, nrow, cp, rp = bucket(case)
    model = np.stack([wide_model(p, n, r, cp, rp)
                      for p, n, r in zip(panels, cols, nrow)])
    twin = run_twin(panels.reshape(1, -1), cols, nrow, cp, rp)
    assert np.isfinite(model).all() and np.isfinite(twin).all()
    assert rel(model.reshape(-1), twin[0]) < RTOL
    assert rel(model, run_jax(np.nan_to_num(panels, nan=0.0), cols, nrow,
                              cp, rp)) < RTOL
    for p, n, r in zip(model, cols, nrow):
        assert not p[:, n:].any() and not p[n:cp].any() and \
            not p[cp + r:].any()


@pytest.mark.parametrize("case", list(CASES))
def test_wide_grids_cover_each_element_once(case):
    """Over the whole schedule: every element of the strict upper
    triangle is written once as a part of X^T (by a tile or by a block
    row of the inverse), and before that, in the real 128-column blocks,
    as a partial sum by the first step whose tiles reach it; the rows
    jobs write the real rows below each tile once; the update tiles
    write exactly the real lower trailing elements and the real below
    rows' trailing columns, but for tile k + 1's lower triangle, which
    that tile updates itself."""
    _, cols, nrow, cp, rp = bucket(case)
    for n, nr in zip(cols, nrow):
        upper = np.zeros((cp, cp), dtype=int)
        for k0 in range(0, cp, NB):
            k1 = k0 + NB
            upper[k0:k1, k0:k1] += np.triu(np.ones((NB, NB), int), 1)
            below = np.zeros((cp + rp, NB), dtype=int)
            for kind, r0, cnt in rows_jobs(cp, rp, k0, n, nr):
                if kind == "inv":
                    upper[r0:r0 + cnt, k0:k1] += 1
                else:
                    below[r0:r0 + cnt] += 1
            real = np.zeros(cp + rp, dtype=bool)
            real[k1:n] = real[cp:cp + nr] = k0 < n
            assert (below[real] == 1).all() and not below[~real].any()
            got = np.zeros((cp + rp, cp), dtype=int)
            for _, _, R, C in update_tiles(cp, rp, k0, n, nr):
                np.add.at(got, (R, C), 1)
            want = np.zeros_like(got)
            if k0 < n:
                want[k1:n, k1:n] = np.tril(np.ones((n - k1, n - k1), int)) \
                    if n > k1 else 0
                want[k1:k1 + NB, k1:k1 + NB] = 0  # tile k + 1's own
                want[cp:cp + nr, k1:n] = 1
            assert (got == want).all()
            partial = np.zeros((cp, cp), dtype=int)
            for c0, r0 in inv_tiles(cp, k0, n):
                partial[c0:c0 + TILE, k1 + r0:k1 + r0 + TILE] += 1
            rend = -(-n // NB) * NB if k0 < n else k1
            assert (partial[:k1, k1:rend] == 1).all()
            assert partial.sum() == k1 * max(0, rend - k1)
        assert (upper == np.triu(np.ones((cp, cp), int), 1)).all()


def test_wide_factor_batch_items_equal_single_runs():
    """A batch of two (the second item scaled) through the wrapper equals
    each item's single run bitwise."""
    panels, cols, nrow, cp, rp = bucket("below_rows")
    one = panels.reshape(1, -1)
    two = run_twin(np.concatenate([one, 1.01 * one]), cols, nrow, cp, rp)
    assert np.array_equal(two[0], run_twin(one, cols, nrow, cp, rp)[0])
    assert np.array_equal(two[1], run_twin(1.01 * one, cols, nrow, cp,
                                           rp)[0])


@pytest.mark.parametrize("col", [300, 384, 999])
def test_wide_model_nan_from_failing_column(col):
    """A panel that is not positive definite (its diagonal negative at
    `col`): in the model L is finite before the column and NaN in it from
    the diagonal down; the twin and J's routine give NaN there too (and
    from the start of the failing diagonal block, 128 or 256 wide, on);
    the other panel stays finite."""
    panels, cols, nrow, cp, rp = bucket("below_rows")
    panels = panels.copy()
    panels[0, col, col] = -1.0
    n = cols[0]
    model = wide_model(panels[0], n, nrow[0], cp, rp)
    twin = run_twin(panels.reshape(1, -1), cols, nrow, cp, rp)[0]
    want = run_jax(panels, cols, nrow, cp, rp)
    for got, first in ((model, col), (twin.reshape(panels.shape)[0],
                                      col // 256 * 256), (want[0],
                                                          col // 256 * 256)):
        L = np.tril(got[:n, :n])
        assert np.isfinite(L[:first, :first]).all()
        assert np.isnan(L[col:, col]).all()
    assert np.isfinite(twin.reshape(panels.shape)[1]).all()
    assert np.isfinite(want[1]).all()
