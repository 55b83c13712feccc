"""The three kernels' plain twins against the JAX routines they port,
fed the same inputs from the same schedule (f64, CPU). The CUDA kernels
themselves are held against these twins on the card by chip_smoke.py.

  K1 bucket_factor       vs PlannedBackend._factor_bucket
  K2 segmented_subtract  vs PlannedBackend._apply_pairs
  K3 bucket_solve        vs PlannedBackend._diag_solve(use_inv=True)

K1's grids are also evaluated in numpy in the kernels' order (the
blocked Cholesky and inverse by 32-column sub-blocks; x = below Linv^T
by k in order for cp <= 16, by 32 x 32 blocks of the stored Linv^T in
block order, in 2-8 interleaved sums by the bucket's shape, for wider
panels; the product's lower tiles and their mirror) and held against
the twin and the JAX routine on synthetic buckets.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baspacho_tpu as J
import baspacho_tpu_torch as T
from baspacho_tpu.ops.planned_backend import LumpBucket
from baspacho_tpu_torch.ops import kernels
from baspacho_tpu_torch.ops.planned_backend import _dev_bucket, _dev_csr
from baspacho_tpu_torch.ops.schedule import pair_csr, solve_csr
from baspacho_tpu_torch.testing.problems import SMALL, spd_data
from same_native import one_native_library  # noqa: F401 (autouse)

torch.set_num_threads(1)

RTOL = 1e-10  # f64: XLA and torch sum in different orders, and the
#               stored inverse amplifies rounding

_cache = {}


def problem():
    """The meridian problem (gen_meridians(3, 150)): 4 levels, panel
    widths 4..256, below blocks 0..64 rows."""
    if not _cache:
        js, ts = SMALL["meri3"](J), SMALL["meri3"](T)
        data = spd_data(js, 11) * js.skel.padding_mask()
        _cache.update(js=js, ts=ts, data=data,
                      fj=np.asarray(js.factor(data)))
    return _cache["js"], _cache["ts"], _cache["data"], _cache["fj"]


def rel(a, b):
    return np.max(np.abs(np.asarray(a) - np.asarray(b))) / \
        max(np.max(np.abs(np.asarray(b))), 1e-300)


def _levels(js, ts):
    nl = js.skel.num_lumps
    return list(zip(js.backend._factor_schedule(0, nl),
                    ts.backend._factor_schedule(0, nl)))


def test_k1_twin_matches_factor_bucket():
    """Every bucket, factored from the (masked) input: stored panels,
    the embedded inverse included, and the products x x^T."""
    js, ts, data, _ = problem()
    ext_j = jnp.concatenate([jnp.asarray(data), jnp.zeros(2)])
    n = 0
    for (jlbs, _, _, _), (tlbs, _, ptot, _) in _levels(js, ts):
        for jlb, tlb in zip(jlbs, tlbs):
            want, prod_j = jax.jit(
                lambda e, jlb=jlb: js.backend._factor_bucket(e, jlb))(ext_j)
            got = torch.from_numpy(data.copy())[None]
            prod = torch.zeros((1, max(ptot, 1)), dtype=torch.float64)
            b = _dev_bucket(tlb, "cpu")
            kernels.bucket_factor_twin(got, prod, b.off, b.rows, b.cols,
                                       b.cp, b.rp, b.prod_base)
            assert rel(got[0].numpy(), want[:-2]) < RTOL
            if tlb.rp:
                size = len(tlb.off) * tlb.rp * tlb.rp
                seg = prod[0, tlb.prod_base:tlb.prod_base + size].numpy()
                assert rel(seg, prod_j) < RTOL
            n += 1
    assert n >= 8


# ----------------------------------------------------------------------
# K1's grids in numpy, in the kernels' order (csrc/bucket_factor.cu)
# ----------------------------------------------------------------------
SUB = 32   # warp_tiles.cuh kSub: sub-block width, one warp's block
TILE = 64  # bucket_factor.cu kTile: prod_tile's tile edge (rp > 32)


def tri_tile(t):
    """warp_tiles.cuh tri_tile: tile t of a lower tile triangle, row by
    row, from a float32 square root and integer corrections."""
    f = np.float32
    i = int((np.sqrt(f(8.0) * f(t) + f(1.0)) - f(1.0)) * f(0.5))
    while (i + 1) * (i + 2) // 2 <= t:
        i += 1
    while i * (i + 1) // 2 > t:
        i -= 1
    return i, t - i * (i + 1) // 2


def _warp_chol_inv(A, dx, p0, pw):
    """warp_chol_inv: the pw x pw block at (p0, p0) from its lower
    triangle: L on and below the diagonal, X^T = L^-T above, diag X in
    dx; both right-looking, column by column, as the warp's registers
    do (X's row k, once known, is folded into the sums of later rows)."""
    D = A[p0:p0 + pw, p0:p0 + pw]
    L = np.tril(D)
    with np.errstate(invalid="ignore"):
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


def _x_block(A, dx, p0):
    """X of the 32 x 32 diagonal block at p0 from its stored X^T and dx
    (zero outside the lower triangle and on padding)."""
    return np.triu(A[p0:p0 + SUB, p0:p0 + SUB], 1).T + \
        np.diag(dx[p0:p0 + SUB])


def chol_model(P, n):
    """The stored diagonal block of one panel (cp x cp, lower triangle
    read): chol_warp_kernel for cp <= 32, chol_block_kernel's blocked
    right-looking factor and block-row inverse otherwise."""
    cp = P.shape[0]
    A = np.zeros((cp, cp))
    A[:n, :n] = np.tril(P[:n, :n])
    dx = np.zeros(cp)
    if cp <= SUB:
        _warp_chol_inv(A, dx, 0, n)
        return A
    nb = -(-n // SUB)
    npad = nb * SUB
    for p in range(nb):
        p0, q0 = p * SUB, (p + 1) * SUB
        _warp_chol_inv(A, dx, p0, min(SUB, n - p0))
        with np.errstate(invalid="ignore"):
            A[q0:npad, p0:q0] = A[q0:npad, p0:q0] @ _x_block(A, dx, p0).T
            m = nb - p - 1
            for t in range(m * (m + 1) // 2):
                I, J = tri_tile(t)
                r, c = q0 + I * SUB, q0 + J * SUB
                A[r:r + SUB, c:c + SUB] -= \
                    A[r:r + SUB, p0:q0] @ A[c:c + SUB, p0:q0].T
    for i in range(1, nb):  # S = L[i, :i] X[:i, :i]; X[i, :i] = -Dinv S
        r0 = i * SUB
        dinv = _x_block(A, dx, r0)
        for C in range(i):
            c0 = C * SUB
            st = np.zeros((SUB, SUB))
            for M in range(C, i):
                m0 = M * SUB
                xt = _x_block(A, dx, c0).T if M == C else \
                    A[c0:c0 + SUB, m0:m0 + SUB]
                st += xt @ A[r0:r0 + SUB, m0:m0 + SUB].T
            A[c0:c0 + SUB, r0:r0 + SUB] = -(st @ dinv.T)
    return A


def prod_model(x, nrow, cp):
    """x x^T of one panel's solved below rows (rp x cp) as the prod grids
    form it: for cp <= 8 and rp <= 32 one entry at a time
    (prod_entry_kernel), else the lower 64 x 64 tiles (I >= J) of
    prod_tile_kernel mirrored to (J, I); a tile past nrow is zero, rows
    at or past nrow are zero. Every element is written once."""
    rp = x.shape[0]
    xs = np.where(np.arange(rp)[:, None] < nrow, x, 0.0)
    if cp <= 8 and rp <= SUB:
        return xs @ xs.T
    out = np.full((rp, rp), np.nan)
    nt = -(-rp // TILE)
    seen = set()
    for t in range(nt * (nt + 1) // 2):
        I, J = tri_tile(t)
        seen.add((I, J))
        ri = slice(I * TILE, min((I + 1) * TILE, rp))
        ci = slice(J * TILE, min((J + 1) * TILE, rp))
        blk = np.zeros((ri.stop - ri.start, ci.stop - ci.start))
        if ri.start < nrow and ci.start < nrow:
            blk = xs[ri] @ xs[ci].T
        out[ri, ci] = blk
        out[ci, ri] = blk.T
    assert seen == {(I, J) for I in range(nt) for J in range(I + 1)}
    assert not np.isnan(out).any()
    return out


BELOW_FILL = 132  # bucket_factor.cu kBelowFill


def below_groups(B, rp):
    """bucket_factor.cu below_groups: below_tile's 8-row groups a CTA, the
    most of 4, 2, 1 that gives BELOW_FILL CTAs."""
    for ng in (4, 2):
        if B * -(-rp // (8 * ng)) >= BELOW_FILL:
            return ng
    return 1


def below_model(below, A, n, nrow, cp, B, rp):
    """x = below Linv^T over the real rows and columns as the below grids
    form it, Linv from the stored block A (Linv^T above the diagonal, 1 /
    diag L on it, zero elsewhere): below_warp (cp <= 16) sums over k in
    order; below_tile (cp >= 32) takes 32-column blocks J of x, a CTA per
    8 NG rows (below_groups of the bucket's B panels of rp rows), each in
    8 / NG sums, set s over its share of the columns of every 32-column
    block K <= J in order (the zero lower part skipped), the sets joined
    in set order. Rows at or past nrow and columns at or past n keep
    their input."""
    X = np.zeros((cp, cp))  # Linv^T, zero outside the real upper triangle
    X[:n, :n] = np.triu(A[:n, :n], 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        X[np.arange(n), np.arange(n)] = 1.0 / np.diag(A)[:n]
    out = below.copy()
    src = np.where(np.arange(cp) < n, below[:nrow], 0.0)
    with np.errstate(invalid="ignore"):
        if cp <= 16:
            x = np.zeros((nrow, cp))
            for k in range(cp):
                x += src[:, k:k + 1] * X[k]
            out[:nrow, :n] = x[:, :n]
            return out
        ng = below_groups(B, rp)
        nsets = 8 // ng
        w = SUB // nsets
        for r0 in range(0, nrow, 8 * ng):
            rb = src[r0:min(r0 + 8 * ng, nrow)]
            for J in range(-(-n // SUB) - 1, -1, -1):
                js = slice(J * SUB, (J + 1) * SUB)
                sets = np.zeros((nsets, rb.shape[0], SUB))
                for K in range(J + 1):
                    for st in range(nsets):
                        ks = slice(K * SUB + st * w, K * SUB + (st + 1) * w)
                        sets[st] += rb[:, ks] @ X[ks, js]
                acc = sets[0]
                for st in range(1, nsets):
                    acc = acc + sets[st]
                live = min((J + 1) * SUB, n) - J * SUB
                out[r0:r0 + rb.shape[0], J * SUB:J * SUB + live] = \
                    acc[:, :live]
    return out


def factor_model(panels, cols, rows, cp, rp):
    """One batch item's bucket (B, cp + rp, cp) through the three grids:
    the stored panels and the products."""
    out, prods = np.zeros_like(panels), []
    for j, (n, r) in enumerate(zip(cols, rows)):
        A = chol_model(panels[j, :cp], n)
        out[j, :cp] = A
        if rp:
            x = below_model(panels[j, cp:], A, n, r, cp, len(cols), rp)
            out[j, cp:] = x
            prods.append(prod_model(x, r, cp))
    return out, (np.stack(prods) if prods else None)


# cp, rp, panels, real widths, real below rows (cycled over the panels)
K1_CASES = {
    "cp4": (4, 8, 3, [3], [3, 6]),
    "cp4_n_eq_cp_rp0": (4, 0, 2, [4], [0]),
    "cp32": (32, 32, 2, [27, 32], [18, 30]),
    "cp64_n_eq_cp": (64, 64, 2, [64], [63, 64]),
    "cp64_two_tiles": (64, 128, 2, [45, 33], [100, 70]),
    "cp256_rp0": (256, 0, 2, [195, 156], [0]),
    "cp256_zero_tiles": (256, 256, 1, [150], [135]),
    "cp512_rp0": (512, 0, 1, [282], [0]),
    "cp512_n_eq_cp": (512, 16, 1, [512], [11]),
    # the below grids: below_warp past one 128-row chunk, below_tile with
    # row counts not a multiple of its 32-row blocks and widths not a
    # multiple of its 32-column blocks
    "cp4_rp200_below_chunks": (4, 200, 3, [3, 4, 2], [150, 200, 7]),
    "cp16_rp48": (16, 48, 2, [13, 16], [47, 1]),
    "cp32_rp100_below": (32, 100, 2, [21, 32], [99, 33]),
    "cp256_rp96_below": (256, 96, 2, [219, 256], [70, 96]),
    "cp512_rp96_below": (512, 96, 1, [300], [65]),
    # below_tile's longer row blocks: 2 and 4 row groups a CTA
    "cp32_rp2112_two_groups": (32, 2112, 1, [27], [2099]),
    "cp64_rp4224_four_groups": (64, 4224, 1, [50], [4200]),
}


def _k1_bucket(cp, rp, B, widths, rows, seed, batch=2):
    """A compact synthetic bucket in a (batch, B (cp + rp) cp) buffer:
    panel j at offset j (cp + rp) cp, an SPD lower triangle (a A^T + n I)
    and random below rows on the real rows, zero padding; batch item b
    scaled by 1 + b / 100."""
    rng = np.random.RandomState(seed)
    h = cp + rp
    panels = np.zeros((B, h, cp))
    cols = np.array([widths[j % len(widths)] for j in range(B)])
    nrow = np.array([rows[j % len(rows)] if rp else 0 for j in range(B)])
    for j in range(B):
        n, r = cols[j], nrow[j]
        a = rng.rand(n, n) - 0.5
        panels[j, :n, :n] = np.tril(a @ a.T + n * np.eye(n))
        panels[j, cp:cp + r, :n] = rng.rand(r, n) - 0.5
    data = np.stack([panels.reshape(-1) * (1 + b / 100)
                     for b in range(batch)])
    return data, cols, nrow


def _jax_bucket(data, cols, nrow, cp, rp):
    """J's _factor_bucket on each batch item of a compact bucket:
    (stored panels, products or None)."""
    js = problem()[0]
    B = len(cols)
    lb = LumpBucket(
        rp=rp, cp=cp, off=np.arange(B) * (cp + rp) * cp, rows=nrow,
        cols=cols, vec_off=np.zeros(B, np.int64))
    outs, prods = [], []
    fn = jax.jit(lambda e: js.backend._factor_bucket(e, lb))
    for item in data:
        ext, prod = fn(jnp.asarray(item))
        outs.append(np.asarray(ext))
        prods.append(None if prod is None else np.asarray(prod))
    return np.stack(outs), (None if prods[0] is None else np.stack(prods))


@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_grid_models_match_twin_and_factor_bucket(case):
    """The numpy model of chol_warp / chol_block + below + prod_entry /
    prod_tile against the twin and J's _factor_bucket, f64, batch 2:
    stored panels (L, Linv^T, x) and products, within RTOL; the product
    tiles cover rp x rp once, zero past the real rows."""
    cp, rp, B, widths, rows = K1_CASES[case]
    data, cols, nrow = _k1_bucket(cp, rp, B, widths, rows,
                                  seed=len(case) + cp + rp)
    h = cp + rp
    got = torch.from_numpy(data.copy())
    prod = torch.full((2, max(B * rp * rp, 1)), np.nan, dtype=torch.float64)
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64))
    kernels.bucket_factor_twin(got, prod, t(np.arange(B) * h * cp),
                               t(nrow), t(cols), cp, rp, 0)
    want_j, prod_j = _jax_bucket(data, cols, nrow, cp, rp)
    for b in range(2):
        stored, prods = factor_model(data[b].reshape(B, h, cp), cols, nrow,
                                     cp, rp)
        assert rel(stored.reshape(-1), got[b].numpy()) < RTOL
        assert rel(stored.reshape(-1), want_j[b]) < RTOL
        if rp:
            assert rel(prods.reshape(-1), prod[b].numpy()) < RTOL
            assert rel(prods.reshape(-1), prod_j[b]) < RTOL
            live = np.arange(rp) < nrow[:, None]
            assert not prods[~live].any() and \
                not prods.transpose(0, 2, 1)[~live].any()


@pytest.mark.parametrize("cp,n,col", [(4, 3, 1), (64, 60, 40),
                                      (256, 200, 150)])
def test_k1_model_nan_from_failing_column(cp, n, col):
    """A panel that is not positive definite: the kernels' order gives
    NaN in L from the failing column on and finite values before it;
    the twin and J's routine give NaN there too."""
    data, cols, nrow = _k1_bucket(cp, 0, 2, [n], [0], seed=cp, batch=1)
    data = data.reshape(2, cp, cp)
    data[1, col, col] = -1.0
    A = chol_model(data[1], n)
    L = np.tril(A[:n, :n])
    assert np.isfinite(L[:, :col]).all() and np.isnan(L[col:, col]).all()
    assert np.isfinite(chol_model(data[0], n)).all()
    got = torch.from_numpy(data.reshape(1, -1).copy())
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64))
    kernels.bucket_factor_twin(got, None, t([0, cp * cp]), t(nrow), t(cols),
                               cp, 0, 0)
    want_j, _ = _jax_bucket(data.reshape(1, -1), cols, nrow, cp, 0)
    for other in (got[0].numpy(), want_j[0]):
        o = other.reshape(2, cp, cp)[1]
        assert np.isnan(o[col:n, col]).all()
        assert np.isfinite(other.reshape(2, cp, cp)[0]).all()


@pytest.mark.parametrize("cp,n,col", [(4, 3, 1), (32, 30, 7), (64, 60, 40),
                                      (256, 200, 150), (512, 282, 100)])
def test_k1_below_nan_from_failing_column(cp, n, col):
    """A panel with below rows that is not positive definite: in the
    below grids' order x is NaN from the failing column on and finite
    before it, and the other panel finite; the twin and J's routine give
    NaN in x from that column on too."""
    rp, nr = 40, 37
    data, cols, nrow = _k1_bucket(cp, rp, 2, [n], [nr], seed=cp + 1,
                                  batch=1)
    h = cp + rp
    panels = data.reshape(2, h, cp)
    panels[1, col, col] = -1.0
    for j in range(2):
        A = chol_model(panels[j, :cp], n)
        x = below_model(panels[j, cp:], A, n, nr, cp, 2, rp)[:nr, :n]
        if j == 0:
            assert np.isfinite(A).all() and np.isfinite(x).all()
        else:
            assert np.isfinite(x[:, :col]).all()
            assert np.isnan(x[:, col:]).all()
    got = torch.from_numpy(panels.reshape(1, -1).copy())
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64))
    kernels.bucket_factor_twin(got, None, t([0, h * cp]), t(nrow), t(cols),
                               cp, rp, 0)
    want_j, _ = _jax_bucket(panels.reshape(1, -1), cols, nrow, cp, rp)
    for other in (got[0].numpy(), want_j[0]):
        o = other[:2 * h * cp].reshape(2, h, cp)
        assert np.isnan(o[1, cp:cp + nr, col:n]).all()
        assert np.isfinite(o[0]).all()


def test_k1_tri_tile_enumerates_each_lower_tile_once():
    """tri_tile over the tile triangles of every prod_tile launch up to
    rp = 23,040 (BAL 871's widest pair level is 7,680: 7,260 tiles)."""
    for nt in (1, 2, 3, 48, 88, 120, 360):
        got = [tri_tile(t) for t in range(nt * (nt + 1) // 2)]
        assert got == [(I, J) for I in range(nt) for J in range(I + 1)]


def test_k2_twin_matches_apply_pairs():
    """Each level's block pairs subtracted from a random product buffer
    into a random data buffer."""
    js, ts, data, _ = problem()
    rng = np.random.RandomState(5)
    n = 0
    for (_, jpbs, jptot, dense), (_, tpbs, ptot, _) in _levels(js, ts):
        if not ptot:
            continue
        assert dense is None and jptot == ptot
        flat = rng.rand(ptot)
        aux = []
        js.backend._register_aux(jpbs, aux)
        want = jax.jit(lambda e, f, a, jpbs=jpbs: js.backend._apply_pairs(
            e, f, jpbs, a))(
            jnp.concatenate([jnp.asarray(data), jnp.zeros(2)]),
            jnp.asarray(flat), [jnp.asarray(a) for a in aux])
        got = torch.from_numpy(data.copy())[None]
        c = _dev_csr(pair_csr(tpbs), "cpu")
        kernels.segmented_subtract_twin(got, torch.from_numpy(flat)[None],
                                        c.tgt, c.seg_ptr, c.src_idx, 1)
        assert rel(got[0].numpy(), want[:-2]) < RTOL
        n += 1
    assert n >= 3


@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("transpose", [False, True])
def test_k3_twin_matches_diag_solve(nrhs, transpose):
    """Every bucket of the factored problem, one RHS block; the L pass's
    below scatter runs through the K2 twin, as on the main path."""
    js, ts, _, fj = problem()
    order = js.order
    rng = np.random.RandomState(nrhs + 10 * transpose)
    v = rng.rand(order, nrhs)
    ext_j = jnp.concatenate([jnp.asarray(fj), jnp.zeros(2)])
    vv_j = jnp.concatenate([jnp.asarray(v), jnp.zeros((1, nrhs))])
    data_t = torch.from_numpy(fj.copy())[None]
    n = 0
    for jlbs, tlbs in zip(js.backend._solve_schedule(0, js.skel.num_lumps),
                          ts.backend._solve_schedule(0, ts.skel.num_lumps)):
        for jlb, tlb in zip(jlbs, tlbs):
            bidx = jnp.asarray(jlb.below_idx) if jlb.rp else None
            want = jax.jit(lambda e, v, bx, jlb=jlb: js.backend._diag_solve(
                e, v, jlb, order, transpose, bx, use_inv=True))(
                ext_j, vv_j, bidx)
            got = torch.from_numpy(v.copy())[None]
            b = _dev_bucket(tlb, "cpu")
            y = torch.zeros((1, len(tlb.off) * tlb.rp, nrhs),
                            dtype=torch.float64)
            kernels.bucket_solve_twin(data_t, got, y, 0, b.off, b.rows,
                                      b.cols, b.vec_off, b.below_idx, b.cp,
                                      b.rp, transpose)
            if not transpose and tlb.rp:
                c = _dev_csr(solve_csr([tlb], [0], order), "cpu")
                kernels.segmented_subtract_twin(got, y, c.tgt, c.seg_ptr,
                                                c.src_idx, nrhs)
            assert rel(got[0].numpy(), want[:order]) < RTOL
            n += 1
    assert n >= 8


def test_k2_twin_against_loop():
    """Segment sums in a plain loop, batched, width > 1."""
    rng = np.random.RandomState(0)
    out = rng.rand(2, 7, 3)
    src = rng.rand(2, 5, 3)
    tgt = np.array([1, 4, 6])
    seg_ptr = np.array([0, 2, 2, 5])
    src_idx = np.array([0, 3, 1, 1, 4])
    want = out.copy()
    for t in range(3):
        for j in range(seg_ptr[t], seg_ptr[t + 1]):
            want[:, tgt[t]] -= src[:, src_idx[j]]
    got = torch.from_numpy(out.copy())
    kernels.segmented_subtract_twin(got, torch.from_numpy(src),
                                    *(torch.from_numpy(a) for a in
                                      (tgt, seg_ptr, src_idx)), 3)
    assert np.max(np.abs(got.numpy() - want)) < 1e-15


def test_wrappers_route_cpu_to_twins_and_count():
    js, ts, data, _ = problem()
    tlb = ts.backend._factor_schedule(0, ts.skel.num_lumps)[0][0][0]
    b = _dev_bucket(tlb, "cpu")
    kernels.reset_counts()
    d = torch.from_numpy(data.copy())[None]
    prod = torch.zeros((1, max(len(tlb.off) * tlb.rp ** 2, 1)),
                       dtype=torch.float64)
    kernels.bucket_factor(d, prod, b.off, b.rows, b.cols, b.cp, b.rp,
                          b.prod_base)
    c = kernels.COUNTS["bucket_factor"]
    assert (c.launches, c.twin_calls) == (0, 1)
    kernels.reset_counts()
    assert kernels.COUNTS["bucket_factor"].twin_calls == 0


def test_wrappers_never_fall_back_off_cpu():
    """A tensor on a device other than the CPU goes to the kernel path,
    which refuses anything that is not CUDA: no silent twin."""
    d = torch.empty((1, 16), dtype=torch.float64, device="meta")
    i = torch.empty(1, dtype=torch.int64, device="meta")
    kernels.reset_counts()
    with pytest.raises(RuntimeError, match="needs CUDA"):
        kernels.bucket_factor(d, None, i, i, i, 4, 0, 0)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        kernels.segmented_subtract(d, d, i, i, i, 1)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        kernels.bucket_solve(d, d.view(1, 16, 1), None, 0, i, i, i, i, i,
                             4, 0, True)
    assert all(c.twin_calls == 0 and c.launches == 0
               for c in kernels.COUNTS.values())


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_wrappers_refuse_mismatched_batches(device):
    """Every wrapper checks that its operands' batch sizes agree before
    it runs the twin (CPU) or would launch the kernel (any other device)."""
    f = dict(dtype=torch.float64, device=device)
    i = torch.zeros(1, dtype=torch.int64, device=device)
    kernels.reset_counts()
    with pytest.raises(ValueError, match="batch"):
        kernels.bucket_factor(torch.zeros((2, 64), **f),
                              torch.zeros((1, 64), **f), i, i, i, 4, 8, 0)
    with pytest.raises(ValueError, match="batch"):
        kernels.segmented_subtract(torch.zeros((1, 8), **f),
                                   torch.zeros((3, 8), **f), i, i, i, 1)
    with pytest.raises(ValueError, match="batch"):
        kernels.bucket_solve(torch.zeros((1, 64), **f),
                             torch.zeros((16, 8, 1), **f), None, 0, i, i, i,
                             i, i, 4, 0, True)
    with pytest.raises(ValueError, match="batch"):
        kernels.bucket_solve(torch.zeros((2, 64), **f),
                             torch.zeros((2, 8, 1), **f),
                             torch.zeros((1, 8, 1), **f), 0, i, i, i, i, i,
                             4, 8, False)
    assert all(c.twin_calls == 0 and c.launches == 0
               for c in kernels.COUNTS.values())


def test_build_names_and_flags():
    """The library is content-hashed per source set (the shared headers
    included) and built for the Hopper target with the plain-C route."""
    p = kernels.library_path()
    assert os.path.dirname(p) == kernels.BUILD_DIR
    assert p == kernels.library_path()
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    for s in kernels.SOURCES + kernels.HEADERS:
        assert os.path.exists(os.path.join(kernels.CSRC, s))
