"""K3-wide's grids (csrc/wide_solve.cu) modelled in numpy, in the
kernels' order, against the plain twin `wide_solve_twin` and against the
JAX package's PlannedBackend._diag_solve(use_inv=True) (f64, CPU). The
CUDA kernels cannot run here: chip_smoke.py holds them against the twin
on the card (k3w_levels).

The model follows `kernels.wide_solve_layout`. Both passes' column sums
are one pattern (col_sums): a work item reads a block of rows over a
strip of columns, warp w summing rows w, w + 8, ... in order, the warps
joined in warp order, into one partial per (block, column, RHS column);
a post adds a column's partials, warp w every eighth in order, joined in
warp order. L pass: tiles (row block c <= column block s) of the stored
upper triangle, edge E, weights the own rows; the post adds b / P[j][j]
and writes t and vv; then a warp per below row forms y. Lt pass: chunks
of 64 below rows over strips of 256 columns, weights the gathered rows
(sentinel zero); one chunk writes t = b - sum itself, more go through
the post; then a warp per row of the stored triangle. Partial buffers
and y start as NaN and the model's data holds NaN in every padded slot,
so a value read but never written shows up in the result. Tolerance
1e-12 relative: the model, the twin and JAX sum in different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from types import SimpleNamespace

import baspacho_tpu as J
import baspacho_tpu_torch as T
from baspacho_tpu.ops.planned_backend import LumpBucket as JBucket
from baspacho_tpu.ops.planned_backend import PlannedBackend as JPlanned
from baspacho_tpu_torch.ops import kernels
from baspacho_tpu_torch.ops.planned_backend import _dev_bucket, _dev_csr
from baspacho_tpu_torch.ops.schedule import LumpBucket, solve_csr
from baspacho_tpu_torch.testing.problems import spd_data, wide_below
from same_native import one_native_library  # noqa: F401 (autouse)

torch.set_num_threads(1)

RTOL = 1e-12
WARPS = 8      # warps per CTA (csrc/wide_solve.cu kWarps)
STRIP = kernels.WIDE_SOLVE_STRIP
CHUNK = kernels.WIDE_SOLVE_CHUNK
# cp, rp, real widths, real below rows, the real rows made sentinels
# (panel, row)
CASES = {
    # two panels, rows not a multiple of the chunk (200 = 3 x 64 + 8),
    # widths not a multiple of 32, four chunks through the post
    "cp1024_rp256_chunks": (1024, 256, (1000, 777), (200, 129),
                            ((0, 5), (0, 199), (1, 64))),
    # WIDE_BELOW's shape: one chunk, so the rows grid writes t itself
    "cp1024_rp64_one_chunk": (1024, 64, (540,), (36,), ((0, 0),)),
    # a strip past the padded width (1152 = 4.5 strips), three chunks
    "cp1152_rp130_chunks": (1152, 130, (1100, 1152), (130, 65),
                            ((1, 3),)),
    # FLAT's corner: tiles of 128, no below rows
    "cp3072_rp0": (3072, 0, (2985,), (0,), ()),
}
_cache = {}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def stored_panel(rng, cp, rp, n, r):
    """A factored panel as wide_factor stores it: L on and below the
    diagonal, Linv^T strictly above, x below, over n real columns and r
    real below rows; zero padding."""
    p = np.zeros((cp + rp, cp))
    m = rng.rand(n, n) - 0.5
    L = np.linalg.cholesky(m @ m.T + n * np.eye(n))
    p[:n, :n] = np.tril(L) + np.triu(np.linalg.inv(L).T, 1)
    p[cp:cp + r, :n] = rng.rand(r, n) - 0.5
    return p


def case(name):
    """(port bucket, JAX bucket fields, clean data, data with NaN in the
    padding, order) of a synthetic wide bucket."""
    if name not in _cache:
        cp, rp, cols, rows, sentinels = CASES[name]
        rng = np.random.RandomState(cp + 7 * rp)
        h, B = cp + rp, len(cols)
        data = np.zeros(B * h * cp)
        real = np.zeros(B * h * cp, dtype=bool)
        for i, (n, r) in enumerate(zip(cols, rows)):
            data[i * h * cp:(i + 1) * h * cp] = \
                stored_panel(rng, cp, rp, n, r).reshape(-1)
            q = real[i * h * cp:(i + 1) * h * cp].reshape(h, cp)
            q[:n, :n] = True
            q[cp:cp + r, :n] = True
        vec_off = np.concatenate([[0], np.cumsum(cols)[:-1]])
        order = sum(cols) + max(rows) + 40
        bidx = np.full((B, max(rp, 1)), order, dtype=np.int32)
        for i, r in enumerate(rows):
            bidx[i, :r] = np.sort(rng.choice(np.arange(sum(cols), order), r,
                                             replace=False))
        for p, r in sentinels:
            bidx[p, r] = order
        kw = dict(rp=rp, cp=cp, off=np.arange(B, dtype=np.int32) * h * cp,
                  rows=np.array(rows, np.int32),
                  cols=np.array(cols, np.int32),
                  vec_off=vec_off.astype(np.int32), below_idx=bidx)
        tlb = LumpBucket(**kw)
        tlb.members = np.arange(B)
        junk = np.where(real, data, np.nan)
        _cache[name] = (tlb, kw, data, junk, order)
    return _cache[name]


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
def tri_tile(t):
    """warp_tiles.cuh tri_tile: tile t of a lower tile triangle, row by
    row: (I, J), J <= I."""
    i = int((np.sqrt(np.float32(8.0) * np.float32(t) + np.float32(1.0)) -
             np.float32(1.0)) * np.float32(0.5))
    while (i + 1) * (i + 2) // 2 <= t:
        i += 1
    while i * (i + 1) // 2 > t:
        i -= 1
    return i, t - i * (i + 1) // 2


def col_sums(A, r0, r1, c0, width, g, real):
    """col_sums: sum_r A[r][j] g[r - r0] over rows [r0, r1) for the strip
    [c0, c0 + width) (columns past A's read as zero), elements where
    real(r, j) is false read as zero: warp w on rows r0 + w, r0 + w + 8,
    ... in order, the warps joined in warp order. g: (rows, nrhs)."""
    j = c0 + np.arange(width)
    jc = np.minimum(j, A.shape[1] - 1)
    out = np.zeros((width, g.shape[1]))
    for w in range(WARPS):
        acc = np.zeros_like(out)
        for r in range(r0 + w, r1, WARPS):
            e = np.where(real(r, j) & (j < A.shape[1]), A[r, jc], 0.0)
            acc += e[:, None] * g[r - r0][None, :]
        out += acc
    return out


def post_sum(parts):
    """The post's sum of one column's partials (ne, nrhs): warp w on
    entries w, w + 8, ... in order, the warps joined in warp order."""
    out = np.zeros(parts.shape[1:])
    for w in range(WARPS):
        acc = np.zeros_like(out)
        for e in range(w, parts.shape[0], WARPS):
            acc += parts[e]
        out += acc
    return out


def warp_dot(a, x):
    """A warp's dot of a row with x (nrhs columns): lane l sums elements
    l, l + 32, ... in order, then a butterfly over 16, 8, 4, 2, 1."""
    m = len(a)
    k = -(-m // 32)
    if k == 0:
        return np.zeros(x.shape[1:])
    ap = np.zeros(32 * k)
    ap[:m] = a
    xp = np.zeros((32 * k, x.shape[1]))
    xp[:m] = x
    ap, xp = ap.reshape(k, 32), xp.reshape(k, 32, -1)
    lanes = np.zeros((32, x.shape[1]))
    for e in range(k):
        lanes += ap[e][:, None] * xp[e]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[np.arange(32) ^ o]
    return lanes[0]


def wide_model(data, vv, y, y_base, off, rows, cols, vec_off, below_idx, cp,
               rp, transpose):
    """K3-wide's grids on numpy arrays, in place in vv (batch, order,
    nrhs) and y (batch, Y, nrhs), as wide_solve's arguments."""
    order, nrhs = vv.shape[1], vv.shape[2]
    edge, nchunk = kernels.wide_solve_layout(cp, rp)
    h = cp + rp
    for z in range(vv.shape[0]):
        v = vv[z]
        for p in range(len(off)):
            P = data[z, off[p]:off[p] + h * cp].reshape(h, cp)
            n, v0 = int(cols[p]), int(vec_off[p])
            nrows = int(rows[p]) if rp else 0
            b = v[v0:v0 + n].copy()
            t = np.full((cp, nrhs), np.nan)
            if not transpose:
                nblk = -(-cp // edge)
                part = np.full((nblk, cp, nrhs), np.nan)
                for tt in range(nblk * (nblk + 1) // 2):
                    s, c = tri_tile(tt)
                    m0, c0 = c * edge, s * edge
                    if c0 >= n:
                        continue
                    m1 = min(m0 + edge, n)
                    g = np.zeros((edge, nrhs))
                    g[:m1 - m0] = b[m0:m1]
                    sums = col_sums(P, m0, m1, c0, edge, g,
                                    lambda m, j: (m < j) & (j < n))
                    live = min(c0 + edge, n) - c0
                    part[c, c0:c0 + live] = sums[:live]
                for j in range(n):
                    t[j] = post_sum(part[:j // 32 * 32 // edge + 1, j]) + \
                        b[j] / P[j, j]
                v[v0:v0 + n] = t[:n]
                for r in range(rp):
                    y[z, y_base + p * rp + r] = \
                        warp_dot(P[cp + r, :n], t[:n]) if r < nrows else 0.0
            else:
                q = below_idx[p * rp:(p + 1) * rp] if rp else []
                nstrip = -(-cp // STRIP)
                part = np.full((nchunk, cp, nrhs), np.nan)
                for c in range(nchunk):
                    r0, r1 = c * CHUNK, min(c * CHUNK + CHUNK, nrows)
                    if nchunk > 1 and r0 >= nrows:
                        continue
                    g = np.zeros((CHUNK, nrhs))
                    for r in range(r0, r1):
                        if q[r] != order:
                            g[r - r0] = v[q[r]]
                    for s in range(nstrip):
                        c0 = s * STRIP
                        if c0 >= n:
                            continue
                        live = min(c0 + STRIP, n) - c0
                        sums = col_sums(P[cp:], r0, r1, c0, STRIP, g,
                                        lambda r, j: j < n)[:live]
                        if nchunk == 1:
                            t[c0:c0 + live] = b[c0:c0 + live] - sums
                        else:
                            part[c, c0:c0 + live] = sums
                if nchunk > 1:
                    ne = -(-nrows // CHUNK)
                    for j in range(n):
                        t[j] = b[j] - post_sum(part[:ne, j])
                for j in range(n):
                    v[v0 + j] = warp_dot(P[j, j + 1:n], t[j + 1:n]) + \
                        t[j] / P[j, j]


# ----------------------------------------------------------------------
# the tests
# ----------------------------------------------------------------------
def _with_k2(tlb, order, vv, y, nrhs):
    """vv after K2's vv[bidx] -= y (its twin), as the L pass runs it."""
    o = torch.from_numpy(vv.copy())
    if tlb.rp:
        c = _dev_csr(solve_csr([tlb], [0], order), "cpu")
        kernels.segmented_subtract_twin(o, torch.from_numpy(y), c.tgt,
                                        c.seg_ptr, c.src_idx, nrhs)
    return o.numpy()


def jax_diag_solve(kw, data, v, order, transpose):
    """PlannedBackend._diag_solve(use_inv=True) of the JAX package on this
    one bucket, one item (the L pass's below scatter included)."""
    jb = JBucket(**kw)
    fake = SimpleNamespace(
        _read_panels=lambda ext, lb: JPlanned._read_panels(None, ext, lb),
        _bucket_xidx=lambda sb, o: JPlanned._bucket_xidx(None, sb, o),
        _tri_stored=lambda P, c, x, t: JPlanned._tri_stored(None, P, c, x,
                                                            t))
    ext = jnp.concatenate([jnp.asarray(data), jnp.zeros(2)])
    vv = jnp.concatenate([jnp.asarray(v), jnp.zeros((1, v.shape[1]))])
    bidx = jnp.asarray(jb.below_idx) if jb.rp else None
    out = JPlanned._diag_solve(fake, ext, vv, jb, order, transpose, bidx,
                               use_inv=True)
    return np.asarray(out)[:order]


def run_model(name, nrhs, transpose, batch=1, seed=0):
    tlb, _, _, junk, order = case(name)
    rng = np.random.RandomState(seed + nrhs)
    v = rng.rand(batch, order, nrhs) - 0.5
    data = np.stack([junk * (1.0 + 0.5 * z) for z in range(batch)])
    y = np.full((batch, len(tlb.off) * tlb.rp, nrhs), np.nan)
    got = v.copy()
    wide_model(data, got, y, 0, tlb.off, tlb.rows, tlb.cols, tlb.vec_off,
               tlb.below_idx.reshape(-1), tlb.cp, tlb.rp, transpose)
    return v, got, y


def test_wide_solve_layout_follows_the_shape():
    """The layout depends on (cp, rp) only: BAL 871's and FLAT's wide
    buckets give every grid that reads a panel at least one CTA per SM of
    the H100 (132), the rows grid on the below blocks at least two, and
    the chunks cover every below row."""
    L = kernels.wide_solve_layout
    assert L(1024, 7168) == (64, 112)  # BAL: 136 tiles, 448 rows CTAs
    assert L(3072, 4096) == (128, 64)  # BAL: 300 tiles, 768 rows CTAs
    assert L(4096, 0) == (128, 1)      # BAL's last lump: 528 tiles
    assert L(3072, 0) == (128, 1)      # FLAT and Schur's corner
    assert L(1024, 64) == (64, 1)      # WIDE_BELOW: one chunk
    for cp, rp in ((1024, 7168), (3072, 4096), (4096, 0), (3072, 0)):
        edge, nchunk = L(cp, rp)
        nblk = -(-cp // edge)
        assert nblk * (nblk + 1) // 2 >= 132
        if rp:
            assert nchunk * -(-cp // STRIP) >= 2 * 132
    for cp in range(640, 8193, 128):
        for rp in (0, 1, 63, 64, 65, 7168):
            edge, nchunk = L(cp, rp)
            assert edge in (64, 128) and cp % edge == 0 and edge % 32 == 0
            assert nchunk >= 1 and nchunk * CHUNK >= rp
            assert (nchunk - 1) * CHUNK < max(rp, 1)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("name", list(CASES))
def test_k3w_model_matches_twin_and_jax(name, nrhs, transpose):
    """The model on data with NaN in the padding, against the plain twin
    on clean data and the JAX bucket solve on it, after K2's scatter of
    y in the L pass; y's padded rows are written as zeros."""
    tlb, kw, clean, junk, order = case(name)
    v, got, y = run_model(name, nrhs, transpose)
    assert not np.isnan(got).any()
    if not transpose and tlb.rp:
        assert not np.isnan(y).any()
        for p, r in enumerate(tlb.rows):
            assert not y[0, p * tlb.rp + r:(p + 1) * tlb.rp].any()
    b = _dev_bucket(tlb, "cpu")
    tv = torch.from_numpy(v.copy())
    ty = torch.full(y.shape, np.nan, dtype=torch.float64)
    kernels.wide_solve_twin(torch.from_numpy(clean)[None], tv, ty, 0, b.off,
                            b.rows, b.cols, b.vec_off, b.below_idx, b.cp,
                            b.rp, transpose)
    if not transpose:
        if tlb.rp:
            assert rel(y, ty.numpy()) < RTOL
        got = _with_k2(tlb, order, got, y, nrhs)
        twin = _with_k2(tlb, order, tv.numpy(), ty.numpy(), nrhs)
    else:
        twin = tv.numpy()
    assert rel(got, twin) < RTOL
    want = jax_diag_solve(kw, clean, v[0], order, transpose)
    assert rel(twin[0], want) < RTOL
    assert rel(got[0], want) < RTOL


@pytest.mark.parametrize("name", ["cp1024_rp256_chunks",
                                  "cp1024_rp64_one_chunk"])
def test_k3w_model_batch_items_equal_single_runs(name):
    """A batch of two through the model equals each item run alone,
    bitwise, in both passes (every sum's order depends on the shape
    only), and the twin's batch agrees with the model's."""
    tlb, _, _, junk, order = case(name)
    b = _dev_bucket(tlb, "cpu")
    for transpose in (False, True):
        v, got, y = run_model(name, 3, transpose, batch=2, seed=5)
        data = np.stack([junk * (1.0 + 0.5 * z) for z in range(2)])
        for z in range(2):
            v1 = v[z:z + 1].copy()
            y1 = np.full((1,) + y.shape[1:], np.nan)
            wide_model(data[z:z + 1], v1, y1, 0, tlb.off, tlb.rows, tlb.cols,
                       tlb.vec_off, tlb.below_idx.reshape(-1), tlb.cp, tlb.rp,
                       transpose)
            assert np.array_equal(v1[0], got[z])
            assert np.array_equal(y1[0], y[z], equal_nan=True)
        tv = torch.from_numpy(v.copy())
        ty = torch.zeros(y.shape, dtype=torch.float64)
        kernels.wide_solve_twin(torch.from_numpy(np.nan_to_num(data)), tv,
                                ty, 0, b.off, b.rows, b.cols, b.vec_off,
                                b.below_idx, b.cp, b.rp, transpose)
        assert rel(got, tv.numpy()) < RTOL
        if not transpose:
            assert rel(y, ty.numpy()) < RTOL


_wb = {}


def planned_wide_below():
    """WIDE_BELOW factored by the JAX PLANNED backend: a 540-wide lump
    (padded 1024) with 36 below rows, beside a 120-wide one."""
    if not _wb:
        js, ts = wide_below(J), wide_below(T, device="cpu")
        data = spd_data(js, 3) * js.skel.padding_mask()
        _wb.update(js=js, ts=ts, fj=np.asarray(js.factor(data)))
    return _wb["js"], _wb["ts"], _wb["fj"]


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("nrhs", [1, 3])
def test_k3w_model_on_a_planned_factor(nrhs, transpose):
    """The wide bucket of a JAX PLANNED factor of WIDE_BELOW: the model
    (with K2's twin in the L pass) and the twin against
    _diag_solve(use_inv=True)."""
    js, ts, fj = planned_wide_below()
    order = js.order
    rng = np.random.RandomState(nrhs + 10 * transpose)
    v = rng.rand(order, nrhs)
    ext_j = jnp.concatenate([jnp.asarray(fj), jnp.zeros(2)])
    vv_j = jnp.concatenate([jnp.asarray(v), jnp.zeros((1, nrhs))])
    seen = []
    for jlbs, tlbs in zip(js.backend._solve_schedule(0, js.skel.num_lumps),
                          ts.backend._solve_schedule(0, ts.skel.num_lumps)):
        for jlb, tlb in zip(jlbs, tlbs):
            if tlb.cp <= kernels.NARROW_MAX:
                continue
            bidx = jnp.asarray(jlb.below_idx) if jlb.rp else None
            want = jax.jit(lambda e, vj, bx, jlb=jlb: js.backend._diag_solve(
                e, vj, jlb, order, transpose, bx, use_inv=True))(
                ext_j, vv_j, bidx)
            got = v.copy()[None]
            y = np.full((1, len(tlb.off) * tlb.rp, nrhs), np.nan)
            wide_model(fj[None], got, y, 0, tlb.off, tlb.rows, tlb.cols,
                       tlb.vec_off, np.asarray(tlb.below_idx).reshape(-1),
                       tlb.cp, tlb.rp, transpose)
            b = _dev_bucket(tlb, "cpu")
            tv = torch.from_numpy(v.copy())[None]
            ty = torch.zeros(y.shape, dtype=torch.float64)
            kernels.wide_solve_twin(torch.from_numpy(fj.copy())[None], tv, ty,
                                    0, b.off, b.rows, b.cols, b.vec_off,
                                    b.below_idx, b.cp, b.rp, transpose)
            twin = tv.numpy()
            if not transpose:
                got = _with_k2(tlb, order, got, y, nrhs)
                twin = _with_k2(tlb, order, twin, ty.numpy(), nrhs)
            assert rel(got[0], want[:order]) < RTOL
            assert rel(twin[0], want[:order]) < RTOL
            seen.append(tlb.rp)
    assert len(seen) == 1 and seen[0] > 0  # the 540-wide lump, below rows
