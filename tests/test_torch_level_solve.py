"""K3's grids (csrc/bucket_solve.cu) modelled in numpy, in the kernels'
order, against the plain twin `_diag_solve_plain` and against the JAX
package's PlannedBackend._diag_solve(use_inv=True) (f64, CPU). The CUDA
kernels cannot run here: chip_smoke.py holds them against the twin on
the card (k3_levels).

The model follows `kernels.solve_layout`: one warp per small panel (4 <=
cp <= 32, rp cp <= 1024, 256 panels or more: lanes over (row group,
column), column sums per lane joined across the groups by a butterfly,
row dots by a butterfly within a group, x in the lanes), else a CTA of
eight warps per panel for its own rows (Lt: a thread a row of the strict
upper) and, past one chunk of below rows, a CTA per chunk (L: row dots
into y after the diag grid; Lt: column sums into partials that the diag
grid adds in chunk order, the warps' sums joined in warp order).
Partial buffers and y start as NaN, so a value that a work item reads
but none wrote shows up in the result.

Synthetic buckets hold panels of one padded shape with different real
widths and row counts, sentinels (bidx == order) among the real below
rows, and NaN in every padded slot of the model's copy of the data (the
twin and JAX read clean, zero-padded data). Tolerance 1e-12 relative:
the model, the twin and JAX sum in different orders."""

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
from baspacho_tpu_torch.testing.problems import SMALL, spd_data
from same_native import one_native_library  # noqa: F401 (autouse)

torch.set_num_threads(1)

RTOL = 1e-12
WARPS = 8  # warps per CTA (csrc/bucket_solve.cu kWarps)
# cp, rp, real widths, real below rows, the real rows made sentinels
# (panel, row); a warp grid's bucket holds at least SOLVE_WARP_PANELS
# panels (the widths and rows tiled)
CASES = {
    "cp4_rp64_warp": (4, 64, (3, 4, 3) * 86, (45, 64, 0) * 86,
                      ((0, 5), (1, 40), (63, 44))),
    "cp8_rp16_warp": (8, 16, (5, 8) * 128, (16, 9) * 128, ((1, 2),)),
    "cp32_rp32_warp": (32, 32, (32, 21) * 128, (32, 17) * 128, ((0, 31),)),
    "cp32_rp0_warp": (32, 0, (30, 7) * 128, (0, 0) * 128, ()),
    "cp4_rp64_one_chunk": (4, 64, (3, 4), (45, 64), ((0, 5),)),
    "cp32_rp0_one_cta": (32, 0, (30, 7), (0, 0), ()),
    "cp4_rp512_chunks": (4, 512, (3, 2), (300, 512), ((0, 299),)),
    "cp16_rp1536_chunks": (16, 1536, (15, 9), (1000, 1536), ((0, 0),)),
    "cp32_rp64_one_chunk": (32, 64, (32, 19), (40, 64), ((1, 63),)),
    "cp64_rp64_one_chunk": (64, 64, (60, 37), (50, 9), ((0, 3),)),
    "cp128_rp256_chunks": (128, 256, (100, 128), (200, 129), ((1, 128),)),
    "cp256_rp0": (256, 0, (256, 130), (0, 0), ()),
    "cp512_rp32_chunks": (512, 32, (300, 512), (20, 32), ((0, 7),)),
}
_cache = {}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def stored_panel(rng, cp, rp, n, r):
    """A factored panel as bucket_factor stores it: L on and below the
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
    padding, order) of a synthetic bucket."""
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
def _bfly(v, offsets):
    """__shfl_xor_sync butterfly over the last axis (the lanes)."""
    lanes = np.arange(v.shape[-1])
    for o in offsets:
        v = v + v[..., lanes ^ o]
    return v


def _group(G):    # group_sum: offsets G/2 .. 1
    return [G >> j for j in range(1, 6) if G >> j]


def _across(G):   # across_groups: offsets G .. 16
    return [o for o in (1, 2, 4, 8, 16) if o >= G]


def _at(A, i, c):
    """A[i, c] with the indices clipped into A (the value is masked out
    wherever they were out of range)."""
    return A[np.clip(i, 0, A.shape[0] - 1), np.clip(c, 0, A.shape[1] - 1)]


def _warp(P, cp, rp, n, nrows, b, g, transpose, row_lanes=False):
    """solve_l_warp_kernel / solve_lt_warp_kernel on one panel and RHS
    column: b its own rows' values (n), g its below rows' gathers
    (nrows; 0 for a sentinel); row_lanes: the L pass's y by a lane a row,
    its columns in order (cp <= 8 at nrhs > 1). Returns (the own rows'
    new values, y)."""
    G, RG = cp, 32 // cp
    lane = np.arange(32)
    gi, m = lane // G, lane % G
    below = P[cp:]
    bl = np.where(m < n, b[np.minimum(m, n - 1)], 0.0)
    acc = np.zeros(32)
    y = np.full(rp, np.nan)
    z = np.full(n, np.nan)
    if not transpose:
        for i0 in range(0, n, RG):
            i = i0 + gi
            bi = bl[i & 31]
            mask = (i < n) & (m > i) & (m < n)
            acc = np.where(mask, acc + _at(P, i, m) * bi, acc)
        acc = _bfly(acc, _across(G))
        d = np.where(m < n, _at(P, m, m), 1.0)  # padding: no division
        x = np.where(m < n, bl / d + acc, 0.0)
        if row_lanes:
            for r in range(rp):
                y[r] = 0.0
                if r < nrows:
                    for c in range(cp):  # zeros past the real columns
                        y[r] += (below[r, c] if c < n else 0.0) * x[c]
            return x[:n], y
        for r0 in range(0, rp, RG):
            r = r0 + gi
            e = np.where((r < nrows) & (m < n), _at(below, r, m), 0.0)
            d = _bfly(e * x, _group(G))
            for ln in np.nonzero((m == 0) & (r < rp))[0]:
                y[r[ln]] = d[ln]
        return x[:n], y
    for i0 in range(0, nrows, RG):
        i = i0 + gi
        mask = (i < nrows) & (m < n)
        acc = np.where(mask, acc + _at(below, i, m) *
                       g[np.minimum(i, max(nrows - 1, 0))], acc)
    acc = _bfly(acc, _across(G))
    x = bl - acc
    for j0 in range(0, n, RG):
        j = j0 + gi
        e = np.where((j < n) & (m > j) & (m < n), _at(P, j, m), 0.0)
        d = _bfly(e * x, _group(G))
        xj = x[j & 31]
        for ln in np.nonzero((m == 0) & (j < n))[0]:
            z[j[ln]] = xj[ln] / P[j[ln], j[ln]] + d[ln]
    return z, y


def _lanes(cp):
    G = min(cp, 32)
    lane = np.arange(32)
    gi, m = lane // G, lane % G
    CT = max(1, cp // 32)
    cols = m[None, :] + 32 * np.arange(CT)[:, None]  # (CT, 32)
    return G, 32 // G, gi, m, cols


def _colsums(A, first, end, n, cp, weight, below_rows):
    """The warps' column sums over rows [first, end) of A (the strict
    upper's own rows, or below rows), weight[i] per row, joined across
    the groups: red (WARPS, CT * 32), red[w][col]."""
    G, RG, gi, m, cols = _lanes(cp)
    red = np.full((WARPS, cols.size), np.nan)
    for w in range(WARPS):
        acc = np.zeros(cols.shape)
        for ib in range(first + w * RG, end, WARPS * RG):
            i = ib + gi
            mask = (i < end)[None, :] & (cols < n)
            if not below_rows:
                mask &= cols > i[None, :]
            wi = weight[np.clip(i, 0, len(weight) - 1)]
            acc = np.where(mask, acc + _at(A, i[None, :], cols) * wi, acc)
        acc = _bfly(acc, _across(G))
        for t in range(cols.shape[0]):
            for ln in np.nonzero(gi == 0)[0]:
                red[w, m[ln] + 32 * t] = acc[t, ln]
    return red


def _rowdots(A, first, end, lim, n, cp, x):
    """The warps' row dots with x over below rows [first, end) (real
    below the lim-th): {row: dot}."""
    G, RG, gi, m, cols = _lanes(cp)
    xs = np.where(cols < n, x[np.clip(cols, 0, len(x) - 1)], 0.0)
    out = {}
    for w in range(WARPS):
        for rb in range(first + w * RG, end, WARPS * RG):
            r = rb + gi
            mask = (r < lim)[None, :] & (cols < n)
            d = np.zeros(32)
            for t in range(cols.shape[0]):
                d = d + np.where(mask[t], _at(A, r, cols[t]) * xs[t], 0.0)
            d = _bfly(d, _group(G))
            for ln in np.nonzero((m == 0) & (r < end))[0]:
                out[r[ln]] = d[ln]
    return out


def _cta(P, cp, rp, n, nrows, b, g, transpose, crc, nchunk):
    """solve_{l,lt}_diag_kernel and solve_{l,lt}_rows_kernel on one panel
    and RHS column, in their launch order."""
    below = P[cp:]
    y = np.full(rp, np.nan)
    if not transpose:
        red = _colsums(P, 0, n, n, cp, b, False)
        x = np.array([b[j] / P[j, j] + sum(red[:, j], 0.0) for j in range(n)])
        chunks = [(0, rp)] if nchunk == 1 else \
            [(c * crc, min(c * crc + crc, rp)) for c in range(nchunk)]
        for r0, r1 in chunks:
            for r, d in _rowdots(below, r0, r1, nrows, n, cp, x).items():
                y[r] = d
        return x, y
    part = np.full((max(nchunk, 1), cp), np.nan)
    if nchunk > 1:
        for c in range(nchunk):
            r0 = c * crc
            if r0 >= nrows:
                continue
            red = _colsums(below, r0, min(r0 + crc, nrows), n, cp, g, True)
            for j in range(n):
                part[c, j] = sum(red[:, j], 0.0)
    s = np.zeros(n)
    if nchunk == 1 and nrows > 0:
        red = _colsums(below, 0, nrows, n, cp, g, True)
        s = np.array([sum(red[:, j], 0.0) for j in range(n)])
    nc = -(-nrows // crc) if nchunk > 1 else 0
    for c in range(nc):
        s = s + part[c, :n]
    x = b - s
    z = np.zeros(n)
    for j in range(n):  # a thread a row, its columns in order
        z[j] = x[j] / P[j, j]
        for m in range(j + 1, n):
            z[j] += P[j, m] * x[m]
    return z, y


def solve_model(data, vv, y, y_base, off, rows, cols, vec_off, below_idx, cp,
                rp, transpose):
    """K3's wrapper call in numpy, in the kernels' order, in place in vv
    and y (numpy arrays, the wrapper's layout)."""
    crc, nchunk = kernels.solve_layout(cp, rp, len(off))
    batch, order, nrhs = vv.shape
    h = cp + rp
    for z in range(batch):
        for k in range(nrhs):
            v = vv[z, :, k]
            for p in range(len(off)):
                P = data[z, int(off[p]):int(off[p]) + h * cp].reshape(h, cp)
                n, v0 = int(cols[p]), int(vec_off[p])
                nrows = int(rows[p]) if rp else 0
                q = np.asarray(below_idx[p][:nrows]) if rp else np.zeros(0)
                g = np.where(q != order,
                             v[np.minimum(q, order - 1).astype(int)], 0.0)
                b = v[v0:v0 + n].copy()
                if crc == 0:
                    x, yp = _warp(P, cp, rp, n, nrows, b, g, transpose,
                                  nrhs > 1 and cp <= 8)
                else:
                    x, yp = _cta(P, cp, rp, n, nrows, b, g, transpose, crc,
                                 nchunk)
                v[v0:v0 + n] = x
                if not transpose and rp:
                    y[z, y_base + p * rp:y_base + (p + 1) * rp, k] = yp


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
    solve_model(data, got, y, 0, tlb.off, tlb.rows, tlb.cols, tlb.vec_off,
                tlb.below_idx, tlb.cp, tlb.rp, transpose)
    return v, got, y


def test_solve_layout_follows_the_shape():
    """Which grid each shape takes, and that a layout depends on (cp, rp)
    only: chunks hold whole CTA steps and cover every below row."""
    L = kernels.solve_layout
    assert L(4, 64, 527478) == (0, 1)  # BAL's and Schur's points
    assert L(4, 256, 256) == (0, 1)
    assert L(32, 32, 1000) == (0, 1)
    assert L(4, 64, 2) == (256, 1)     # few panels: a CTA each
    assert L(4, 32, 255) == (256, 1)
    assert L(32, 64, 1000) == (256, 1)  # too big for one warp: one chunk
    assert L(16, 1536, 1) == (256, 6)  # FLAT's 15-wide lump
    assert L(128, 3072, 1) == (64, 48)  # BAL's pair levels
    assert L(256, 7680, 1) == (32, 240)
    assert L(512, 0, 1) == (16, 0)
    for cp in (4, 8, 16, 32, 64, 128, 256, 512):
        for rp in (0, 8, 64, 256, 1024, 7680):
            for B in (1, 255, 256, 10000):
                crc, nchunk = L(cp, rp, B)
                if crc == 0:
                    assert 4 <= cp <= 32 and B >= kernels.SOLVE_WARP_PANELS
                    assert rp * cp <= kernels.SOLVE_WARP_ELEMS
                    continue
                rg = 32 // min(cp, 32)
                assert crc % (WARPS * rg) == 0
                assert crc <= kernels.SOLVE_MAX_CHUNK
                assert nchunk == -(-rp // crc)
    for bad in (3, 12, 1024):
        with pytest.raises(ValueError, match="power of two"):
            L(bad, 8, 1)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("name", list(CASES))
def test_k3_model_matches_twin_and_jax(name, nrhs, transpose):
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
    kernels._diag_solve_plain(torch.from_numpy(clean)[None], tv, ty, 0,
                              b.off, b.rows, b.cols, b.vec_off, b.below_idx,
                              b.cp, b.rp, transpose)
    if not transpose:
        if tlb.rp:
            assert rel(y, ty.numpy()) < RTOL
        got = _with_k2(tlb, order, got, y, nrhs)
        twin = _with_k2(tlb, order, tv.numpy(), ty.numpy(), nrhs)
    else:
        twin = tv.numpy()
    want = jax_diag_solve(kw, clean, v[0], order, transpose)
    assert rel(twin[0], want) < RTOL
    assert rel(got[0], want) < RTOL


@pytest.mark.parametrize("name", ["cp4_rp64_warp", "cp4_rp64_one_chunk",
                                  "cp16_rp1536_chunks",
                                  "cp512_rp32_chunks"])
def test_k3_model_batch_items_equal_single_runs(name):
    """A batch of two through the model equals each item run alone,
    bitwise, in both passes: the order of every sum depends on the
    shape only."""
    tlb, _, _, junk, order = case(name)
    for transpose in (False, True):
        v, got, y = run_model(name, 3, transpose, batch=2, seed=5)
        data = np.stack([junk * (1.0 + 0.5 * z) for z in range(2)])
        for z in range(2):
            v1 = v[z:z + 1].copy()
            y1 = np.full((1,) + y.shape[1:], np.nan)
            solve_model(data[z:z + 1], v1, y1, 0, tlb.off, tlb.rows,
                        tlb.cols, tlb.vec_off, tlb.below_idx, tlb.cp, tlb.rp,
                        transpose)
            assert np.array_equal(v1[0], got[z])
            assert np.array_equal(y1[0], y[z], equal_nan=True)


_meri = {}


def meri():
    """The meridian problem (gen_meridians(3, 150)) factored by the JAX
    PLANNED backend: buckets cp 4..256, below rows 0..64."""
    if not _meri:
        js, ts = SMALL["meri3"](J), SMALL["meri3"](T)
        data = spd_data(js, 11) * js.skel.padding_mask()
        _meri.update(js=js, ts=ts, fj=np.asarray(js.factor(data)))
    return _meri["js"], _meri["ts"], _meri["fj"]


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("nrhs", [1, 3])
def test_k3_model_on_a_planned_factor(nrhs, transpose, monkeypatch):
    """Every bucket of a factor from the JAX PLANNED backend: the model
    (with K2's twin in the L pass) against _diag_solve(use_inv=True).
    The warp grid's panel threshold is lowered to 64, so that this small
    factor's largest buckets (up to 122 panels) take it."""
    monkeypatch.setattr(kernels, "SOLVE_WARP_PANELS", 64)
    js, ts, fj = meri()
    order = js.order
    rng = np.random.RandomState(nrhs + 10 * transpose)
    v = rng.rand(order, nrhs)
    ext_j = jnp.concatenate([jnp.asarray(fj), jnp.zeros(2)])
    vv_j = jnp.concatenate([jnp.asarray(v), jnp.zeros((1, nrhs))])
    layouts = set()
    for jlbs, tlbs in zip(js.backend._solve_schedule(0, js.skel.num_lumps),
                          ts.backend._solve_schedule(0, ts.skel.num_lumps)):
        for jlb, tlb in zip(jlbs, tlbs):
            bidx = jnp.asarray(jlb.below_idx) if jlb.rp else None
            want = jax.jit(lambda e, vj, bx, jlb=jlb: js.backend._diag_solve(
                e, vj, jlb, order, transpose, bx, use_inv=True))(
                ext_j, vv_j, bidx)
            got = v.copy()[None]
            y = np.full((1, len(tlb.off) * tlb.rp, nrhs), np.nan)
            solve_model(fj[None], got, y, 0, tlb.off, tlb.rows, tlb.cols,
                        tlb.vec_off, tlb.below_idx, tlb.cp, tlb.rp,
                        transpose)
            if not transpose:
                got = _with_k2(tlb, order, got, y, nrhs)
            assert rel(got[0], want[:order]) < RTOL
            layouts.add(kernels.solve_layout(tlb.cp, tlb.rp,
                                             len(tlb.off))[0] > 0)
    assert layouts == {False, True}  # both the warp and the CTA grids
