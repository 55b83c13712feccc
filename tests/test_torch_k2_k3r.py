"""K2's grids (csrc/segmented_subtract.cu) and K3-rest narrow's
(csrc/tri_solve.cu) modelled in numpy, in the kernels' order, against
their plain twins and against the JAX package (f64, CPU). The CUDA
kernels cannot run here: chip_smoke.py holds them against the twins on
the card (k2_levels, k3r_levels).

K2 follows its plan (`kernels.seg_plan`): a thread per short segment
(at most SEG_SHORT sources, in order from zero), a CTA per chunk of a
longer one (thread t sums sources t, t + 256, t + 512, t + 768 of the
chunk in that order, a butterfly per warp, the warps' sums in warp
order; a one-chunk segment is written by its CTA, the others' chunks
write partials), then a thread per (segment of several chunks, column)
adding its partials in chunk order.

K3-rest narrow follows K3's layout (`kernels.tri_layout`): a warp per
small panel, else a CTA per panel and, past one chunk of below rows, a
CTA per chunk. Its below phases are K3's (modelled in
test_torch_level_solve.py, reused here); its own n x n block is
substituted (x[j] times 1 / d[j], then x[m] -= L[m][j] x[j] for m > j;
Lt from the last column, x[m] -= L[j][m] x[j] for m < j), which both
grids do in column order: the warp on its lanes, the CTA by 32-column
blocks. The model reads data with NaN in the strict upper triangle and
in every padded slot, so a read of either shows up in the result; the
twin and JAX read finite values there (the JAX package needs zero
padding).

Whole paths: the port's factor, solve_l_up_to / solve_lt_up_to, the
from-solves on pseudo-factored data and add_mv_from with both models in
place of the kernels, against the JAX package, on a problem whose L
pass scatters 700 origins onto a 33-row corner (long segments) and on a
meridian problem (short ones, every K3-rest grid). Tolerance 1e-12
relative: the model, the twins and JAX sum in different orders."""

import numpy as np
import pytest
import torch

import baspacho_tpu as J
from baspacho_tpu.ops.planned_backend import LumpBucket as JBucket
import baspacho_tpu_torch as T
from baspacho_tpu_torch.ops import kernels
from baspacho_tpu_torch.ops.planned_backend import (_dev_bucket, _dev_csr,
                                                    _row_bases)
from baspacho_tpu_torch.ops.schedule import LumpBucket, pair_csr, solve_csr
from baspacho_tpu_torch.testing.problems import SMALL, build_flat, spd_data
from test_torch_level_solve import (WARPS, _across, _at, _bfly, _colsums,
                                    _group, _rowdots, rel)
from same_native import one_native_library  # noqa: F401 (autouse)

torch.set_num_threads(1)

RTOL = 1e-12
THREADS = 256  # a chunk's CTA (csrc/segmented_subtract.cu kThreads)
PER = 4        # sources a thread of a chunk (kPer)


# ----------------------------------------------------------------------
# K2: the plan and the model
# ----------------------------------------------------------------------
def k2_model(out, src, plan, width):
    """K2's three grids on numpy (batch, ...) buffers, in place in out."""
    batch = out.shape[0]
    o = out.reshape(batch, -1, width)
    s = src.reshape(batch, -1, width)
    s_ptr, s_src = plan["s_ptr"].astype(np.int64), plan["s_src"]
    n_short = len(plan["s_tgt"])
    if n_short:  # seg_short: a thread a segment, its sources in order
        beg, lens = s_ptr[:-1], np.diff(s_ptr)
        acc = np.zeros((batch, n_short, width))
        for k in range(int(lens.max())):
            live = k < lens
            q = s_src[np.minimum(beg + k, max(len(s_src) - 1, 0))]
            acc = np.where(live[None, :, None], acc + s[:, q], acc)
        o[:, plan["s_tgt"]] -= acc
    part = np.full((batch, plan["n_slot"], width), np.nan)
    c_ptr, l_src = plan["c_ptr"].astype(np.int64), plan["l_src"]
    lanes = np.arange(32)
    for c, dst in enumerate(plan["c_dst"]):  # seg_chunk: a CTA a chunk
        b, e = c_ptr[c], c_ptr[c + 1]
        acc = np.zeros((THREADS, batch, width))
        for u in range(PER):
            j = b + np.arange(THREADS) + u * THREADS
            live = (j < e)[:, None, None]
            q = l_src[np.minimum(j, e - 1)]
            acc = np.where(live, acc + np.moveaxis(s[:, q], 1, 0), acc)
        acc = acc.reshape(WARPS, 32, batch, width)
        for off in (16, 8, 4, 2, 1):
            acc = acc + acc[:, lanes ^ off]
        total = acc[0, 0]
        for w in range(1, WARPS):
            total = total + acc[w, 0]
        if dst >= 0:
            o[:, dst] -= total
        else:
            part[:, -1 - dst] = total
    p_ptr = plan["p_ptr"].astype(np.int64)
    for qs, t in enumerate(plan["p_tgt"]):  # seg_post: chunk order
        total = np.zeros((batch, width))
        for c in range(p_ptr[qs], p_ptr[qs + 1]):
            total = total + part[:, c]
        o[:, t] -= total


def csr_case(lens, n_src, seed):
    """A target-sorted CSR of the given segment lengths over n_src
    sources (targets spaced out, sources at random)."""
    rng = np.random.RandomState(seed)
    lens = np.asarray(lens, dtype=np.int64)
    tgt = np.sort(rng.choice(3 * len(lens), len(lens), replace=False))
    seg_ptr = np.r_[0, np.cumsum(lens)]
    src_idx = rng.randint(0, n_src, int(seg_ptr[-1]))
    return tgt, seg_ptr, src_idx


# every class: short (1 .. 32), one chunk (33 .. 1024), several (1025 ..)
LENS = [1, 2, 3, 5, 31, 32, 33, 100, 1023, 1024, 1025, 2048, 2049, 3100, 7,
        1, 64, 4000]


def test_seg_plan_covers_every_source_in_order():
    """Each class holds what its grid can take, the chunks of a segment
    are as equal as they come, and the plan lists every source once in
    its segment's order; int32 where every value fits and the plan has
    chunks or SEG_I32_SOURCES sources, else int64."""
    tgt, seg_ptr, src_idx = csr_case(LENS, 5000, 0)
    p = kernels.seg_plan(tgt, seg_ptr, src_idx)
    assert p["idx32"] and p["s_src"].dtype == np.int32
    lens = np.diff(seg_ptr)
    short = lens <= kernels.SEG_SHORT
    assert np.array_equal(p["s_tgt"], tgt[short])
    assert np.array_equal(np.diff(p["s_ptr"]), lens[short])
    assert np.array_equal(p["s_src"], np.concatenate(
        [src_idx[a:b] for a, b, k in zip(seg_ptr, seg_ptr[1:], short) if k]))
    assert np.array_equal(p["l_src"], np.concatenate(
        [src_idx[a:b] for a, b, k in zip(seg_ptr, seg_ptr[1:], short)
         if not k]))
    sizes = np.diff(p["c_ptr"])
    assert sizes.max() <= kernels.SEG_CHUNK and sizes.min() > 0
    # the long segments in order, each cut into ceil(len / SEG_CHUNK)
    # chunks differing by at most one source
    c, slot = 0, 0
    for t, n in zip(tgt[~short], lens[~short]):
        k = -(-n // kernels.SEG_CHUNK)
        got = sizes[c:c + k]
        assert got.sum() == n and got.max() - got.min() <= 1
        dst = p["c_dst"][c:c + k]
        if k == 1:
            assert dst[0] == t
        else:
            assert list(dst) == [-1 - s for s in range(slot, slot + k)]
            q = list(p["p_tgt"]).index(t)
            assert p["p_ptr"][q + 1] - p["p_ptr"][q] == k
            slot += k
        c += k
    assert c == len(sizes) and slot == p["n_slot"]
    big = kernels.seg_plan(tgt, seg_ptr, src_idx + 2 ** 31)
    assert not big["idx32"] and big["l_src"].dtype == np.int64
    # short segments alone: int64 below SEG_I32_SOURCES sources, int32 from
    # there on
    for n, want in ((kernels.SEG_I32_SOURCES - 1, False),
                    (kernels.SEG_I32_SOURCES, True)):
        one = np.arange(n)
        q = kernels.seg_plan(one, np.arange(n + 1), one)
        assert q["idx32"] is want and q["c_dst"].size == 0
        assert q["s_src"].dtype == (np.int32 if want else np.int64)


@pytest.mark.parametrize("width", [1, 3, 5])
def test_k2_model_matches_twin(width):
    """The model against the twin, a batch of two, on segments of every
    class; each batch item equals its single run, bitwise."""
    tgt, seg_ptr, src_idx = csr_case(LENS, 5000, width)
    p = kernels.seg_plan(tgt, seg_ptr, src_idx)
    rng = np.random.RandomState(10 + width)
    n_out = 3 * len(LENS)
    out = rng.rand(2, n_out * width) - 0.5
    src = rng.rand(2, 5000 * width) - 0.5
    got = out.copy()
    k2_model(got, src, p, width)
    want = torch.from_numpy(out.copy())
    kernels.segmented_subtract_twin(
        want, torch.from_numpy(src), torch.from_numpy(tgt),
        torch.from_numpy(seg_ptr), torch.from_numpy(src_idx), width)
    assert rel(got, want.numpy()) < RTOL
    for z in range(2):
        one = out[z:z + 1].copy()
        k2_model(one, src[z:z + 1], p, width)
        assert np.array_equal(one[0], got[z])


# ----------------------------------------------------------------------
# K3-rest narrow: the model
# ----------------------------------------------------------------------
def subst(P, n, x, transpose):
    """The own block's substitution in column order (Lt: from the last
    column), x[j] times 1 / d[j]; reads only the lower triangle."""
    x = np.array(x, dtype=np.float64)
    rd = 1.0 / np.diagonal(P)[:n]
    for j in (range(n - 1, -1, -1) if transpose else range(n)):
        x[j] = x[j] * rd[j]
        if transpose:
            x[:j] = x[:j] - P[j, :j] * x[j]
        else:
            x[j + 1:n] = x[j + 1:n] - P[j + 1:n, j] * x[j]
    return x


def _tri_warp(P, cp, rp, n, nrows, b, g, transpose, row_lanes):
    """tri_l_warp_kernel / tri_lt_warp_kernel on one panel and RHS
    column (the below phases are K3's warp grids')."""
    G, RG = cp, 32 // cp
    lane = np.arange(32)
    gi, m = lane // G, lane % G
    below = P[cp:]
    y = np.full(rp, np.nan)
    if not transpose:
        x = subst(P, n, b, False)
        xl = np.where(m < n, x[np.minimum(m, n - 1)], 0.0)
        if row_lanes:
            for r in range(rp):
                y[r] = 0.0
                if r < nrows:
                    for c in range(cp):
                        y[r] += (below[r, c] if c < n else 0.0) * xl[c]
            return x, y
        for r0 in range(0, rp, RG):
            r = r0 + gi
            e = np.where((r < nrows) & (m < n), _at(below, r, m), 0.0)
            d = _bfly(e * xl, _group(G))
            for ln in np.nonzero((m == 0) & (r < rp))[0]:
                y[r[ln]] = d[ln]
        return x, y
    acc = np.zeros(32)
    for i0 in range(0, nrows, RG):
        i = i0 + gi
        mask = (i < nrows) & (m < n)
        acc = np.where(mask, acc + _at(below, i, m) *
                       g[np.minimum(i, max(nrows - 1, 0))], acc)
    acc = _bfly(acc, _across(G))
    bl = np.where(m < n, b[np.minimum(m, n - 1)], 0.0)
    return subst(P, n, (bl - acc)[:n], True), y


def _tri_cta(P, cp, rp, n, nrows, b, g, transpose, crc, nchunk):
    """tri_{l,lt}_diag_kernel and tri_{l,lt}_rows_kernel on one panel and
    RHS column, in their launch order."""
    below = P[cp:]
    y = np.full(rp, np.nan)
    if not transpose:
        x = subst(P, n, b, False)
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
            if r0 < nrows:
                red = _colsums(below, r0, min(r0 + crc, nrows), n, cp, g,
                               True)
                part[c, :n] = [sum(red[:, j], 0.0) for j in range(n)]
    s = np.zeros(n)
    if nchunk == 1 and nrows > 0:
        red = _colsums(below, 0, nrows, n, cp, g, True)
        s = np.array([sum(red[:, j], 0.0) for j in range(n)])
    for c in range(-(-nrows // crc) if nchunk > 1 else 0):
        s = s + part[c, :n]
    return subst(P, n, b - s, True), y


def tri_model(data, vv, y, y_base, off, rows, cols, vec_off, below_idx, cp,
              rp, transpose):
    """K3-rest's wrapper call in numpy, in the kernels' order, in place in
    vv and y (numpy arrays, the wrapper's layout)."""
    crc, nchunk = kernels.tri_layout(cp, rp, len(off))
    batch, order, nrhs = vv.shape
    h = cp + rp
    below_idx = np.asarray(below_idx).reshape(len(off), -1)
    for z in range(batch):
        for k in range(nrhs):
            v = vv[z, :, k]
            for p in range(len(off)):
                P = data[z, int(off[p]):int(off[p]) + h * cp].reshape(h, cp)
                n, v0 = int(cols[p]), int(vec_off[p])
                nrows = int(rows[p]) if rp else 0
                q = below_idx[p][:nrows] if rp else np.zeros(0, int)
                g = np.where(q != order, v[np.minimum(q, order - 1)], 0.0)
                b = v[v0:v0 + n].copy()
                if crc == 0:
                    x, yp = _tri_warp(P, cp, rp, n, nrows, b, g, transpose,
                                      nrhs > 1 and cp <= 8)
                else:
                    x, yp = _tri_cta(P, cp, rp, n, nrows, b, g, transpose,
                                     crc, nchunk)
                v[v0:v0 + n] = x
                if not transpose and rp:
                    y[z, y_base + p * rp:y_base + (p + 1) * rp, k] = yp


# cp, rp, real widths, real below rows, sentinels (panel, row); the warp
# grid's buckets hold SOLVE_WARP_PANELS panels or more, or cp-4 panels
TRI_CASES = {
    "cp4_rp64_warp": (4, 64, (3, 4, 1) * 86, (45, 64, 0) * 86,
                      ((0, 5), (1, 40), (63, 44))),
    "cp8_rp16_warp": (8, 16, (5, 8) * 128, (16, 9) * 128, ((1, 2),)),
    "cp32_rp32_warp": (32, 32, (32, 21) * 128, (32, 17) * 128, ((0, 31),)),
    "cp4_rp64_few_panels": (4, 64, (3, 4), (45, 64), ((0, 5),)),
    "cp4_rp512_chunks": (4, 512, (3, 2), (300, 512), ((0, 299),)),
    "cp8_rp16_cta": (8, 16, (5, 8), (16, 9), ((1, 2),)),
    "cp2_rp8_cta": (2, 8, (1, 2, 2), (8, 3, 0), ((1, 1),)),
    "cp16_rp1536_chunks": (16, 1536, (15, 9), (1000, 1536), ((0, 0),)),
    "cp64_rp64_one_chunk": (64, 64, (60, 37), (50, 9), ((0, 3),)),
    "cp128_rp256_chunks": (128, 256, (100, 128), (200, 129), ((1, 128),)),
    "cp256_rp0": (256, 0, (256, 130), (0, 0), ()),
    "cp512_rp32_chunks": (512, 32, (300, 512), (20, 32), ((0, 7),)),
}
_cache = {}


def tri_case(name):
    """(port bucket, JAX bucket, clean data (zero padding, Linv^T-like
    values strictly above the diagonal), model data (NaN there and in
    the padding), order) of a synthetic bucket of lower-triangular
    panels, as factor_up_to and the pseudo-factor leave them."""
    if name not in _cache:
        cp, rp, cols, rows, sentinels = TRI_CASES[name]
        rng = np.random.RandomState(cp + 3 * rp + len(cols))
        h, B = cp + rp, len(cols)
        clean = np.zeros((B, h, cp))
        junk = np.full((B, h, cp), np.nan)
        for i, (n, r) in enumerate(zip(cols, rows)):
            L = np.tril(rng.rand(n, n) - 0.5) / np.sqrt(n)
            L[np.arange(n), np.arange(n)] = 1.0 + rng.rand(n)
            up = np.triu(rng.rand(n, n), 1)
            clean[i, :n, :n] = L + up
            junk[i, :n, :n] = np.where(up > 0, np.nan, L)
            clean[i, cp:cp + r, :n] = junk[i, cp:cp + r, :n] = \
                rng.rand(r, n) - 0.5
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
        _cache[name] = (tlb, JBucket(**kw), clean.reshape(-1),
                        junk.reshape(-1), order)
    return _cache[name]


def _jax_backend():
    if "jb" not in _cache:
        _cache["jb"] = SMALL["meri2"](J).backend
    return _cache["jb"]


def _with_k2(tlb, order, vv, y, nrhs):
    """vv after K2's vv[bidx] -= y (its twin), as the L pass runs it."""
    o = torch.from_numpy(vv.copy())
    if tlb.rp:
        c = _dev_csr(solve_csr([tlb], [0], order), "cpu")
        kernels.segmented_subtract_twin(o, torch.from_numpy(y), c.tgt,
                                        c.seg_ptr, c.src_idx, nrhs)
    return o.numpy()


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("name", list(TRI_CASES))
def test_k3r_model_matches_twin_and_jax(name, nrhs, transpose):
    """The model on data with NaN above the diagonal and in the padding
    against the twin (finite values there) and the JAX package's
    _diag_solve(use_inv=False) on zero-padded data, after K2's scatter of
    y in the L pass; y's padded rows are written as zeros. A batch of two
    equals its single runs, bitwise."""
    import jax
    import jax.numpy as jnp
    tlb, jlb, clean, junk, order = tri_case(name)
    rng = np.random.RandomState(nrhs + 2 * transpose)
    v = rng.rand(2, order, nrhs) - 0.5
    data = np.stack([junk, junk * 1.5])
    y = np.full((2, len(tlb.off) * tlb.rp, nrhs), np.nan)
    got = v.copy()
    tri_model(data, got, y, 0, tlb.off, tlb.rows, tlb.cols, tlb.vec_off,
              tlb.below_idx, tlb.cp, tlb.rp, transpose)
    assert not np.isnan(got).any()
    if not transpose and tlb.rp:
        assert not np.isnan(y).any()
        for p, r in enumerate(tlb.rows):
            assert not y[0, p * tlb.rp + r:(p + 1) * tlb.rp].any()
    one = v[1:].copy()
    y1 = np.full((1,) + y.shape[1:], np.nan)
    tri_model(data[1:], one, y1, 0, tlb.off, tlb.rows, tlb.cols, tlb.vec_off,
              tlb.below_idx, tlb.cp, tlb.rp, transpose)
    assert np.array_equal(one[0], got[1])
    assert np.array_equal(y1[0], y[1], equal_nan=True)
    b = _dev_bucket(tlb, "cpu")
    padded = np.where(np.isnan(junk) & (clean == 0), 7.0, clean)
    tv = torch.from_numpy(v[:1].copy())
    ty = torch.full(y[:1].shape, np.nan, dtype=torch.float64)
    kernels.tri_solve_twin(torch.from_numpy(padded)[None], tv, ty, 0, b.off,
                           b.rows, b.cols, b.vec_off, b.below_idx, b.cp, b.rp,
                           transpose)
    jb = _jax_backend()
    want = np.asarray(jax.jit(lambda e, vj, bx: jb._diag_solve(
        e, vj, jlb, order, transpose, bx if tlb.rp else None,
        use_inv=False))(jnp.concatenate([jnp.asarray(clean), jnp.zeros(2)]),
                        jnp.concatenate([jnp.asarray(v[0]),
                                         jnp.zeros((1, nrhs))]),
                        jnp.asarray(jlb.below_idx)))[:order]
    if not transpose:
        if tlb.rp:
            assert rel(y[:1], ty.numpy()) < RTOL
        got = _with_k2(tlb, order, got, y, nrhs)
        twin = _with_k2(tlb, order, tv.numpy(), ty.numpy(), nrhs)
    else:
        twin = tv.numpy()
    assert rel(twin[0], want) < RTOL
    assert rel(got[0], want) < RTOL


# ----------------------------------------------------------------------
# whole paths: both models in place of the kernels, against JAX
# ----------------------------------------------------------------------
def _k2_op(out, src, tgt, seg_ptr, src_idx, width, layout=None):
    o = out.numpy()
    k2_model(o, src.numpy().reshape(src.shape[0], -1),
             kernels.seg_plan(tgt.numpy(), seg_ptr.numpy(), src_idx.numpy()),
             width)


def _tri_op(data, vv, y, y_base, off, rows, cols, vec_off, below_idx, cp,
            rp, transpose):
    tri_model(data.numpy(), vv.numpy(),
              y.numpy() if y is not None else None, y_base, off.numpy(),
              rows.numpy(), cols.numpy(), vec_off.numpy(),
              below_idx.numpy(), cp, rp, transpose)


def path_problem(name):
    """(JAX solver, port solver, data, split span) of a whole-path case:
    "schur", a flat 20-variable corner under 700 eliminated origins
    (SMALL's elim_range, larger), whose L pass scatters the origins'
    below rows onto the corner's 33 rows, ~60-100 sources a row; "meri2",
    SMALL's meridian problem split at a middle lump, whose pair levels
    and partial solves take short segments and every grid of K3-rest."""
    if name not in _cache:
        if name == "schur":
            kw = dict(n=20, fill=0.25, schur=700, elim_ranges=[0, 700])
            js, ts = build_flat(J, 1, **kw), build_flat(T, 1, **kw)
            t = 700
        else:
            js, ts = SMALL[name](J), SMALL[name](T)
            t = int(ts.skel.lump_to_span[ts.skel.num_lumps // 2])
        data = spd_data(js, 5) * js.skel.padding_mask()
        _cache[name] = (js, ts, data, t)
    return _cache[name]


@pytest.fixture
def models(monkeypatch):
    """The port's programs run K2's and K3-rest's models; K2's chunks cut
    at 32 sources, so that the long segments take several and the post
    grid runs."""
    monkeypatch.setattr(kernels, "segmented_subtract", _k2_op)
    monkeypatch.setattr(kernels, "tri_solve", _tri_op)
    monkeypatch.setattr(kernels, "SEG_CHUNK", 32)


def _plan_classes(ts, t):
    """Segments in each class of the K2 plans of the factor's pair levels
    and of the up-to L pass: (short, chunks, with a post)."""
    nl = ts.skel.num_lumps
    csrs = [pair_csr(lv[1]) for lv in ts.backend._factor_schedule(0, nl)
            if lv[2]]
    csrs += [solve_csr(lv, _row_bases(lv)[0], ts.order)
             for lv in ts.backend._solve_schedule(0, ts._lump_of_span(t))]
    seen = [0, 0, 0]
    for c in csrs:
        p = kernels.seg_plan(c.tgt, c.seg_ptr, c.src_idx)
        for i, key in enumerate(("s_tgt", "c_dst", "p_tgt")):
            seen[i] += len(p[key])
    return seen


@pytest.mark.parametrize("name", ["schur", "meri2"])
def test_models_on_partial_paths_match_jax(name, models):
    """factor_up_to, solve_l_up_to / solve_lt_up_to (nrhs 1 and 3), the
    from-solves on pseudo-factored data, the full factor and
    add_mv_from(0) / add_mv_from(t) of the port with the models in place
    of the kernels, against the JAX package."""
    js, ts, data, t = path_problem(name)
    short, chunks, post = _plan_classes(ts, t)
    assert (chunks and post) if name == "schur" else short
    d = torch.from_numpy(data)
    rng = np.random.RandomState(3)
    fu_j = np.asarray(js.factor_up_to(data, t))
    fu = ts.factor_up_to(d, t)
    for nrhs in (1, 3):
        b = rng.rand(ts.order, nrhs)
        vl = ts.solve_l_up_to(fu, t, torch.from_numpy(b))
        assert rel(vl.numpy(), np.asarray(js.solve_l_up_to(fu_j, t, b))) \
            < RTOL
        vt = ts.solve_lt_up_to(fu, t, torch.from_numpy(b))
        assert rel(vt.numpy(), np.asarray(js.solve_lt_up_to(fu_j, t, b))) \
            < RTOL
    pf_j = np.asarray(js.pseudo_factor_from(fu_j, t))
    pf = torch.from_numpy(pf_j.copy())
    b = rng.rand(ts.order, 3)
    for op in ("solve_l_from", "solve_lt_from"):
        got = getattr(ts, op)(pf, t, torch.from_numpy(b))
        assert rel(got.numpy(), np.asarray(getattr(js, op)(pf_j, t, b))) \
            < RTOL
    f = ts.factor(d)
    ri, _ = ts.skel.data_coords()
    live = ri != ts.order
    assert rel(f.numpy()[live], np.asarray(js.factor(data))[live]) < RTOL
    x, out = rng.rand(ts.order, 3), rng.rand(ts.order, 3)
    for start in (0, t):
        got = ts.add_mv_from(d, start, torch.from_numpy(x),
                             torch.from_numpy(out), 0.7)
        want = np.asarray(js.add_mv_from(data, start, x, out, 0.7))
        assert rel(got.numpy(), want) < RTOL
