"""K5's grids (csrc/add_mv.cu) modelled in numpy, in the kernels' order,
against the plain twin `_add_mv_plain` and against the JAX package's
make_add_mv bucket step (f64, CPU). The CUDA kernels cannot run here:
chip_smoke.py holds them against the twin on the card (k5_levels).

The model follows `kernels.mv_layout`: one warp per small panel (cp <= 32,
its rows in lane groups, row dots by a butterfly within the group,
column sums joined across the groups), else CTAs over (chunk of rows,
column strip), each warp on every eighth row, the warps' column sums
joined in warp order, and a post pass that adds each own row's strip and
chunk partials in order. Its partial buffers start as NaN, so a partial
the post reads but no work item wrote shows up in the result.

Synthetic buckets hold two panels of one padded shape with different
real widths and row counts, a sentinel (bidx == order) among the real
below rows of some, and garbage in every padded slot of the port's copy
of the data (the JAX step reads clean, zero-padded data). Tolerance 1e-10
relative: the model, the twin and JAX sum in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from types import SimpleNamespace

from baspacho_tpu.ops.planned_backend import LumpBucket as JBucket
from baspacho_tpu.ops.planned_backend import PlannedBackend as JPlanned
from baspacho_tpu_torch.ops import kernels
from baspacho_tpu_torch.ops.planned_backend import _dev_bucket, _dev_csr
from baspacho_tpu_torch.ops.schedule import LumpBucket, solve_csr
from same_native import one_native_library  # noqa: F401 (autouse)

torch.set_num_threads(1)

RTOL = 1e-10
WARPS = 8  # warps per CTA (csrc/add_mv.cu kWarps)
# cp, rp, real widths, real below rows, a real row made a sentinel
CASES = {
    "cp4_rp64_warp": (4, 64, (3, 4), (60, 17), (0, 5)),
    "cp8_rp64_warp": (8, 64, (8, 5), (64, 33), (1, 2)),
    "cp32_rp0_warp": (32, 0, (32, 21), (0, 0), None),
    "cp32_rp64_one_cta": (32, 64, (32, 21), (64, 40), None),
    "cp16_rp128_one_cta": (16, 128, (9, 16), (100, 128), (1, 7)),
    "cp16_rp512_chunks": (16, 512, (9, 16), (300, 512), (1, 7)),
    "cp64_rp64_one_cta": (64, 64, (60, 37), (50, 9), None),
    "cp128_rp1024_chunks": (128, 1024, (81, 128), (600, 333), (0, 5)),
    "cp512_rp0_chunks": (512, 0, (300, 512), (0, 0), None),
    "cp1024_rp256_strips": (1024, 256, (1000, 700), (200, 256), (1, 0)),
}
_cache = {}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def case(name):
    """(port bucket, JAX bucket fields, clean data, data with garbage in
    the padding, order) of a two-panel bucket."""
    if name not in _cache:
        cp, rp, cols, rows, sentinel = CASES[name]
        rng = np.random.RandomState(cp + rp)
        h = cp + rp
        data = np.zeros(2 * h * cp)
        mask = np.zeros(2 * h * cp)
        for i, (n, r) in enumerate(zip(cols, rows)):
            p = data[i * h * cp:(i + 1) * h * cp].reshape(h, cp)
            m = rng.rand(n, n) - 0.5
            p[:n, :n] = np.tril(m @ m.T + n * np.eye(n))
            p[cp:cp + r, :n] = rng.rand(r, n) - 0.5
            q = mask[i * h * cp:(i + 1) * h * cp].reshape(h, cp)
            q[:n, :n] = np.tril(np.ones((n, n)))
            q[cp:cp + r, :n] = 1
        order = sum(cols) + max(rows) + 40
        bidx = np.full((2, max(rp, 1)), order, dtype=np.int32)
        for i, r in enumerate(rows):
            bidx[i, :r] = np.sort(rng.choice(np.arange(sum(cols), order), r,
                                             replace=False))
        if sentinel:
            bidx[sentinel] = order
        kw = dict(rp=rp, cp=cp, off=np.array([0, h * cp], np.int32),
                  rows=np.array(rows, np.int32),
                  cols=np.array(cols, np.int32),
                  vec_off=np.array([0, cols[0]], np.int32), below_idx=bidx)
        tlb = LumpBucket(**kw)
        tlb.members = np.array([0, 1])
        # the strict upper triangle holds garbage too, as a factor's Linv^T
        junk = data + (1 - mask) * rng.rand(len(data))
        _cache[name] = (tlb, kw, data, junk, order)
    return _cache[name]


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


def _gather(i, cp, n, end, v0, bi, order, xz):
    """row_gather over lanes: the end of each row's real columns and its
    gather (x_own[i] for an own row, x[bidx] for a below row)."""
    own = i < cp
    lim = np.where(own, np.where(i < n, i + 1, 0), np.where(i < end, n, 0))
    g = np.zeros(i.shape)
    o = own & (i < n)
    g[o] = xz[v0 + i[o]]
    b = ~own & (i < end)
    q = bi[i[b] - cp]
    g[b] = np.where(q != order, xz[np.minimum(q, len(xz) - 1)], 0.0)
    return lim, g


def _panel(data, z, off, cp, h):
    return data[z, off:off + h * cp].reshape(h, cp)


def _warp_panel(P, xz, oz, yz, ybase, n, nrows, v0, bi, order, cp, rp,
                alpha):
    """mv_warp_kernel on one panel, one RHS column."""
    RG, lanes = 32 // cp, np.arange(32)
    gi, m = lanes // cp, lanes % cp
    end, h = cp + nrows, cp + rp
    xo = np.where(m < n, xz[v0 + np.minimum(m, n - 1)], 0.0)
    acc, rd = np.zeros(32), np.full(32, np.nan)
    for i0 in range(0, end, RG):
        i = i0 + gi
        lim, g = _gather(i, cp, n, end, v0, bi, order, xz)
        e = np.where(m < lim, P[np.minimum(i, h - 1), m], 0.0)
        acc = np.where((i >= cp) | (m < i), acc + e * g, acc)
        d = _bfly(e * xo, _group(cp))
        for ln in np.nonzero((m == 0) & (lim > 0))[0]:
            if i[ln] < cp:
                rd[i[ln]] = d[ln]
            else:
                yz[ybase + i[ln] - cp] = -alpha * d[ln]
    acc = _bfly(acc, _across(cp))
    for j in range(n):
        oz[v0 + j] += alpha * (rd[j] + acc[j])
    if rp:
        yz[ybase + nrows:ybase + rp] = 0.0


def _chunk_panel(P, xz, oz, yz, ybase, n, nrows, v0, bi, order, cp, rp,
                 alpha, W, crc, nchunk):
    """mv_chunk_kernel / wide_mv_chunk_kernel over one panel's (chunk,
    strip) items, then mv_post_kernel, one RHS column."""
    h, nstrip = cp + rp, -(-cp // W)
    G = min(W, 32)
    RG, CT = 32 // G, max(1, W // 32)
    lanes = np.arange(32)
    gi, m = lanes // G, lanes % G
    end = cp + nrows
    fused = nchunk == 1 and nstrip == 1
    colp = np.full((nchunk, cp), np.nan)
    rowp = np.full((nstrip, h), np.nan)
    rd = np.full(cp, np.nan)
    for c in range(nchunk):
        for s in range(nstrip):
            r0, c0 = c * crc, s * W
            r1 = min(r0 + crc, h)
            if r1 <= cp and r1 <= c0:
                continue
            rend = min(r1, end)
            cols = c0 + m[None, :] + 32 * np.arange(CT)[:, None]  # (CT, 32)
            xo = np.where(cols < n, xz[v0 + np.minimum(cols, n - 1)], 0.0)
            acc = np.zeros((WARPS, CT, 32))
            for w in range(WARPS):
                for ib in range(r0 + w * RG, rend, WARPS * RG):
                    i = ib + gi
                    lim, g = _gather(i, cp, n, end, v0, bi, order, xz)
                    e = np.where(cols < lim, P[np.minimum(i, h - 1),
                                               np.minimum(cols, cp - 1)],
                                 0.0)
                    d = np.zeros(32)
                    for t in range(CT):
                        d = d + e[t] * xo[t]
                    d = _bfly(d, _group(G))
                    acc[w] = np.where((i >= cp) | (cols < i), acc[w] + e * g,
                                      acc[w])
                    for ln in np.nonzero((m == 0) & (lim > 0))[0]:
                        il = i[ln]
                        if il >= cp and nstrip == 1:
                            yz[ybase + il - cp] = -alpha * d[ln]
                        elif fused:
                            rd[il] = d[ln]
                        else:
                            rowp[s, il] = d[ln]
            if nstrip == 1 and rp:
                for il in range(max(r0, end, cp), r1):
                    yz[ybase + il - cp] = 0.0
            acc = _bfly(acc, _across(G))
            red = acc[:, :, :G].reshape(WARPS, CT * G)  # red[w][m + 32 t]
            v = np.zeros(CT * G)
            for w in range(WARPS):
                v = v + red[w]
            for j in range(min(W, n - c0)):
                if fused:
                    oz[v0 + c0 + j] += alpha * (rd[c0 + j] + v[j])
                else:
                    colp[c, c0 + j] = v[j]
    if fused:
        return
    c1 = ((end if nrows else n) - 1) // crc
    for i in range(n):
        # mv_post_kernel: the row's strips then its chunks, warp w summing
        # entries w, w + 8, ..., then the warps in order
        entries = [rowp[s, i] for s in range(i // W + 1)] + \
            [colp[c, i] for c in range(i // crc, c1 + 1)]
        acc = np.zeros(WARPS)
        for e, v in enumerate(entries):
            acc[e % WARPS] += v
        tot = 0.0
        for w in range(WARPS):
            tot += acc[w]
        oz[v0 + i] += alpha * tot
    if nstrip > 1:
        for r in range(rp):
            acc = 0.0
            if r < nrows:
                for s in range(nstrip):
                    acc += rowp[s, cp + r]
            yz[ybase + r] = -alpha * acc


def mv_model(data, x, out, y, y_base, off, rows, cols, vec_off, below_idx,
             cp, rp, alpha):
    """K5's wrapper call in numpy, in the kernels' order, in place in out
    and y (numpy arrays, the wrapper's layout)."""
    W, crc, nchunk = kernels.mv_layout(cp, rp)
    batch, order, nrhs = x.shape
    h = cp + rp
    for z in range(batch):
        for k in range(nrhs):
            xz, oz = x[z, :, k], out[z, :, k]
            yz = y[z, :, k] if rp else None
            for p in range(len(off)):
                a = (_panel(data, z, int(off[p]), cp, h), xz, oz, yz,
                     y_base + p * rp, int(cols[p]),
                     int(rows[p]) if rp else 0, int(vec_off[p]),
                     below_idx[p], order, cp, rp, alpha)
                if crc == 0:
                    _warp_panel(*a)
                else:
                    _chunk_panel(*a, W, crc, nchunk)


def _with_k2(tlb, order, out, y, nrhs):
    """out after K2's out[bidx] -= y (its twin), as make_add_mv runs it."""
    o = torch.from_numpy(out.copy())
    if tlb.rp:
        c = _dev_csr(solve_csr([tlb], [0], order), "cpu")
        kernels.segmented_subtract_twin(o, torch.from_numpy(y), c.tgt,
                                        c.seg_ptr, c.src_idx, nrhs)
    return o.numpy()


def jax_bucket_step(kw, data, x, out, alpha, order):
    """PlannedBackend.make_add_mv of the JAX package on this one bucket
    (its bucket list and order stood in), one item."""
    jb = JBucket(**kw)
    fake = SimpleNamespace(
        plan=SimpleNamespace(skel=SimpleNamespace(order=order, num_lumps=1)),
        _bucket_lumps=lambda lds, with_below_idx: [jb],
        _read_panels=lambda ext, lb: JPlanned._read_panels(None, ext, lb))
    fn, aux = JPlanned.make_add_mv(fake, 0)
    return np.asarray(fn(jnp.asarray(data), jnp.asarray(x), jnp.asarray(out),
                         alpha, [jnp.asarray(a) for a in aux]))


def run_model(name, nrhs, batch=1, seed=0):
    tlb, _, _, junk, order = case(name)
    rng = np.random.RandomState(seed + nrhs)
    x = rng.rand(batch, order, nrhs) - 0.5
    out = rng.rand(batch, order, nrhs)
    data = np.stack([junk * (1.0 + 0.5 * z) for z in range(batch)])
    y = np.full((batch, len(tlb.off) * tlb.rp, nrhs), np.nan)
    got = out.copy()
    mv_model(data, x, got, y, 0, tlb.off, tlb.rows, tlb.cols, tlb.vec_off,
             tlb.below_idx, tlb.cp, tlb.rp, -0.6)
    return data, x, out, got, y


def test_mv_layout_follows_the_shape():
    """Which grid each shape takes, and that a layout depends on (cp, rp)
    only: chunks hold whole warp steps, strips cover every column."""
    L = kernels.mv_layout
    assert L(4, 64) == (4, 0, 1)        # BAL's and Schur's points
    assert L(16, 0) == (16, 0, 1)
    assert L(32, 64)[1] > 0             # too big for one warp
    assert L(128, 3072) == (128, 64, 50)
    assert L(256, 7680) == (256, 32, 248)
    assert L(4096, 0) == (512, 32, 128)
    assert L(3072, 4096) == (512, 32, 224)
    assert L(16, 512) == (16, 256, 3)   # rows per chunk capped
    for cp in (4, 8, 16, 32, 64, 128, 256, 512, 1024, 1536, 4096):
        for rp in (0, 8, 64, 1024, 7680):
            W, crc, nchunk = L(cp, rp)
            if crc == 0:
                assert 4 <= cp <= 32 and \
                    (cp + rp) * cp <= kernels.MV_WARP_ELEMS
                continue
            rg = 32 // min(W, 32)
            assert crc % (WARPS * rg) == 0 and crc <= kernels.MV_MAX_CHUNK
            # the post reads a 32-column block's partials as one list
            assert crc % 32 == 0 and (W % 32 == 0 or W == cp)
            assert nchunk * crc >= cp + rp > (nchunk - 1) * crc
            assert W == min(cp, kernels.MV_STRIP) and W <= 32 * 16


@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("name", list(CASES))
def test_mv_model_matches_twin_and_jax(name, nrhs):
    """The model on data with garbage in the padding and above the
    diagonal, against the plain twin on the same data and the JAX bucket
    step on clean data, after K2's scatter of y."""
    tlb, kw, clean, junk, order = case(name)
    data, x, out, got, y = run_model(name, nrhs)
    assert not np.isnan(got).any() and not np.isnan(y).any()
    got = _with_k2(tlb, order, got, y, nrhs)
    b = _dev_bucket(tlb, "cpu")
    to = torch.from_numpy(out.copy())
    ty = torch.full(y.shape, np.nan, dtype=torch.float64)
    kernels._add_mv_plain(torch.from_numpy(data), torch.from_numpy(x), to,
                          ty, 0, b.off, b.rows, b.cols, b.vec_off,
                          b.below_idx, b.cp, b.rp, -0.6)
    if tlb.rp:
        assert rel(y, ty.numpy()) < RTOL
    twin = _with_k2(tlb, order, to.numpy(), ty.numpy(), nrhs)
    want = jax_bucket_step(kw, clean, x[0], out[0], -0.6, order)
    assert rel(twin[0], want) < RTOL
    assert rel(got[0], want) < RTOL


@pytest.mark.parametrize("name", ["cp4_rp64_warp", "cp64_rp64_one_cta",
                                  "cp128_rp1024_chunks",
                                  "cp1024_rp256_strips"])
def test_mv_model_batch_items_equal_single_runs(name):
    """A batch of two through the model equals each item run alone,
    bitwise: the order of every sum depends on the shape only."""
    tlb, _, _, junk, order = case(name)
    data, x, out, got, y = run_model(name, 1, batch=2, seed=3)
    for z in range(2):
        o1 = out[z:z + 1].copy()
        y1 = np.full((1,) + y.shape[1:], np.nan)
        mv_model(data[z:z + 1], x[z:z + 1], o1, y1, 0, tlb.off, tlb.rows,
                 tlb.cols, tlb.vec_off, tlb.below_idx, tlb.cp, tlb.rp, -0.6)
        assert np.array_equal(o1[0], got[z]) and np.array_equal(y1[0], y[z])
