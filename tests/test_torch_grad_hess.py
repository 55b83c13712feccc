"""K6's grids (csrc/grad_hess.cu) modelled in numpy, in the kernels'
order, on the plan of ops/assembly.py, against the plain twin and the
JAX package's Optimizer.compute_grad_hess (f64, CPU). The CUDA kernels
cannot run here: chip_smoke.py holds them against the twin on the card
(k6_levels).

The model follows the launches of bs_grad_hess per output: the chunk
grid (a CTA per chunk of a long segment's records, G = 256 / rows thread
groups over interleaved records, joined in group order into a partial
block), the short grid (a thread per row of a segment, found from its
class entry's first segment by division over whole CTAs, adding its
segment's records in order to each element), the post grid (a thread
per element of a long segment, adding its chunks' partials in chunk
order). Partial blocks start as NaN, so a partial the post reads but no
chunk wrote shows up in the result.

Scenes: a small BAL scene (camera-point blocks stored transposed, the
rdim-9 prior family, cameras of ~100 observations: long segments, cut
into chunks of the plan's 256 records or, to split them unevenly, of 7),
and the SE3 bundle adjustment of tests/test_optimizer.py (no long
segment: an empty class list). Tolerance 1e-12 relative."""

import numpy as np
import pytest
import torch

import baspacho_tpu as J
import baspacho_tpu.optimizer as JO
from baspacho_tpu import bal as JB
import baspacho_tpu_torch as T
import baspacho_tpu_torch.optimizer as TO
from baspacho_tpu_torch import bal as TB
from baspacho_tpu_torch.ops import assembly, kernels
from baspacho_tpu_torch.testing.problems import se3_ba
from same_native import one_native_library  # noqa: F401 (autouse)

torch.set_num_threads(1)

RTOL = 1e-12
THREADS = 256      # csrc/grad_hess.cu kThreads
MAX_CLASSES = 8    # class entries of one modelled launch: fewer than the
#                    kernel's kMaxCls (kernels.GH_MAX_CLASSES), so that
#                    the small scenes span several launches (a launch's
#                    split changes no sum)


def _bal(O, **kw):
    pkg = TB if O is TO else JB
    prob = pkg.make_random_bal(n_cams=6, n_pts=200, track_len=3, seed=4,
                               noise=0.5)
    return pkg.build_ba_optimizer(prob, huber=1.0, **kw)[0]


SCENES = {"bal": _bal, "se3_ba": lambda O, **kw: se3_ba(O, **kw)[0]}
_cache = {}


def scene(name, chunk_rec=assembly.GH_CHUNK_REC, pieces=False):
    """(JAX optimizer, port optimizer, port terms) with K6's plans built
    at chunks of chunk_rec records; with `pieces`, the short grid's
    classes cut into pieces of 4 KB of W (64 elements at least)."""
    key = (name, chunk_rec, pieces)
    if key not in _cache:
        old = (assembly.GH_CHUNK_REC, assembly.GH_PIECE_BYTES,
               assembly.GH_PIECE_ELEMS)
        assembly.GH_CHUNK_REC = chunk_rec
        if pieces:
            assembly.GH_PIECE_BYTES, assembly.GH_PIECE_ELEMS = 4096, 64
        try:
            jo, to = SCENES[name](JO), SCENES[name](TO, device="cpu")
            jo.build_solver(JO.OptimizerSettings(
                backend=J.BackendType.PLANNED))
            to.build_solver(TO.OptimizerSettings(
                backend=T.BackendType.PLANNED))
        finally:
            (assembly.GH_CHUNK_REC, assembly.GH_PIECE_BYTES,
             assembly.GH_PIECE_ELEMS) = old
        terms = to.jacobians([f.values for f in to.families])
        _cache[key] = (jo, to, terms)
    return _cache[key]


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _np(t):
    return t.numpy()


def launch_threads(entries, per_row):
    """The threads of the short grid (per_row: a thread per row of a
    segment, over its columns) or of the post grid (a thread per element)
    over class entries (output, first segment, segments, rows, cols,
    records a segment, first record), as bs_grad_hess lays them out
    (launches of up to MAX_CLASSES entries, each entry on whole CTAs):
    (output, segment, row, column, element, first record, records) per
    element, in launch and thread order (a row's columns in order); the
    first record as the short grid finds it, from its entry."""
    out = []
    for i in range(0, len(entries), MAX_CLASSES):
        cl = entries[i:i + MAX_CLASSES]
        per = cl[:, 3] if per_row else cl[:, 3] * cl[:, 4]
        cta = np.concatenate([[0], np.cumsum(-(-cl[:, 2] * per // THREADS))])
        th = np.arange(int(cta[-1]) * THREADS)
        b = th // THREADS
        k = np.searchsorted(cta[1:], b, side="right")
        t = (b - cta[k]) * THREADS + th % THREADS
        sl = t // per[k]
        live = sl < cl[k, 2]
        k, t, sl = k[live], t[live], sl[live]
        if per_row:
            r = t - sl * per[k]
            C = cl[k, 4]
            k, sl, r = (np.repeat(a, C) for a in (k, sl, r))
            c = np.arange(len(k)) - np.repeat(np.cumsum(C) - C, C)
            e = r * cl[k, 4] + c
        else:
            e = t - sl * per[k]
            r, c = e // cl[k, 4], e % cl[k, 4]
        out.append((cl[k, 0], cl[k, 1] + sl, r, c, e,
                    cl[k, 6] + sl * cl[k, 5], cl[k, 5]))
    if not out:
        return [np.zeros(0, np.int64)] * 7
    return [np.concatenate(a) for a in zip(*out)]


def _arrays(seg):
    return [_np(getattr(seg, k)) for k in ("off", "stride", "rows", "cols",
                                           "ptr", "rec")]


def _chunks(W, seg, plan):
    """gh_chunk_kernel on one output: its chunks' partial blocks."""
    ta, tb, Q, rdim = _np(plan.tab_a), _np(plan.tab_b), plan.Q, plan.rdim
    off, stride, rows, cols, ptr, rec = _arrays(seg)
    cseg, cp0 = _np(seg.chunk_seg), _np(seg.chunk_p0)
    part = np.full((len(cseg), max(seg.max_e_long, 1)), np.nan)
    for j, (s, p0) in enumerate(zip(cseg, cp0)):
        R, C = int(rows[s]), int(cols[s])
        E, nrec = R * C, int(min(seg.chunk_rec, ptr[s + 1] - p0))
        f, q = rec[p0:p0 + nrec] // Q, rec[p0:p0 + nrec] % Q
        stA = np.stack([W[f, k][np.arange(nrec)[:, None],
                                ta[q][:, None] + np.arange(R)]
                        for k in range(rdim)], 1)  # [nrec][rdim][R]
        stB = np.stack([W[f, k][np.arange(nrec)[:, None],
                                tb[q][:, None] + np.arange(C)]
                        for k in range(rdim)], 1)
        G = THREADS // R  # thread (g, r): row r over records g, g + G, ..
        red = np.zeros((G, R, C))
        for g in range(G):
            for jj in range(g, nrec, G):
                sm = np.zeros((R, C))
                for k in range(rdim):
                    sm = sm + stA[jj, k][:, None] * stB[jj, k][None, :]
                red[g] = red[g] + sm
        tot = np.zeros((R, C))
        for g in range(G):
            tot = tot + red[g]
        part[j, :E] = tot.reshape(-1)
    return part


def k6_model(W, outs, plan):
    """bs_grad_hess on one family in numpy, in place in outs (the Hessian
    data, the gradient): the chunk grid (both outputs' chunks, each on
    its own), the short grid, the post grid."""
    ta, tb, Q, rdim = _np(plan.tab_a), _np(plan.tab_b), plan.Q, plan.rdim
    segs = (plan.hess, plan.grad)
    parts = [_chunks(W, seg, plan) for seg in segs]
    o_, s_, r_, c_, _, p0_, cnt_ = launch_threads(plan.short_entries,
                                                   True)
    for o, seg in enumerate(segs):
        m = o_ == o
        s, r, c, p0, cnt = s_[m], r_[m], c_[m], p0_[m], cnt_[m]
        off, stride, _, _, _, rec = _arrays(seg)
        dst = off[s] + r * stride[s] + c
        acc = outs[o][dst].copy()
        for k in range(int(cnt.max(initial=0))):
            live = k < cnt
            v = rec[np.where(live, p0 + k, 0)]
            f, q = v // Q, v % Q
            sm = np.zeros(len(s))
            for kk in range(rdim):
                sm = sm + W[f, kk, ta[q] + r] * W[f, kk, tb[q] + c]
            acc = np.where(live, acc + sm, acc)
        outs[o][dst] = acc
    if not any(len(seg.chunk_seg) for seg in segs):
        return
    o_, s_, r_, c_, e_, _, _ = launch_threads(plan.long_entries, False)
    for o, seg in enumerate(segs):
        m = o_ == o
        s, r, c, e = s_[m], r_[m], c_[m], e_[m]
        off, stride = _np(seg.off), _np(seg.stride)
        cptr = _np(seg.chunk_ptr)
        L = s - len(seg.short)
        dst = off[s] + r * stride[s] + c
        tot = outs[o][dst].copy()
        for k in range(int((cptr[L + 1] - cptr[L]).max(initial=0))):
            live = cptr[L] + k < cptr[L + 1]
            tot = np.where(live, tot + parts[o][np.where(live, cptr[L] + k,
                                                         0), e], tot)
        outs[o][dst] = tot


def model_grad_hess(to, terms):
    g, h = np.zeros(to.solver.order), np.zeros(to.solver.data_size)
    for (_, W), (_, plan) in zip(terms, to._plans):
        k6_model(_np(W), (h, g), plan)
    return g, h


@pytest.mark.parametrize("name,chunk_rec,pieces", [
    ("bal", 256, False), ("bal", 7, False), ("bal", 7, True),
    ("se3_ba", 256, False)])
def test_k6_model_matches_twin_and_jax(name, chunk_rec, pieces):
    """The model's gradient and Hessian data against the plain twin and
    JAX's compute_grad_hess, over every family."""
    jo, to, terms = scene(name, chunk_rec, pieces)
    if pieces:
        assert len(to._plans[0][1].short_entries) > 8
    _, gj, hj = jo.compute_grad_hess([f.values for f in jo.families])
    g, h = model_grad_hess(to, terms)
    assert not np.isnan(g).any() and not np.isnan(h).any()
    gt = torch.zeros(to.solver.order, dtype=torch.float64)
    ht = torch.zeros(to.solver.data_size, dtype=torch.float64)
    for (_, W), (_, plan) in zip(terms, to._plans):
        kernels.grad_hess_twin(W, ht, gt, plan)
    assert rel(gt.numpy(), gj) <= RTOL and rel(ht.numpy(), hj) <= RTOL
    assert rel(g, gj) <= RTOL and rel(h, hj) <= RTOL


def test_k6_scenes_cover_the_plan_shapes():
    """The cases the model runs: transposed camera-point blocks, the
    rdim-9 prior family, long segments cut unevenly into chunks, and a
    plan with no long segment (empty class lists)."""
    _, to, _ = scene("bal", 7)
    plans = [p for _, p in to._plans]
    assert sorted(p.rdim for p in plans) == [2, 9]
    p = next(p for p in plans if p.rdim == 2)
    assert bool(p.pairs[1][-1].all())  # the point-camera blocks, flipped
    for seg in (p.hess, p.grad):
        n_long = len(seg.long)
        cnt = np.diff(_np(seg.ptr))[len(seg.short):]
        assert n_long > 0 and (cnt > assembly.LONG_SEG).all()
        assert (cnt % 7 != 0).any()  # a last chunk shorter than the rest
        assert len(seg.chunk_seg) == int((-(-cnt // 7)).sum())
    _, se3, _ = scene("se3_ba")
    assert all(len(s.long_classes) == 0 and len(s.chunk_seg) == 0
               and len(q.long_entries) == 0
               for _, q in se3._plans for s in (q.hess, q.grad))


def _contributions(plan, name):
    """(destination offset, record) of every contribution to one output,
    in the order the plan was given them (pairs or slots, then
    factors)."""
    dst, rec = [], []
    Q, F = plan.Q, None
    if name == "hess":
        for p, (_, ti, _, tj, off, stride, flip) in enumerate(plan.pairs):
            off, flip = _np(off), _np(flip)
            F = len(off)
            dst.append(off)
            rec.append(np.arange(F) * Q + 2 * p + flip)
    else:
        npairs = len(plan.pairs)
        for i, (_, _, vec_off) in enumerate(plan.vecs):
            F = len(vec_off)
            dst.append(_np(vec_off))
            rec.append(np.arange(F) * Q + 2 * npairs + i)
    return np.concatenate(dst), np.concatenate(rec)


@pytest.mark.parametrize("name,chunk_rec,pieces", [
    ("bal", 7, False), ("bal", 7, True), ("se3_ba", 256, False)])
def test_k6_plan_covers_each_element_once_in_order(name, chunk_rec, pieces):
    """Every destination element is one short-grid thread's or one
    post-grid thread's, once; each segment's records are its block's
    contributions in the order given, and a short one's are where its
    class entry says; the chunks tile each long segment's records in
    order."""
    _, to, _ = scene(name, chunk_rec, pieces)
    for _, plan in to._plans:
        short = launch_threads(plan.short_entries, True)
        long = launch_threads(plan.long_entries, False)
        for o, nm in enumerate(("hess", "grad")):
            seg = getattr(plan, nm)
            off, stride, rows, cols, ptr, rec = _arrays(seg)
            want = np.concatenate([np.zeros(0, np.int64)] + [
                (a + np.arange(r)[:, None] * st + np.arange(c)).ravel()
                for a, st, r, c in zip(off, stride, rows, cols)])
            got = []
            for th, first in ((short, True), (long, False)):
                m = th[0] == o
                s, r, c, p0, cnt = th[1][m], th[2][m], th[3][m], th[5][m], \
                    th[6][m]
                got.append(off[s] + r * stride[s] + c)
                if first:  # its records, from the class entry
                    assert (s < len(seg.short)).all()
                    assert np.array_equal(p0, ptr[s])
                    assert np.array_equal(cnt, ptr[s + 1] - ptr[s])
                else:
                    assert (s >= len(seg.short)).all()
            got = np.concatenate(got)
            assert len(got) == len(want) == len(np.unique(got))
            assert np.array_equal(np.sort(got), np.sort(want))
            # classes: short then long, equal shapes, contiguous segments
            cls = np.concatenate([seg.short_classes, seg.long_classes])
            assert np.array_equal(cls[:, 0], np.concatenate(
                [[0], np.cumsum(cls[:, 1])[:-1]]))
            assert cls[:, 1].sum() == len(off)
            for s0, n, R, C, _, rec0 in cls:
                assert (rows[s0:s0 + n] == R).all()
                assert (cols[s0:s0 + n] == C).all()
                assert rec0 == ptr[s0]
            # records in the order given, per destination block
            d, r_ = _contributions(plan, nm)
            by_block = {}
            for dd, rr in zip(d[np.argsort(d, kind="stable")],
                              r_[np.argsort(d, kind="stable")]):
                by_block.setdefault(dd, []).append(rr)
            assert len(rec) == len(d)
            for sgi in range(len(off)):
                assert list(rec[ptr[sgi]:ptr[sgi + 1]]) == \
                    by_block[off[sgi]]
            # chunks: in segment order, each chunk_rec records but the last
            cseg, cp0, cptr = (_np(seg.chunk_seg), _np(seg.chunk_p0),
                               _np(seg.chunk_ptr))
            for i, s in enumerate(range(len(seg.short), len(off))):
                starts = cp0[cptr[i]:cptr[i + 1]]
                assert (cseg[cptr[i]:cptr[i + 1]] == s).all()
                assert np.array_equal(starts, np.arange(
                    ptr[s], ptr[s + 1], seg.chunk_rec))


def test_k6_short_entries_interleave_the_classes():
    """The short grid's entries, both outputs' classes cut into pieces
    laid out piece by piece: each class's pieces in order and covering
    it, and pieces of different classes and outputs alternating."""
    _, to, _ = scene("bal", 256, pieces=True)
    plan = next(p for _, p in to._plans if p.rdim == 2)
    se = plan.short_entries
    keys = [(o, R, C, cnt) for o, _, _, R, C, cnt, _ in se.tolist()]
    assert len(set(keys)) >= 3 and keys[0] != keys[1]
    for o, nm in enumerate(("hess", "grad")):
        seg = getattr(plan, nm)
        for s0, n, R, C, cnt, rec0 in seg.short_classes.tolist():
            mine = [e for e in se.tolist() if e[0] == o and
                    s0 <= e[1] < s0 + n]
            assert len(mine) > 1
            assert [e[1] for e in mine] == sorted(e[1] for e in mine)
            assert mine[0][1] == s0 and sum(e[2] for e in mine) == n
            for _, a, m, r, c, k, p in mine:
                assert (r, c, k) == (R, C, cnt)
                assert p == rec0 + (a - s0) * cnt


def test_k6_class_entries_split_past_the_element_limit():
    """A run of equal-shape segments past GH_CLASS_ELEMS elements becomes
    several entries, each under the short grid's 32-bit element index;
    a change of record count starts a new entry."""
    old = assembly.GH_CLASS_ELEMS
    assembly.GH_CLASS_ELEMS = 100
    try:
        n = 34
        cls = assembly._classes(
            5, np.array([3] * 32 + [9] * 2), np.array([3] * 32 + [1] * 2),
            np.array([2] * 30 + [1] * 4), 100 + np.arange(n) * 2)
    finally:
        assembly.GH_CLASS_ELEMS = old
    assert cls.tolist() == [[5, 11, 3, 3, 2, 100], [16, 11, 3, 3, 2, 122],
                            [27, 8, 3, 3, 2, 144], [35, 2, 3, 3, 1, 160],
                            [37, 2, 9, 1, 1, 164]]
    z = np.zeros(0, np.int64)
    assert assembly._classes(0, z, z, z, z).shape == (0, 6)


def test_k6_model_runs_are_bitwise_equal():
    """Two runs of the model on one plan give the same bits (the order
    of every sum is the plan's)."""
    _, to, terms = scene("bal", 7)
    a, b = model_grad_hess(to, terms), model_grad_hess(to, terms)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
