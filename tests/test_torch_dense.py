"""Dense (Schur) levels: the port's dense-level rule and plan, the K4
twin against a loop oracle, and the planned factor + solve as a whole
against the JAX package's PLANNED solver on problems with a level that
the JAX package runs dense (f64, CPU twins). The CUDA kernel is held
against the twin on the card by chip_smoke.py.

Problems: SMALL["elim_range"] (a 60-block elimination range over 30
compact rows), `wide_dense` (1,500 eliminated blocks over a 600-wide
lump of padded width 1024: a dense level and a wide panel in one) and
`wide_below` (a 540-wide lump, padded 1024, with 36 below rows beside a
narrow lump: the level goes dense in the port because of its wide
origin, and runs on pairs in the JAX package).

Tolerances: 1e-10 relative between the packages (XLA and torch sum in
different orders, and the stored inverse amplifies rounding); 1e-12
between the port's dense and pair mechanisms (the same products, summed
in another order); 1e-13 for the K4 twin against the loop oracle (one
update, no inverse)."""

import numpy as np
import pytest
import torch

import baspacho_tpu as J
import baspacho_tpu_torch as T
from baspacho_tpu_torch.ops import kernels
from baspacho_tpu_torch.ops.planned_backend import DevDense, PlannedBackend
from baspacho_tpu_torch.ops.schedule import (DENSE_PIECE, DENSE_TILE,
                                             NARROW_MAX, PlannedSchedule)
from baspacho_tpu_torch.testing.mat_gen import SparseMatGenerator
from baspacho_tpu_torch.testing.problems import (SMALL, flat_schur5k,
                                                 spd_data, wide_below,
                                                 wide_dense)
from same_native import one_native_library  # noqa: F401 (autouse)

torch.set_num_threads(1)

PROBLEMS = {"elim_range": SMALL["elim_range"], "wide_dense": wide_dense,
            "wide_below": wide_below}
JAX_DENSE = ("elim_range", "wide_dense")  # level 0 is dense in both
_cache = {}


def case(name):
    """(JAX solver, port solver, data, JAX factor) of one problem."""
    if name not in _cache:
        js, ts = PROBLEMS[name](J), PROBLEMS[name](T)
        data = spd_data(js, 21)
        _cache[name] = (js, ts, data, np.asarray(js.factor(data)))
    return _cache[name]


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def levels(s):
    return s.backend._factor_schedule(0, s.skel.num_lumps)


@pytest.mark.parametrize("name", JAX_DENSE)
def test_level_is_dense_in_both_packages(name):
    js, ts, _, _ = case(name)
    assert levels(js)[0][3] is not None
    lbs, pairs, ptot, dense = levels(ts)[0]
    assert dense is not None and pairs is None and ptot == 0
    assert dense.R <= levels(js)[0][3]["R"]  # JAX closes small gaps
    assert all(lv[3] is None for lv in levels(ts)[1:])


def test_wide_origin_sends_its_level_dense():
    """A level with an origin wider than NARROW_MAX goes dense, below
    rows and all, even with pairs forced: the blocked wide factor writes
    no product. The JAX package runs this level on pairs."""
    js, ts, _, _ = case("wide_below")
    assert levels(js)[0][3] is None
    lbs, pairs, ptot, dense = levels(ts)[0]
    assert dense is not None and pairs is None and ptot == 0
    wide = [lb for lb in lbs if lb.cp > NARROW_MAX]
    assert [(lb.cp, lb.rp, int(lb.rows[0])) for lb in wide] == \
        [(1024, 64, 36)]
    # the narrow origin's records read its rows (stride 128); the wide
    # one (36 rows, stride 1024) has no records: one 64 x 64 tile
    assert [(w[1], w[3], w[8]) for w in dense.wide] == [(36, 1024, 1)]
    ld = (dense.rec[:, 1] >> 16) & 0xffff
    assert sorted(set(ld.tolist())) == [128]
    forced = PlannedBackend(ts.plan, assembly="pairs")
    assert forced._factor_schedule(0, ts.skel.num_lumps)[0][3] is not None
    assert all(lv[3] is None for lv in levels(ts)[1:])


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_factor_buffer_matches_jax(name):
    """The whole buffer, the stored inverse (strict upper of each diag
    block, the wide one's included) too."""
    js, ts, data, fj = case(name)
    ft = ts.factor(torch.from_numpy(data))
    assert ft.shape == (ts.data_size,) and ft.dtype == torch.float64
    assert rel(ft.numpy(), fj) < 1e-10


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_solve_matches_jax(name):
    js, ts, data, fj = case(name)
    rng = np.random.RandomState(7)
    for rhs in (rng.rand(js.order, 1), rng.rand(js.order, 3),
                rng.rand(js.order)):
        want = np.asarray(js.solve(fj, rhs))
        got = ts.solve(torch.from_numpy(fj.copy()), torch.from_numpy(rhs))
        assert got.shape == rhs.shape
        assert rel(got.numpy(), want) < 1e-10


@pytest.mark.parametrize("name,forced", [
    ("elim_range", "pairs"), ("wide_dense", "pairs"),
    ("meri3", "dense"), ("meri2", "dense")])
def test_dense_and_pairs_agree(name, forced):
    """The same factor through the other mechanism: forced pairs on the
    dense levels, forced dense on MERI's and GRID's pair levels."""
    ts = case(name)[1] if name in PROBLEMS else SMALL[name](T)
    data = case(name)[2] if name in PROBLEMS else spd_data(ts, 21)
    other = PlannedBackend(ts.plan, assembly=forced)
    updating = [lv for lv in other._factor_schedule(0, ts.skel.num_lumps)
                if lv[2] or lv[3] is not None]
    assert updating and all((lv[3] is not None) == (forced == "dense")
                            for lv in updating)
    want = ts.factor(torch.from_numpy(data))
    got = other.make_factor(0, ts.skel.num_lumps, "cpu")(
        torch.from_numpy(data)[None])[0]
    assert rel(got.numpy(), want.numpy()) < 1e-12


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_batched_matches_single_bitwise(name):
    _, ts, data, _ = case(name)
    datas = np.stack([data * (1.0 + 0.01 * b) for b in range(3)])
    fb = ts.factor(torch.from_numpy(datas))
    rhs = np.random.RandomState(3).rand(3, ts.order, 2)
    xb = ts.solve(fb, torch.from_numpy(rhs))
    for b in range(3):
        fs = ts.factor(torch.from_numpy(datas[b]))
        assert torch.equal(fb[b], fs)
        assert torch.equal(xb[b], ts.solve(fs, torch.from_numpy(rhs[b])))
    assert torch.equal(ts.factor(torch.from_numpy(data)),
                       ts.factor(torch.from_numpy(data)))


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_k4_twin_against_loop(name):
    """dense_update_twin on a random buffer against a plain loop over
    origins and their below-row pairs (row span >= column span), each
    addressed through the skeleton's chains."""
    _, ts, _, _ = case(name)
    sk, plan, be = ts.skel, ts.plan, ts.backend
    lbs, _, _, du = levels(ts)[0]
    buf = np.random.RandomState(9).rand(ts.data_size) * sk.padding_mask()
    want = buf.copy()
    span_of = np.searchsorted(sk.span_start, np.arange(ts.order),
                              side="right") - 1
    ptr, flat = plan.below_row_ptr, plan.below_rows_flat
    n_orig = 0
    for lb in lbs:
        for off, m, n in zip(lb.off, lb.members, lb.cols):
            g = flat[ptr[m]:ptr[m + 1]].astype(np.int64)
            if not len(g):
                continue
            n_orig += 1
            X = buf[off + lb.cp * lb.cp:][:len(g) * lb.cp].reshape(
                len(g), lb.cp)[:, :n]
            sp = span_of[g]
            p, q = np.nonzero(sp[:, None] >= sp[None, :])
            t = sk.span_to_lump[sp[q]]
            pos = np.searchsorted(be._chain_keys, t * sk.num_spans + sp[p])
            tgt = sk.chain_data[pos] + (g[p] - sk.span_start[sp[p]]) * \
                sk.col_stride[t] + g[q] - sk.lump_start[t]
            np.subtract.at(want, tgt, (X @ X.T)[p, q])
    assert n_orig == len(du.org_xoff)
    got = torch.from_numpy(buf.copy())[None]
    kernels.reset_counts()
    kernels.dense_update(got, DevDense(du, "cpu"))
    assert kernels.COUNTS["dense_update"].twin_calls == 1
    assert rel(got[0].numpy(), want) < 1e-13


def bal_case():
    """A small BAL scene whose point level goes dense (sum rows^2 / R^2
    ~ 15): (port solver, its first dense level)."""
    if "bal" not in _cache:
        from baspacho_tpu_torch.bal import make_random_bal
        from baspacho_tpu_torch.testing.flows import ba_optimizer, ba_settings
        prob = make_random_bal(n_cams=6, n_pts=60, track_len=3)
        opt = ba_optimizer(prob, ba_settings(T.BackendType.PLANNED, 1), "cpu")
        dense = [lv for lv in levels(opt.solver) if lv[3] is not None]
        _cache["bal"] = (opt.solver, dense[0])
    return _cache["bal"]


def _separator_problem(blocks, sep, links, n_sep_links=None):
    """Dense parameter blocks (sizes `blocks`, each one param per row of
    3) over separator params of sizes `sep`, ordered last: block i links
    to the separator params in links[i]. Returns the port's solver."""
    sizes = [s for s in blocks for _ in range(s // 3)]
    ranges, first = [], 0
    for s in blocks:
        ranges.append((first, first + s // 3))
        first += s // 3
    n = first + len(sep)
    gen = SparseMatGenerator(n, seed=5)
    for (a, b), ln in zip(ranges, links):
        gen.connect_ranges(a, b, a, b, 1.0)
        for j in ln:
            gen.connect_ranges(a, b, first + j, first + j + 1, 1.0)
    gen.connect_ranges(first, n, first, n, 1.0)
    return T.create_solver(
        T.Settings(backend=T.BackendType.PLANNED),
        np.array([3] * len(sizes) + list(sep)), gen.to_structure(),
        elim_last_ids=list(range(first, n)), device="cpu")


def limits_case(name):
    """Dense levels past the limits of the plan's packed fields:
    `big_span`, 20 narrow origins below one 2,050-row separator span and
    a 40-row one (span-blocks of |a| + |b| > 4,096 rows, cut into
    32-row pieces); `wide_tiles`, a 540-wide origin over spans of 50, 40
    and 70 rows (three 64-row tiles of its product, chains straddling
    them) beside a narrow one sharing two of its targets."""
    if name not in _cache:
        if name == "big_span":
            ts = _separator_problem([3] * 20, [2050, 40], [(0, 1)] * 20)
        else:
            ts = _separator_problem([540, 30], [50, 40, 70],
                                    [(0, 1, 2), (1, 2)])
        _cache[name] = (ts, levels(ts)[0])
    return _cache[name]


LIMITS = ("big_span", "wide_tiles")


def dense_level(name):
    """(port solver, level tuple) of the dense level the plan tests use."""
    if name == "bal":
        return bal_case()
    if name in LIMITS:
        return limits_case(name)
    ts = case(name)[1]
    return ts, levels(ts)[0]


def decode(du):
    """Per record: (xa, xb, ld, n) as stored, its destination, its
    origin, the rows of x_o[a] and x_o[b] in the origin and its first
    column."""
    xb, m = du.rec[:, 0], du.rec[:, 1]
    ld, n = (m >> 16) & 0xffff, m & 0xffff
    xa = xb + (m >> 32) * ld
    dst = np.repeat(np.arange(len(du.dst_off)), np.diff(du.dst_ptr))
    by_off = np.argsort(du.org_xoff)
    o = by_off[np.searchsorted(du.org_xoff[by_off], xb, side="right") - 1]
    row_b, k0 = np.divmod(xb - du.org_xoff[o], ld)
    row_a = (xa - k0 - du.org_xoff[o]) // ld
    return xa, xb, ld, n, dst, o, row_a, row_b, k0


def wide_targets(du, w):
    """A wide origin's tiles: per tile (rows i, rows j, keep (i, j)
    where the row chain is at or past the column chain, the targets)."""
    xoff, rows, _, _, r0, p0, c0, t0, nt = w
    rch, rin = du.w_rch[r0:r0 + rows], du.w_rin[r0:r0 + rows]
    out = []
    for t in du.w_tile[t0:t0 + nt]:
        i = (t >> 32) * DENSE_TILE + np.arange(DENSE_TILE)
        j = (t & 0xffffffff) * DENSE_TILE + np.arange(DENSE_TILE)
        i, j = i[i < rows], j[j < rows]
        a, b = rch[i][:, None], rch[j][None, :]
        tgt = du.w_pt[p0 + a * (a + 1) // 2 + b] + rin[i][:, None] * \
            du.w_cld[c0 + b] + rin[j][None, :]
        out.append((i, j, a >= b, tgt))
    return out


def k4_records_numpy(buf, du):
    """buf less K4's update from its plan alone: each wide origin's x x^T
    by tiles, then each record's product x_o[a] x_o[b]^T over its
    columns, subtracted at its destination (numpy, grouped by
    destination shape)."""
    out = buf.copy()
    for w in du.wide:
        xoff, rows, width, ld = w[:4]
        x = buf[xoff:xoff + rows * ld].reshape(rows, ld)[:, :width]
        for i, j, keep, tgt in wide_targets(du, w):
            np.subtract.at(out, tgt[keep], (x[i] @ x[j].T)[keep])
    xa, xb, ld, n, dst, _, _, _, _ = decode(du)
    R, C = du.dst_rows[dst], du.dst_cols[dst]
    for r_, c_ in sorted(set(zip(R.tolist(), C.tolist()))):
        sel = np.flatnonzero((R == r_) & (C == c_))
        k = np.arange(int(n[sel].max()))
        live = (k < n[sel, None])[:, None, :]

        def gather(x, h):
            idx = x[sel, None, None] + np.arange(h)[:, None] * \
                ld[sel, None, None] + k
            return np.where(live, buf[np.where(live, idx, 0)], 0.0)
        blk = np.einsum("mrk,mck->mrc", gather(xa, r_), gather(xb, c_))
        d = dst[sel]
        tgt = du.dst_off[d, None, None] + np.arange(r_)[:, None] * \
            du.dst_ld[d, None, None] + np.arange(c_)
        np.subtract.at(out, tgt, blk)
    return out


@pytest.mark.parametrize("name", [*sorted(PROBLEMS), "bal", *LIMITS])
def test_k4_records_match_twin(name):
    """K4's plan evaluated record by record (and tile by tile) in numpy
    gives the twin's buffer (the kernel evaluates the same plan on the
    card)."""
    ts, (_, _, _, du) = dense_level(name)
    buf = np.random.RandomState(5).rand(ts.data_size) * \
        ts.skel.padding_mask()
    got = torch.from_numpy(buf.copy())[None]
    kernels.dense_update_twin(got, DevDense(du, "cpu"))
    assert rel(k4_records_numpy(buf, du), got[0].numpy()) < 1e-12


def test_limits_cases_reach_the_limits():
    """big_span's span-blocks exceed a record stage of 4,096 values, and
    its spans are cut into pieces; wide_tiles has three tiles a side with
    the chains straddling two tile edges, and a narrow origin whose
    destinations are pieces of the wide one's targets."""
    ts, (_, _, _, du) = limits_case("big_span")
    assert du.max_span == 2050 and not du.wide
    assert du.dst_rows.max() == DENSE_PIECE
    # pieces of (s, s), (t, s), (t, t): 2,050 rows in 65, 40 in 2
    assert len(du.dst_off) == 65 * 65 + 2 * 65 + 2 * 2
    ts, (lbs, _, _, du) = limits_case("wide_tiles")
    assert [(lb.cp, int(lb.rows[0])) for lb in lbs if lb.cp > NARROW_MAX] \
        == [(1024, 160)]
    (w,) = du.wide
    tiles = {(int(t >> 32), int(t & 0xffffffff))
             for t in du.w_tile[w[7]:w[7] + w[8]]}
    assert tiles == {(i, j) for i in range(3) for j in range(i + 1)} | \
        {(0, 1), (1, 2)}
    assert len(du.rec) and len(du.org_xoff) == 2


@pytest.mark.parametrize("name", [*sorted(PROBLEMS), "bal", *LIMITS])
def test_dense_plan_invariants(name):
    ts, (lbs, _, _, du) = dense_level(name)
    sk = ts.skel
    span_size = np.diff(sk.span_start)
    assert du.R == int(span_size[du.tspans].sum()) == int(du.sp_size.sum())
    for s in range(len(du.tspans)):
        qa, qb = du.slice_ptr[s], du.slice_ptr[s + 1]
        assert du.sl_cs[qa] == du.sp_cs[s] and np.all(
            np.diff(du.sl_cs[qa:qb]) > 0)
    # compact rows ascend along each origin's rows
    members = np.concatenate([np.asarray(lb.members)[lb.rows > 0]
                              for lb in lbs if lb.rp])
    assert len(members) == len(du.org_xoff)
    for o in range(len(du.org_rows)):
        c = du.crow[du.org_rptr[o]:du.org_rptr[o + 1]]
        assert np.all(np.diff(c) > 0) and c.max() < du.R
    # records sorted by destination, none empty, targets disjoint
    xa, xb, ld, n, dst, o, row_a, row_b, k0 = decode(du)
    assert np.all(np.diff(du.dst_ptr) > 0) and du.dst_ptr[-1] == len(xb)
    cnt = np.diff(du.dst_ptr)
    assert len(np.unique(du.dst_off)) == len(cnt)
    assert np.array_equal(np.sort(np.concatenate([du.dst_short,
                                                  du.dst_long])),
                          np.arange(len(cnt)))
    assert np.all(cnt[du.dst_long] > 32) and np.all(cnt[du.dst_short] <= 32)
    wide_org = np.flatnonzero(np.isin(du.org_xoff, [w[0] for w in du.wide]))
    assert not np.any(np.isin(o, wide_org))
    assert len(du.wide) == \
        sum(lb.cp > NARROW_MAX for lb in lbs for _ in range(len(lb.off)))
    # origin order inside a destination (an origin's k-slices in order)
    same = dst[1:] == dst[:-1]
    step = (o[1:] > o[:-1]) | ((o[1:] == o[:-1]) & (k0[1:] > k0[:-1]))
    assert np.all(step[same])

    # every (a >= b, narrow o) pair, each of its pieces once, its
    # k-slices covering the origin
    def span_piece(rows):
        cr = du.crow[du.org_rptr[o] + rows]
        s = du.tspans[np.searchsorted(du.sp_cs, cr, side="right") - 1]
        off = cr - du.sp_cs[np.searchsorted(du.tspans, s)]
        assert np.all(off % DENSE_PIECE == 0)  # pieces start at 32 rows
        return s, off // DENSE_PIECE
    (a, pa), (b, pb) = span_piece(row_a), span_piece(row_b)
    got = {}
    for t in zip(o.tolist(), a.tolist(), b.tolist(), pa.tolist(),
                 pb.tolist(), k0.tolist(), n.tolist()):
        got.setdefault(t[:5], []).append(t[5:])
    npieces = -(-span_size // DENSE_PIECE)
    want = set()
    for oi in set(range(len(du.org_xoff))) - set(wide_org.tolist()):
        cr = du.crow[du.org_rptr[oi]:du.org_rptr[oi + 1]]
        sp = np.unique(du.tspans[np.searchsorted(du.sp_cs, cr,
                                                 side="right") - 1])
        want |= {(oi, int(x), int(y), i, j) for k, x in enumerate(sp)
                 for y in sp[:k + 1] for i in range(npieces[x])
                 for j in range(npieces[y])}
    assert set(got) == want
    for key, sl in got.items():
        assert sum(w for _, w in sl) == du.org_cols[key[0]]
        assert [k for k, _ in sl] == sorted(k for k, _ in sl)
    # destinations are the pieces' |a| x |b|
    assert np.array_equal(du.dst_rows[dst], np.minimum(
        DENSE_PIECE, span_size[a] - pa * DENSE_PIECE))
    assert np.array_equal(du.dst_cols[dst], np.minimum(
        DENSE_PIECE, span_size[b] - pb * DENSE_PIECE))
    assert np.all(n * (du.dst_rows[dst] + du.dst_cols[dst]) <= 4096)
    # a wide origin's tiles cover each (i, j) with a row chain at or past
    # the column chain once, at distinct targets
    for w in du.wide:
        rch = du.w_rch[w[4]:w[4] + w[1]]
        cover = np.zeros((w[1], w[1]), int)
        tgts = []
        for i, j, keep, tgt in wide_targets(du, w):
            cover[np.ix_(i, j)] += keep
            tgts.append(tgt[keep])
        assert np.array_equal(cover, rch[:, None] >= rch[None, :])
        tgts = np.concatenate(tgts)
        assert len(np.unique(tgts)) == len(tgts)


@pytest.mark.parametrize("name", ["meri2", "meri3", "grid10", "flat"])
def test_rule_keeps_sparse_levels_on_pairs(name):
    """MERI's and GRID's levels stay on the pair path (their origins'
    products overlap little: sum rows^2 / R^2 <= 0.74 on the full-size
    problems too)."""
    ts = SMALL[name](T)
    assert all(lv[3] is None for lv in levels(ts))


def test_assembly_argument_checked():
    ts = SMALL["meri2"](T)
    with pytest.raises(ValueError, match="assembly"):
        PlannedSchedule(ts.plan, assembly="w")


def test_schur_schedule_enumerates_no_pairs_on_its_dense_level(
        monkeypatch):
    """FLAT + Schur 5k: the 5,000-origin level goes dense without a single
    block pair being enumerated (the pair enumeration runs only on the
    wide lump's level, which has no origins)."""
    calls = []
    orig = PlannedSchedule._build_pairs

    def spy(self, lds, origin_pos):
        calls.append(len(origin_pos))
        return orig(self, lds, origin_pos)

    monkeypatch.setattr(PlannedSchedule, "_build_pairs", spy)
    ts = flat_schur5k(T)
    sched = levels(ts)
    assert sched[0][3] is not None and len(sched[0][3].org_xoff) == 5000
    assert sched[0][3].R == 3000
    assert calls == [0]


def test_dense_wrapper_never_falls_back_off_cpu():
    d = torch.empty((1, 16), dtype=torch.float64, device="meta")
    kernels.reset_counts()
    du = levels(SMALL["elim_range"](T))[0][3]
    with pytest.raises(RuntimeError, match="needs CUDA"):
        kernels.dense_update(d, DevDense(du, "meta"))
    assert all(c.twin_calls == 0 and c.launches == 0
               for c in kernels.COUNTS.values())
