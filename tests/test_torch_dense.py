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
from baspacho_tpu_torch.ops.schedule import NARROW_MAX, PlannedSchedule
from baspacho_tpu_torch.testing.problems import (SMALL, flat_schur5k,
                                                 spd_data, wide_below,
                                                 wide_dense)

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
    assert sorted(set(dense.ent_ld.tolist())) == [128, 1024]
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


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_dense_plan_invariants(name):
    _, ts, _, _ = case(name)
    sk = ts.skel
    du = levels(ts)[0][3]
    span_size = np.diff(sk.span_start)
    assert du.R == int(span_size[du.tspans].sum()) == int(du.sp_size.sum())
    # one list entry per (origin, below chain); entries in origin order
    nd = sk.lump_to_span[1:] - sk.lump_to_span[:-1]
    members = np.concatenate([np.asarray(lb.members)[lb.rows > 0]
                              for lb in levels(ts)[0][0] if lb.rp])
    chains = (sk.chain_col_ptr[members + 1] - sk.chain_col_ptr[members] -
              nd[members]).sum()
    assert len(du.ent_x) == chains == du.list_ptr[-1]
    for s in range(len(du.tspans)):
        a, b = du.list_ptr[s], du.list_ptr[s + 1]
        assert np.all(np.diff(du.ent_row[a:b]) > 0)
        qa, qb = du.slice_ptr[s], du.slice_ptr[s + 1]
        assert du.sl_cs[qa] == du.sp_cs[s] and np.all(
            np.diff(du.sl_cs[qa:qb]) > 0)
    # compact rows ascend along each origin's rows
    for o in range(len(du.org_rows)):
        c = du.crow[du.org_rptr[o]:du.org_rptr[o + 1]]
        assert np.all(np.diff(c) > 0) and c.max() < du.R


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
