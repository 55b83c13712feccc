"""Partial factor/solve, block mat-vec and pseudo-factor of the port
against the JAX package (f64, CPU twins), on both backends.

The five 2x2 block identities of tests/test_partial.py (reference
PartialFactorSolveTest.cpp), with split point t (offset o):

  factor_up_to(t)   -> [L11 ; L21 = A21 L11^-T ; A22 - L21 L21^T]
  factor_up_to(t) then factor_from(t) == factor()
  solve_l_up_to / solve_lt_up_to / solve_l_from / solve_lt_from
  add_mv_from(t): out + alpha A22 x2 on the corner
  pseudo_factor_from: per-span Cholesky and L^-T below

Each is held against the dense oracle (1e-9, as the JAX tests) and
against the JAX package's output on the same skeleton (1e-10 relative:
XLA and torch sum in different orders, and the JAX package inverts tiny
panels where the port substitutes). Buffers are compared on their live
slots: an unfactored target's dead upper half holds whatever its
updates left there, which differs between the two packages and is
never read.
"""

import numpy as np
import pytest
import torch

import baspacho_tpu as J
import baspacho_tpu_torch as T
from baspacho_tpu.testing import SparseMatGenerator as JGen
from baspacho_tpu_torch.ops import kernels
from baspacho_tpu_torch.testing import SparseMatGenerator, random_spd_data
from baspacho_tpu_torch.testing.problems import SMALL, spd_data, wide_below, \
    wide_dense

torch.set_num_threads(1)

BACKENDS = ["REF", "PLANNED"]
RTOL = 1e-10
_cache = {}


def maxabs(a):
    a = np.asarray(a)
    return np.max(np.abs(a)) if a.size else 0.0


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def live_rel(solver, a, b):
    """rel over the live (lower-half, non-padding) slots."""
    ri, _ = solver.skel.data_coords()
    live = ri != solver.order
    return rel(np.asarray(a)[..., live], np.asarray(b)[..., live])


def build(seed, backend, n=40, fill=0.06):
    """tests/test_partial.py's problem in both packages (the port's
    create_solver is a copy of the JAX pipeline: same skeleton)."""
    key = (seed, backend, n, fill)
    if key not in _cache:
        out = []
        for pkg, gen in ((J, JGen), (T, SparseMatGenerator)):
            ss = gen.gen_flat(n, fill, seed=seed).to_structure()
            rng = np.random.RandomState(seed)
            psizes = rng.randint(2, 4, size=ss.order)
            kw = {} if pkg is J else {"device": "cpu"}
            out.append(pkg.create_solver(
                pkg.Settings(backend=getattr(pkg.BackendType, backend)),
                psizes, ss, **kw))
        js, ts = out
        a, b = T.skeleton_arrays(js.skel), T.skeleton_arrays(ts.skel)
        assert all(np.array_equal(a[k], b[k]) for k in a)
        assert ts.skel.num_lumps >= 2
        data = random_spd_data(ts.data_size, ts.order, seed + 500)
        data = np.asarray(ts.skel.damp(data, 0.0, ts.order * 1.5))
        _cache[key] = (js, ts, data)
    return _cache[key]


def mid_lump_span(solver):
    nl = solver.skel.num_lumps
    return int(solver.skel.lump_to_span[max(1, nl // 2)])


def tt(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", range(4))
def test_factor_up_to_schur(backend, seed):
    js, ts, data = build(seed, backend)
    t = mid_lump_span(ts)
    o = ts.span_vector_offset(t)
    m = ts.skel.densify(data, fill_upper_half=True)
    a11, a21, a22 = m[:o, :o], m[o:, :o], m[o:, o:]
    got = ts.factor_up_to(tt(data), t).numpy()
    part = ts.skel.densify(got)
    l11_want = np.linalg.cholesky(a11)
    assert maxabs(np.tril(part[:o, :o]) - l11_want) < 1e-9
    l21_want = a21 @ np.linalg.inv(l11_want).T
    assert maxabs(part[o:, :o] - l21_want) < 1e-9
    schur_want = np.tril(a22 - l21_want @ l21_want.T)
    mask = np.tril(ts.skel.densify(np.ones(ts.data_size))[o:, o:]) != 0
    assert maxabs((np.tril(part[o:, o:]) - schur_want) * mask) < 1e-9
    assert live_rel(ts, got, js.factor_up_to(data, t)) < RTOL


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", range(4))
def test_factor_up_to_plus_from_equals_full(backend, seed):
    js, ts, data = build(seed, backend)
    t = mid_lump_span(ts)
    full = ts.factor(tt(data))
    part = ts.factor_from(ts.factor_up_to(tt(data), t), t)
    assert maxabs(full.numpy() - part.numpy()) < 1e-9
    assert rel(part.numpy(), js.factor_from(js.factor_up_to(data, t), t)) \
        < RTOL


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", range(3))
def test_partial_solves(backend, seed):
    js, ts, data = build(seed, backend)
    t = mid_lump_span(ts)
    o = ts.span_vector_offset(t)
    part = ts.factor_up_to(tt(data), t).numpy()
    dense = ts.skel.densify(part)
    l11, l21 = np.tril(dense[:o, :o]), dense[o:, :o]
    v = np.random.RandomState(seed).rand(ts.order, 2)
    v1, v2 = v[:o], v[o:]
    got = ts.solve_l_up_to(tt(part), t, tt(v)).numpy()
    want = np.concatenate([np.linalg.solve(l11, v1),
                           v2 - l21 @ np.linalg.solve(l11, v1)])
    assert maxabs(got - want) < 1e-9
    assert rel(got, js.solve_l_up_to(part, t, v)) < RTOL
    got = ts.solve_lt_up_to(tt(part), t, tt(v)).numpy()
    want = np.concatenate([np.linalg.solve(l11.T, v1 - l21.T @ v2), v2])
    assert maxabs(got - want) < 1e-9
    assert rel(got, js.solve_lt_up_to(part, t, v)) < RTOL

    fullf = ts.factor_from(tt(part), t).numpy()
    l22 = np.tril(ts.skel.densify(fullf)[o:, o:])
    got = ts.solve_l_from(tt(fullf), t, tt(v)).numpy()
    assert maxabs(got - np.concatenate([v1, np.linalg.solve(l22, v2)])) \
        < 1e-9
    assert rel(got, js.solve_l_from(fullf, t, v)) < RTOL
    got = ts.solve_lt_from(tt(fullf), t, tt(v)).numpy()
    assert maxabs(got - np.concatenate([v1, np.linalg.solve(l22.T, v2)])) \
        < 1e-9
    assert rel(got, js.solve_lt_from(fullf, t, v)) < RTOL
    # full-range L and Lt solves compose to the solve
    x = ts.solve_lt(tt(fullf), ts.solve_l(tt(fullf), tt(v)))
    assert rel(x.numpy(), ts.solve(tt(fullf), tt(v)).numpy()) < 1e-12


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", range(3))
def test_add_mv_from(backend, seed):
    js, ts, data = build(seed, backend)
    t = mid_lump_span(ts)
    o = ts.span_vector_offset(t)
    m = ts.skel.densify(data, fill_upper_half=True)
    rng = np.random.RandomState(seed)
    x, out0 = rng.rand(ts.order, 2), rng.rand(ts.order, 2)
    out_t = tt(out0)
    got = ts.add_mv_from(tt(data), t, tt(x), out_t, 0.7).numpy()
    assert np.array_equal(out_t.numpy(), out0)  # out is left as it was
    want = out0.copy()
    want[o:] += 0.7 * (m[o:, o:] @ x[o:])
    assert maxabs(got - want) < 1e-9
    assert rel(got, js.add_mv_from(data, t, x, out0, 0.7)) < RTOL
    got = ts.add_mv_from(tt(data), 0, tt(x[:, 0]), tt(out0[:, 0]),
                         0.7).numpy()
    assert got.shape == (ts.order,)
    assert maxabs(got - (out0[:, 0] + 0.7 * (m @ x[:, 0]))) < 1e-9


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", range(3))
def test_pseudo_factor(backend, seed):
    js, ts, data = build(seed, backend)
    res = ts.pseudo_factor_from(tt(data), 0).numpy()
    assert rel(res, js.pseudo_factor_from(data, 0)) < RTOL
    acc = ts.internal_accessor()
    sk = ts.skel
    for s in range(sk.num_spans):
        diag = acc.diag_block(data, s)
        l_want = np.linalg.cholesky(np.tril(diag) + np.tril(diag, -1).T)
        assert maxabs(np.tril(acc.diag_block(res, s)) - l_want) < 1e-9
        lump = int(sk.span_to_lump[s])
        for ci in range(int(sk.chain_col_ptr[lump]),
                        int(sk.chain_col_ptr[lump + 1])):
            r = int(sk.chain_row_span[ci])
            if r > s:
                b_want = np.linalg.solve(l_want, acc.block(data, r, s).T).T
                assert maxabs(acc.block(res, r, s) - b_want) < 1e-9
    t = mid_lump_span(ts)
    part = ts.pseudo_factor_from(tt(data), t).numpy()
    assert rel(part, js.pseudo_factor_from(data, t)) < RTOL


def test_planned_partial_and_addmv():
    """tests/test_planned_backend.py:50-68, on the JAX solver's skeleton."""
    gen = JGen.gen_flat(40, 0.05, seed=1)
    ss = gen.to_structure()
    psizes = np.random.RandomState(1).randint(1, 4, size=ss.order)
    js = J.create_solver(J.Settings(backend=J.BackendType.PLANNED), psizes,
                         ss)
    ts = T.solver_from_skeleton(T.skeleton_arrays(js.skel), js.permutation,
                                js.sparse_elim_ranges, device="cpu")
    data = np.asarray(ts.skel.damp(random_spd_data(ts.data_size, ts.order,
                                                   78), 0.0, ts.order * 1.5))
    nl = ts.skel.num_lumps
    assert nl >= 2
    t = int(ts.skel.lump_to_span[max(1, nl // 2)])
    o = ts.span_vector_offset(t)
    full = ts.factor(tt(data)).numpy()
    part = ts.factor_from(ts.factor_up_to(tt(data), t), t).numpy()
    assert maxabs(full - part) < 1e-9
    m = ts.skel.densify(data, fill_upper_half=True)
    rng = np.random.RandomState(3)
    x, out = rng.rand(ts.order, 2), rng.rand(ts.order, 2)
    got = ts.add_mv_from(tt(data), t, tt(x), tt(out), 0.5).numpy()
    want = out.copy()
    want[o:] += 0.5 * (m[o:, o:] @ x[o:])
    assert maxabs(got - want) < 1e-9
    assert rel(got, js.add_mv_from(data, t, x, out, 0.5)) < RTOL


def _carried(make):
    """JAX PLANNED solver, the port's on its skeleton, and data with zero
    padding (the JAX package's partial solves read the padded rows and
    columns of the diag blocks, as its factor leaves them: zero; the
    port reads only the real ones)."""
    js = make(J)
    ts = T.solver_from_skeleton(T.skeleton_arrays(js.skel), js.permutation,
                                js.sparse_elim_ranges, device="cpu")
    return js, ts, spd_data(js, 3) * ts.skel.padding_mask()


@pytest.mark.parametrize("name", ["elim_range", "wide_below"])
def test_partial_ops_on_dense_and_wide_levels(name):
    """Its wide_dense case runs in test_torch_partial_wide.py: it takes
    most of this file's time, and the runner hands out whole files."""
    partial_ops_on_dense_and_wide_levels(name)


def partial_ops_on_dense_and_wide_levels(name):
    """Problems with a dense level (the range's update lands on a lump
    past it) and with wide panels (K3-rest wide, K5 wide; wide_below's
    wide lump has below rows): every partial op against JAX PLANNED on
    the same skeleton, and up_to + from against the full factor."""
    make = {"elim_range": SMALL["elim_range"], "wide_dense": wide_dense,
            "wide_below": wide_below}[name]
    js, ts, data = _carried(make)
    nl = ts.skel.num_lumps
    t = int(ts.skel.lump_to_span[max(1, nl // 2)])
    kernels.reset_counts()
    fu = ts.factor_up_to(tt(data), t)
    assert live_rel(ts, fu.numpy(), js.factor_up_to(data, t)) < RTOL
    ff = ts.factor_from(fu, t)
    assert rel(ff.numpy(), ts.factor(tt(data)).numpy()) < 1e-12
    fj = np.asarray(js.factor_from(js.factor_up_to(data, t), t))
    assert rel(ff.numpy(), fj) < RTOL
    v = np.random.RandomState(2).rand(ts.order, 3)
    for m, f in (("solve_l_up_to", fu), ("solve_lt_up_to", fu),
                 ("solve_l_from", ff), ("solve_lt_from", ff)):
        got = getattr(ts, m)(f, t, tt(v)).numpy()
        assert rel(got, getattr(js, m)(f.numpy(), t, v)) < RTOL, m
    for st in (0, t):
        got = ts.add_mv_from(tt(data), st, tt(v), tt(0.3 * v), -0.7).numpy()
        assert rel(got, js.add_mv_from(data, st, v, 0.3 * v, -0.7)) < RTOL
    pf = ts.pseudo_factor_from(tt(data), t)
    assert rel(pf.numpy(), js.pseudo_factor_from(data, t)) < RTOL
    for m in ("solve_l_from", "solve_lt_from"):
        got = getattr(ts, m)(pf, t, tt(v)).numpy()
        assert rel(got, getattr(js, m)(pf.numpy(), t, v)) < RTOL, m
    # the port reads no padding: garbage there changes nothing
    junk = tt(pf.numpy() + 1e3 * (1 - ts.skel.padding_mask()))
    for m in ("solve_l_from", "solve_lt_from"):
        assert torch.equal(getattr(ts, m)(pf, t, tt(v)),
                           getattr(ts, m)(junk, t, tt(v)))
    c = kernels.COUNTS
    assert c["tri_solve"].twin_calls > 0 and c["add_mv"].twin_calls > 0
    if name != "elim_range":
        assert c["wide_tri_solve"].twin_calls > 0
        assert c["wide_add_mv"].twin_calls > 0
    assert all(k.launches == 0 for k in c.values())


@pytest.mark.parametrize("backend", BACKENDS)
def test_partial_ops_batched_match_single(backend):
    js, ts, data = build(1, backend)
    t = mid_lump_span(ts)
    datas = np.stack([data * (1.0 + 0.01 * b) for b in range(3)])
    v = np.random.RandomState(5).rand(3, ts.order, 2)
    fb = ts.factor_up_to(tt(datas), t)
    lb = ts.solve_l_up_to(fb, t, tt(v))
    mb = ts.add_mv_from(tt(datas), t, tt(v), tt(v), 2.0)
    pb = ts.pseudo_factor_from(tt(datas), t)
    for b in range(3):
        fs = ts.factor_up_to(tt(datas[b]), t)
        assert rel(fb[b].numpy(), fs.numpy()) < 1e-12
        assert rel(lb[b].numpy(), ts.solve_l_up_to(fs, t, tt(v[b])).numpy()) \
            < 1e-12
        assert rel(mb[b].numpy(), ts.add_mv_from(
            tt(datas[b]), t, tt(v[b]), tt(v[b]), 2.0).numpy()) < 1e-12
        assert rel(pb[b].numpy(),
                   ts.pseudo_factor_from(tt(datas[b]), t).numpy()) < 1e-12


def _policy_problem(pkg, gen_cls, seed=0, n=14, schur=56):
    gen = gen_cls.gen_flat(n, 0.3, seed=seed)
    gen.add_schur_set(schur, 0.12)
    ss = gen.to_structure()
    return ss, np.full(ss.order, 2), schur


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("policy", ["FOR_AUTO_ELIMS", "FOR_GIVEN_ELIMS"])
def test_partial_fill_policies(policy, backend):
    """tests/test_create_solver.py's partial fill policies: the skeleton
    factors only up to the elimination end; factor_up_to there gives
    L11 and L21 of the dense formula, and matches JAX."""
    solvers = []
    for pkg, gen in ((J, JGen), (T, SparseMatGenerator)):
        ss, psizes, schur = _policy_problem(pkg, gen, seed=2)
        kw = {} if pkg is J else {"device": "cpu"}
        solvers.append(pkg.create_solver(
            pkg.Settings(add_fill_policy=getattr(pkg.AddFillPolicy, policy),
                         backend=getattr(pkg.BackendType, backend)),
            psizes, ss, sparse_elim_ranges=[0, schur], **kw))
    js, ts = solvers
    assert ts.can_factor_up_to == js.can_factor_up_to
    assert schur <= ts.can_factor_up_to < ts.skel.num_spans
    if policy == "FOR_GIVEN_ELIMS":
        assert ts.can_factor_up_to == schur
        assert np.array_equal(ts.permutation, np.arange(len(psizes)))
    data = np.asarray(ts.skel.damp(random_spd_data(ts.data_size, ts.order,
                                                   3), 0.0, ts.order * 1.5))
    t = schur
    o = ts.span_vector_offset(t)
    m = ts.skel.densify(data, fill_upper_half=True)
    got = ts.factor_up_to(tt(data), t).numpy()
    part = ts.skel.densify(got)
    l11_want = np.linalg.cholesky(m[:o, :o])
    assert maxabs(np.tril(part[:o, :o]) - l11_want) < 1e-9
    l21_want = np.linalg.solve(l11_want, m[:o, o:]).T
    mask = ts.skel.densify(np.ones(ts.data_size))[o:, :o] != 0
    assert maxabs((part[o:, :o] - l21_want) * mask) < 1e-9
    assert live_rel(ts, got, js.factor_up_to(data, t)) < RTOL
    with pytest.raises(AssertionError):
        ts.factor(tt(data))  # past can_factor_up_to


def test_elim_last_ids_allow_partial_factor():
    gen = SparseMatGenerator.gen_flat(20, 0.25, seed=7)
    ts = T.create_solver(T.Settings(), np.full(20, 3), gen.to_structure(),
                         elim_last_ids={2, 9, 15, 18}, device="cpu")
    spans = sorted(int(ts.permutation[i]) for i in (2, 9, 15, 18))
    assert spans == [16, 17, 18, 19]
    assert ts.skel.span_offset_in_lump[16] == 0
    data = np.asarray(ts.skel.damp(random_spd_data(ts.data_size, ts.order,
                                                   1), 0.0, ts.order * 1.5))
    part = ts.factor_up_to(tt(data), 16)
    full = ts.factor_from(part, 16)
    assert maxabs(full.numpy() - ts.factor(tt(data)).numpy()) < 1e-9
