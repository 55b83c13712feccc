"""Host layer of the PyTorch port against the JAX package: the port's
numpy-only copy of the symbolic analysis must build the same skeleton
(bit for bit) and the same level schedule, and the package must not
import JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import baspacho_tpu as J
import baspacho_tpu_torch as T
from baspacho_tpu_torch.ops.schedule import PlannedSchedule, pair_csr, solve_csr
from baspacho_tpu_torch.testing import SparseMatGenerator
from baspacho_tpu_torch.testing.problems import SMALL
from same_native import one_native_library  # noqa: F401 (autouse)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_cache = {}


def solvers(name):
    """(JAX solver, port solver) of one SMALL problem, built once."""
    if name not in _cache:
        _cache[name] = (SMALL[name](J), SMALL[name](T))
    return _cache[name]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_skeleton_bit_for_bit(name):
    js, ts = solvers(name)
    a, b = T.skeleton_arrays(js.skel), T.skeleton_arrays(ts.skel)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert np.array_equal(js.permutation, ts.permutation)
    assert js.sparse_elim_ranges == ts.sparse_elim_ranges
    assert js.data_size == ts.data_size and js.order == ts.order


@pytest.mark.parametrize("name", sorted(SMALL))
def test_level_schedule_matches(name):
    """Same levels and lump buckets; the same levels dense; the same
    block pairs wherever both schedules took the pair assembly."""
    js, ts = solvers(name)
    nl = js.skel.num_lumps
    jsched = js.backend._factor_schedule(0, nl)
    tsched = ts.backend._factor_schedule(0, nl)
    assert len(jsched) == len(tsched)
    for (jlb, jpb, jptot, dense), (tlb, tpb, tptot, tdense) in zip(
            jsched, tsched):
        assert (dense is None) == (tdense is None)
        assert len(jlb) == len(tlb)
        for a, b in zip(jlb, tlb):
            assert (a.cp, a.rp) == (b.cp, b.rp)
            assert dense is not None or a.prod_base == b.prod_base
            for f in ("off", "rows", "cols", "vec_off", "below_idx",
                      "members"):
                assert np.array_equal(getattr(a, f), getattr(b, f)), f
        if dense is None:
            # the JAX package splits the level's pairs into padded shape
            # groups; the port keeps them as one list: same set of pairs
            assert jptot == tptot
            f = ("src_base", "src_stride", "rs", "cs", "c0",
                 "tgt_row_start", "tgt_stride")
            want = np.array([np.concatenate(
                [np.asarray(getattr(p, k), np.int64) for p in jpb] or
                [np.zeros(0, np.int64)]) for k in f]).T
            got = np.array([getattr(tpb, k) for k in f]).T
            assert got.shape == want.shape
            assert np.array_equal(np.unique(got, axis=0),
                                  np.unique(want, axis=0))
            assert len(np.unique(got, axis=0)) == len(got)


def test_skeleton_carries_over():
    """solver_from_skeleton rebuilds the JAX solver's exact layout."""
    js, _ = solvers("meri2")
    ts = T.solver_from_skeleton(T.skeleton_arrays(js.skel), js.permutation,
                                js.sparse_elim_ranges, device="cpu")
    a, b = T.skeleton_arrays(js.skel), T.skeleton_arrays(ts.skel)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    bad = dict(a)
    bad["col_stride"] = bad["col_stride"] + 1
    with pytest.raises(ValueError):
        T.solver_from_skeleton(bad, js.permutation, js.sparse_elim_ranges,
                               device="cpu")


@pytest.mark.parametrize("name", ["meri3", "elim_range"])
def test_pair_csr_covers_every_contribution(name):
    """Every real element of every pair rectangle appears exactly once;
    targets ascend; within a target, contributions keep origin order."""
    _, ts = solvers(name)
    # forced pairs: elim_range's first level goes dense by default
    sched = PlannedSchedule(ts.plan, assembly="pairs")._factor_schedule(
        0, ts.skel.num_lumps)
    for lbs, pairs, ptot, _ in sched:
        csr = pair_csr(pairs)
        want = int((pairs.rs * pairs.cs).sum())
        assert len(csr.src_idx) == want == csr.seg_ptr[-1]
        assert np.all(np.diff(csr.tgt) > 0)
        assert len(np.unique(csr.src_idx)) == len(csr.src_idx)
        if want:
            assert csr.src_idx.max() < ptot
            assert csr.tgt.max() < ts.data_size


def test_solve_csr_skips_sentinels():
    _, ts = solvers("meri3")
    order = ts.order
    for lbs in ts.backend._solve_schedule(0, ts.skel.num_lumps):
        base, tot = [], 0
        for lb in lbs:
            base.append(tot)
            tot += len(lb.off) * lb.rp
        csr = solve_csr(lbs, base, order)
        real = sum(int(np.count_nonzero(lb.below_idx != order))
                   for lb in lbs if lb.rp)
        assert len(csr.src_idx) == real
        assert np.all(csr.tgt < order) and np.all(np.diff(csr.tgt) > 0)


def test_refusals_at_create_time():
    """Nothing that the JAX package builds is refused any more: the REF
    backend (the default of Settings) factors and solves, a wide
    supernode takes the blocked path, and a skeleton that factors only
    up to a span (fill policy NONE) builds and factors up to it."""
    gen = SparseMatGenerator.gen_flat(4, 1.0, seed=0)
    ss = gen.to_structure()
    ref = T.create_solver(T.Settings(), np.full(4, 3), ss, device="cpu")
    assert ref.backend_type == T.BackendType.REF
    data = np.asarray(ref.skel.damp(np.random.RandomState(0).rand(
        ref.data_size), 0.0, 20.0))
    f = ref.factor(torch.from_numpy(data)).numpy()
    dense = ref.skel.densify(data, fill_upper_half=True)
    L = np.tril(ref.skel.densify(f))
    assert np.abs(L @ L.T - dense).max() < 1e-10
    x = ref.solve(torch.from_numpy(f),
                  torch.ones(ref.order, dtype=torch.float64)).numpy()
    assert np.abs(dense @ x - 1).max() < 1e-10
    # one dense supernode of width 800 pads to 1024: no refusal, it
    # takes the blocked wide path
    wide = T.create_solver(T.Settings(backend=T.BackendType.PLANNED),
                           np.full(4, 200), ss, device="cpu")
    assert [lb.cp for lv in wide.backend._factor_schedule(
        0, wide.skel.num_lumps) for lb in lv[0]] == [1024]
    none = T.create_solver(T.Settings(backend=T.BackendType.PLANNED,
                                      add_fill_policy=T.AddFillPolicy.NONE),
                           np.full(4, 3), ss, device="cpu")
    assert none.can_factor_up_to == 0
    d0 = torch.from_numpy(np.random.RandomState(1).rand(none.data_size) *
                          none.skel.padding_mask())
    assert torch.equal(none.factor_up_to(d0, 0), d0)  # an empty range


def test_port_imports_no_jax():
    """The port and chip_smoke.py import neither jax nor baspacho_tpu."""
    code = ("import sys\n"
            "import baspacho_tpu_torch, baspacho_tpu_torch.ops.kernels\n"
            "import baspacho_tpu_torch.ops.planned_backend\n"
            "import baspacho_tpu_torch.testing.problems\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'baspacho_tpu' or "
            "m.startswith('baspacho_tpu.')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
