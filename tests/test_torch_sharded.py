"""The port's sharded factor and solve and the data-parallel batch against
the JAX package, on N = 2 and 4 ranks over gloo on the CPU.

The cases are those of tests/test_multichip.py. For each N one launch
(baspacho_tpu_torch/testing/ranks.py: spawned processes that import only
the port) runs every case; the JAX side runs factor_sharded /
solve_sharded on a 1-D Mesh of N of conftest's 8 CPU devices, and factor
/ solve. The port's solvers are rebuilt from the JAX solvers' skeletons,
so both hold the same buffer.

Tolerances: the JAX test's own, rel 1e-9 / atol 1e-11, between the
sharded runs and the single-device ones of either package (a dense
level's update is summed over the ranks, in another order); 1e-8 from a
dense solve on the 1-D right-hand side. Bitwise: every rank's output
against rank 0's, a rerun against the first run, and the data-parallel
batch against the one-process batch.
"""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import baspacho_tpu as J
import baspacho_tpu_torch as T
from baspacho_tpu.testing import SparseMatGenerator, random_spd_data
from baspacho_tpu_torch.ops.schedule import factor_share, share_bounds
from baspacho_tpu_torch.testing import ranks
from baspacho_tpu_torch.testing.problems import SMALL, spd_data
from same_native import one_native_library  # noqa: F401 (autouse)

torch.set_num_threads(1)

NS = (2, 4)
# tests/test_multichip.py's cases, and the port's small problem with a
# dense level (the others' levels all go to pairs in the port's rule)
FACTOR_CASES = ("flat_w", "schur_oh", "grid_pairs", "elim_range")
SOLVE_CASES = ("flat", "schur", "elim_range")
# the JAX package's factor_sharded fails on this case's dense level under
# x64 (a TypeError from dynamic_slice, baspacho_tpu/ops/planned_backend.py
# :1989 in its W mode, :2033 in its one-hot mode): the port's sharded
# factor is held against both packages' factor there
JAX_SHARDED_DENSE = ("elim_range",)
DP_BACKENDS = ("PLANNED", "REF")
DP_BATCH = 16


def _with_env(env, build):
    """build() with the JAX package's environment knobs set (they pick
    its dense mode or force pair levels, as tests/test_multichip.py
    does)."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return build()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _jax_case(gen, psize, elim=(), env=()):
    """tests/test_multichip.py's _sharded_case: (JAX solver, data)."""
    js = _with_env(dict(env), lambda: J.create_solver(
        J.Settings(backend=J.BackendType.PLANNED), np.asarray(psize),
        gen.to_structure(), sparse_elim_ranges=list(elim)))
    data = np.asarray(random_spd_data(js.data_size, js.order, 5))
    return js, np.asarray(js.skel.damp(data, 0.0, js.order * 1.5))


def _schur_gen(seed):
    gen = SparseMatGenerator.gen_flat(40, 0.1, seed=seed)
    gen.add_schur_set(500, 0.03)
    return gen


def _build_case(name):
    if name == "flat_w":
        return _jax_case(SparseMatGenerator.gen_flat(150, 0.1, seed=4),
                         np.full(150, 3))
    if name == "schur_oh":
        return _jax_case(_schur_gen(6), np.full(540, 2), [0, 500],
                         {"BASPACHO_FORCE_DENSE_MODE": "oh"})
    if name == "grid_pairs":
        return _jax_case(SparseMatGenerator.gen_grid(10, 10, 0.3, seed=7),
                         np.full(100, 3),
                         env={"BASPACHO_FORCE_ASSEMBLY": "pairs"})
    if name == "flat":
        return _jax_case(SparseMatGenerator.gen_flat(150, 0.1, seed=9),
                         np.full(150, 3))
    if name == "elim_range":
        js = SMALL[name](J)
        return js, spd_data(js, 5)
    assert name == "schur"
    return _jax_case(_schur_gen(11), np.full(540, 2), [0, 500])


def _dp_case(backend):
    """tests/test_multichip.py's _build(n=16, fill=0.25, seed=3): (JAX
    solver, batch data, batch rhs)."""
    gen = SparseMatGenerator.gen_flat(16, 0.25, seed=3)
    psize = np.random.RandomState(3).randint(1, 4, size=16)
    js = J.create_solver(J.Settings(backend=getattr(J.BackendType, backend)),
                         psize, gen.to_structure())
    data = np.asarray(random_spd_data(js.data_size, js.order, 3))
    data = np.asarray(js.skel.damp(data, 0.0, js.order * 1.5))
    datas = np.stack([data * (1.0 + 0.01 * b) for b in range(DP_BATCH)])
    rhs = np.random.RandomState(0).rand(DP_BATCH, js.order, 2)
    return js, datas, rhs


def _port(js, backend="PLANNED"):
    return T.solver_from_skeleton(
        T.skeleton_arrays(js.skel), js.permutation, js.sparse_elim_ranges,
        device="cpu", backend=getattr(T.BackendType, backend))


_cases = {}


def case(name):
    """(JAX solver, port solver, data) of a factor / solve case."""
    if name not in _cases:
        js, data = _build_case(name)
        _cases[name] = (js, _port(js), data)
    return _cases[name]


def dp_case(backend):
    key = ("dp", backend)
    if key not in _cases:
        js, datas, rhs = _dp_case(backend)
        _cases[key] = (js, _port(js, backend), datas, rhs)
    return _cases[key]


def solve_rhs(ts):
    return np.random.RandomState(3).rand(ts.order, 2)


def port_factor(name):
    _, ts, data = case(name)
    return ts.factor(torch.from_numpy(data)).numpy()


_runs = {}


def runs(n):
    """{case name: ranks.Result} of one launch of every case on n gloo
    ranks."""
    if n not in _runs:
        todo = []
        for name in FACTOR_CASES:
            todo.append(ranks.Case(f"factor_{name}", case(name)[1],
                                   "factor_sharded",
                                   {"data": case(name)[2]}))
        for name in SOLVE_CASES:
            ts = case(name)[1]
            f, rhs = port_factor(name), solve_rhs(ts)
            todo.append(ranks.Case(f"solve_{name}", ts, "solve_sharded",
                                   {"factor": f, "rhs": rhs}))
            todo.append(ranks.Case(f"solve1_{name}", ts, "solve_sharded",
                                   {"factor": f, "rhs": rhs[:, 0]}))
        for b in DP_BACKENDS:
            _, ts, datas, rhs = dp_case(b)
            todo.append(ranks.Case(f"dp_{b}", ts, "dp",
                                   {"data": datas, "rhs": rhs}))
        got = ranks.launch(n, todo, backend="gloo", device="cpu",
                           timeout_s=300)
        _runs[n] = {c.name: r for c, r in zip(todo, got)}
    return _runs[n]


def mesh(n):
    return Mesh(np.array(jax.devices()[:n]), axis_names=("shard",))


def close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11)


def check_ranks(res):
    """Every rank returned rank 0's bytes, and a rerun its own."""
    assert len(set(res.hashes)) == 1, res.hashes
    assert all(rec["rerun_equal"] for rec in res.records)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", FACTOR_CASES)
def test_factor_sharded_matches_jax(name, n):
    js, ts, data = case(name)
    res = runs(n)[f"factor_{name}"]
    check_ranks(res)
    got = res.outputs["factor"]
    if name not in JAX_SHARDED_DENSE:
        close(got, np.asarray(js.factor_sharded(data, mesh(n))))
    close(got, np.asarray(js.factor(data)))
    close(got, port_factor(name))
    L = np.tril(ts.skel.densify(got))
    dense = ts.skel.densify(data, fill_upper_half=True)
    assert np.max(np.abs(L @ L.T - dense)) / np.abs(dense).max() < 1e-9
    # the K1 twin on every rank; collectives where a bucket is split
    rec = res.records[0]
    assert rec["twin_calls"]["bucket_factor"] > 0
    assert (rec["collectives"] > 0) == ("split" in _kinds(ts, n))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", SOLVE_CASES)
def test_solve_sharded_matches_jax(name, n):
    js, ts, data = case(name)
    res = runs(n)[f"solve_{name}"]
    check_ranks(res)
    f_port = port_factor(name)
    fj = np.asarray(js.factor(data))
    rhs = solve_rhs(ts)
    got = res.outputs["solution"]
    close(got, np.asarray(js.solve_sharded(fj, rhs, mesh(n))))
    close(got, np.asarray(js.solve(fj, rhs)))
    close(got, ts.solve(torch.from_numpy(f_port),
                        torch.from_numpy(rhs)).numpy())
    res1 = runs(n)[f"solve1_{name}"]
    check_ranks(res1)
    got1 = res1.outputs["solution"]
    close(got1, np.asarray(js.solve_sharded(fj, rhs[:, 0], mesh(n))))
    dense = ts.skel.densify(data, fill_upper_half=True)
    assert np.abs(got1 - np.linalg.solve(dense, rhs[:, 0])).max() < 1e-8
    assert (res.records[0]["collectives"] > 0) == ("split" in _kinds(ts, n))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("backend", DP_BACKENDS)
def test_dp_batch_bitwise(backend, n):
    """Each rank factors and solves 16 / n items: the gathered batch is
    the one-process batch, bit for bit (tests/test_multichip.py:31), and
    agrees with the JAX package's."""
    js, ts, datas, rhs = dp_case(backend)
    res = runs(n)[f"dp_{backend}"]
    check_ranks(res)
    f1 = ts.factor(torch.from_numpy(datas))
    x1 = ts.solve(f1, torch.from_numpy(rhs))
    np.testing.assert_array_equal(res.outputs["factor"], f1.numpy())
    np.testing.assert_array_equal(res.outputs["solution"], x1.numpy())
    fj = np.asarray(js.factor(datas))
    np.testing.assert_allclose(res.outputs["factor"], fj, rtol=1e-10,
                               atol=1e-12)
    for b in (0, DP_BATCH - 1):
        L = np.tril(ts.skel.densify(res.outputs["factor"][b]))
        dense = ts.skel.densify(datas[b], fill_upper_half=True)
        assert np.max(np.abs(L @ L.T - dense)) < 1e-9


def _kinds(ts, n):
    """What the port's sharded schedule of `ts` holds at n ranks: pair
    levels, dense levels, replicated and split buckets (factor and
    solve)."""
    sch = ts.backend._factor_schedule(0, ts.skel.num_lumps)
    kinds = set()
    for lump_buckets, _, _, dense in sch:
        kinds.add("dense" if dense is not None else "pair")
        for lb in lump_buckets:
            split = share_bounds(len(lb.off), n) is not None
            kinds.add("split" if split else "replicated")
            if split:
                kinds.add("split dense" if dense is not None
                          else "split pair")
    return kinds


@pytest.mark.parametrize("n", NS)
def test_cases_cover_the_schedule(n):
    """Between them the factor and solve cases run, in the port's own
    schedule, a pair level and a dense level each with a split bucket,
    and replicated buckets."""
    kinds = set()
    for name in FACTOR_CASES + SOLVE_CASES:
        kinds |= _kinds(case(name)[1], n)
    assert {"pair", "dense", "split", "replicated", "split dense",
            "split pair"} <= kinds, kinds


def _records(du):
    """K4's records of a DenseUpdate with their destinations, as sorted
    rows (destination offset, stride, rows, cols, record)."""
    if du is None:
        return np.zeros((0, 6), np.int64)
    d = np.repeat(np.arange(len(du.dst_off)), np.diff(du.dst_ptr))
    rows = np.stack([du.dst_off[d], du.dst_ld[d], du.dst_rows[d],
                     du.dst_cols[d], du.rec[:, 0], du.rec[:, 1]], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", ("schur_oh", "elim_range"))
def test_share_descriptors(name, n):
    """In numpy: the shares partition each split bucket and every rank
    factors the replicated buckets whole; the packs carry each split
    panel's elements (and products) once, to where they came from; on
    a dense level the ranks' K4 records sum to the level's and every
    record's destination lies in the level's target set."""
    ts = case(name)[1]
    sch = ts.backend._factor_schedule(0, ts.skel.num_lumps)
    for level in sch:
        lump_buckets, _, ptot, dense = level
        shares = [factor_share(ts.backend, level, n, r) for r in range(n)]
        split = [lb for lb in lump_buckets
                 if share_bounds(len(lb.off), n) is not None]
        rep = [lb for lb in lump_buckets if lb not in split]
        for sh in shares:
            assert [id(b) for b in sh.buckets if any(b is lb for lb in rep)] \
                == [id(lb) for lb in rep]
        for lb in split:
            parts = [b for sh in shares for b in sh.buckets
                     if len(b.members) and np.isin(b.members,
                                                   lb.members).all()]
            assert np.array_equal(np.concatenate([b.members for b in parts]),
                                  lb.members)
            assert [b.prod_base for b in parts] == [
                lb.prod_base + int(np.sum([len(p.off) for p in parts[:i]]))
                * lb.rp * lb.rp for i in range(len(parts))]
        sh = shares[0]
        if not split:
            assert sh.pack_len == 0 and sh.targets is None
            continue
        el = np.concatenate([(lb.off[:, None].astype(np.int64) + np.arange(
            (lb.cp + lb.rp) * lb.cp)).ravel() for lb in split])
        assert np.array_equal(np.sort(sh.unpack_data_dst), np.sort(el))
        for q, shq in enumerate(shares):
            # rank q's pack lands where rank q took it from
            seg = (sh.unpack_data_src >= q * sh.pack_len) & \
                (sh.unpack_data_src < (q + 1) * sh.pack_len)
            assert np.array_equal(sh.unpack_data_dst[seg], shq.pack_data)
            assert shq.pack_len == sh.pack_len
            assert len(shq.pack_data) + len(shq.pack_prod) <= sh.pack_len
        if dense is None:
            pr = np.concatenate([lb.prod_base + np.arange(
                len(lb.off) * lb.rp * lb.rp) for lb in split if lb.rp])
            assert np.array_equal(np.sort(sh.unpack_prod_dst), pr)
            assert pr.max() < ptot
            continue
        assert all(np.array_equal(s.targets, sh.targets) for s in shares)
        assert np.array_equal(np.unique(sh.targets), sh.targets)
        mine = np.concatenate([_records(s.dense) for s in shares])
        assert np.array_equal(mine[np.lexsort(mine.T[::-1])],
                              _records(dense))
        assert sum(len(s.dense.wide) for s in shares
                   if s.dense is not None) == len(dense.wide)
        for s in shares:
            if s.dense is None:
                continue
            d = s.dense
            tgt = np.concatenate([
                o + np.arange(r)[:, None] * ld + np.arange(c)
                for o, ld, r, c in zip(d.dst_off, d.dst_ld, d.dst_rows,
                                       d.dst_cols)], axis=None)
            assert np.isin(tgt, sh.targets).all()


@pytest.mark.parametrize("name", ("elim_range", "schur_oh"))
def test_one_rank_is_factor(name, tmp_path):
    """On a group of one rank (in this process, gloo, a 1-D DeviceMesh)
    every bucket of two panels or more is one share: factor_sharded is
    factor bit for bit, the dense level's sum included (t0 + (0 - U) is
    t0 - U in floating point), and it is timed into stats.factor."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    _, ts, data = case(name)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cpu", (1,))
        d = torch.from_numpy(data)
        ts.enable_stats()
        got = ts.factor_sharded(d, mesh)
        assert ts.stats.factor.num_runs == 1
        ts.enable_stats(False)
        assert torch.equal(got, ts.factor(d))
        rhs = torch.from_numpy(solve_rhs(ts))
        close(ts.solve_sharded(got, rhs, mesh).numpy(),
              ts.solve(got, rhs).numpy())
    finally:
        ts.enable_stats(False)
        ts.reset_stats()
        dist.destroy_process_group()
