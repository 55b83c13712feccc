"""The port's stats slice (baspacho_tpu_torch/stats.py and the Solver's
stats methods) against the JAX package's (baspacho_tpu/stats.py), on the
CPU twins, f64: coarse OpStat counts, print_stats' matrix block, the
shapes of the profile records bucket by bucket and level by level, the
replays, the fit, a custom model in create_solver, and the fit_model
demo twin. Times differ between the packages and are not compared; the
fit of identical records agrees to 1e-12."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

import baspacho_tpu as J
import baspacho_tpu_torch as T
from baspacho_tpu.stats import fit_computation_model as j_fit
from baspacho_tpu.stats import profile_factor as j_profile_factor
from baspacho_tpu.stats import profile_solve as j_profile_solve
from baspacho_tpu_torch.ops.planned_backend import DevBucket
from baspacho_tpu_torch.stats import ProfileRecords, fit_computation_model, \
    profile_factor, profile_solve, solve_split
from baspacho_tpu_torch.testing.mat_gen import SparseMatGenerator
from baspacho_tpu_torch.testing.problems import SMALL, build_gen, spd_data
from same_native import one_native_library  # noqa: F401 (autouse)

torch.set_num_threads(1)


@contextlib.contextmanager
def jax_assembly(mode):
    """BASPACHO_FORCE_ASSEMBLY for the JAX package's schedule (the port
    reads no such variable: its own rule sends a level dense or not)."""
    if mode is None:
        yield
        return
    os.environ["BASPACHO_FORCE_ASSEMBLY"] = mode
    try:
        yield
    finally:
        os.environ.pop("BASPACHO_FORCE_ASSEMBLY", None)


def flat(pkg, n, fill, seed, schur=0, **kw):
    """tests/test_stats.py's problems: gen_flat(n, fill, seed) with
    2-wide params (and a Schur set, eliminated first); `kw` names the
    backend or the merge model (testing/problems.py)."""
    gen = SparseMatGenerator.gen_flat(n, fill, seed=seed)
    if schur:
        gen.add_schur_set(schur, 0.03)
        kw["elim_ranges"] = [0, schur]
    return build_gen(pkg, gen, block=2, **kw)


# (maker, the JAX package's assembly mode) of the profiled problems
PROBLEMS = {
    "flat": (SMALL["flat"], "pairs"),
    "elim_range": (SMALL["elim_range"], "dense"),
    "meri2": (SMALL["meri2"], "pairs"),
    "grid10": (SMALL["grid10"], "pairs"),
    "stats_flat30": (lambda pkg: flat(pkg, 30, 0.1, 0), "pairs"),
    "stats_flat150": (lambda pkg: flat(pkg, 150, 0.03, 1), "pairs"),
    "stats_dense": (lambda pkg: flat(pkg, 40, 0.1, 5, schur=400), "dense"),
}
_cache = {}


def profiled(name):
    """(JAX solver, port solver, data, JAX records, port records) of a
    problem's factor profile (one run per piece)."""
    if name not in _cache:
        make, mode = PROBLEMS[name]
        with jax_assembly(mode):
            js = make(J)
            data = spd_data(js, 3)
            jr = j_profile_factor(js, data, reps=1)
            js.backend._factor_schedule(0, js.skel.num_lumps)
        ts = make(T)
        tr = ts.profile_ops(torch.from_numpy(data), reps=1)
        _cache[name] = (js, ts, data, jr, tr)
    return _cache[name]


def shapes(records, ops=None):
    return [r[:4] for r in records if ops is None or r[0] in ops]


def port_levels(ts, records):
    """The port's records split by level: per bucket potrf, trsm (below
    rows) and syge (below rows, pair level, narrow), then the level's
    asmbl or dense_upd."""
    out, i = [], 0
    for lbs, pairs, _, dense in ts.backend._factor_schedule(
            0, ts.skel.num_lumps):
        n = sum(1 + (lb.rp > 0) + (lb.rp > 0 and dense is None)
                for lb in lbs)
        n += dense is not None or (pairs is not None and len(pairs.rs) > 0)
        out.append((dense is None, records[i:i + n]))
        i += n
    assert i == len(records)
    return out


def jax_levels(js, records):
    """The JAX package's records split by level (stats.py:185-241)."""
    out, i = [], 0
    for lbs, _, _, dense in js.backend._factor_schedule(
            0, js.skel.num_lumps):
        n = sum(1 + (lb.rp > 0) + (lb.rp > 0 and dense is None)
                for lb in lbs)
        n += dense is not None or any(lb.rp > 0 for lb in lbs)
        out.append((dense is None, records[i:i + n]))
        i += n
    assert i == len(records)
    return out


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_potrf_trsm_records_match_jax(name):
    """potrf (cp, B, 0) and trsm (cp, rp B, 0) for every bucket, in the
    JAX package's order, all finite and > 0."""
    _, _, _, jr, tr = profiled(name)
    assert isinstance(tr, ProfileRecords)
    assert shapes(tr, ("potrf", "trsm")) == shapes(jr, ("potrf", "trsm"))
    assert all(np.isfinite(r[4]) and r[4] > 0 for r in tr)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_pair_level_records_match_jax(name):
    """On each level that pairs in both packages, the same records:
    potrf, trsm and syge (rp, rp, cp B) per bucket, then asmbl (pairs,
    elements)."""
    js, ts, _, jr, tr = profiled(name)
    pl, jl = port_levels(ts, tr), jax_levels(js, jr)
    assert len(pl) == len(jl)
    both = [(p, j) for (pp, p), (jp, j) in zip(pl, jl) if pp and jp]
    for p, j in both:
        assert shapes(p) == shapes(j)
    if name in ("meri2", "stats_flat150"):
        assert any(shapes(p, ("syge",)) for p, _ in both)
        assert any(shapes(p, ("asmbl",)) for p, _ in both)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_replay_equals_factor(name):
    """The profile's replay is the factor, bit for bit; a dense level
    yields dense_upd (R compact rows, K4 records)."""
    _, ts, data, _, tr = profiled(name)
    assert torch.equal(tr.output, ts.factor(torch.from_numpy(data)))
    dense = [lv[3] for lv in ts.backend._factor_schedule(
        0, ts.skel.num_lumps) if lv[3] is not None]
    got = [r[:4] for r in tr if r[0] == "dense_upd"]
    assert got == [("dense_upd", d.R, len(d.rec) + len(d.w_tile), 0)
                   for d in dense]
    if name == "elim_range":
        assert got


def test_dense_level_matches_jax_rows():
    """A Schur level dense in both packages: the same compact rows R (the
    JAX package's second number counts its slices)."""
    _, _, _, jr, tr = profiled("elim_range")
    assert [r[1] for r in tr if r[0] == "dense_upd"] == \
        [r[1] for r in jr if r[0] == "dense_upd"]


def test_profile_batched_and_rhs_checks():
    """A batch profiles as one call per piece; its replay is the batched
    factor. The solve profile takes the solve's right-hand sides."""
    _, ts, data, _, tr = profiled("meri2")
    d2 = torch.from_numpy(np.stack([data, data * 1.01]))
    r2 = profile_factor(ts, d2, reps=1)
    assert shapes(r2) == shapes(tr)
    assert torch.equal(r2.output, ts.factor(d2))
    f = ts.factor(torch.from_numpy(data))
    with pytest.raises(ValueError):
        profile_solve(ts, f, torch.ones(ts.order + 1, dtype=torch.float64))


SOLVE_PROBLEMS = {"elim_range": SMALL["elim_range"],
                  "stats_flat80": lambda pkg: flat(pkg, 80, 0.06, 2)}


@pytest.mark.parametrize("name", sorted(SOLVE_PROBLEMS))
def test_solve_records_match_jax(name):
    """Diagonal stages (cp, B) and gemv / gemvT (cp, rp B) per bucket in
    the JAX package's order; one assembleVec (targets, buckets with below
    rows) per level with a scatter, none of assembleVecT; the replay is
    the solve, bit for bit; print_stats' per-stage lines."""
    make = SOLVE_PROBLEMS[name]
    js, ts = make(J), make(T)
    data = spd_data(js, 5)
    rhs = np.random.RandomState(1).rand(js.order, 2)
    fj = np.asarray(js.factor(data))
    jr = j_profile_solve(js, fj, rhs, reps=1)
    ft = ts.factor(torch.from_numpy(data))
    b = torch.from_numpy(rhs)
    tr = ts.profile_solve_ops(ft, b, reps=1)
    assert torch.equal(tr.output, ts.solve(ft, b))
    assert all(np.isfinite(r[4]) and r[4] > 0 for r in tr)
    stage = {"solveL", "solveLt", "sparseElimSolveL", "sparseElimSolveLt",
             "gemv", "gemvT"}
    assert shapes(tr, stage) == shapes(jr, stage)
    levels = ts.backend._solve_levels(0, ts.skel.num_lumps, ts.device)
    assert shapes(tr, ("assembleVec",)) == [
        ("assembleVec", lv.csr.n_tgt, sum(x.rp > 0 for x in lv.buckets), 0)
        for lv in levels if lv.csr.n_tgt]
    assert not shapes(tr, ("assembleVecT",))
    js.stats.record_profile(jr)
    for st in ("sparse_elim_solve_l", "sparse_elim_solve_lt",
               "solve_diag_l", "solve_diag_lt", "gemv", "gemv_t"):
        assert getattr(ts.stats, st).num_runs == \
            getattr(js.stats, st).num_runs
    text = printed(ts)
    assert "Per-solve-stage (profiled):" in text
    for line in ("sparseElimSolveL", "solveLt", "gemvT", "assembleVec",
                 "assembleVecT: no runs"):
        assert f"\n  {line}" in text
    if name == "elim_range":
        assert shapes(tr, ("gemv",)) and shapes(tr, ("assembleVec",)) and \
            shapes(tr, ("sparseElimSolveL",))


def _bucket(cp, rp, B):
    z = torch.zeros(B, dtype=torch.int64)
    return DevBucket(cp=cp, rp=rp, prod_base=0, off=z, rows=z, cols=z,
                     vec_off=z, below_idx=z, off_h=(), cols_h=())


@pytest.mark.parametrize("cp,rp,B,split", [
    (4, 64, 300, True),     # warp grid at rp and at 0
    (4, 512, 300, False),   # diag + rows at rp, warp grid at 0
    (4, 512, 100, True),    # diag + rows, diag alone at 0
    (64, 64, 300, True),    # diag at both
    (1024, 64, 3, True),    # K3-wide: a subset of its grids at 0
    (8, 0, 300, False),     # no below rows: one call
])
def test_solve_split(cp, rp, B, split):
    assert solve_split(_bucket(cp, rp, B)) is split


def printed(solver) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        solver.print_stats()
    return buf.getvalue()


def matrix_block(text: str) -> str:
    return text.split("Solver timings:")[0]


@pytest.mark.parametrize("name,backend", [
    ("meri2", "PLANNED"), ("elim_range", "PLANNED"), ("elim_range", "REF")])
def test_coarse_stats_match_jax(name, backend):
    """The same calls record the same num_runs per OpStat (factor and
    factor_up_to into factor; PLANNED's fused solve into solveL, REF's
    into solveL and solveLt; factor_from, the partial solves and
    add_mv_from nothing), reset_stats clears them, a disabled solver
    records nothing, and print_stats' matrix block is the JAX
    package's."""
    js, ts = SMALL[name](J, backend=backend), SMALL[name](T, backend=backend)
    data = spd_data(js, 2)
    rhs = np.random.RandomState(3).rand(js.order)
    span = js.skel.num_spans // 2
    split = int(js.skel.lump_to_span[js.skel.span_to_lump[span]])

    def calls(s, arr):
        f = s.factor(arr(data))
        s.solve(f, arr(rhs))
        s.solve(f, arr(rhs))
        s.factor_up_to(arr(data), split)
        s.factor_from(arr(data), split)
        s.solve_l(f, arr(rhs))
        s.add_mv_from(arr(data), 0, arr(rhs), arr(rhs))
    for s in (js, ts):
        s.enable_stats()
    calls(js, np.asarray)
    calls(ts, torch.from_numpy)
    runs = [st.num_runs for st in js.stats._all()]
    assert [st.num_runs for st in ts.stats._all()] == runs
    assert runs[0] == 2 and runs[1] == 2
    assert ts.stats.factor.total_time > 0
    assert matrix_block(printed(ts)) == matrix_block(printed(js))
    for s in (js, ts):
        s.reset_stats()
        s.enable_stats(False)
    calls(ts, torch.from_numpy)
    assert all(st.num_runs == 0 for st in ts.stats._all())
    assert "factor: no runs" in printed(ts)


def test_profile_refuses_ref():
    """The profiles time the PLANNED backend's kernels; a REF solver
    refuses (the JAX package's has no schedule to profile either)."""
    js, ts = SMALL["meri2"](J, backend="REF"), SMALL["meri2"](T, backend="REF")
    data = spd_data(js, 2)
    with pytest.raises(AttributeError):
        j_profile_factor(js, data, reps=1)
    with pytest.raises(ValueError, match="PLANNED"):
        ts.profile_ops(torch.from_numpy(data), reps=1)
    with pytest.raises(ValueError, match="PLANNED"):
        ts.profile_solve_ops(torch.from_numpy(data),
                             torch.ones(ts.order, dtype=torch.float64))


def test_profile_ops_fill_per_op_stats():
    """profile_ops aggregates its records into the per-op stats that
    print_stats shows, as the JAX Solver's does."""
    js, ts, data, jr, tr = profiled("meri2")
    fresh = SMALL["meri2"](T)
    recs = fresh.profile_ops(torch.from_numpy(data), reps=1)
    js.stats.reset()
    js.stats.record_profile(jr)
    for st in ("potrf", "trsm", "syge", "asmbl"):
        assert getattr(fresh.stats, st).num_runs == \
            getattr(js.stats, st).num_runs == \
            sum(r[0] == st for r in recs)
    assert "Per-op (profiled):" in printed(fresh)


def test_fit_matches_jax():
    """Identical records give the same fitted model in both packages."""
    records = []
    for name in ("meri2", "stats_flat150", "elim_range"):
        records += list(profiled(name)[4])
    cm, cj = fit_computation_model(records), j_fit(records)
    assert isinstance(cm, T.ComputationModel)
    for k in ("potrf_params", "trsm_params", "syge_params", "asmbl_params"):
        a, b = getattr(cm, k), np.asarray(getattr(cj, k))
        assert a.shape == b.shape
        assert np.all(np.isfinite(a)) and np.all(a >= 0)
        assert np.max(np.abs(a - b)) <= 1e-12 * max(np.max(np.abs(b)),
                                                    1e-300)
    # no records of a kind: the JAX package's placeholder sample
    empty = fit_computation_model([])
    ref = j_fit([])
    assert np.allclose(empty.potrf_params, ref.potrf_params, rtol=1e-12,
                       atol=0)


def test_custom_computation_model_used():
    """A model that prices assembly high merges more, and each package's
    create_solver builds the same skeleton under the same model
    (tests/test_stats.py test_custom_computation_model_used)."""
    params = dict(potrf_params=[0, 0, 0, 1e-9],
                  trsm_params=[0, 0, 0, 0, 0, 1e-9],
                  syge_params=[0, 0, 0, 0, 0, 1e-9])
    starts = {}
    for asmbl in (1e-12, 1e-2):
        got = []
        for pkg in (J, T):
            model = pkg.ComputationModel(asmbl_params=[asmbl, 0, 0, 0],
                                         **params)
            s = flat(pkg, 40, 0.08, 3, backend="REF",
                     computation_model=model)
            got.append(np.asarray(s.skel.lump_start))
        assert np.array_equal(got[0], got[1])
        starts[asmbl] = got[1]
    assert len(starts[1e-2]) <= len(starts[1e-12])


def test_fit_model_twin_runs():
    """baspacho_tpu_torch/examples/fit_model.py on the CPU: records of
    the profile and a model of 20 finite, non-negative coefficients."""
    from baspacho_tpu_torch.examples import fit_model
    out = fit_model.main(["--device", "cpu"])
    assert out["records"] and all(r[4] > 0 for r in out["records"])
    coef = np.concatenate([out["model"].potrf_params,
                           out["model"].trsm_params,
                           out["model"].syge_params,
                           out["model"].asmbl_params])
    assert coef.shape == (20,)
    assert np.all(np.isfinite(coef)) and np.all(coef >= 0)
