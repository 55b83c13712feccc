"""Solver.solve_refined of the port on the PLANNED CPU twins, held to a
plain float64 dense solve (torch.linalg.solve of the damped matrix): an
f32 factor refined twice meets the f64 contract of 1e-10 and unrefined
misses it; with the port's tracing on (trace.py) the call records
`refine`, `refine.residual` and `refine.cast` under one call id, its
solves keep their own `solve` spans and ids, K5's wrappers count host
ns, and the result is the same bits as with tracing off. `elim_range`
runs only narrow K5 buckets, `wide_below` a wide one too."""

import pytest
import torch

import baspacho_tpu_torch as T
from baspacho_tpu_torch import trace
from baspacho_tpu_torch.ops import kernels
from baspacho_tpu_torch.testing.problems import SMALL, spd_data, wide_below

torch.set_num_threads(1)

PROBLEMS = {"elim_range": SMALL["elim_range"], "wide_below": wide_below}
CONTRACT = 1e-10


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and an empty log."""
    trace.enable(False)
    trace.take()
    yield
    trace.enable(False)
    trace.take()


def problem(name, backend="PLANNED"):
    """The solver, its f64 data, the f32 factor and a right-hand side."""
    s = PROBLEMS[name](T, backend=backend)
    d = torch.as_tensor(spd_data(s, 7))
    b = torch.linspace(-1, 1, s.order, dtype=torch.float64)
    return s, d, s.factor(d.float()), b


def relative_residual(a, x, b) -> float:
    return float(torch.linalg.vector_norm(a @ x - b)
                 / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("iterations", [0, 2])
def test_refined_against_a_dense_f64_solve(name, iterations):
    s, d, f32, b = problem(name)
    assert f32.dtype == torch.float32 and s.check_factor(f32)
    x = s.solve_refined(d, f32, b, iterations=iterations)
    assert x.dtype == torch.float64
    a = torch.as_tensor(s.skel.densify(d.numpy(), fill_upper_half=True))
    want = torch.linalg.solve(a, b)
    res = relative_residual(a, x, b)
    err = float(torch.linalg.vector_norm(x - want)
                / torch.linalg.vector_norm(want))
    if iterations:
        assert res <= CONTRACT and err <= CONTRACT
    else:
        # the f32 factor alone: about f32's rounding, decades above
        assert 1e3 * CONTRACT < res < 1e-4


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_spans_counters_and_bits(name):
    s, d, f32, b = problem(name)
    x0 = s.solve_refined(d, f32, b)
    assert trace.take() == []
    kernels.reset_counts()
    trace.enable(True)
    x1 = s.solve_refined(d, f32, b)
    trace.enable(False)
    assert torch.equal(x0, x1)
    spans = trace.take()
    solve = ["solve", "solve.input"]
    assert [x.name for x in spans] == (
        ["refine", "refine.cast"] + solve + ["refine.cast"]
        + (["refine.residual", "refine.cast"] + solve + ["refine.cast"]) * 2)
    top = spans[0]
    assert top.parent is None and top.call is not None
    own = [x for x in spans if x.name.startswith("refine.")]
    assert len(own) == 2 + 3 * 2
    assert all(x.parent == 0 and x.call == top.call for x in own)
    calls = [x for x in spans if x.name == "solve"]
    assert all(x.parent == 0 for x in calls)
    assert len({x.call for x in calls} | {top.call}) == 4
    for x in spans:
        if x.name == "solve.input":
            assert spans[x.parent].name == "solve"
            assert x.call == spans[x.parent].call
        if x.parent is not None:
            p = spans[x.parent]
            assert p.start_ns <= x.start_ns <= x.end_ns <= p.end_ns
    # K5's wrappers are timed while tracing (wide ones where a lump is)
    timed = {k for k in ("add_mv", "wide_add_mv")
             if kernels.COUNTS[k].host_ns > 0}
    assert timed == ({"add_mv", "wide_add_mv"} if name == "wide_below"
                     else {"add_mv"})
    h = kernels.COUNTS["add_mv"].host_ns
    s.solve_refined(d, f32, b)
    assert kernels.COUNTS["add_mv"].host_ns == h
    trace.enable(True)
    s.solve_refined(d, f32, b, iterations=1)
    assert kernels.COUNTS["add_mv"].host_ns > h


def test_ref_backend_records_no_refine_span():
    s, d, f32, b = problem("elim_range", backend="REF")
    trace.enable(True)
    s.solve_refined(d, f32, b)
    assert trace.take() == []
