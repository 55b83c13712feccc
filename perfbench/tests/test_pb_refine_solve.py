"""The cell bal-871-mixed.refine and the solve step on bal-871 (its cell,
bal-871.solve, waits outside BENCHMARK.json: PERF.md §7) cut to CPU
sizes: both run and are correct by the plain reference, the refine step unrefined
(rounds 0, the control) and a solve that returns its right-hand side are
judged incorrect, the steps' traffic checks, the refined solve's work,
the program segment of a refine step on the CPU, and the three readers
of the port's refine spans on made-up profiled steps and without them."""

import io
import time
from unittest import mock

import pytest

from perfbench import faults, harness, segment
from perfbench import work as wk
from perfbench.tests import small
from perfbench.tests.test_pb_trace import CUDA, ev

CELLS = {"bal-871-mixed.refine": "bal-871-mixed",
         "bal-871.solve": "bal-871"}
NEW = ("refine_ms", "refine_residual_ms", "residual_mv_roofline")
SEED = 2147483701
SOLVE = {"name": "bal-871.solve", "config": "bal-871", "traffic": "solve",
         "chips": 1, "why": "one synced solve a step on a held factor"}


def bench() -> dict:
    """BENCHMARK.json with the solve step's cell."""
    b = harness.load_json(f"{harness.ROOT}/BENCHMARK.json")
    b["workloads"] = b["workloads"] + [SOLVE]
    return b


def run(workload, trace=False, **kw):
    with mock.patch.object(harness, "benchmark", bench):
        return harness.run_cell(workload, SEED, 0.2, trace,
                                time.perf_counter(), device="cpu",
                                cfg=small.config(CELLS[workload]),
                                out=io.StringIO(), **kw)


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(workload):
    r = run(workload)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    res = r["checks"]["residual_max"]
    assert 0 < res["value"] < 1e-13 and res["limit"] == 1e-10
    assert set(r["metrics"]) == {"step_ms", "step_p95_ms", "setup_s"}


def unrefined(cell):
    cell.mix.rounds = 0


@pytest.mark.parametrize("workload,hook", [
    ("bal-871-mixed.refine", unrefined),
    ("bal-871-mixed.refine", faults.unchanged_solve),
    ("bal-871.solve", faults.unchanged_solve),
    ("bal-871.solve", faults.altered)])
def test_control_and_faults_fail(workload, hook):
    r = run(workload, hook=hook)
    assert not r["correct"] and r["failed"] > 0
    assert r["checks"]["residual_max"]["value"] > 1e-9


@pytest.mark.parametrize("step,traffic", [
    ("refine", {"why": "w", "step": "refine", "lambda_log10": [-6, -1],
                "rounds": 2, "extra": 1}),
    ("refine", {"why": "w", "step": "refine", "lambda_log10": [-6, -1]}),
    ("refine", {"why": "w", "step": "refine", "lambda_log10": [-6, -1],
                "rounds": -1}),
    ("solve", {"why": "w", "step": "solve", "lambda_log10": [-6, -1],
               "rhs_count": 64, "solves": 8}),
    ("solve", {"why": "w", "step": "solve", "lambda_log10": [-6, -1],
               "rhs_count": 0}),
    ("solve", {"why": "w", "step": "solve", "lambda_log10": [-6, -1]})])
def test_check_refuses(step, traffic):
    with pytest.raises(ValueError):
        harness.step_module(step).check(traffic)


def test_traffic_files_check():
    for workload in CELLS:
        _, cfg, traffic = harness.cell_spec(bench(), workload)
        assert cfg["residual_limit"] == 1e-10
    _, cfg, traffic = harness.cell_spec(bench(), "bal-871-mixed.refine")
    assert (cfg["dtype"], cfg["matrix_dtype"], traffic["rounds"]) == \
        ("float32", "float64", 2)


def test_refined_solve_work():
    """Three float32 solves and two float64 mat-vecs, the mat-vecs' part
    kept beside the whole; each mat-vec reads the lower half once."""
    refine = harness.step_module("refine")
    n, r = [3, 3, 9], [9, 9, 0]
    solve = wk.solve_work(n, r, 1, 1, 4)
    mv = refine.matvec_work(n, r, 1, 1, 8)
    nnz = wk.nnz_l(n, r)
    assert mv.bytes == (nnz + 3 * 15) * 8
    assert mv.flops == 2 * (2 * nnz - 15)
    w = refine.RefinedSolve(3 * solve.flops + 2 * mv.flops,
                            3 * solve.bytes + 2 * mv.bytes,
                            wk.Work(2 * mv.flops, 2 * mv.bytes))
    assert w.matvecs.bytes == 2 * mv.bytes and isinstance(w, wk.Work)


def test_segment_of_a_refine_step_on_the_cpu():
    """The counted steps of the refine cell: the factor, then refine
    with its solves inside it, as refine_ms needs."""
    bench = harness.benchmark()
    _, _, traffic = harness.cell_spec(bench, "bal-871-mixed.refine")
    seg = segment.measure(small.config("bal-871-mixed"), traffic, SEED,
                          "cpu", steps=2)
    spans = seg.counted.spans
    assert [x[0] for x in spans if x[3] is None] == ["factor", "refine"] * 2
    for name, _, _, p, call in spans:
        if name.startswith("refine.") or name == "solve":
            assert spans[p][0] == "refine"
        if name.startswith("refine."):
            assert call == spans[p][4]
    assert sum(x[0] == "solve" for x in spans) == 2 * 3
    assert sum(x[0] == "refine.residual" for x in spans) == 2 * 2
    assert seg.trace is None


def refine_events():
    # host: one step 0..100 us. The benchmark's factor (10..30) holds the
    # port's factor (11..29, k1: call 1); its solve (30..90) holds the
    # port's refine (31..89): a cast (32..33, call 2), a solve (34..40,
    # call 3), a cast (41..42, call 4), a residual (43..50: K5 call 5,
    # the subtraction call 6), a cast (51..52, call 7), a solve (53..60,
    # call 8), a cast (61..62, call 9). Device: k1 12..30, cast 33..34,
    # solve 40..46, cast 46..47, mv 50..58, sub 58..60, cast 60..61,
    # solve 62..70, cast 70..71.
    host = [("bench.steps", 0, 100, 0), ("bench.step", 0, 100, 0),
            ("bench.redamp", 0, 10, 0), ("bench.factor", 10, 30, 0),
            ("baspacho.factor", 11, 29, 0), ("cudaLaunchKernel", 12, 13, 1),
            ("bench.solve", 30, 90, 0), ("baspacho.refine", 31, 89, 0),
            ("baspacho.refine.cast", 32, 33, 0),
            ("cudaLaunchKernel", 32.5, 33, 2),
            ("baspacho.solve", 34, 40, 0), ("cudaLaunchKernel", 35, 36, 3),
            ("baspacho.refine.cast", 41, 42, 0),
            ("cudaLaunchKernel", 41.5, 42, 4),
            ("baspacho.refine.residual", 43, 50, 0),
            ("cudaLaunchKernel", 44, 45, 5), ("cudaLaunchKernel", 46, 47, 6),
            ("baspacho.refine.cast", 51, 52, 0),
            ("cudaLaunchKernel", 51.5, 52, 7),
            ("baspacho.solve", 53, 60, 0), ("cudaLaunchKernel", 54, 55, 8),
            ("baspacho.refine.cast", 61, 62, 0),
            ("cudaLaunchKernel", 61.5, 62, 9), ("bench.sync", 90, 100, 0)]
    dev = [("k1", 12, 30, 1), ("cast", 33, 34, 2), ("k3", 40, 46, 3),
           ("cast", 46, 47, 4), ("mv", 50, 58, 5), ("sub", 58, 60, 6),
           ("cast", 60, 61, 7), ("k3", 62, 70, 8), ("cast", 70, 71, 9)]
    return [ev(n, a, b, id=i) for n, a, b, i in host] + \
        [ev(n, a, b, CUDA, id=i) for n, a, b, i in dev]


def refine_segment(solve_outside=False):
    spans = [("factor", 0, 10, None, 1), ("factor.input", 1, 2, 0, 1),
             ("refine", 20, 90, None, 2), ("refine.cast", 21, 22, 2, 2),
             ("solve", 23, 30, 2, 3), ("solve.input", 24, 25, 4, 3),
             ("refine.residual", 31, 40, 2, 2)]
    if solve_outside:
        spans.append(("solve", 95, 99, None, 4))
    return segment.Segment(
        setup_spans=[], programs_s=1.0,
        counted=segment.Counted(steps=1, wall_s=1e-4, host_ns=1000,
                                spans=spans),
        trace=segment.read(refine_events(), CUDA, steps=1))


def test_readers_on_made_up_steps(monkeypatch):
    refine = harness.step_module("refine")
    seg = refine_segment()
    assert set(seg.trace.port_iv) == {
        "baspacho.factor", "baspacho.refine.cast", "baspacho.solve",
        "baspacho.refine.residual"}
    run = harness.Run(stages={}, steps=4, wall_s=0.04,
                      peak=(67e12, 3.35e12))
    # least time of the step's mat-vecs: 5 us of bytes
    run.work = {"solve": refine.RefinedSolve(
        1.0, 1.0, wk.Work(1.0, 5e-6 * 3.35e12))}
    monkeypatch.setattr(segment, "of", lambda r: seg if r is run else None)
    got = {name: harness.reader(name)(run) for name in NEW}
    # refine: 33..34, 40..47, 50..61, 62..71; the residual 50..60
    assert got == pytest.approx({"refine_ms": 28e-3,
                                 "refine_residual_ms": 10e-3,
                                 "residual_mv_roofline": 50.0})
    # a work with no mat-vecs (refactor's) reads no roofline
    run.work = {"solve": wk.Work(1.0, 1.0)}
    assert harness.reader("residual_mv_roofline")(run) is None
    # a solve outside refine: its records cannot be told apart
    seg = refine_segment(solve_outside=True)
    assert harness.reader("refine_ms")(run) is None


def test_readers_silent_without_spans(monkeypatch):
    """No segment, or a segment of a cell that refines nothing (the
    refactor step's spans, a parent port's): every new reader gives
    None and raises nothing."""
    from perfbench.tests.test_pb_segment import made_up
    refine = harness.step_module("refine")
    run = harness.Run(stages={}, steps=4, wall_s=0.04,
                      peak=(67e12, 3.35e12),
                      work={"solve": refine.RefinedSolve(
                          1.0, 1.0, wk.Work(1.0, 1.0))})
    for seg in (None, made_up()):
        monkeypatch.setattr(segment, "of", lambda r, seg=seg: seg)
        for name in NEW:
            assert harness.reader(name)(run) is None, name


def test_cpu_trace_run_gives_no_new_metric():
    """A --trace 1 run of the refine cell at a CPU size, started by no
    command line: correct, none of the new metrics, and no error."""
    r = run("bal-871-mixed.refine", trace=True)
    assert r["correct"]
    assert not set(NEW) & set(r["metrics"])
