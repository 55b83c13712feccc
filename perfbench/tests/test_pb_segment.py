"""The program segment (perfbench/segment.py) and its seven readers: the
port's spans in a made-up profiler event list (device records given to
the innermost span, idle time inside the port's calls, gaps named by
the innermost span of either kind), self times, the readers on a
made-up segment and without one, and a segment measured at a CPU size
(set-up spans and counted steps; the profiled steps need the card)."""

import io
import time

import pytest

from perfbench import harness, segment
from perfbench import trace as tr
from perfbench.tests import small
from perfbench.tests.test_pb_trace import CUDA, ev

NEW = ("schedule_s", "layout_s", "upload_s", "program_host_ms",
       "bindings_ms", "input_copy_ms", "program_idle_pct")


def port_events():
    # host: one step 0..100 us. In the benchmark's factor (10..40) the
    # port's factor call (11..39) copies its input in factor.input
    # (12..16: a memcpy, call 1, and a fill kernel, call 2), then
    # launches k1 (call 3); in the benchmark's solve (40..60) the port's
    # solve (41..58) copies its right-hand side in solve.input (42..44,
    # call 4) and launches k2 (call 5). The device runs: copy 14..18,
    # fill 18..20, k1 30..45, copy 50..52, k2 55..70; idle 0..14 (host
    # mid 7: redamp), 20..30 (mid 25: the port's factor), 45..50 (mid
    # 47.5: the port's solve), 52..55 (mid 53.5: the port's solve),
    # 70..100 (mid 85: sync). The spans' annotation records on the
    # device are left out.
    return [
        ev("bench.steps", 0, 100), ev("bench.step", 0, 100),
        ev("bench.redamp", 0, 10), ev("bench.factor", 10, 40),
        ev("baspacho.factor", 11, 39), ev("baspacho.factor.input", 12, 16),
        ev("cudaMemcpyAsync", 13, 14, id=1),
        ev("cudaLaunchKernel", 15, 16, id=2),
        ev("cudaLaunchKernel", 20, 21, id=3),
        ev("bench.solve", 40, 60), ev("baspacho.solve", 41, 58),
        ev("baspacho.solve.input", 42, 44),
        ev("cudaMemcpyAsync", 43, 44, id=4),
        ev("cudaLaunchKernel", 50, 51, id=5),
        ev("bench.sync", 60, 100),
        ev("Memcpy DtoD", 14, 18, CUDA, id=1),
        ev("index_elementwise_kernel", 18, 20, CUDA, id=2),
        ev("k1", 30, 45, CUDA, id=3), ev("Memcpy DtoD", 50, 52, CUDA, id=4),
        ev("k2", 55, 70, CUDA, id=5),
        ev("baspacho.factor", 14, 45, CUDA), ev("bench.factor", 14, 45, CUDA),
    ]


def test_port_spans():
    t = segment.read(port_events(), CUDA, steps=1)
    assert t.window_s == pytest.approx(100e-6)
    # device records go to the innermost span that launched them
    assert t.port_iv == {"baspacho.factor.input": [(14, 18), (18, 20)],
                         "baspacho.factor": [(30, 45)],
                         "baspacho.solve.input": [(50, 52)],
                         "baspacho.solve": [(55, 70)]}
    # idle inside the port's calls (11..39 and 41..58 on the host):
    # 11..14 (the gap's middle is in redamp), 20..30, 45..50, 52..55
    assert t.port_idle_s == pytest.approx(21e-6)
    # gaps named by the innermost span of either kind (us)
    assert sorted((k, round(v * 1e6, 9)) for k, v in t.gaps) == [
        ("baspacho.factor", 10), ("baspacho.solve", 3),
        ("baspacho.solve", 5), ("redamp", 14), ("sync", 30)]


def test_benchmark_spans_read_as_before():
    """The benchmark's own reader, on the same steps less the port's
    ranges (as the segment's completeness test reads them), gives the
    benchmark's spans what it gives without the port's tracing."""
    ev_ = [e for e in port_events()
           if not e.name.startswith(segment.PORT_PREFIX)]
    t = tr.read(ev_, CUDA, steps=1, port_kernels={"k1", "k2"})
    assert t.port_by_span == {"factor": 1, "solve": 1}
    assert t.kernels_by_span == {"factor": 3, "solve": 2}
    assert t.device_s_by_span == pytest.approx({"factor": 21e-6,
                                                "solve": 17e-6})


def test_innermost_and_overlap():
    s = segment.Innermost([("a", 0, 100), ("b", 10, 50), ("c", 20, 30),
                           ("d", 60, 70)])
    assert [s.at(t) for t in (5, 15, 25, 35, 55, 65, 100, -1)] == \
        ["a", "b", "c", "b", "a", "d", None, None]
    assert segment.overlap([(0, 10), (20, 30)], [(5, 25), (8, 9)]) == 10
    assert segment.overlap([], [(0, 1)]) == 0


def test_self_seconds():
    spans = [("programs.schedule", 0, 100, None, None),
             ("programs.upload", 10, 30, 0, None),
             ("programs.layout", 40, 70, 0, None),
             ("programs.upload", 50, 60, 2, None),
             ("programs.upload", 200, 210, None, None)]
    assert segment.self_seconds(spans, "programs.schedule") == \
        pytest.approx(50e-9)
    assert segment.self_seconds(spans, "programs.layout") == \
        pytest.approx(20e-9)
    assert segment.self_seconds(spans, "programs.upload") == \
        pytest.approx(40e-9)
    assert segment.self_seconds(spans, "factor") == 0


def made_up() -> segment.Segment:
    setup = [("programs.schedule", 0, 4_000_000_000, None, None),
             ("programs.upload", 0, 1_000_000_000, 0, None),
             ("programs.layout", 5_000_000_000, 7_000_000_000, None, None),
             ("programs.upload", 6_000_000_000, 6_500_000_000, 2, None)]
    spans = [("factor", 0, 3_000_000, None, 1),
             ("factor.input", 100, 200, 0, 1),
             ("solve", 4_000_000, 5_000_000, None, 2),
             ("solve.input", 4_000_100, 4_000_200, 2, 2)]
    return segment.Segment(
        setup_spans=setup, programs_s=7.0,
        counted=segment.Counted(steps=2, wall_s=0.02, host_ns=1_500_000,
                                spans=spans + [
                                    (n, a, b, None if p is None else p + 4,
                                     c) for n, a, b, p, c in spans]),
        trace=segment.read(port_events(), CUDA, steps=1))


def test_new_readers(monkeypatch):
    run = harness.Run(stages={}, steps=4, wall_s=0.04)
    seg = made_up()
    monkeypatch.setattr(segment, "of", lambda r: seg if r is run else None)
    got = {name: harness.reader(name)(run) for name in NEW}
    assert got == pytest.approx({
        "schedule_s": 3.0, "layout_s": 1.5, "upload_s": 1.5,
        "program_host_ms": 4.0, "bindings_ms": 0.75,
        # the copies 14..18, the fill 18..20, the solve's copy 50..52
        "input_copy_ms": 8e-3, "program_idle_pct": 21.0})
    out = io.StringIO()
    segment.report(seg, run, out)
    said = out.getvalue()
    assert "on-cost x 1.000000" in said
    assert "programs.schedule 3.000" in said
    assert "idle inside the port 0.000021 s" in said
    assert '"baspacho.factor.input": 6e-06' in said


def test_new_readers_silent_without_a_segment(monkeypatch):
    """No card, a process run.py did not start with a cell, or a port
    without its own tracing: every new reader gives None, raises nothing
    and measures nothing."""
    def measure(*a, **k):
        raise AssertionError("measured")

    monkeypatch.setattr(segment, "measure", measure)
    cell = ["--workload", "grid-200-b8.refactor", "--seed", "7"]
    for argv, card, port in [([], True, True), (cell, False, True),
                             (cell, True, False)]:
        run = harness.Run(stages={"programs": 1.0}, steps=10, wall_s=1.0)
        monkeypatch.setattr(segment.sys, "argv", ["run.py"] + argv)
        monkeypatch.setattr(segment.torch.cuda, "is_available",
                            lambda card=card: card)
        if not port:
            monkeypatch.setattr(segment, "port_trace", None)
        for name in NEW:
            assert harness.reader(name)(run) is None, name


def test_one_segment_a_run(monkeypatch):
    """The seven readers of one run share one segment of the cell and
    seed run.py's command line names; another run measures anew."""
    calls = []

    def measure(cfg, traffic, seed, device, steps):
        calls.append((cfg["generator"], traffic["step"], seed, str(device),
                      steps))
        return made_up()

    monkeypatch.setattr(segment, "measure", measure)
    monkeypatch.setattr(segment.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(segment.sys, "argv", [
        "perfbench/run.py", "--workload", "grid-200-b8.refactor", "--seed",
        "2147483701", "--seconds", "10", "--trace", "1"])
    run = harness.Run(stages={}, steps=40, wall_s=0.5)
    for name in NEW:
        assert harness.reader(name)(run) is not None
    assert calls == [("grid", "refactor", 2147483701, "cuda:0", 20)]
    harness.reader("schedule_s")(harness.Run(stages={}, steps=4, wall_s=4))
    assert calls[-1][-1] == 3
    assert segment.trace_steps(1e-6) == 20


def test_command_cell():
    assert segment.command_cell(["--workload", "w", "--seed", "5"]) == \
        ("w", 5)
    assert segment.command_cell(["--workload", "w"]) is None
    assert segment.command_cell(["-q", "--se", "5", "--workload", "w"]) \
        is None


@pytest.mark.parametrize("workload", sorted(small.CELLS))
def test_measure_on_the_cpu(workload):
    """A segment at a CPU size: the set-up's programs.* spans within the
    host clock around the programs, the counted steps' spans and wrapper
    ns, no profiled steps, and the port's tracing off and its log empty
    afterwards."""
    from baspacho_tpu_torch import trace as port_trace
    bench = harness.benchmark()
    _, _, traffic = harness.cell_spec(bench, workload)
    cfg = small.config(small.CELLS[workload])
    t0 = time.perf_counter()
    seg = segment.measure(cfg, traffic, 2147483701, "cpu", steps=2)
    wall = time.perf_counter() - t0
    assert not port_trace.ON and port_trace.take() == []
    names = {x[0] for x in seg.setup_spans}
    assert {"programs.schedule", "programs.upload"} <= names
    assert all(x[4] is None for x in seg.setup_spans)
    phases = sum(segment.self_seconds(seg.setup_spans, k) for k in names)
    assert 0 < phases <= seg.programs_s < wall
    c = seg.counted
    assert c.steps == 2 and c.host_ns > 0
    calls = [x for x in c.spans if x[3] is None]
    assert [x[0] for x in calls] == ["factor", "solve"] * 2
    assert {x[0] for x in c.spans} == {"factor", "factor.input", "solve",
                                      "solve.input"}
    assert 0 < c.host_ns / c.steps * 1e-6 <= segment.program_host_ms(seg)
    assert seg.trace is None


def test_cpu_trace_run_gives_no_new_metric():
    """A --trace 1 run at a CPU size, started by no command line: the
    result line holds none of the new metrics, and no error."""
    r = harness.run_cell("grid-200-b8.refactor", 2147483701, 0.2, True,
                         time.perf_counter(), device="cpu",
                         cfg=small.config("grid-200-b8"), out=io.StringIO())
    assert r["correct"]
    assert not set(NEW) & set(r["metrics"])


@pytest.mark.cuda
def test_measure_on_the_card(card):
    """At the CPU size on the card: the profiled steps give the port's
    input copies and its calls device work, and name gaps."""
    _, _, traffic = harness.cell_spec(harness.benchmark(),
                                      "grid-200-b8.refactor")
    seg = segment.measure(small.config("grid-200-b8"), traffic, 2147483701,
                          card, steps=3)
    t = seg.trace
    assert t is not None and t.steps == 3
    assert {"baspacho.factor.input", "baspacho.solve.input"} <= set(t.port_iv)
    assert 0 <= t.port_idle_s <= t.window_s
    assert t.gaps
