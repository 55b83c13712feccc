"""The port's tracing (baspacho_tpu_torch/trace.py) on the CPU twins:
factor and solve give the same bits with tracing on and off; the spans'
names, parents, call ids and nesting; off, the log stays empty, the
wrappers' host_ns stays 0 and the programs get the plain kernels module;
on, host_ns advances; the set-up spans of a program build and their self
times; and the `baspacho.*` ranges under a CPU torch.profiler nest as
the in-memory log says."""

import time

import pytest
import torch

import baspacho_tpu_torch as T
from baspacho_tpu_torch import trace
from baspacho_tpu_torch.ops import kernels
from baspacho_tpu_torch.testing.problems import SMALL, spd_data

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and an empty log."""
    trace.enable(False)
    trace.take()
    yield
    trace.enable(False)
    trace.take()


def problem(name="elim_range", batch=None):
    """A PLANNED solver (programs built), its data and a right-hand side,
    one system or a batch of `batch`."""
    s = SMALL[name](T)
    s.factor_program()
    s.solve_program()
    d = torch.as_tensor(spd_data(s, 5))
    b = torch.linspace(-1, 1, s.order, dtype=torch.float64)
    if batch:
        d = torch.stack([d * (1 + 0.1 * i) for i in range(batch)])
        b = torch.stack([b + i for i in range(batch)])
    return s, d, b


def step(s, d, b):
    f = s.factor(d)
    return f, s.solve(f, b)


def host_ns():
    return sum(c.host_ns for c in kernels.COUNTS.values())


def self_ns(spans):
    """Self time by span name: each span's duration less its children's."""
    out = {}
    for x in spans:
        dur = x.end_ns - x.start_ns
        out[x.name] = out.get(x.name, 0) + dur
        if x.parent is not None:
            p = spans[x.parent].name
            out[p] = out.get(p, 0) - dur
    return out


@pytest.mark.parametrize("name,batch", [("elim_range", None),
                                        ("meri2", 3), ("grid10", None)])
def test_outputs_bitwise_on_and_off(name, batch):
    s, d, b = problem(name, batch)
    f0, x0 = step(s, d, b)
    trace.enable(True)
    f1, x1 = step(s, d, b)
    trace.enable(False)
    assert torch.equal(f0, f1) and torch.equal(x0, x1)
    assert [x.name for x in trace.take()] == \
        ["factor", "factor.input", "solve", "solve.input"]


def test_spans_names_parents_calls():
    s, d, b = problem()
    trace.enable(True)
    step(s, d, b)
    step(s, d, b)
    spans = trace.take()
    assert [x.name for x in spans] == \
        ["factor", "factor.input", "solve", "solve.input"] * 2
    assert [x.parent for x in spans] == [None, 0, None, 2, None, 4, None, 6]
    # the spans of one facade call share its id; each call has its own
    calls = [x.call for x in spans]
    assert calls[0] == calls[1] and calls[2] == calls[3]
    assert len(set(calls)) == 4 and None not in calls
    for x in spans:
        assert 0 < x.start_ns <= x.end_ns
        if x.parent is not None:
            p = spans[x.parent]
            assert p.start_ns <= x.start_ns and x.end_ns <= p.end_ns
    # the calls follow one another
    assert all(a.end_ns <= c.start_ns for a, c in
               zip(spans[0::2], spans[2::2]))


def test_off_keeps_nothing_and_passes_the_kernels_module():
    s, d, b = problem()
    seen = []
    for op in ("factor", "solve"):
        key = (op, 0, s.skel.num_lumps)
        fn = s._fns[key]

        def spy(*args, ops=kernels, _fn=fn):
            seen.append(ops)
            return _fn(*args, ops=ops)

        s._fns[key] = spy
    kernels.reset_counts()
    step(s, d, b)
    assert seen == [kernels, kernels]
    assert trace.take() == [] and host_ns() == 0
    assert sum(c.twin_calls for c in kernels.COUNTS.values()) > 0
    trace.enable(True)
    step(s, d, b)
    assert len(seen) == 4
    assert all(ops is not kernels for ops in seen[2:])
    assert host_ns() > 0


def test_host_ns_advances_only_on_and_resets():
    s, d, b = problem("meri2")
    kernels.reset_counts()
    step(s, d, b)
    assert host_ns() == 0
    trace.enable(True)
    t0 = time.perf_counter_ns()
    step(s, d, b)
    wall = time.perf_counter_ns() - t0
    h = host_ns()
    spans = trace.take()
    assert 0 < h <= wall
    # the wrappers run inside the calls' spans
    assert h <= sum(x.end_ns - x.start_ns for x in spans
                    if x.parent is None)
    for name, c in kernels.COUNTS.items():
        assert (c.host_ns > 0) == (c.twin_calls > 0), name
    step(s, d, b)
    assert host_ns() > h
    kernels.reset_counts()
    assert host_ns() == 0


def test_timed_shim_keeps_the_wrappers():
    ops = kernels.timed(kernels.TWINS)
    assert set(vars(ops)) == set(kernels.COUNTS)
    s, d, b = problem("meri2")
    f0 = s.factor_program()(d[None])
    kernels.reset_counts()
    f1 = s.factor_program()(d[None], ops=ops)
    assert torch.equal(f0, f1)
    assert kernels.COUNTS["bucket_factor"].host_ns > 0


def test_setup_spans():
    s = SMALL["elim_range"](T)
    trace.enable(True)
    t0 = time.perf_counter_ns()
    s.factor_program()
    s.solve_program()
    wall = time.perf_counter_ns() - t0
    spans = trace.take()
    names = {x.name for x in spans}
    assert names == {"programs.schedule", "programs.upload"}
    assert all(x.call is None for x in spans)
    own = self_ns(spans)
    assert all(v >= 0 for v in own.values())
    assert sum(own.values()) <= wall
    # uploads lie inside the schedule's spans or at the top, never the
    # reverse nesting of a schedule in an upload
    for x in spans:
        if x.parent is not None and x.name == "programs.schedule":
            assert spans[x.parent].name == "programs.schedule"
    # built programs are cached: a second build records nothing
    s.factor_program()
    s.solve_program()
    assert trace.take() == []


def test_layout_spans():
    """K2's layouts (built on the card with the programs) record their
    plan as programs.layout and their arrays as programs.upload."""
    s = SMALL["grid10"](T)
    csr = s.backend._solve_levels(0, s.skel.num_lumps, "cpu")[0].csr
    trace.enable(True)
    kernels.SegLayout(csr.tgt, csr.seg_ptr, csr.src_idx, "cpu")
    spans = trace.take()
    assert [x.name for x in spans] == ["programs.layout", "programs.upload"]
    assert [x.parent for x in spans] == [None, None]


def test_take_inside_a_span_raises():
    trace.enable(True)
    with trace.span("programs.schedule"):
        with pytest.raises(RuntimeError):
            trace.take()
    assert [x.name for x in trace.take()] == ["programs.schedule"]


def test_ref_backend_records_no_span():
    s = SMALL["meri2"](T, backend="REF")
    d = torch.as_tensor(spd_data(s, 5))
    b = torch.ones(s.order, dtype=torch.float64)
    trace.enable(True)
    step(s, d, b)
    assert trace.take() == []


def test_profiler_ranges_nest_as_the_log():
    from torch.profiler import ProfilerActivity, profile
    s, d, b = problem()
    trace.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(s, d, b)
    trace.enable(False)
    spans = trace.take()
    ranges = sorted(((e.name, e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.name.startswith(trace.PREFIX)),
                    key=lambda r: r[1])
    assert [r[0] for r in ranges] == [trace.PREFIX + x.name for x in spans]
    for x, (_, a, e) in zip(spans, ranges):
        if x.parent is not None:
            _, pa, pe = ranges[x.parent]
            assert pa <= a and e <= pe
        else:
            # the roots are disjoint
            assert all(not (r[1] < e and a < r[2]) for r, y in
                       zip(ranges, spans) if y is not x and y.parent is None)
