"""The program segment of a --trace 1 run: the port's own spans and
counters (baspacho_tpu_torch/trace.py), which the readers schedule_s,
layout_s, upload_s, program_host_ms, bindings_ms, input_copy_ms and
program_idle_pct read.

The harness takes its set-up, window and profiled steps with the port's
tracing off, so the metrics read from them see the port as it runs
untraced. Once the check is done it calls the readers; the first of
these to ask measures the segment, once a run, on a second copy of the
cell and seed that run.py's command line names (--workload, --seed), on
the card:

  set-up    structure, analysis and programs built again with the port's
            tracing on: the programs.* spans, beside the host clock
            around the programs;
  counted   as many steps as the harness's trace takes, tracing on, no
            profiler: the port's factor and solve spans, the kernel
            wrappers' host ns, and the step time (the tracing's on-cost,
            beside the window's step time);
  profiled  as many steps again under torch.profiler, tracing on, taken
            again (up to harness.TRACE_TRIES) while the port's kernels in
            the benchmark's factor and solve spans differ in number from
            the launches the counters saw: the device work each of the
            port's spans launched (the innermost one whose runtime call
            launched it, by launch correlation), the device's idle time
            while the host was inside the port's factor or solve, and the
            idle gaps named by the innermost span of either kind.

It prints what it read before the result line. A port without its own
tracing, a process without a card, or one that run.py did not start
with a cell has no segment: the readers then give None.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from . import harness, program
from . import trace as tr

try:
    from baspacho_tpu_torch import trace as port_trace
except ImportError:  # a port from before its own tracing
    port_trace = None

PORT_PREFIX = "baspacho."
PORT_CALLS = ("baspacho.factor", "baspacho.solve")


@dataclass
class Counted:
    """Steps with the port's tracing on and no profiler."""
    steps: int
    wall_s: float
    host_ns: int        # inside the port's kernel wrappers
    spans: list         # the port's (name, start_ns, end_ns, parent, call)


@dataclass
class PortTrace:
    """What the profiled steps show of the port's spans (profiler us in,
    seconds out)."""
    steps: int
    window_s: float                      # first step start -> last end
    port_iv: Dict[str, list]             # device (start, end) of the
    #                                      records each of the port's
    #                                      spans launched (innermost)
    port_idle_s: float                   # device idle while the host was
    #                                      in the port's factor or solve
    gaps: List[Tuple[str, float]]        # idle gaps by the innermost span


@dataclass
class Segment:
    setup_spans: list                    # the port's spans of the set-up
    programs_s: float                    # host clock around the programs
    counted: Counted
    trace: Optional[PortTrace]           # None off the card or incomplete


def overlap(xs, ys) -> float:
    """Length of the intersection of two unions of (start, end)
    intervals."""
    def merged(iv):
        out = []
        for a, b in sorted(iv):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out
    xs, ys = merged(xs), merged(ys)
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        total += max(0.0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


class Innermost:
    """Host spans (name, start, end) that nest."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: s[1])
        self.starts = [a for _, a, _ in self.spans]

    def at(self, t: float) -> Optional[str]:
        """The innermost span that holds t: of the spans that started by
        t, the latest one not yet ended."""
        i = bisect.bisect_right(self.starts, t)
        while i:
            i -= 1
            name, _, b = self.spans[i]
            if t < b:
                return name
        return None


def self_seconds(spans, name: str) -> float:
    """Self time in s of the spans called `name` among the port's
    (name, start_ns, end_ns, parent index, call id) tuples: each one's
    duration less that of the spans directly inside it."""
    ns = 0
    for n, a, b, parent, _ in spans:
        if n == name:
            ns += b - a
        if parent is not None and spans[parent][0] == name:
            ns -= b - a
    return ns * 1e-9


def read(events, device_type, steps: int) -> PortTrace:
    """The port's part of a profiler trace of `steps` steps taken with its
    tracing on: the records inside tr.STEPS_RANGE, steps spans
    tr.STEP_SPAN, the benchmark's spans bench.<name> and the port's
    baspacho.<name>. Times in the profiler's microseconds."""
    ranges = [e for e in events if e.name == tr.STEPS_RANGE]
    if not ranges:
        raise ValueError(f"no {tr.STEPS_RANGE} range in the trace")
    t0 = ranges[0].time_range.start
    host = [e for e in events if e.device_type != device_type
            and e.time_range.start >= t0]
    step_iv = [(e.time_range.start, e.time_range.end) for e in host
               if e.name == tr.STEP_SPAN]
    if not step_iv:
        raise ValueError("no step spans in the trace")
    w0, w1 = min(a for a, _ in step_iv), max(b for _, b in step_iv)
    bench = [(e.name[len(tr.SPAN_PREFIX):], e.time_range.start,
              e.time_range.end) for e in host
             if e.name.startswith(tr.SPAN_PREFIX)
             and e.name not in (tr.STEPS_RANGE, tr.STEP_SPAN)]
    port = [(e.name, e.time_range.start, e.time_range.end) for e in host
            if e.name.startswith(PORT_PREFIX)]
    inner = Innermost(bench + port)
    # the spans' own annotation records on the device are left out
    dev = [e for e in events if e.device_type == device_type
           and not e.name.startswith((tr.SPAN_PREFIX, PORT_PREFIX))
           and w0 <= e.time_range.start <= w1]
    # a device record and the runtime call that launched it share an id
    launch = {e.id: e for e in host if e.name.startswith("cu")}
    port_iv: Dict[str, list] = {}
    for e in dev:
        call = launch.get(e.id)
        own = None if call is None else inner.at(call.time_range.start)
        if own is not None and own.startswith(PORT_PREFIX):
            port_iv.setdefault(own, []).append(
                (e.time_range.start, e.time_range.end))
    iv = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1))
                for e in dev)
    idle, edge = [], w0
    for a, b in iv:
        if a > edge:
            idle.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        idle.append((edge, w1))
    # a gap is named by the innermost span the host was in at its middle
    gaps = [(inner.at((a + b) / 2) or "loop", (b - a) * 1e-6)
            for a, b in idle]
    in_port = [(a, b) for name, a, b in port if name in PORT_CALLS]
    return PortTrace(steps=steps, window_s=(w1 - w0) * 1e-6,
                     port_iv=port_iv,
                     port_idle_s=overlap(idle, in_port) * 1e-6, gaps=gaps)


def host_ns() -> int:
    """Host ns inside the port's kernel wrappers so far."""
    return sum(c.host_ns for c in program.kernels.COUNTS.values())


def _taken() -> list:
    return [(x.name, x.start_ns, x.end_ns, x.parent, x.call)
            for x in port_trace.take()]


@contextmanager
def _traced():
    """The port's tracing on inside, off after."""
    port_trace.enable(True)
    try:
        yield
    finally:
        port_trace.enable(False)


def _counted(cell, steps: int) -> Counted:
    port_trace.take()
    h0 = host_ns()
    with _traced():
        t0 = time.perf_counter()
        for i in range(steps):
            cell.mix.step(i, harness.no_span)
        wall = time.perf_counter() - t0
    return Counted(steps, wall, host_ns() - h0, _taken())


def _profiled(cell, steps: int) -> Optional[PortTrace]:
    """harness.Cell.traced with the port's tracing on in the steps
    traced, read by `read`; None if no try is complete."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, \
        record_function
    names = program.kernel_names()

    def span(name):
        return record_function(tr.SPAN_PREFIX + name)

    for tries in range(1, harness.TRACE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05 * 4 ** (tries - 1))
            cell.mix.step(0, harness.no_span)
            before = program.launches()
            with _traced(), record_function(tr.STEPS_RANGE):
                for i in range(steps):
                    with span("step"):
                        cell.mix.step(i, span)
            launched = program.launches() - before
        port_trace.take()   # read from the profiler's ranges, not the log
        events = prof.events()
        bench = tr.read([e for e in events
                         if not e.name.startswith(PORT_PREFIX)],
                        DeviceType.CUDA, steps, names)
        seen = sum(bench.port_by_span.get(k, 0) for k in ("factor", "solve"))
        if seen == launched:
            return read(events, DeviceType.CUDA, steps)
        print(f"program trace {tries}: {seen} records of the port's "
              f"kernels in factor and solve for {launched} launches; taken "
              "again", file=sys.stderr, flush=True)
    return None


def measure(cfg: dict, traffic: dict, seed: int, device,
            steps: int) -> Segment:
    """The segment on a new copy of the cell (`cfg`, `traffic`) with the
    inputs of `seed`, freed before it returns."""
    stages: Dict[str, float] = {}
    port_trace.take()
    with _traced():
        cell = harness.Cell(cfg, traffic, device, stages)
    setup = _taken()
    cell.load(seed)
    counted = _counted(cell, steps)
    trace = _profiled(cell, steps) if cell.device.type == "cuda" else None
    cell.mix.release()
    cell.mix = None
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    return Segment(setup, stages["programs"], counted, trace)


def trace_steps(step_s: float) -> int:
    """The steps of the harness's traced segment for a step of step_s."""
    lo, hi = harness.TRACE_STEPS
    return max(lo, min(hi, round(harness.TRACE_SECONDS / max(step_s, 1e-9))))


def command_cell(argv) -> Optional[Tuple[str, int]]:
    """(workload, seed) from run.py's command line, or None."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    a, _ = ap.parse_known_args(argv)
    if a.workload is None or a.seed is None:
        return None
    return a.workload, a.seed


def report(seg: Segment, run, out=None) -> None:
    """The segment's readings, one line each part."""
    def say(*a):
        print(*a, file=out or sys.stdout, flush=True)

    names = sorted({x[0] for x in seg.setup_spans})
    say(f"program segment set-up: programs {seg.programs_s:.3f} s by the "
        "host clock; the port's spans, self time s: " + ", ".join(
            f"{k} {self_seconds(seg.setup_spans, k):.3f}" for k in names))
    c = seg.counted
    window = run.wall_s / run.steps
    say(f"program segment: {c.steps} counted steps with the port's "
        f"tracing on, step ms {c.wall_s / c.steps * 1e3:.6f} (window "
        f"{window * 1e3:.6f}: on-cost x {c.wall_s / c.steps / window:.6f});"
        f" host ms/step in the port's calls {program_host_ms(seg):.6f}, "
        f"in its kernel wrappers {c.host_ns / c.steps * 1e-6:.6f}")
    t = seg.trace
    if t is None:
        say("program trace: none")
        return
    idle: Dict[str, float] = {}
    for k, v in t.gaps:
        idle[k] = idle.get(k, 0.0) + v
    top = sorted(t.gaps, key=lambda g: -g[1])[:10]
    say(f"program trace: {t.steps} steps in {t.window_s:.6f} s, idle "
        f"inside the port {t.port_idle_s:.6f} s; device s by the port's "
        "span " + json.dumps({k: tr.union(v) * 1e-6
                              for k, v in t.port_iv.items()})
        + "; idle s by span " + json.dumps(idle)
        + "; widest idle gaps " + json.dumps([[k, v] for k, v in top]))


def program_host_ms(seg: Segment) -> float:
    """Host ms per counted step inside the port's factor and solve
    calls (its top-level spans)."""
    c = seg.counted
    ns = sum(b - a for name, a, b, parent, _ in c.spans
             if parent is None and name in ("factor", "solve"))
    return ns / c.steps * 1e-6


def of(run) -> Optional[Segment]:
    """The segment of `run` (a harness.Run), measured on the first call
    for it and kept on it; None where there is none to measure."""
    if not hasattr(run, "program_segment"):
        run.program_segment = _measure(run)
    return run.program_segment


def _measure(run) -> Optional[Segment]:
    cell = command_cell(sys.argv[1:])
    if port_trace is None or cell is None or not run.steps \
            or not torch.cuda.is_available():
        return None
    workload, seed = cell
    _, cfg, traffic = harness.cell_spec(harness.benchmark(), workload)
    seg = measure(cfg, traffic, seed, torch.device("cuda", 0),
                  trace_steps(run.wall_s / run.steps))
    report(seg, run)
    return seg
