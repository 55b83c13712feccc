"""Reading a profiler trace of a few steps: device busy time and idle
share, device seconds by kernel name, the device work that each of the
benchmark's spans launched, and the idle gaps named by the span the host
was in.

The arithmetic of the busy time (the union of device intervals) and the
short kernel names follow chip_smoke.py's `trace`. A device record is
given to the span that launched it through the profiler's launch
correlation (a device record and the host's runtime call that launched
it share a correlation id), never by overlap in time: the host runs ahead of the device, so the
kernels of a factor mostly run while the host is already in the solve.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Collection, Dict, List, Optional, Tuple

SPAN_PREFIX = "bench."
STEPS_RANGE = "bench.steps"
STEP_SPAN = "bench.step"


def short_name(name: str) -> str:
    """A CUDA kernel's function name without namespace and arguments."""
    m = re.search(r"(\w+)(?:<[^()]*>)?\(", name)
    return m.group(1) if m else name[:60]


@dataclass
class Trace:
    steps: int
    window_s: float                      # first step start -> last end
    busy_s: float                        # union of device intervals
    device_s_by_span: Dict[str, float]   # union of the device records
    #                                      launched inside each span
    kernels_by_span: Dict[str, int]      # device records per span
    port_by_span: Dict[str, int]         # of them, the port's kernels
    device_s_by_name: Dict[str, float]
    gaps: List[Tuple[str, float]] = field(default_factory=list)
    unattributed: int = 0                # device records with no launch

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(self.device_s_by_name.items(), key=lambda kv: -kv[1])
        gaps = sorted(self.gaps, key=lambda g: -g[1])
        return {"device_ops": [[k, v] for k, v in ops[:n]],
                "idle_gaps": [[k, v] for k, v in gaps[:n]]}


def union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    iv = sorted(intervals)
    if not iv:
        return 0.0
    busy, (a, b) = 0.0, iv[0]
    for s, e in iv[1:]:
        if s > b:
            busy, a, b = busy + (b - a), s, e
        else:
            b = max(b, e)
    return busy + (b - a)


def _span_at(spans, t: float) -> Optional[str]:
    for name, a, b in spans:
        if a <= t < b:
            return name
    return None


def read(events, device_type, steps: int,
         port_kernels: Collection[str]) -> Trace:
    """The Trace of the profiler's FunctionEvents `events`: the records
    inside the range STEPS_RANGE, steps spans STEP_SPAN, the inner spans
    bench.<name>; `port_kernels` the short names of the program's own
    kernels. Times in the profiler's microseconds."""
    ranges = [e for e in events if e.name == STEPS_RANGE]
    if not ranges:
        raise ValueError(f"no {STEPS_RANGE} range in the trace")
    t0 = ranges[0].time_range.start
    host = [e for e in events if e.device_type != device_type]
    step_iv = [(e.time_range.start, e.time_range.end) for e in host
               if e.name == STEP_SPAN and e.time_range.start >= t0]
    if not step_iv:
        raise ValueError("no step spans in the trace")
    w0, w1 = min(a for a, _ in step_iv), max(b for _, b in step_iv)
    spans = sorted(((e.name[len(SPAN_PREFIX):], e.time_range.start,
                     e.time_range.end) for e in host
                   if e.name.startswith(SPAN_PREFIX)
                   and e.name not in (STEPS_RANGE, STEP_SPAN)
                   and e.time_range.start >= t0), key=lambda s: s[1])
    dev = [e for e in events if e.device_type == device_type
           and not e.name.startswith(SPAN_PREFIX)
           and w0 <= e.time_range.start <= w1]
    by_name: Dict[str, float] = {}
    for e in dev:
        k = short_name(e.name)
        by_name[k] = by_name.get(k, 0.0) + e.time_range.elapsed_us() * 1e-6
    # a device record's id is its launch's correlation id, which the
    # host's runtime call (cudaLaunchKernel, cudaMemcpyAsync, ...) shares;
    # the call lies inside the span that launched it
    launch = {e.id: e for e in host if e.name.startswith("cu")}
    iv_span: Dict[str, list] = {}
    port_span: Dict[str, int] = {}
    for e in dev:
        call = launch.get(e.id)
        where = None if call is None else \
            _span_at(spans, call.time_range.start)
        if where is not None:
            iv_span.setdefault(where, []).append(
                (e.time_range.start, e.time_range.end))
            if short_name(e.name) in port_kernels:
                port_span[where] = port_span.get(where, 0) + 1
    # kernels of one call can run side by side on several streams: a
    # span's device time is the union of its records' intervals
    by_span = {k: union(v) * 1e-6 for k, v in iv_span.items()}
    n_span = {k: len(v) for k, v in iv_span.items()}
    attributed = sum(n_span.values())
    unattributed = len(dev) - attributed
    iv = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1))
                for e in dev)
    gaps, edge = [], w0
    for a, b in iv:
        if a > edge:
            gaps.append((_span_at(spans, (edge + a) / 2) or "loop",
                         (a - edge) * 1e-6))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((_span_at(spans, (edge + w1) / 2) or "loop",
                     (w1 - edge) * 1e-6))
    return Trace(steps=steps, window_s=(w1 - w0) * 1e-6,
                 busy_s=union(iv) * 1e-6, device_s_by_span=by_span,
                 kernels_by_span=n_span, port_by_span=port_span,
                 device_s_by_name=by_name,
                 gaps=gaps, unattributed=unattributed)
