"""The port's own spans: where the host spends a PLANNED factor or solve
call and the set-up of their programs, beside the kernel wrappers' host
time (`ops.kernels.COUNTS[name].host_ns`).

Off by default; `enable(True)` turns it on for the whole process and
`take()` returns the spans recorded since the last take and clears them.
Each span is kept in memory (a `Span`: name, start and end from
`time.perf_counter_ns`, the index in the log of the span it lies in, and
the id of the facade call it belongs to) and opens
`torch.profiler.record_function("baspacho." + name)`, so that under a
profiler the spans sit on the device records' clock and hold the runtime
calls that launch the kernels. Nothing is written to a file.

The spans:

  factor               Solver.factor / factor_up_to / factor_from on the
                       PLANNED backend, the whole call (checks, program
                       lookup, the program), opened in
                       Solver._run_factor_like
  factor.input         inside it: the program's copy of its input and the
                       padding's index_fill_, opened in the program
                       (PlannedBackend.make_factor)
  solve                Solver.solve on the PLANNED backend, the whole
                       call, opened in Solver._run_solve_like
  solve.input          inside it: the program's copy of its right-hand
                       side, opened in the program
                       (PlannedBackend.make_solve)
  factor.graph         inside `factor` or `solve`: a replay of the call's
  solve.graph          CUDA graph (ops/chain.py GraphSlot.run), in place
                       of the eager levels
  refine               Solver.solve_refined on the PLANNED backend, the
                       whole call; its solves keep their own `solve`
                       spans inside it
  refine.residual      inside it: each round's add_mv_from(mat, 0, ...)
                       and the subtraction from the right-hand side
  refine.cast          inside it: each conversion between the factor's
                       precision and the matrix's
  programs.schedule    building a program: level schedules, the pair and
                       solve CSRs, the dense levels' records
                       (ops/schedule.py) and the factor's padding index
  programs.layout      K2's grid layouts (ops/kernels.py SegLayout, with
                       seg_plan)
  programs.upload      host-to-device copies of the programs' index arrays
                       (planned_backend._i64, DevDense, SegLayout.arrays)
                       and the buckets' host tuples (off_h, cols_h)

The three call spans (factor, solve, refine) and the spans inside one of
them share a call id, but a solve inside `refine` opens a call of its
own; a set-up span has none. A set-up phase is read by self time (its
span less the spans inside it), so an upload inside a layout counts
once.

One test in the facade (Solver._tracing: tracing is on and the backend
is PLANNED) decides whether a call is traced. A traced call opens the
facade's spans (factor, solve, refine and refine's own), and the facade
hands the PLANNED factor and solve programs a timing shim over the
kernel wrappers (`kernels.timed`), which adds each wrapper call's host
ns (on the card: checks, pointers, the stream, the ctypes call; on the
CPU the plain twin) to its counter's `host_ns`, a graph's replay to
`COUNTS["graph_replay"]`; Solver.add_mv_from hands its PLANNED program
the same shim, so K5's host ns land in `COUNTS["add_mv"]` /
`COUNTS["wide_add_mv"]`. Off, a facade call costs
that test and an empty context, the programs get the plain `kernels`
module, and an input span or a set-up span costs one test of `ON`. The
chained and sharded programs have no spans; a factor or solve program
called outside the facade while tracing is on records its input span
alone, with no call id.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import List, Optional

import torch

PREFIX = "baspacho."
ON = False


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int             # 0 while the span is open
    parent: Optional[int]   # index in the log of the span it lies in
    call: Optional[int]     # id of the facade call (None in set-up)


_log: List[Span] = []
_open: List[int] = []       # indices of the open spans, innermost last
_calls = 0
_OFF = nullcontext()


def enable(on: bool = True) -> None:
    global ON
    ON = bool(on)


def take() -> List[Span]:
    """The spans recorded since the last take, in the order they opened;
    the log starts empty again. Take between calls, not inside a span."""
    global _log
    if _open:
        raise RuntimeError(f"take() inside the open span "
                           f"{_log[_open[-1]].name!r}")
    out, _log = _log, []
    return out


def span(name: str, call: bool = False):
    """A context that records the span `name` while tracing is on, and
    does nothing while it is off. `call` starts a new facade call id;
    otherwise the span takes the id of the span it lies in."""
    if not ON:
        return _OFF
    return _record(name, call)


@contextmanager
def _record(name: str, call: bool):
    global _calls
    parent = _open[-1] if _open else None
    if call:
        _calls += 1
        cid = _calls
    else:
        cid = None if parent is None else _log[parent].call
    rec = Span(name, 0, 0, parent, cid)
    _open.append(len(_log))
    _log.append(rec)
    try:
        with torch.profiler.record_function(PREFIX + name):
            rec.start_ns = time.perf_counter_ns()
            try:
                yield rec
            finally:
                rec.end_ns = time.perf_counter_ns()
    finally:
        _open.pop()
