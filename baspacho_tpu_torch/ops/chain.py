"""CUDA graphs of the PLANNED programs: chained executions (k steps back
to back, each on the previous one's output: Solver.factor_chained /
solve_chained, the JAX package's `fori_loop` programs), and the replays
of the facade's own factor and solve calls (Graphs, GraphSlot).

A step is an in-place program (PlannedBackend.make_factor_body /
make_solve_body, UnrolledBackend.make_factor_body / make_solve_l_body)
over a tuple of buffers, the last of which it updates: (data,) for a
factor, (factor data, rhs) for a solve. On a CUDA device one step is
captured once as a CUDA graph over static copies of the buffers and
replayed k times: k is a count at run time, so one capture serves every
k, as one compile does in the JAX package. A call copies its inputs into
the static buffers, replays the graph k times on the caller's stream and
returns a copy of the last buffer; the copies are a fixed cost per call,
which the difference of two chain lengths cancels. On the CPU the chain
is a Python loop of the same step.

Capture (Captured). The step runs once eagerly on the capture stream
first: that builds the kernels, creates the libraries' handles and sizes
the kernels' work buffers (kernels._scratch, kept per stream), so that
the capture allocates none of them. The launches the capture records are
not made, so the kernels' counters are put back as they were, and what
the capture counted is kept (`deltas`): a chain's first call counts one
eager step, and a replay counts nothing. The graph then takes the work
buffers it baked in (kernels.take_scratch): no later call on the stream
can grow or free them. Buffers the step allocates during the capture (a
level's products) come from the graph's private pool and live as long
as the graph. A capture that fails raises with the CUDA error; nothing
runs eagerly instead.

Replays of the facade's calls. A PLANNED factor or solve call on a CUDA
tensor runs its walk (the levels, after the eager input copy) through
the GraphSlot of its (op, lump range, batch, data size, nrhs, dtype).
A slot holds at most one graph, over the buffer addresses it was
captured on, and the addresses of its previous call. A call replays the
graph when its buffers are the graph's, captures a new one (replacing
the old) when they are the previous call's, and runs the walk eagerly
otherwise. A slot whose buffers move MOVES times (a caller that keeps
its factors, or switches between held ones) drops its graph and stays
eager: its calls take the plain path, as off the card. A replay writes
only the call's own buffers, its graph's pool and its work buffers: the
factor's buffer is the call's fresh copy of its input, taken from the
solver's memory pool (Graphs.allocating: one for all its slots, so that
a caller who drops each factor gets the same buffer back, whatever the
process allocates between calls), and the solve works on the slot's own
right-hand side, copied in and out. A factor the caller still holds is
never a later call's buffer. A replay adds to the kernels' counters what
its capture counted (kernels.graph_replay): the counters read as they
would after the eager call. A slot's capture runs in the thread_local
mode and neither synchronises the card nor empties the allocator's
cache. A call made inside the caller's own capture runs eagerly into the
caller's graph, as before. A solver keeps at most SLOTS slots (the least
recently called goes first, with its graph); Graphs.clear() drops them
all with the pool.
"""

from __future__ import annotations

import copy
import time
from contextlib import nullcontext
from typing import Callable, Dict, Optional, Sequence

import torch

from .. import trace
from . import kernels


class Captured:
    """`step()` run once eagerly (as `eager()` where given: the caller's
    own wrappers) on a new stream of `device`, then captured there as a
    CUDA graph: `graph`, `deltas` (kernels.graph_replay's triples of what
    the capture counted), `scratch` (the work buffers it baked in),
    `capture_s` and `pool_bytes` (the memory its private pool reserved).
    With `flush` (the chains) the card is synchronised and the
    allocator's cache emptied first, and the capture is in the global
    mode; without (the facade's slots) neither, in the thread_local
    mode, so that the process's other threads may go on using the card.
    The current stream then waits for the capture stream."""

    def __init__(self, step: Callable, device, eager: Callable = None,
                 flush: bool = True):
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            (eager or step)()
        saved = copy.deepcopy(kernels.COUNTS)
        if flush:
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(stream):
                self.graph.capture_begin(capture_error_mode="global" if flush
                                         else "thread_local")
                try:
                    step()
                finally:
                    self.graph.capture_end()
            self.deltas = [(c, f, getattr(c, f) - getattr(saved[name], f))
                           for name, c in kernels.COUNTS.items()
                           for f in kernels.CAPTURED
                           if getattr(c, f) != getattr(saved[name], f)]
        finally:
            for name, c in kernels.COUNTS.items():
                vars(c).update(vars(saved[name]))
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.scratch = kernels.take_scratch(stream)
        torch.cuda.current_stream(device).wait_stream(stream)

    def replay(self) -> None:
        self.graph.replay()


class GraphChain:
    """One step captured as a CUDA graph over static copies of its
    buffers (the first call's `inputs`); `capture_s` and `pool_bytes`
    are the capture's seconds and the memory it reserved (the graph's
    private pool)."""

    def __init__(self, step: Callable, inputs: Sequence[torch.Tensor]):
        self.buffers = [x.clone(memory_format=torch.contiguous_format)
                        for x in inputs]
        c = Captured(lambda: step(*self.buffers), inputs[0].device)
        self.graph, self.scratch = c.graph, c.scratch
        self.capture_s, self.pool_bytes = c.capture_s, c.pool_bytes

    def run(self, inputs: Sequence[torch.Tensor], k: int) -> torch.Tensor:
        for buf, x in zip(self.buffers, inputs):
            buf.copy_(x)
        for _ in range(k):
            self.graph.replay()
        return self.buffers[-1].clone()


def chained(graphs: Dict[tuple, GraphChain], key: tuple, step: Callable,
            inputs: Sequence[torch.Tensor], k: int) -> torch.Tensor:
    """k steps of `step` on copies of `inputs`; returns the last buffer
    (k = 0: a copy of the last input). On a CUDA device through the graph
    cached in `graphs` under `key` (captured at its first call), on the
    CPU by a loop."""
    if k == 0:
        return inputs[-1].clone(memory_format=torch.contiguous_format)
    if inputs[0].device.type != "cuda":
        bufs = [x.clone(memory_format=torch.contiguous_format)
                for x in inputs]
        for _ in range(k):
            step(*bufs)
        return bufs[-1]
    g = graphs.get(key)
    if g is None:
        g = graphs[key] = GraphChain(step, inputs)
    return g.run(inputs, k)


# calls on moved buffers after which a slot drops its graph and stays
# eager; slots a solver keeps
MOVES = 4
SLOTS = 8


def capture(walk: Callable, bufs: Sequence[torch.Tensor], ops) -> Captured:
    """A GraphSlot's capture on the card: walk(*bufs, ops) computes the
    call's result eagerly on the capture stream, then walk(*bufs,
    kernels) is captured over the same buffers (thread_local, no flush)."""
    return Captured(lambda: walk(*bufs, kernels), bufs[0].device,
                    lambda: walk(*bufs, ops), flush=False)


class GraphSlot:
    """The replays of one (op, lump range, batch, data size, nrhs, dtype):
    `graph` (None, or what `capture` returned: an object with replay()
    and deltas) over the buffer addresses `addrs`, the previous call's
    addresses `last`, the right-hand side `rhs` for the solve, its calls
    by kind (`captures`, `replays`, `eager`) and on moved buffers
    (`moves`); `retired` once `moves` reaches MOVES. `owner` is the
    Graphs whose pool the factor's buffer comes from (None: the
    allocator's own)."""

    def __init__(self, capture: Callable, owner: "Graphs" = None):
        self.capture, self.owner = capture, owner
        self.graph = None
        self.addrs = self.last = self.rhs = None
        self.captures = self.replays = self.eager = self.moves = 0
        self.retired = False

    def allocating(self, device):
        """A context in which the factor's copy of its input is allocated
        (from the owner's pool on a CUDA device)."""
        return nullcontext() if self.owner is None else \
            self.owner.allocating(device)

    def static_rhs(self, v: torch.Tensor) -> torch.Tensor:
        """The slot's own right-hand side buffer, shaped as `v` (made at
        the first call)."""
        if self.rhs is None:
            self.rhs = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        return self.rhs

    def run(self, span: str, walk: Callable, bufs: Sequence[torch.Tensor],
            ops) -> None:
        """walk(*bufs, ops), in place on `bufs`: replayed inside the span
        `span` (trace.py) when they are the graph's buffers, captured when
        they are the previous call's, else run eagerly (a move, unless it
        is the first call)."""
        addrs = tuple(b.data_ptr() for b in bufs)
        if self.graph is not None and addrs == self.addrs:
            with trace.span(span):
                ops.graph_replay(self.graph)
            self.replays += 1
        elif addrs == self.last:
            self.graph = None   # the old graph and its pool go first
            self.graph = self.capture(walk, bufs, ops)
            self.addrs = addrs
            self.captures += 1
        else:
            walk(*bufs, ops)
            self.eager += 1
            if self.last is not None:
                self.moves += 1
                if self.moves >= MOVES:
                    self.retired = True
                    self.graph = self.rhs = None
        self.last = addrs


class Graphs:
    """A solver's replayed calls: a GraphSlot per key (at most SLOTS, the
    least recently called dropped first), for calls on a `device_type`
    device, each capturing through `capture` (the card's by default;
    tests hand a stand-in), and the memory pool of their factors'
    buffers."""

    def __init__(self, capture: Callable = capture,
                 device_type: str = "cuda"):
        self.capture, self.device_type = capture, device_type
        self.slots: Dict[tuple, GraphSlot] = {}
        self.pool = None

    def slot(self, device, *key) -> Optional[GraphSlot]:
        """The slot of `key` for a call on `device`; None where calls on
        it are not graphed, inside the caller's own capture (the call then
        runs eagerly into the caller's graph), or where the slot is
        retired (the call is counted eager and takes the plain path)."""
        if device.type != self.device_type or (
                device.type == "cuda" and
                torch.cuda.is_current_stream_capturing()):
            return None
        s = self.slots.pop(key, None)
        if s is None:
            s = GraphSlot(self.capture, self)
            if len(self.slots) >= SLOTS:
                del self.slots[next(iter(self.slots))]
        self.slots[key] = s
        if s.retired:
            s.eager += 1
            return None
        return s

    def allocating(self, device):
        """A context in which allocations on a CUDA `device` come from
        the pool of the solver's factors (made at the first)."""
        if torch.device(device).type != "cuda":
            return nullcontext()
        if self.pool is None:
            self.pool = torch.cuda.MemPool()
        return torch.cuda.use_mem_pool(self.pool, device)

    def clear(self) -> None:
        """Drops every slot with its graph and right-hand side, and the
        pool: its memory goes back to the allocator once no factor taken
        from it is held."""
        self.slots.clear()
        self.pool = None
