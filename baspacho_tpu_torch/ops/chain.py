"""Chained executions of a factor or solve program: k steps back to back,
each on the previous one's output (Solver.factor_chained /
solve_chained, the JAX package's `fori_loop` programs).

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

Capture. The step runs once eagerly on the capture stream first: that
builds the kernels, creates the libraries' handles and sizes the
kernels' work buffers (kernels._scratch, kept per stream), so that the
capture allocates none of them. The launches the capture records are not
made, so the kernels' counters are put back as they were: a chain's
first call counts one eager step, and a replay counts nothing. The
graph then takes the work buffers it baked in (kernels.take_scratch):
no later call on the stream can grow or free them. Buffers the step
allocates during the capture (a level's products) come from the graph's
private pool and live as long as the graph. A capture that fails raises
with the CUDA error; nothing runs eagerly instead.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Dict, Sequence

import torch

from . import kernels


class GraphChain:
    """One step captured as a CUDA graph over static copies of its
    buffers (the first call's `inputs`); `capture_s` and `pool_bytes`
    are the capture's seconds and the memory it reserved (the graph's
    private pool)."""

    def __init__(self, step: Callable, inputs: Sequence[torch.Tensor]):
        dev = inputs[0].device
        self.buffers = [x.clone(memory_format=torch.contiguous_format)
                        for x in inputs]
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            step(*self.buffers)
        saved = copy.deepcopy(kernels.COUNTS)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                step(*self.buffers)
        finally:
            for name, c in kernels.COUNTS.items():
                vars(c).update(vars(saved[name]))
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.scratch = kernels.take_scratch(stream)

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
