"""bindings_ms: host ms per step inside the port's kernel wrappers
(ops/kernels.py: checks, pointers, the stream, the ctypes call), the sum
of the counters' host_ns over the program segment's counted steps
(perfbench/segment.py: tracing on, no profiler). Nothing where the port
does not count it."""

from perfbench import segment


def read(run):
    s = segment.of(run)
    if s is None or not s.counted.host_ns:
        return None
    return s.counted.host_ns / s.counted.steps * 1e-6
