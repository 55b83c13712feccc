"""program_host_ms: host ms per step inside the port's factor and solve
calls, by the port's own `factor` and `solve` spans (the facade's whole
call: checks, program lookup, the input copy, the runners' levels and
the kernel wrappers; baspacho_tpu_torch/trace.py), over the program
segment's counted steps (perfbench/segment.py: tracing on, no
profiler). Nothing where the port has no spans."""

from perfbench import segment


def read(run):
    s = segment.of(run)
    return None if s is None else segment.program_host_ms(s)
