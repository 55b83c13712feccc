"""program_idle_pct: device idle time while the host was inside the
port's factor or solve calls (the port's `factor` / `solve` spans,
baspacho_tpu_torch/trace.py), over the program segment's profiled steps'
span (first step's start to last step's end; perfbench/segment.py), in
%. Nothing where the port has no spans."""

from perfbench import segment


def read(run):
    s = segment.of(run)
    t = None if s is None else s.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * t.port_idle_s / t.window_s
