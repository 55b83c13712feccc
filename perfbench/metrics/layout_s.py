"""layout_s: host seconds of K2's grid layouts (ops/kernels.py SegLayout
with seg_plan): the self time of the port's programs.layout spans
(baspacho_tpu_torch/trace.py) in the program segment's set-up
(perfbench/segment.py). Nothing where the port has no spans."""

from perfbench import segment


def read(run):
    s = segment.of(run)
    return None if s is None else \
        segment.self_seconds(s.setup_spans, "programs.layout")
