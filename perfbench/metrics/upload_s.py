"""upload_s: host seconds of the host-to-device copies of the programs'
index arrays (planned_backend._i64, DevDense, SegLayout.arrays) and the
buckets' host tuples: the self time of the port's programs.upload spans
(baspacho_tpu_torch/trace.py) in the program segment's set-up
(perfbench/segment.py). Nothing where the port has no spans."""

from perfbench import segment


def read(run):
    s = segment.of(run)
    return None if s is None else \
        segment.self_seconds(s.setup_spans, "programs.upload")
