"""schedule_s: host seconds of the full-range factor's and solve's level
schedules, pair and solve CSRs, dense levels' records and the factor's
padding index (ops/schedule.py, PlannedBackend._pad_idx): the self time
of the port's programs.schedule spans (baspacho_tpu_torch/trace.py) in
the program segment's set-up (perfbench/segment.py). Nothing where the
port has no spans."""

from perfbench import segment


def read(run):
    s = segment.of(run)
    return None if s is None else \
        segment.self_seconds(s.setup_spans, "programs.schedule")
