"""graph_replay_pct: the share of the port's factor and solve calls, over
the program segment's counted steps (perfbench/segment.py: tracing on,
no profiler), that replayed a CUDA graph: the calls whose `factor` or
`solve` span (baspacho_tpu_torch/trace.py; a solve inside `refine` is a
call of its own) holds a `factor.graph` or `solve.graph` span of the
same call id, in %. Nothing where the port has no graph replays (no
`graph_replay` counter) or the segment has no such calls."""

from perfbench import program, segment

CALLS = ("factor", "solve")
REPLAYS = ("factor.graph", "solve.graph")


def read(run):
    if "graph_replay" not in program.kernels.COUNTS:
        return None
    s = segment.of(run)
    if s is None:
        return None
    spans = s.counted.spans
    calls = {cid for name, _, _, _, cid in spans if name in CALLS}
    if not calls:
        return None
    replayed = {cid for name, _, _, _, cid in spans if name in REPLAYS}
    return 100.0 * len(calls & replayed) / len(calls)
