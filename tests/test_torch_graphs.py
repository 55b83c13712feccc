"""The replays of the facade's PLANNED factor and solve calls
(ops/chain.py GraphSlot and Graphs) on the CPU, with a stand-in for the
card's capture and replay: a call runs eagerly on buffers it has not
seen, captures on the previous call's buffers and replays on the
graph's; a slot holds one graph, stays eager after MOVES calls on moved
buffers, a solver keeps SLOTS slots, and clear drops them all; calls
are keyed apart by op, lump range, batch, nrhs and dtype; a replay
counts what one eager call counts; the results are bitwise the eager
programs'; traced replays open their `*.graph` spans and time their own
counter; the CPU by default, REF, the sharded, chained and partial
paths are never graphed; and perfbench's graph_replay_pct reads the
spans."""

import gc
import os
import tempfile
import weakref

import pytest
import torch
import torch.distributed as dist

import baspacho_tpu_torch as T
from baspacho_tpu_torch import trace
from baspacho_tpu_torch.ops import kernels
from baspacho_tpu_torch.ops.chain import MOVES, SLOTS, Graphs, GraphSlot
from baspacho_tpu_torch.testing.problems import SMALL, spd_data, wide_dense

torch.set_num_threads(1)


def snapshot() -> dict:
    return {k: tuple(getattr(c, f) for f in kernels.CAPTURED)
            for k, c in kernels.COUNTS.items()}


def restore(saved: dict) -> None:
    for k, c in kernels.COUNTS.items():
        for f, n in zip(kernels.CAPTURED, saved[k]):
            setattr(c, f, n)


class StandIn:
    """A capture on the CPU: the call's walk runs eagerly on its buffers,
    a second walk on copies counts what the capture records (and is
    undone), and replay() walks the captured buffers again without
    counting, as a CUDA graph's replay launches through no wrapper."""

    def __init__(self, walk, bufs, ops):
        walk(*bufs, ops)
        saved = snapshot()
        walk(*[b.clone() for b in bufs], kernels)
        after = snapshot()
        self.deltas = [(kernels.COUNTS[k], f, a - b)
                       for k in saved
                       for f, a, b in zip(kernels.CAPTURED, after[k],
                                          saved[k]) if a != b]
        restore(saved)
        self.walk, self.bufs, self.replayed = walk, list(bufs), 0

    def replay(self):
        saved = snapshot()
        self.walk(*self.bufs, kernels)
        restore(saved)
        self.replayed += 1


@pytest.fixture(autouse=True)
def clean():
    trace.enable(False)
    trace.take()
    kernels.reset_counts()
    yield
    trace.enable(False)
    trace.take()


def problem(name="elim_range", graphed=True, backend="PLANNED"):
    s = (wide_dense if name == "wide_dense" else SMALL[name])(
        T, backend=backend)
    if graphed:
        s.graphs = Graphs(StandIn, "cpu")
    d = torch.as_tensor(spd_data(s, 5))
    b = torch.linspace(-1, 1, s.order, dtype=torch.float64)
    return s, d, b


def kinds(slot):
    return slot.eager, slot.captures, slot.replays


# -- the rule, on one slot -------------------------------------------------
def synthetic_walk(buf, ops):
    """In place: buf += 1, counted as two K1 grids and one K4 record."""
    c = kernels.COUNTS
    c["bucket_factor"].launches += 1
    c["bucket_factor"].grid_launches += 2
    c["dense_update"].tc_records += 1
    buf += 1


def test_eager_capture_replay_rule():
    slot = GraphSlot(StandIn)
    a, b = torch.zeros(4), torch.zeros(4)
    slot.run("factor.graph", synthetic_walk, (a,), kernels)
    assert kinds(slot) == (1, 0, 0) and slot.graph is None
    slot.run("factor.graph", synthetic_walk, (a,), kernels)
    assert kinds(slot) == (1, 1, 0) and slot.addrs == (a.data_ptr(),)
    slot.run("factor.graph", synthetic_walk, (a,), kernels)
    assert kinds(slot) == (1, 1, 1) and slot.graph.replayed == 1
    # a new buffer runs eagerly; the graph stays for its own buffer
    slot.run("factor.graph", synthetic_walk, (b,), kernels)
    assert kinds(slot) == (2, 1, 1)
    slot.run("factor.graph", synthetic_walk, (a,), kernels)
    assert kinds(slot) == (2, 1, 2)
    assert torch.equal(a, torch.full((4,), 4.0))
    assert torch.equal(b, torch.ones(4))


def test_one_graph_a_slot_the_old_one_freed():
    slot = GraphSlot(StandIn)
    a, b = torch.zeros(4), torch.zeros(4)
    for _ in range(2):
        slot.run("solve.graph", synthetic_walk, (a,), kernels)
    old = weakref.ref(slot.graph)
    for _ in range(2):
        slot.run("solve.graph", synthetic_walk, (b,), kernels)
    gc.collect()
    assert old() is None
    assert slot.captures == 2 and slot.addrs == (b.data_ptr(),)


def test_clear_drops_the_slots_and_their_graphs():
    graphs = Graphs(StandIn, "cpu")
    a = torch.zeros(4)
    slot = graphs.slot(a.device, "factor", 0, 1, 1, 4, 0, a.dtype)
    for _ in range(2):
        slot.run("factor.graph", synthetic_walk, (a,), kernels)
    old = weakref.ref(slot.graph)
    del slot
    graphs.clear()
    gc.collect()
    assert old() is None and graphs.slots == {}
    slot = graphs.slot(a.device, "factor", 0, 1, 1, 4, 0, a.dtype)
    slot.run("factor.graph", synthetic_walk, (a,), kernels)
    assert kinds(slot) == (1, 0, 0)


def test_a_replay_counts_one_eager_call():
    slot = GraphSlot(StandIn)
    a = torch.zeros(4)
    slot.run("factor.graph", synthetic_walk, (a,), kernels)
    eager = snapshot()
    kernels.reset_counts()
    slot.run("factor.graph", synthetic_walk, (a,), kernels)
    assert snapshot() == eager          # the capture counts its eager run
    kernels.reset_counts()
    slot.run("factor.graph", synthetic_walk, (a,), kernels)
    assert slot.replays == 1 and snapshot() == eager
    assert eager["bucket_factor"] == (1, 2, 0, 0, 0)
    assert eager["graph_replay"] == (0, 0, 0, 0, 0)


def test_a_slot_stays_eager_after_its_buffers_move():
    graphs = Graphs(StandIn, "cpu")
    a, b, c = torch.zeros(4), torch.zeros(4), torch.zeros(4)
    key = ("solve", 0, 1, 1, 4, 1, torch.float64)
    for _ in range(2):
        slot = graphs.slot(a.device, *key)
        slot.run("solve.graph", synthetic_walk, (a,), kernels)
    assert slot.graph is not None
    for i in range(MOVES):
        assert not slot.retired
        assert graphs.slot(a.device, *key) is slot
        slot.run("solve.graph", synthetic_walk, ((b, c)[i % 2],), kernels)
    assert slot.retired and slot.graph is None and slot.moves == MOVES
    assert kinds(slot) == (1 + MOVES, 1, 0)
    # its later calls take the plain path, counted eager
    assert graphs.slot(a.device, *key) is None
    assert slot.eager == 2 + MOVES


# -- through the facade ----------------------------------------------------
@pytest.mark.parametrize("name", ["elim_range", "wide_dense"])
def test_solves_on_a_held_factor_replay_bitwise(name):
    s, d, b = problem(name)
    f0 = s.factor_program()(d[None])[0]
    x0 = s.solve_program()(f0[None], b[None, :, None])[0, :, 0]
    f = s.factor(d)
    assert torch.equal(f, f0)
    xs = [s.solve(f, b) for _ in range(4)]
    slot = next(v for k, v in s.graphs.slots.items() if k[0] == "solve")
    assert kinds(slot) == (1, 1, 2)
    for x in xs:
        assert torch.equal(x, x0)
    # each call returns a buffer of its own
    assert len({x.data_ptr() for x in xs}) == len(xs)


def test_factors_bitwise_whatever_the_path():
    s, d, b = problem()
    f0 = s.factor_program()(d[None])[0]
    held = []
    for i in range(6):
        f = s.factor(d)
        assert torch.equal(f, f0)
        if i % 2:
            held.append(f)      # some held, some dropped
        del f
    slot = next(v for k, v in s.graphs.slots.items() if k[0] == "factor")
    assert sum(kinds(slot)) == 6 and slot.eager >= 1
    for f in held:
        assert torch.equal(f, f0)


def test_a_replayed_solve_counts_one_eager_solve():
    s, d, b = problem()
    f = s.factor(d)
    kernels.reset_counts()
    s.solve(f, b)
    eager = snapshot()
    s.solve(f, b)               # the capture
    kernels.reset_counts()
    s.solve(f, b)
    replay = snapshot()
    slot = next(v for k, v in s.graphs.slots.items() if k[0] == "solve")
    assert kinds(slot) == (1, 1, 1)
    assert replay == eager and eager["bucket_solve"][2] > 0


def test_keys_apart_by_op_range_batch_nrhs_and_dtype():
    s, d, b = problem()
    n = s.skel.num_lumps
    half = int(s.skel.lump_to_span[n // 2])
    f = s.factor(d)
    s.solve(f, b)
    s.solve(f, torch.stack([b, 2 * b], 1))
    s.factor(torch.stack([d, d]))
    s.factor(d.to(torch.float32))
    s.factor_up_to(d, half)
    s.factor_from(d, half)
    h = s._lump_of_span(half)
    size = s.skel.data_size
    assert set(s.graphs.slots) == {
        ("factor", 0, n, 1, size, 0, torch.float64),
        ("solve", 0, n, 1, size, 1, torch.float64),
        ("solve", 0, n, 1, size, 2, torch.float64),
        ("factor", 0, n, 2, size, 0, torch.float64),
        ("factor", 0, n, 1, size, 0, torch.float32),
        ("factor", 0, h, 1, size, 0, torch.float64),
        ("factor", h, n, 1, size, 0, torch.float64)}


def test_traced_replays_open_their_spans_and_time_their_counter():
    s, d, b = problem()
    f = s.factor(d)
    s.solve(f, b)
    s.solve(f, b)
    trace.enable(True)
    x = s.solve(f, b)
    spans = trace.take()
    trace.enable(False)
    names = [x.name for x in spans]
    assert names == ["solve", "solve.input", "solve.graph"]
    assert spans[2].parent == 0 and spans[2].call == spans[0].call
    assert kernels.COUNTS["graph_replay"].host_ns > 0
    assert torch.equal(x, s.solve_program()(f[None], b[None, :, None])
                       [0, :, 0])
    # untraced, a replay adds no host ns
    kernels.reset_counts()
    slot = next(v for k, v in s.graphs.slots.items() if k[0] == "solve")
    n = slot.replays
    s.solve(f, b)
    assert slot.replays == n + 1
    assert kernels.COUNTS["graph_replay"].host_ns == 0


def test_the_timing_shim_wraps_the_replay_and_not_the_twins():
    assert not hasattr(kernels.TWINS, "graph_replay")
    slot = GraphSlot(StandIn)
    a = torch.zeros(4)
    for _ in range(2):
        slot.run("factor.graph", synthetic_walk, (a,), kernels)
    slot.run("factor.graph", synthetic_walk, (a,),
             kernels.timed(kernels.TWINS))
    assert slot.replays == 1 and slot.graph.replayed == 1
    assert kernels.COUNTS["graph_replay"].host_ns > 0
    assert torch.equal(a, torch.full((4,), 3.0))


def test_a_solver_keeps_its_most_recent_slots():
    graphs = Graphs(StandIn, "cpu")
    a = torch.zeros(4)
    keys = [("factor", 0, 1, batch, 4, 0, a.dtype)
            for batch in range(SLOTS + 1)]
    first = graphs.slot(a.device, *keys[0])
    for key in keys[1:SLOTS]:
        graphs.slot(a.device, *key)
    assert graphs.slot(a.device, *keys[0]) is first     # now the newest
    graphs.slot(a.device, *keys[SLOTS])
    assert len(graphs.slots) == SLOTS
    assert keys[1] not in graphs.slots and graphs.slots[keys[0]] is first
    # off the card the factors' buffers come from no pool
    with graphs.allocating(a.device):
        pass
    assert graphs.pool is None


# -- the paths never graphed -----------------------------------------------
def test_cpu_calls_are_not_graphed_by_default():
    s, d, b = problem(graphed=False)
    for _ in range(3):
        f = s.factor(d)
        s.solve(f, b)
    assert s.graphs.slots == {}
    assert kernels.COUNTS["graph_replay"].host_ns == 0


def test_ref_is_not_graphed():
    s, d, b = problem("meri2", backend="REF")
    for _ in range(3):
        f = s.factor(d)
        s.solve(f, b)
    assert s.graphs.slots == {}


def test_partial_solves_mat_vec_and_pseudo_are_not_graphed():
    s, d, b = problem()
    f = s.factor(d)
    slots = set(s.graphs.slots)
    span = int(s.skel.lump_to_span[s.skel.num_lumps // 2])
    for _ in range(3):
        s.solve_l(f, b)
        s.solve_lt(f, b)
        s.solve_l_from(f, span, b)
        s.add_mv_from(d, 0, b, torch.zeros_like(b))
        s.pseudo_factor_from(d, span)
    assert set(s.graphs.slots) == slots


def test_chained_is_not_graphed():
    s, d, b = problem()
    f0 = s.factor(d)
    fc = s.factor_chained(d, 1)
    xc = s.solve_chained(f0, b, 2)
    assert torch.equal(fc, f0)
    assert torch.equal(xc, s.solve(f0, s.solve(f0, b)))
    assert {k[0] for k in s.graphs.slots} == {"factor", "solve"}
    assert all(k[3] == 1 and k[5] in (0, 1) for k in s.graphs.slots)
    assert sum(sl.captures + sl.replays + sl.eager
               for sl in s.graphs.slots.values()) == 3


def test_sharded_is_not_graphed():
    s, d, b = problem()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(tmp, "store"),
            rank=0, world_size=1)
        try:
            group = dist.group.WORLD
            f = s.factor_sharded(d, group)
            x = s.solve_sharded(f, b, group)
        finally:
            dist.destroy_process_group()
    assert s.graphs.slots == {}
    assert torch.equal(f, s.factor_program()(d[None])[0])
    # a share's rows are summed back (old + change): not bitwise
    x0 = s.solve_program()(f[None], b[None, :, None])[0, :, 0]
    assert torch.allclose(x, x0, rtol=1e-12, atol=0)


# -- perfbench's reader ----------------------------------------------------
def test_graph_replay_pct_reads_the_calls_spans():
    from perfbench import segment
    from perfbench.metrics import graph_replay_pct

    class Run:
        pass

    def seg(spans):
        run = Run()
        run.program_segment = segment.Segment(
            [], 0.0, segment.Counted(1, 1.0, 0, spans), None)
        return run

    spans = [("factor", 0, 9, None, 1), ("factor.input", 1, 2, 0, 1),
             ("factor.graph", 3, 8, 0, 1),
             ("solve", 10, 19, None, 2), ("solve.input", 11, 12, 3, 2),
             ("refine", 20, 40, None, 3), ("solve", 21, 29, 5, 4),
             ("solve.graph", 22, 28, 6, 4)]
    assert graph_replay_pct.read(seg(spans)) == pytest.approx(200 / 3)
    assert graph_replay_pct.read(seg([])) is None
    run = Run()
    run.program_segment = None
    assert graph_replay_pct.read(run) is None
