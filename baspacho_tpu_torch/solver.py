"""Solver: symbolic plan + the numeric factor, solves and mat-vec on a
torch device.

Port of baspacho_tpu/solver.py. The host part (BackendType,
AddFillPolicy, Settings and the create_solver pipeline) is copied close
to line for line, so both packages build the same skeleton and the same
data buffer means the same matrix. The MXU precision fields of Settings
are dropped: the hand-written kernels compute at full precision.

The facade keeps the JAX Solver's public names, input checks and
batching rules (a leading batch axis on the data, 1-D or 2-D right-hand
sides): factor / factor_up_to / factor_from, the full and partial L /
Lt solves, add_mv_from, pseudo_factor_from, check_factor,
solve_refined and make_differentiable_solve, on either backend (PLANNED
through the hand-written kernels, REF in plain torch), and the stats:
enable_stats / reset_stats / print_stats with `stats` (factor and solve
calls timed by CUDA events while enabled) and the per-op profiles
profile_ops / profile_solve_ops (PLANNED, stats.py). A solver runs on
the CUDA card unless a device is named. factor_sharded / solve_sharded
split one factor or solve over the ranks of a torch.distributed process
group (PLANNED, one system); factor_chained / solve_chained run k
factors or solves back to back, on the card as one CUDA graph replayed k
times (ops/chain.py), for device time free of the host's launches. On
the card a PLANNED factor or solve call replays a CUDA graph of its
levels where its buffers are those of the graph of its op, lump range,
batch, nrhs and dtype (`graphs`, ops/chain.py Graphs): bit for bit the
eager call's launches, without the host's.
While the port's tracing is on (trace.py), a PLANNED factor or solve
call runs inside its span with the kernel wrappers timed (one test,
Solver._tracing, decides it); off, it costs that test and an empty
context.

createSolver pipeline (same analysis structure as reference :611-752):
  1. apply given sparse-elim-range fill,
  2. AMD-reorder the remaining bottom-right corner,
  3. elimination tree: auto-detect further elim ranges, merge supernodes
     under the computation model,
  4. compose permutations, build the coalesced factor skeleton.
"""

from __future__ import annotations

import enum
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import trace
from .accessor import CoalescedAccessor, PermutedCoalescedAccessor
from .block_matrix import CoalescedBlockMatrixSkel
from .computation_model import ComputationModel
from .elimination_tree import EliminationTree
from .ops import kernels
from .ops.chain import Graphs, chained
from .ops.plan import build_plan
from .sparse_structure import SparseStructure
from .stats import SolverStats, profile_factor, profile_solve
from .utils import (compose_permutations, cum_sum_vec, inverse_permutation,
                    is_strictly_increasing)

class BackendType(enum.Enum):
    REF = "ref"          # unrolled ops, one op per lump/board
    PLANNED = "planned"  # level-scheduled bucketed batched ops


class AddFillPolicy(enum.Enum):
    COMPLETE = 0         # fill for complete factoring, reorder
    FOR_AUTO_ELIMS = 1   # fill for given+auto elim ranges, reorder
    FOR_GIVEN_ELIMS = 2  # fill for given elim ranges only, no reorder
    NONE = 3             # no fill, no reorder


@dataclass
class Settings:
    find_sparse_elimination_ranges: bool = True
    backend: BackendType = BackendType.REF
    add_fill_policy: AddFillPolicy = AddFillPolicy.COMPLETE
    computation_model: Optional[ComputationModel] = None


def shard_group(mesh):
    """The process group of a 1-D `torch.distributed.device_mesh.DeviceMesh`
    or a ProcessGroup given as it is (the JAX package's 1-D Mesh)."""
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(mesh, DeviceMesh):
        if mesh.ndim != 1:
            raise ValueError(f"a sharded factor or solve takes a 1-D mesh, "
                             f"got {mesh.ndim} dimensions")
        return mesh.get_group()
    return mesh


def resolve_device(device=None) -> torch.device:
    """The device a solver runs on: the one named, else the CUDA card.
    Without a card and without a named device it raises rather than
    carrying on on the CPU (device="cpu" runs the plain twins). A CUDA
    device comes back with its index (the current card's when none is
    named), as the tensors on it report theirs."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the solver runs on the GPU unless a device is "
            "named; pass device='cpu' to run the plain PyTorch versions")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Solver:
    def __init__(self, skel: CoalescedBlockMatrixSkel,
                 sparse_elim_ranges: Sequence[int],
                 permutation: np.ndarray,
                 backend: BackendType = BackendType.PLANNED,
                 can_factor_up_to: int = -1,
                 device=None):
        self.skel = skel
        self.device = resolve_device(device)
        self.sparse_elim_ranges = list(sparse_elim_ranges)
        self.permutation = np.asarray(permutation, dtype=np.int64)
        self.can_factor_up_to = (skel.num_spans if can_factor_up_to < 0
                                 else can_factor_up_to)
        max_lump = (skel.num_lumps
                    if self.can_factor_up_to >= skel.num_spans
                    else int(skel.span_to_lump[self.can_factor_up_to]))
        self.plan = build_plan(skel, self.sparse_elim_ranges, max_lump)
        if backend == BackendType.PLANNED:
            from .ops.planned_backend import PlannedBackend
            self.backend = PlannedBackend(self.plan)
        else:
            from .ops.ref_backend import UnrolledBackend
            self.backend = UnrolledBackend(self.plan)
        self.backend_type = backend
        self._fns: Dict[tuple, object] = {}
        # the chained methods' CUDA graphs (ops/chain.py), per (op,
        # backend, batch, data size, nrhs, dtype)
        self._chains: Dict[tuple, object] = {}
        # the PLANNED factor and solve calls' graphs (ops/chain.py), per
        # (op, start lump, end lump, batch, data size, nrhs, dtype)
        self.graphs = Graphs()
        self.stats = SolverStats()

    # -- stats (reference Solver::enableStats/printStats/resetStats) ----
    def enable_stats(self, enabled: bool = True):
        self.stats.enable(enabled)

    def reset_stats(self):
        self.stats.reset()

    def print_stats(self):
        sk = self.skel
        print(f"Matrix stats:\n  spans: {sk.num_spans}  lumps: "
              f"{sk.num_lumps}  order: {sk.order}\n"
              f"  data size: {sk.data_size}\n"
              f"  levels: {getattr(self.backend, 'num_levels', 'n/a')}\n"
              f"  sparse elim ranges: {self.sparse_elim_ranges}")
        print(self.stats)

    def profile_ops(self, data, reps: int = 5):
        """Per-op profiling mode (PLANNED): runs the factor schedule level
        by level and times each piece of a bucket on the kernels from
        restored operands (stats.profile_factor), records (op, shape...,
        seconds) samples and aggregates them into the per-op stats shown
        by print_stats — the reference's OpStat-per-category view
        (MatOps.h:84-101). Returns the raw records (the `bench -Z` CSV
        analog, consumable by stats.fit_computation_model)."""
        records = profile_factor(self, data, reps=reps)
        self.stats.record_profile(records)
        return records

    def profile_solve_ops(self, factor_data, rhs, reps: int = 5):
        """Per-stage solve profiling (PLANNED): times each solve stage
        (sparse-elim L/Lt, diag solve L/Lt, gemv/gemvT, the L pass's RHS
        scatter) on the kernels (stats.profile_solve) and aggregates into
        the per-stage stats shown by print_stats — the reference's
        solve-stage OpStats (MatOps.h:84-101)."""
        records = profile_solve(self, factor_data, rhs, reps=reps)
        self.stats.record_profile(records)
        return records

    def _timed(self, stat, run):
        """run() and, while `stat` is enabled, its time into `stat`: on a
        card by CUDA events around the call and a synchronise, on the CPU
        by the host clock. Disabled (or no stat), it adds no event and no
        synchronise."""
        if stat is None or not stat.enabled:
            return run()
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            out = run()
            stat.record(time.perf_counter() - t0)
            return out
        stream = torch.cuda.current_stream(self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = run()
        end.record(stream)
        end.synchronize()
        stat.record(start.elapsed_time(end) * 1e-3)
        return out

    # -- introspection --------------------------------------------------
    @property
    def order(self) -> int:
        return self.skel.order

    @property
    def data_size(self) -> int:
        return self.skel.data_size

    def span_vector_offset(self, span: int) -> int:
        return self.skel.span_vector_offset(span)

    def span_matrix_offset(self, span: int) -> int:
        return self.skel.span_matrix_offset(span)

    def accessor(self) -> PermutedCoalescedAccessor:
        return PermutedCoalescedAccessor(self.skel, self.permutation)

    def internal_accessor(self) -> CoalescedAccessor:
        return CoalescedAccessor(self.skel)

    def param_to_span(self) -> np.ndarray:
        return self.permutation

    # -- internals ------------------------------------------------------
    def _lump_of_span(self, span_index: int) -> int:
        assert 0 <= span_index <= self.skel.num_spans
        assert self.skel.span_offset_in_lump[span_index] == 0
        return int(self.skel.span_to_lump[span_index])

    def program(self, op: str, start: int, end: int = -1):
        """The backend program of `op` over lumps [start, end) (cached):
        "factor", "solve" (PLANNED, full range), "solve_l", "solve_lt"
        over batched (batch, ...) tensors; their in-place bodies
        "factor_body", "solve_body" and "solve_l_body" (the chains');
        "add_mv" from lump `start`; "pseudo" over spans [start, end)."""
        key = (op, start, end)
        fn = self._fns.get(key)
        if fn is None:
            b, dev = self.backend, self.device
            if op == "add_mv":
                fn = b.make_add_mv(start, dev)
            elif op == "pseudo":
                fn = b.make_pseudo_factor(start, end, dev)
            else:
                fn = getattr(b, f"make_{op}")(start, end, dev)
            self._fns[key] = fn
        return fn

    def _as_tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            if x.device != self.device:
                raise ValueError(f"tensor on {x.device}, solver runs on "
                                 f"{self.device}")
            t = x
        else:
            t = torch.as_tensor(np.asarray(x), device=self.device)
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype {t.dtype} not supported "
                            "(float32 or float64)")
        return t

    def _check_data(self, data):
        """Input validation on the numeric wrappers (the reference guards
        every op with BASPACHO_CHECK*, DebugMacros.h:28-51)."""
        if data.shape[-1] != self.skel.data_size:
            raise ValueError(
                f"data has {data.shape[-1]} elements, factor layout needs "
                f"{self.skel.data_size}")
        if data.ndim > 2:
            raise ValueError("data must be (dataSize,) or (batch, dataSize)")

    def _check_rhs(self, v, batched):
        want = 2 if batched else 1
        if v.ndim not in (want, want + 1):
            raise ValueError(
                f"rhs must have {want} or {want + 1} dims "
                f"({'batched' if batched else 'unbatched'} data), got "
                f"{v.ndim}")
        if v.shape[1 if batched else 0] != self.skel.order:
            raise ValueError(
                f"rhs length {v.shape[1 if batched else 0]} != matrix "
                f"order {self.skel.order}")

    def _check_vec(self, data, v, what="rhs"):
        """Checks one vector operand against the data: dims, length,
        dtype and batch. Returns (batched, 1-D)."""
        batched = data.ndim == 2
        self._check_rhs(v, batched)
        if v.dtype != data.dtype:
            raise TypeError(f"{what} dtype {v.dtype} != data dtype "
                            f"{data.dtype}")
        if batched and v.shape[0] != data.shape[0]:
            raise ValueError(f"{what} batch {v.shape[0]} != data batch "
                             f"{data.shape[0]}")
        return batched, v.ndim == (2 if batched else 1)

    def _tracing(self) -> bool:
        """Whether a call is traced (trace.py), decided here alone:
        tracing is on and the backend is PLANNED. A traced factor, solve
        or solve_refined runs inside its call span, and a traced factor,
        solve or add_mv_from hands its program the timed kernel wrappers
        (kernels.timed: each call's host ns added to its counter's
        host_ns); untraced, the program runs its default, the kernels
        module."""
        return trace.ON and self.backend_type == BackendType.PLANNED

    def _program_args(self, op, start: int, end: int, x, nrhs: int,
                      traced: bool) -> dict:
        """The keyword arguments of a call of the program `op`: the timed
        wrappers when `traced`, and for a PLANNED factor or solve its
        GraphSlot (ops/chain.py) where `graphs` graphs calls on x's
        device."""
        kw = {"ops": kernels.timed(kernels)} if traced else {}
        if self.backend_type == BackendType.PLANNED and \
                op in ("factor", "solve"):
            slot = self.graphs.slot(x.device, op, start, end, x.shape[0],
                                    x.shape[1], nrhs, x.dtype)
            if slot is not None:
                kw["slot"] = slot
        return kw

    def _run_factor_like(self, op, data, start: int, end: int, stat=None,
                         traced: bool = False):
        """The program `op` on `data`; with `stat`, the program's call
        timed into it (_timed); `traced` (_tracing), inside its span
        `op` on the timed wrappers."""
        with _span(op, traced, call=True):
            data = self._as_tensor(data)
            self._check_data(data)
            batched = data.ndim == 2
            fn = self.program(op, start, end)
            x = (data if batched else data[None]).contiguous()
            kw = self._program_args(op, start, end, x, 0, traced)
            out = self._timed(stat, lambda: fn(x, **kw))
            return out if batched else out[0]

    def _run_solve_like(self, op, mat_data, rhs, start: int, end: int,
                        stat=None, traced: bool = False):
        with _span(op, traced, call=True):
            data = self._as_tensor(mat_data)
            v = self._as_tensor(rhs)
            self._check_data(data)
            batched, vec1d = self._check_vec(data, v)
            if vec1d:
                v = v[..., None]
            if not batched:
                data, v = data[None], v[None]
            fn = self.program(op, start, end)
            data = data.contiguous()
            kw = self._program_args(op, start, end, data, v.shape[2], traced)
            out = self._timed(stat, lambda: fn(data, v, **kw))
            if not batched:
                out = out[0]
            return out[..., 0] if vec1d else out

    def factor_program(self):
        """The full-range factor program: (batch, data_size) -> factor."""
        return self.program("factor", 0, self.skel.num_lumps)

    def solve_program(self):
        """The full-range solve program of the PLANNED backend: (data
        (batch, data_size), v (batch, order, nrhs)) -> solution."""
        return self.program("solve", 0, self.skel.num_lumps)

    # -- factor ---------------------------------------------------------
    def factor(self, data):
        return self.factor_up_to(data, self.skel.num_spans)

    def factor_up_to(self, data, span_index: int):
        assert span_index <= self.can_factor_up_to
        return self._run_factor_like("factor", data, 0,
                                     self._lump_of_span(span_index),
                                     self.stats.factor, self._tracing())

    def factor_from(self, data, span_index: int):
        return self._run_factor_like("factor", data,
                                     self._lump_of_span(span_index),
                                     self.skel.num_lumps,
                                     traced=self._tracing())

    # -- solve ----------------------------------------------------------
    def solve(self, mat_data, rhs):
        n = self.skel.num_lumps
        if self.backend_type == BackendType.PLANNED:
            # fused L + Lt solve on the stored inverse
            return self._run_solve_like("solve", mat_data, rhs, 0, n,
                                        self.stats.solve_l, self._tracing())
        rhs = self._run_solve_like("solve_l", mat_data, rhs, 0, n,
                                   self.stats.solve_l)
        return self._run_solve_like("solve_lt", mat_data, rhs, 0, n,
                                    self.stats.solve_lt)

    def solve_l(self, mat_data, rhs):
        return self.solve_l_up_to(mat_data, self.skel.num_spans, rhs)

    def solve_lt(self, mat_data, rhs):
        return self.solve_lt_up_to(mat_data, self.skel.num_spans, rhs)

    def solve_l_up_to(self, mat_data, span_index: int, rhs):
        return self._run_solve_like("solve_l", mat_data, rhs, 0,
                                    self._lump_of_span(span_index))

    def solve_lt_up_to(self, mat_data, span_index: int, rhs):
        return self._run_solve_like("solve_lt", mat_data, rhs, 0,
                                    self._lump_of_span(span_index))

    def solve_l_from(self, mat_data, span_index: int, rhs):
        return self._run_solve_like("solve_l", mat_data, rhs,
                                    self._lump_of_span(span_index),
                                    self.skel.num_lumps)

    def solve_lt_from(self, mat_data, span_index: int, rhs):
        return self._run_solve_like("solve_lt", mat_data, rhs,
                                    self._lump_of_span(span_index),
                                    self.skel.num_lumps)

    # -- matvec / pseudo-factor / checks --------------------------------
    def add_mv_from(self, mat_data, span_index: int, x, out, alpha=1.0):
        """out + alpha * M x on the bottom-right corner from span_index,
        as a new tensor (`out` is left as it was)."""
        start_l = self._lump_of_span(span_index)
        data = self._as_tensor(mat_data)
        x = self._as_tensor(x)
        out = self._as_tensor(out)
        self._check_data(data)
        batched, vec1d = self._check_vec(data, x, "x")
        self._check_vec(data, out, "out")
        if out.shape != x.shape:
            raise ValueError(f"out shape {tuple(out.shape)} != x shape "
                             f"{tuple(x.shape)}")
        if vec1d:
            x, out = x[..., None], out[..., None]
        if not batched:
            data, x, out = data[None], x[None], out[None]
        fn = self.program("add_mv", start_l)
        args = (data.contiguous(), x.contiguous(), out, float(alpha))
        res = fn(*args, ops=kernels.timed(kernels)) if self._tracing() \
            else fn(*args)
        if not batched:
            res = res[0]
        return res[..., 0] if vec1d else res

    def pseudo_factor_from(self, data, span_index: int):
        """Per-span Cholesky of the diagonal blocks of spans >= span_index
        and their column blocks below multiplied by L^-T (the
        Gauss-Seidel preconditioner's factor); no update between spans."""
        return self._run_factor_like("pseudo", data, span_index,
                                     self.skel.num_spans)

    def check_factor(self, factored) -> bool:
        """True iff every diagonal entry of L is finite and positive
        (batched data: all items)."""
        f = self._as_tensor(factored)
        idx = torch.from_numpy(self.skel.damp_indices()).to(f.device)
        d = f.index_select(-1, idx)
        return bool(torch.all(torch.isfinite(d) & (d > 0)))

    def solve_refined(self, mat_data, factor_data, rhs,
                      iterations: int = 2):
        """Mixed-precision solve by iterative refinement: `factor_data`
        (typically float32) factors the matrix held at higher precision
        in `mat_data`; each round takes the residual r = b - M x at the
        matrix precision (block mat-vec) and corrects with a solve at
        the factor's precision.

        While tracing is on (trace.py), a PLANNED call runs inside the
        span `refine`, which holds each solve's own `solve` span (a call
        id of its own), `refine.residual` (each round's add_mv_from and
        its subtraction from b) and `refine.cast` (each conversion
        between the factor's precision and the matrix's)."""
        traced = self._tracing()
        with _span("refine", traced, call=True):
            rhs = self._as_tensor(rhs)
            mat = self._as_tensor(mat_data)
            lp = self._as_tensor(factor_data)
            with _span("refine.cast", traced):
                b = rhs.to(lp.dtype)
            x = self.solve(lp, b)
            with _span("refine.cast", traced):
                x = x.to(rhs.dtype)
            for _ in range(iterations):
                with _span("refine.residual", traced):
                    r = rhs - self.add_mv_from(mat, 0, x,
                                               torch.zeros_like(x), 1.0)
                with _span("refine.cast", traced):
                    r = r.to(lp.dtype)
                d = self.solve(lp, r)
                with _span("refine.cast", traced):
                    d = d.to(rhs.dtype)
                x = x + d
            return x

    def make_differentiable_solve(self):
        """Returns f(hdata, rhs) -> x solving H x = rhs for the SPD block
        matrix held in `hdata`, differentiable with torch.autograd. The
        backward uses the implicit-function theorem (no differentiation
        through the factor): with y = H^-1 g, bar_rhs = y and bar_H =
        -y x^T symmetrized onto the stored lower half,
        bar_hdata[slot(i, j)] = -(y_i x_j + x_i y_j) for i > j and
        -y_i x_i on the diagonal; padding and the dead upper halves of
        the diagonal blocks get 0. One (unbatched) system, rhs 1-D or
        (order, nrhs)."""
        ri, ci = self.skel.data_coords()
        coords = (torch.from_numpy(ri).to(self.device),
                  torch.from_numpy(ci).to(self.device))

        def diff_solve(hdata, rhs):
            return _DiffSolve.apply(self, coords, hdata, rhs)

        return diff_solve

    # -- one factor or solve sharded over a process group ----------------
    def sharded_program(self, op: str, mesh):
        """The full-range program "factor_sharded" or "solve_sharded" of
        the PLANNED backend for this rank of `mesh` (shard_group),
        cached per (op, ranks, rank, group)."""
        group = shard_group(mesh)
        n, r = dist.get_world_size(group), dist.get_rank(group)
        key = (op, n, r, group)
        fn = self._fns.get(key)
        if fn is None:
            fn = getattr(self.backend, f"make_{op}")(
                0, self.skel.num_lumps, group, self.device)
            self._fns[key] = fn
        return fn

    def _check_sharded(self, what: str) -> None:
        if self.backend_type != BackendType.PLANNED:
            raise ValueError(f"{what} needs the PLANNED backend")

    def factor_sharded(self, data, mesh):
        """Factor ONE matrix with every level's panel work split over the
        ranks of `mesh`, a 1-D DeviceMesh or a ProcessGroup: per level,
        one all-gather of the factored panels and, on a dense level, one
        all-reduce of its update (PlannedBackend.make_factor_sharded).
        Every rank passes the same data and gets the same factor, that
        of `factor(data)` up to the order of the update's sums. Timed
        into `stats.factor` while it is enabled."""
        self._check_sharded("factor_sharded")
        data = self._as_tensor(data)
        self._check_data(data)
        if data.ndim != 1:
            raise ValueError("factor_sharded shards ONE factorization")
        fn = self.sharded_program("factor_sharded", mesh)
        x = data[None].contiguous()
        return self._timed(self.stats.factor, lambda: fn(x))[0]

    def solve_sharded(self, mat_data, rhs, mesh):
        """Solve ONE system with every level's panel work split over the
        ranks of `mesh`: per level and pass, one all-reduce of the
        changes of the RHS rows the level touches
        (PlannedBackend.make_solve_sharded). `mat_data` must come from
        factor / factor_sharded (the solve reads the stored inverse);
        rhs is (order,) or (order, nrhs)."""
        self._check_sharded("solve_sharded")
        data = self._as_tensor(mat_data)
        v = self._as_tensor(rhs)
        self._check_data(data)
        if data.ndim != 1:
            raise ValueError("solve_sharded shards ONE solve")
        _, vec1d = self._check_vec(data, v)
        fn = self.sharded_program("solve_sharded", mesh)
        out = fn(data[None].contiguous(),
                 (v[:, None] if vec1d else v)[None])[0]
        return out[:, 0] if vec1d else out

    # -- chained executions (a timing aid) ------------------------------
    def factor_chained(self, data, k: int):
        """k back-to-back factors, each of the previous one's output, in
        one dispatch (past the first, the values are garbage: the steps
        factor an already factored buffer). On the card one factor is
        captured as a CUDA graph at the first call per (batch, dtype)
        and replayed k times (ops/chain.py), so the difference of two
        chain lengths is device time per factor, free of the host's
        launches; on the CPU it is a loop. k = 0 returns a copy of
        `data`, k = 1 equals factor(data). Not timed into `stats`."""
        data = self._as_tensor(data)
        self._check_data(data)
        k = _chain_length(k)
        batched = data.ndim == 2
        x = data if batched else data[None]
        out = chained(self._chains, ("factor", self.backend_type, x.shape[0],
                                     self.skel.data_size, 0, x.dtype),
                      self.program("factor_body", 0, self.skel.num_lumps),
                      (x,), k)
        return out if batched else out[0]

    def solve_chained(self, mat_data, rhs, k: int):
        """k back-to-back solves x_{i+1} = A^-1 x_i on the factor
        `mat_data` (A^-k rhs), as factor_chained runs its factors; k = 0
        returns a copy of `rhs`. On REF, which has no fused solve, the
        step is the L pass alone (solve_l), as in the JAX package."""
        data = self._as_tensor(mat_data)
        v = self._as_tensor(rhs)
        self._check_data(data)
        batched, vec1d = self._check_vec(data, v)
        k = _chain_length(k)
        if vec1d:
            v = v[..., None]
        if not batched:
            data, v = data[None], v[None]
        op = "solve_body" if hasattr(self.backend, "make_solve") \
            else "solve_l_body"
        out = chained(self._chains, (op, self.backend_type, v.shape[0],
                                     self.skel.data_size, v.shape[2],
                                     v.dtype),
                      self.program(op, 0, self.skel.num_lumps), (data, v), k)
        if not batched:
            out = out[0]
        return out[..., 0] if vec1d else out


_UNTRACED = nullcontext()


def _span(name: str, traced: bool, call: bool = False):
    """trace.span(name, call) in a traced call (Solver._tracing), else
    a context that does nothing."""
    return trace.span(name, call) if traced else _UNTRACED


def _chain_length(k) -> int:
    k = int(k)
    if k < 0:
        raise ValueError(f"chain length k must be >= 0, got {k}")
    return k


class _DiffSolve(torch.autograd.Function):
    """x = H^-1 rhs with the implicit-gradient backward of
    Solver.make_differentiable_solve; the backward is one more solve on
    the forward's factor."""

    @staticmethod
    def forward(ctx, solver, coords, hdata, rhs):
        f = solver.factor(hdata)
        x = solver.solve(f, rhs)
        ctx.solver, ctx.coords = solver, coords
        ctx.save_for_backward(f, x)
        return x

    @staticmethod
    def backward(ctx, g):
        f, x = ctx.saved_tensors
        ri, ci = ctx.coords
        y = ctx.solver.solve(f, g.contiguous())
        # a zero row, so sentinel coordinates (order) read 0
        xe = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
        ye = torch.cat([y, y.new_zeros((1,) + y.shape[1:])])
        yr, yc, xr, xc = ye[ri], ye[ci], xe[ri], xe[ci]
        if x.ndim == 1:
            diag = yr * xc
            prod = diag + xr * yc
        else:  # (order, nrhs): sum over the rhs columns
            diag = (yr * xc).sum(-1)
            prod = diag + (xr * yc).sum(-1)
        bar_h = -torch.where(ri == ci, diag, prod)
        return None, None, bar_h.to(x.dtype), y


# -- carried-over state --------------------------------------------------
SKELETON_KEYS = ("span_start", "lump_to_span", "chain_col_ptr",
                 "chain_row_span", "lump_start", "span_to_lump",
                 "span_offset_in_lump", "chain_rows_till_end", "chain_data",
                 "col_stride", "padded_below", "below_rows", "panel_base",
                 "board_col_ptr", "board_row_lump", "board_chain_col_ord",
                 "board_row_ptr", "board_col_lump", "board_col_ord")


def skeleton_arrays(skel) -> Dict[str, np.ndarray]:
    """The arrays that define a skeleton's layout, as numpy copies. Works
    on a skeleton of either package: the same arrays mean the same
    padded data buffer."""
    return {k: np.array(getattr(skel, k), dtype=np.int64)
            for k in SKELETON_KEYS}


def solver_from_skeleton(arrays: Dict[str, np.ndarray], permutation,
                         sparse_elim_ranges: Sequence[int],
                         device=None,
                         backend: BackendType = BackendType.PLANNED
                         ) -> Solver:
    """A solver of `backend` (PLANNED unless named) on exactly the
    skeleton described by `arrays` (from skeleton_arrays, e.g. of a JAX
    Solver's skel), on `device` (default: the CUDA card). Raises
    ValueError when the rebuilt layout differs from the given one."""
    skel = CoalescedBlockMatrixSkel(
        arrays["span_start"], arrays["lump_to_span"],
        arrays["chain_col_ptr"], arrays["chain_row_span"],
        pad_fn=_pad_fn_for(Settings(backend=backend)))
    mine = skeleton_arrays(skel)
    for k, v in arrays.items():
        if k in mine and not np.array_equal(mine[k], v):
            raise ValueError(f"skeleton array {k!r} differs from the "
                             "padded layout this port builds")
    return Solver(skel, sparse_elim_ranges, permutation, backend, -1,
                  device)


def _bottom_permutation(settings: "Settings", ss: SparseStructure,
                        ss_bottom: SparseStructure, given_elim_end: int,
                        n_params: int) -> np.ndarray:
    """Ordering of the bottom (post-given-elim) system.

    Default is AMD (reference behavior, Solver.cpp:659). But when a given
    sparse elimination range dwarfs the bottom system AND its columns are
    LOCAL in user order (each eliminated block touches a narrow band of
    bottom rows — BA landmarks seeing a camera-trajectory window), AMD
    would scramble that band structure and with it the chunk locality the
    planned backend's dense updates depend on; reverse Cuthill-McKee
    preserves it at a modest fill cost on the (comparatively tiny) bottom
    factor. The within-range member sort + outlier routing downstream
    complete the picture.
    """
    if settings.backend == BackendType.PLANNED and given_elim_end > 0 \
            and given_elim_end >= 4 * ss_bottom.order:
        # median user-order spread of the elim columns' bottom rows
        rows = ss.expanded_rows()
        cols = ss.inds
        sel = (cols < given_elim_end) & (rows >= given_elim_end)
        if np.any(sel):
            r = rows[sel] - given_elim_end
            c = cols[sel]
            o = np.argsort(c, kind="stable")
            r, c = r[o], c[o]
            uniq, start_idx = np.unique(c, return_index=True)
            mx = np.maximum.reduceat(r, start_idx)
            mn = np.minimum.reduceat(r, start_idx)
            med = float(np.median(mx - mn)) if len(uniq) else 0.0
            if med <= ss_bottom.order / 8:
                # keep locality: the user's order already has it (that is
                # what the median-spread test established), so identity is
                # the natural candidate; RCM can beat it when the user
                # order is banded-but-sloppy. Pick by measured bandwidth.
                nb = ss_bottom.order
                er = ss_bottom.expanded_rows()
                ec = ss_bottom.inds

                def p90_bw(perm):
                    inv = np.empty(nb, np.int64)
                    inv[perm] = np.arange(nb)
                    return float(np.percentile(np.abs(inv[er] - inv[ec]),
                                               90)) if len(er) else 0.0

                ident = np.arange(nb, dtype=np.int64)
                rcm = ss_bottom.rcm_permutation()
                return ident if p90_bw(ident) <= p90_bw(rcm) else rcm
    return ss_bottom.fill_reducing_permutation()


def _pad_fn_for(settings: "Settings"):
    """Padded bucket storage for the planned backend; the reference
    backend keeps the packed layout."""
    if settings.backend == BackendType.PLANNED:
        from .ops.schedule import storage_pad
        return storage_pad
    return None


def _batched_factor_cost(et, pad_fn) -> float:
    """Modeled factor time of a merged tree under the BATCHED execution
    regime the planned backend actually runs: same-shape lumps of a level
    execute as ONE XLA op, levels are sequential, and each sequential op
    carries a dispatch/schedule overhead. The per-node polynomial the merge
    loop minimizes cannot express this (its constant terms charge per NODE;
    batching charges per BUCKET) — this evaluator re-prices a candidate
    tree post-merge:

      cost = sum_buckets [ ops(bucket) * C_DISPATCH + flops(bucket)/rate ]
           + num_levels * LEVEL_OPS * C_DISPATCH

    Constants below are measured on TPU v5e (tools/measure_dispatch.py):
    chained small-op overhead and effective f32-highest matmul rates at
    the panel shapes the backend emits. Used only to SELECT between merge
    candidates (see create_solver), never to drive the merge loop itself,
    so ranking fidelity is what matters, not absolute accuracy."""
    from .computation_model import batched_regime_v5e as brp
    from .utils import cum_sum_vec as _csv

    nl = len(et.lump_start) - 1
    if nl == 0:
        return 0.0
    widths = et.lump_start[1:] - et.lump_start[:-1]
    span_sizes = np.empty(len(et.param_size), dtype=np.int64)
    span_sizes[et.perm_inverse] = et.param_size
    rp_sizes = span_sizes[et.row_param]
    sums = np.concatenate([[0], np.cumsum(rp_sizes)])
    col_rows = sums[et.col_start[1:]] - sums[et.col_start[:-1]]
    below = col_rows - widths

    counts = et.lump_to_span[1:] - et.lump_to_span[:-1]
    span_to_lump = np.repeat(np.arange(nl, dtype=np.int64), counts)
    levels = np.zeros(nl, dtype=np.int64)
    for a in range(nl):
        tl = span_to_lump[et.row_param[et.col_start[a]:et.col_start[a + 1]]]
        tl = np.unique(tl[tl > a])
        if len(tl):
            np.maximum.at(levels, tl, levels[a] + 1)

    if pad_fn is not None:
        prp, pcp = pad_fn(below, widths)
    else:
        prp, pcp = below, widths

    t = float(levels.max() + 1) * brp.level_ops * brp.dispatch_overhead
    buckets = {}
    for a in range(nl):
        key = (int(levels[a]), int(pcp[a]), int(prp[a]))
        buckets[key] = buckets.get(key, 0) + 1
    for (_, s, r), B in buckets.items():
        if s <= 8:
            ops = 3.0 * s          # unrolled tiny-panel chol/inverse
        elif s <= 256:
            ops = brp.bucket_ops   # native cholesky + trsm + read/write
        else:
            ops = brp.block_step_ops * ((s + 255) // 256)
        flops = B * (s ** 3 / 3.0 + s * s * r + s * r * r)
        # narrow panels waste MXU lanes; measured v5e utilization fits
        # min(1, s/1024) (see BatchedRegimeParams provenance)
        util = min(1.0, max(s, 1) / brp.mxu_sat_width)
        t += ops * brp.dispatch_overhead + flops / (brp.matmul_rate * util)
    return t


def create_solver(settings: Settings, param_sizes, ss: SparseStructure,
                  sparse_elim_ranges: Sequence[int] = (),
                  elim_last_ids: Sequence[int] = (),
                  device=None) -> Solver:
    """The solver of `ss` under `settings`, on `device` (default: the
    CUDA card; without one it raises, see resolve_device)."""
    device = resolve_device(device)
    param_sizes = np.asarray(param_sizes, dtype=np.int64)
    sparse_elim_ranges = list(sparse_elim_ranges)
    elim_last = set(int(i) for i in elim_last_ids)
    assert settings.add_fill_policy == AddFillPolicy.COMPLETE or not elim_last
    assert len(sparse_elim_ranges) != 1
    given_elim_end = sparse_elim_ranges[-1] if sparse_elim_ranges else 0
    if sparse_elim_ranges:
        assert is_strictly_increasing(sparse_elim_ranges)
        for i in elim_last:
            assert i >= given_elim_end

    if settings.add_fill_policy != AddFillPolicy.NONE:
        for e in range(len(sparse_elim_ranges) - 1):
            ss = ss.add_independent_elimination_fill(
                sparse_elim_ranges[e], sparse_elim_ranges[e + 1])

    if settings.add_fill_policy in (AddFillPolicy.NONE,
                                    AddFillPolicy.FOR_GIVEN_ELIMS):
        n = len(param_sizes)
        span_start = cum_sum_vec(param_sizes)
        lump_to_span = np.arange(n + 1, dtype=np.int64)
        permutation = np.arange(n, dtype=np.int64)
        sst = ss.transpose()  # CSC columns of the lower half
        skel = CoalescedBlockMatrixSkel(span_start, lump_to_span,
                                        sst.ptrs, sst.inds,
                                        pad_fn=_pad_fn_for(settings))
        cfut = 0 if settings.add_fill_policy == AddFillPolicy.NONE \
            else given_elim_end
        return Solver(skel, sparse_elim_ranges, permutation,
                      settings.backend, cfut, device=device)

    ss_bottom = ss.extract_right_bottom(given_elim_end)
    perm = _bottom_permutation(settings, ss, ss_bottom, given_elim_end,
                               len(param_sizes))
    no_cross_points = []
    if elim_last:
        parts = ([], [])
        for p in perm:
            parts[int((p + given_elim_end) in elim_last)].append(int(p))
        no_cross_points.append(len(parts[0]))
        perm = np.array(parts[0] + parts[1], dtype=np.int64)
    inv_perm = inverse_permutation(perm)
    sorted_ss_bottom = ss_bottom.symmetric_permutation(inv_perm,
                                                      lower_half=True)
    sorted_bottom_param_size = np.empty(len(param_sizes) - given_elim_end,
                                        dtype=np.int64)
    sorted_bottom_param_size[inv_perm] = param_sizes[given_elim_end:]

    comp_model = settings.computation_model
    et = EliminationTree(sorted_bottom_param_size, sorted_ss_bottom,
                         comp_model)
    et.build_tree()
    et.process_tree(settings.find_sparse_elimination_ranges, no_cross_points,
                    settings.add_fill_policy == AddFillPolicy.FOR_AUTO_ELIMS)

    # Op-overhead-bound regime handling (PLANNED backend): when the bottom
    # system merges down to a handful of lumps, per-XLA-op launch/schedule
    # overhead — not flops — dominates the factor and especially the solve
    # (each lump level is a sequential op chain). The per-node polynomial
    # model cannot express this (its constant terms charge per NODE, while
    # batched execution charges per BUCKET), so in that regime we generate
    # alternative merge CANDIDATES by scaling the model's constant terms
    # (constants represent dispatch overhead; scaling asks "what if each
    # node carried the whole chain's overhead") and SELECT by the
    # batched-regime cost evaluator (_batched_factor_cost, measured v5e
    # constants). The candidates re-run only the merge phase — the symbolic
    # fill from build_tree is reused (et.remerge), so the expensive part of
    # the analysis is not repeated. Applies to user-provided models too:
    # candidate generation scales WHATEVER model is in effect. Measured on
    # v5e: flat1000 32 lumps/3 levels -> 2 lumps/2 levels, factor 15.7 ->
    # 5.2 ms; grid/meridian/BA-scale problems keep >100 lumps and never
    # enter this path.
    n_bottom_lumps = len(et.lump_to_span) - 1
    n_auto_elim = (et.sparse_elim_ranges[-1] if et.sparse_elim_ranges
                   else 0)
    if (settings.backend == BackendType.PLANNED
            and n_auto_elim == 0 and 2 < n_bottom_lumps <= 64):
        from .computation_model import scale_constant_terms
        find_elims = settings.find_sparse_elimination_ranges
        only_elims = settings.add_fill_policy == AddFillPolicy.FOR_AUTO_ELIMS
        pad_fn = _pad_fn_for(settings)
        base = et.comp_model
        et.compute_aggregate_struct(only_elims)
        best = et.capture_merge_state()
        best_cost = _batched_factor_cost(et, pad_fn)
        for scale in (8.0, 64.0):
            et.remerge(scale_constant_terms(base, scale), find_elims,
                       no_cross_points, only_elims)
            if (len(et.lump_to_span) - 1 >= len(best["lump_to_span"]) - 1
                    or et.sparse_elim_ranges):
                continue  # not a coarser candidate
            et.compute_aggregate_struct(only_elims)
            cost = _batched_factor_cost(et, pad_fn)
            if cost < best_cost:
                best, best_cost = et.capture_merge_state(), cost
        et.restore_merge_state(best)
    else:
        et.compute_aggregate_struct(
            settings.add_fill_policy == AddFillPolicy.FOR_AUTO_ELIMS)

    et_total_inv_perm = compose_permutations(et.perm_inverse, inv_perm)
    full_inv_perm = np.concatenate([
        np.arange(given_elim_end, dtype=np.int64),
        given_elim_end + et_total_inv_perm])

    # Order each given sparse-elim range by padded panel SHAPE first, then
    # by its members' connected rows' positions in the FINAL ordering (any
    # order within an independent range is a valid elimination order with
    # identical fill). The shape-major key makes every (padded rows,
    # padded width) class one consecutive run of lumps — and hence of
    # panel STORAGE — so the planned backend's batched panel reads become
    # reshapes of contiguous slices instead of per-panel gathers (measured
    # 190 ms of pure gather/scatter on the 50k-landmark Schur level,
    # ~5 ns/element vs HBM's ~0.005). The locality minor key keeps
    # same-neighborhood members adjacent WITHIN a shape class (BA:
    # landmarks sorted by camera) — and since buckets group by shape, the
    # chunked dense update sees the exact same member order as a pure
    # locality sort. The reference's CPU/GPU sparse elimination is
    # insensitive to all of this (per-row chains / atomics,
    # MatOpsCuda.cu:309); batched XLA execution is not.
    if sparse_elim_ranges:
        sst_cols = ss.transpose()  # lower-half columns: rows >= col
        col_of = np.repeat(np.arange(len(param_sizes), dtype=np.int64),
                           sst_cols.ptrs[1:] - sst_cols.ptrs[:-1])
        pad_fn = _pad_fn_for(settings)
        for e in range(len(sparse_elim_ranges) - 1):
            a, b = sparse_elim_ranges[e], sparse_elim_ranges[e + 1]
            sel = (col_of >= a) & (col_of < b) & (sst_cols.inds > col_of)
            cols = col_of[sel] - a
            vals = full_inv_perm[sst_cols.inds[sel]]
            keys = np.full(b - a, np.int64(1) << 60)
            if len(cols):
                uniq, start_idx = np.unique(cols, return_index=True)
                keys[uniq] = np.minimum.reduceat(vals, start_idx)
            if pad_fn is not None:
                # per-member below rows = total size of connected rows
                # (independent range: no internal edges, no fill lands in
                # these columns, no merging — matches the skeleton's
                # storage_pad input exactly)
                rows_tot = np.bincount(
                    cols, weights=param_sizes[sst_cols.inds[sel]],
                    minlength=b - a).astype(np.int64)
                prp, cp = pad_fn(rows_tot, param_sizes[a:b])
                order = np.lexsort((keys, prp, cp))
            else:
                order = np.argsort(keys, kind="stable")
            full_inv_perm[a:b] = a + inverse_permutation(order)

    full_span_start = np.zeros(len(param_sizes), dtype=np.int64)
    full_span_start[full_inv_perm] = param_sizes
    full_span_start = cum_sum_vec(full_span_start)

    full_lump_to_span = np.concatenate([
        np.arange(given_elim_end, dtype=np.int64),
        given_elim_end + et.lump_to_span])
    assert len(full_span_start) - 1 == full_lump_to_span[-1]

    sorted_sst = ss.symmetric_permutation(full_inv_perm,
                                          lower_half=True).transpose()
    elim_end_data_ptr = int(sorted_sst.ptrs[given_elim_end])
    full_col_start = np.concatenate([
        sorted_sst.ptrs[:given_elim_end],
        elim_end_data_ptr + et.col_start])
    full_row_param = np.concatenate([
        sorted_sst.inds[:elim_end_data_ptr],
        given_elim_end + et.row_param])
    assert len(full_col_start) == len(full_lump_to_span)
    assert len(full_row_param) == full_col_start[-1]

    full_ranges = list(sparse_elim_ranges)
    if et.sparse_elim_ranges:
        skip = 1 if sparse_elim_ranges else 0
        full_ranges += [given_elim_end + r
                        for r in et.sparse_elim_ranges[skip:]]
    if len(full_ranges) == 1:
        full_ranges = []
    full_elim_end = full_ranges[-1] if full_ranges else 0

    skel = CoalescedBlockMatrixSkel(full_span_start, full_lump_to_span,
                                    full_col_start, full_row_param,
                                    pad_fn=_pad_fn_for(settings))

    cfut = (full_elim_end
            if settings.add_fill_policy == AddFillPolicy.FOR_AUTO_ELIMS
            else len(param_sizes))
    return Solver(skel, full_ranges, full_inv_perm, settings.backend, cfut,
                  device=device)
