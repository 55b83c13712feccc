"""Per-op timing stats, profiling on the card's kernels, and the fit of
the computation model (port of baspacho_tpu/stats.py).

The reference wraps every backend op in an RAII timer (MatOps.h:84-101,
Utils.h:49-121) and can dump per-op (shape, time) records that its
`opt_comp_model` tool fits into a ComputationModel, which calibrates the
supernode-merge heuristic. Here the coarse stats (whole factor and solve
calls) are collected by Solver.enable_stats(); `profile_factor` and
`profile_solve` run the PLANNED schedule level by level and time each
piece of a bucket on the kernels themselves (ops/kernels.py), from
restored operands (a bucket's own panels copied back before each run),
as (op, a, b, c, seconds) records;
`fit_computation_model` least-squares fits the polynomial models from
such records.

`SolverStats` and `fit_computation_model` are the JAX package's, line
for line. The timer is the port's own: on a CUDA device each run of a
piece is bracketed by CUDA events behind a `torch.cuda._sleep` that
keeps the card busy while the host queues the run, so that the window
holds device time alone; on the CPU, `perf_counter` around the twin.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from .computation_model import ComputationModel
from .ops import kernels
from .ops.planned_backend import PlannedBackend, factor_input
from .utils import OpStat


@dataclass
class SolverStats:
    factor: OpStat = field(default_factory=OpStat)
    solve_l: OpStat = field(default_factory=OpStat)
    solve_lt: OpStat = field(default_factory=OpStat)
    add_mv: OpStat = field(default_factory=OpStat)
    # per-op categories (reference MatOps.h:84-101 keeps potrf/trsm/syge/
    # asmbl OpStats on the symbolic ctx); populated by the profiling mode
    # (Solver.profile_ops)
    potrf: OpStat = field(default_factory=OpStat)
    trsm: OpStat = field(default_factory=OpStat)
    syge: OpStat = field(default_factory=OpStat)
    asmbl: OpStat = field(default_factory=OpStat)
    # per-stage solve stats (reference MatOps.h:84-101 keeps 8 solve-stage
    # OpStats: sparse-elim L/Lt, diag solve L/Lt, gemv/gemvT, vector
    # assemble/assembleT); populated by Solver.profile_solve_ops
    sparse_elim_solve_l: OpStat = field(default_factory=OpStat)
    sparse_elim_solve_lt: OpStat = field(default_factory=OpStat)
    solve_diag_l: OpStat = field(default_factory=OpStat)
    solve_diag_lt: OpStat = field(default_factory=OpStat)
    gemv: OpStat = field(default_factory=OpStat)
    gemv_t: OpStat = field(default_factory=OpStat)
    assemble_vec: OpStat = field(default_factory=OpStat)
    assemble_vec_t: OpStat = field(default_factory=OpStat)

    def _all(self):
        return (self.factor, self.solve_l, self.solve_lt, self.add_mv,
                self.potrf, self.trsm, self.syge, self.asmbl,
                self.sparse_elim_solve_l, self.sparse_elim_solve_lt,
                self.solve_diag_l, self.solve_diag_lt, self.gemv,
                self.gemv_t, self.assemble_vec, self.assemble_vec_t)

    def enable(self, enabled: bool = True):
        for s in self._all():
            s.enabled = enabled

    def reset(self):
        for s in self._all():
            s.reset()

    def record_profile(self, records) -> None:
        """Aggregate per-op profile records (see profile_factor /
        profile_solve) into the per-op OpStat counters — the reference's
        printStats layout."""
        by = {"potrf": self.potrf, "trsm": self.trsm, "syge": self.syge,
              "asmbl": self.asmbl,
              "sparseElimSolveL": self.sparse_elim_solve_l,
              "sparseElimSolveLt": self.sparse_elim_solve_lt,
              "solveL": self.solve_diag_l, "solveLt": self.solve_diag_lt,
              "gemv": self.gemv, "gemvT": self.gemv_t,
              "assembleVec": self.assemble_vec,
              "assembleVecT": self.assemble_vec_t}
        for op, a, b, c, t in records:
            st = by.get(op)
            if st is not None:
                was = st.enabled
                st.enabled = True
                st.record(t)
                st.enabled = was

    def __str__(self):
        out = (f"Solver timings:\n  factor: {self.factor}\n"
               f"  solveL: {self.solve_l}\n  solveLt: {self.solve_lt}\n"
               f"  addMv: {self.add_mv}")
        if any(s.num_runs for s in (self.potrf, self.trsm, self.syge,
                                    self.asmbl)):
            out += (f"\nPer-op (profiled):\n  potrf: {self.potrf}\n"
                    f"  trsm: {self.trsm}\n  syge: {self.syge}\n"
                    f"  asmbl: {self.asmbl}")
        solve_stats = (("sparseElimSolveL", self.sparse_elim_solve_l),
                       ("sparseElimSolveLt", self.sparse_elim_solve_lt),
                       ("solveL", self.solve_diag_l),
                       ("solveLt", self.solve_diag_lt),
                       ("gemv", self.gemv), ("gemvT", self.gemv_t),
                       ("assembleVec", self.assemble_vec),
                       ("assembleVecT", self.assemble_vec_t))
        if any(s.num_runs for _, s in solve_stats):
            out += "\nPer-solve-stage (profiled):"
            for name, s in solve_stats:
                out += f"\n  {name}: {s}"
        return out


# the least time a record holds: a difference of two timed calls below it
# (run-to-run spread on a tiny piece) is raised to it, as the JAX
# package's null-op subtraction does
MIN_RECORD_S = 1e-7


class ProfileRecords(list):
    """The (op, a, b, c, seconds) records of a profile, with `clamped`,
    the number of differences raised to MIN_RECORD_S, and `output`, what
    the replay of the schedule produced: the factored buffer (equal to
    Solver.factor(data) bit for bit) or the solution."""

    clamped: int = 0
    output = None


class _Timer:
    """Median seconds of a call over `reps` runs after one warm-up, the
    operands the call writes restored before each run, outside the timed
    window. On a CUDA device each run waits behind torch.cuda._sleep,
    sized from the warm-up's host time, so that the card is still busy
    while the host queues the start event, the call and the end event:
    the window then holds only the call's device time. All runs are read
    after one synchronise. On the CPU, perf_counter around each run."""

    SLEEP_MARGIN_S = 50e-6   # beyond twice the call's host time
    MAX_SLEEP_S = 0.02

    def __init__(self, device: torch.device, reps: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self.reps = max(1, int(reps))
        self.clamped = 0
        if self.cuda:
            self.cycles_per_s = _sleep_rate(device)

    def __call__(self, restore: Callable, call: Callable) -> float:
        restore()
        t0 = time.perf_counter()
        call()
        host_s = time.perf_counter() - t0
        if not self.cuda:
            ts = []
            for _ in range(self.reps):
                restore()
                t0 = time.perf_counter()
                call()
                ts.append(time.perf_counter() - t0)
            return float(np.median(ts))
        sleep_s = min(2 * host_s + self.SLEEP_MARGIN_S, self.MAX_SLEEP_S)
        cycles = int(sleep_s * self.cycles_per_s)
        marks = []
        for _ in range(self.reps):
            restore()
            torch.cuda._sleep(cycles)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            marks.append((start, end))
        torch.cuda.synchronize(self.device)
        return float(np.median([s.elapsed_time(e) for s, e in marks])) * 1e-3

    def diff(self, t_whole: float, t_part: float) -> float:
        """t_whole - t_part, raised to MIN_RECORD_S (counted)."""
        d = t_whole - t_part
        if d < MIN_RECORD_S:
            self.clamped += 1
            return MIN_RECORD_S
        return d


def _sleep_rate(device: torch.device) -> float:
    """torch.cuda._sleep's cycles per second on the device, from CUDA
    events around one sleep of 2^22 cycles (after a short one)."""
    n = 1 << 22
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(n)
    end.record()
    end.synchronize()
    return n / (start.elapsed_time(end) * 1e-3)


def _planned(solver) -> PlannedBackend:
    if not isinstance(solver.backend, PlannedBackend):
        raise ValueError("profiling times the PLANNED backend's kernels "
                         "piece by piece; this solver runs the "
                         f"{solver.backend_type.name} backend")
    return solver.backend


def _device_scope(device: torch.device):
    """The device's context on a card (its current stream then times and
    runs every piece), none on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else \
        contextlib.nullcontext()


def profile_factor(solver, data, reps: int = 5) -> ProfileRecords:
    """Time each piece of each bucket of the PLANNED factor schedule on
    the solver's device, level by level, from restored operands.

    Returns ProfileRecords of (op, a, b, c, seconds), per bucket of B
    panels (cp, rp padded):
      potrf (cp, B, 0)        K1 at rp = 0: the Cholesky / inverse grid,
                              which cp alone chooses (K1-wide at rp = 0
                              for a wide bucket)
      trsm  (cp, rp * B, 0)   K1 without the product (diagonal and below
                              rows) minus the rp = 0 call (K1-wide's
                              whole call minus its rp = 0 call)
      syge  (rp, rp, cp * B)  pair levels only: K1's whole call minus the
                              call without the product (wide buckets
                              have none: their levels go dense)
    and per level
      asmbl (npairs, nel, 0)     K2 over the level's block pairs: nel is
                                 the elements it subtracts (the JAX
                                 package counts its padded scatter
                                 windows, equal where a level has at most
                                 24 pair shapes)
      dense_upd (R, n, 0)        K4 on a dense level: R compact rows, n
                                 the port's own count of K4 records (one
                                 per destination, narrow origin and
                                 k-slice, plus the wide origins' tiles;
                                 the JAX package counts its slices)
    Before each run a bucket's piece gets back its panels: the span of
    the buffer that holds them is copied from a copy of the level's span
    taken when the level starts. The copy leaves the panels in the L2
    cache where they fit, as the previous level's update leaves them in
    the factor; a copy of the whole buffer before each run instead left
    GRID 100x100's large panels out of it, and its potrf records well
    over the factor's chol grids (tools/stats_timer_probe.py times both
    restores). The level's update is timed from a copy of the whole
    buffer (its targets lie anywhere after the level).
    A difference below MIN_RECORD_S is raised to it and counted in
    `clamped`. After its pieces are timed, each level runs as
    make_factor runs it, so that later levels are profiled on real data;
    `output` is that replay, equal to solver.factor(data) bit for bit.
    The per-sample shapes feed fit_computation_model."""
    be = _planned(solver)
    data = solver._as_tensor(data)
    solver._check_data(data)
    batched = data.ndim == 2
    dev, nl = solver.device, solver.skel.num_lumps
    out = ProfileRecords()
    with _device_scope(dev):
        timer = _Timer(dev, reps)
        levels = be._factor_levels(0, nl, dev)
        ext = factor_input(data if batched else data[None], be._pad_idx(dev))
        for level in levels:
            buckets, csr, dense = level.buckets, level.csr, level.dense
            prod = be._level_prod(ext, level)
            if buckets:
                lo, hi = _panel_span(buckets)
                pre = ext[:, lo:hi].clone()
                for b in buckets:
                    blo, bhi = _panel_span([b])

                    def restore(dst=ext[:, blo:bhi],
                                src=pre[:, blo - lo:bhi - lo]):
                        dst.copy_(src)
                    out.extend(_bucket_records(timer, restore, ext,
                                               prod, b))
                ext[:, lo:hi].copy_(pre)
                del pre
            be._factor_buckets(ext, prod, level, kernels)
            if (csr is not None and csr.n_tgt) or dense is not None:
                mid = ext.clone()

                def restore_mid(src=mid):
                    ext.copy_(src)
                t = timer(restore_mid, lambda: be._level_update(
                    ext, prod, level, kernels))
                if dense is not None:
                    n = int(dense.rec.shape[0] + dense.w_tile.shape[0])
                    out.append(("dense_upd", dense.R, n, 0, t))
                else:
                    out.append(("asmbl", level.pairs, level.elements, 0,
                                t))
                restore_mid()
                del mid
            be._level_update(ext, prod, level, kernels)
    out.clamped = timer.clamped
    out.output = ext if batched else ext[0]
    return out


def _panel_span(buckets) -> Tuple[int, int]:
    """The range [lo, hi) of the buffer that holds the buckets' panels
    ((cp + rp) x cp elements from each offset)."""
    return (min(min(b.off_h) for b in buckets),
            max(max(b.off_h) + (b.cp + b.rp) * b.cp for b in buckets))


def _bucket_records(timer: _Timer, restore, ext, prod,
                    b) -> List[Tuple]:
    """potrf / trsm / syge records of one factor bucket (profile_factor)."""
    B = int(b.off.shape[0])

    def k1(rp, pr):
        if b.wide:
            kernels.wide_factor(ext, b.off, b.rows, b.cols, b.cp, rp,
                                b.off_h, b.cols_h)
        else:
            kernels.bucket_factor(ext, pr, b.off, b.rows, b.cols, b.cp, rp,
                                  b.prod_base)

    t_chol = timer(restore, lambda: k1(0, None))
    recs = [("potrf", b.cp, B, 0, t_chol)]
    if b.rp == 0:
        return recs
    t_below = timer(restore, lambda: k1(b.rp, None))
    recs.append(("trsm", b.cp, b.rp * B, 0, timer.diff(t_below, t_chol)))
    if prod is not None and not b.wide:
        t_all = timer(restore, lambda: k1(b.rp, prod))
        recs.append(("syge", b.rp, b.rp, b.cp * B,
                     timer.diff(t_all, t_below)))
    return recs


def solve_split(b) -> bool:
    """Whether profile_solve splits a bucket's diagonal solve from its
    below work by a call at rp = 0: only where that call launches no grid
    the real call does not. K3 chooses its layout from (cp, rp, B), and at
    rp = 0 any bucket of 4 <= cp <= 32 and SOLVE_WARP_PANELS panels or
    more passes the warp grid's rp * cp <= SOLVE_WARP_ELEMS; such a bucket
    whose real call runs the diag and rows grids (rp * cp >
    SOLVE_WARP_ELEMS) is not split. K3-wide's rp = 0 call runs a subset
    of its real call's grids, as K3's diag layout does."""
    if b.rp == 0:
        return False
    if b.wide:
        return True
    B = int(b.off.shape[0])
    warp = kernels.solve_layout(b.cp, b.rp, B)[0] == 0
    warp0 = kernels.solve_layout(b.cp, 0, B)[0] == 0
    return warp == warp0


def profile_solve(solver, factor_data, rhs, reps: int = 5) -> ProfileRecords:
    """Time each stage of the PLANNED solve (on a factor from
    profile_factor / Solver.factor, through the stored inverse) on the
    solver's device, level by level, from restored operands — the
    reference's solve-stage OpStats (MatOps.h:84-101). Returns
    ProfileRecords of (op, a, b, 0, seconds):
      solveL / solveLt (cp, B)     K3 / K3-wide of a bucket at rp = 0
                                   (sparseElimSolveL / Lt for a bucket
                                   of sparse-elimination lumps)
      gemv / gemvT (cp, rp * B)    the bucket's call as the solve makes
                                   it minus its rp = 0 call
      assembleVec (T, n)           K2 on a level's solve CSR: T target
                                   rows, n buckets with below rows (one
                                   record a level: the port scatters a
                                   whole level at once)
    A bucket that solve_split declines (K3's warp grid at rp = 0 only)
    records its whole call under the diagonal stage and no gemv / gemvT.
    assembleVecT has no launch of its own — K3's Lt pass gathers the
    below rows itself — and no record. `output` is the replayed solution,
    equal to solver.solve(factor_data, rhs) bit for bit."""
    be = _planned(solver)
    nl = solver.skel.num_lumps
    data = solver._as_tensor(factor_data)
    v = solver._as_tensor(rhs)
    solver._check_data(data)
    batched, vec1d = solver._check_vec(data, v)
    if vec1d:
        v = v[..., None]
    if not batched:
        data, v = data[None], v[None]
    data = data.contiguous()
    dev = solver.device
    out = ProfileRecords()
    with _device_scope(dev):
        timer = _Timer(dev, reps)
        levels = be._solve_levels(0, nl, dev)
        vv = v.clone(memory_format=torch.contiguous_format)

        def stage(b, elim, y, base, transpose, restore):
            diag = ("sparseElimSolve" if elim else "solve") + \
                ("Lt" if transpose else "L")
            B = int(b.off.shape[0])

            def call(bk):
                return lambda: be._diag_solve(kernels, bk, True, data, vv, y,
                                              base, transpose)
            t = timer(restore, call(b))
            if not solve_split(b):
                return [(diag, b.cp, B, 0, t)]
            t0 = timer(restore, call(replace(b, rp=0)))
            return [(diag, b.cp, B, 0, t0),
                    ("gemvT" if transpose else "gemv", b.cp, b.rp * B, 0,
                     timer.diff(t, t0))]

        for level in levels:
            pre = vv.clone()
            y = be._level_y(vv, level)

            def restore(src=pre):
                vv.copy_(src)
            for b, elim, base in zip(level.buckets, level.elim,
                                     level.row_base):
                out.extend(stage(b, elim, y, base, False, restore))
            restore()
            be._l_buckets(level, True, data, vv, y, kernels)
            csr = level.csr
            if csr.n_tgt:
                mid = vv.clone()

                def restore_mid(src=mid):
                    vv.copy_(src)
                t = timer(restore_mid, lambda: be._l_scatter(level, vv, y,
                                                             kernels))
                out.append(("assembleVec", csr.n_tgt,
                            sum(b.rp > 0 for b in level.buckets), 0, t))
                restore_mid()
            be._l_scatter(level, vv, y, kernels)
        for level in reversed(levels):
            pre = vv.clone()

            def restore(src=pre):
                vv.copy_(src)
            for b, elim in zip(level.buckets, level.elim):
                out.extend(stage(b, elim, None, 0, True, restore))
            restore()
            be._lt_pass([level], True, data, vv, kernels)
    out.clamped = timer.clamped
    res = vv if batched else vv[0]
    out.output = res[..., 0] if vec1d else res
    return out


def fit_computation_model(records: List[Tuple]) -> ComputationModel:
    """Least-squares fit of the polynomial op models from profile records
    (the reference's opt_comp_model, examples/OptimizeCompModel.cpp,
    re-done as four small linear regressions with 1/sqrt(t) weighting)."""
    groups: Dict[str, List] = {"potrf": [], "trsm": [], "syge": [],
                               "asmbl": []}
    for op, a, b, c, t in records:
        if op in groups:  # other categories (dense_upd, solve stages)
            groups[op].append((a, b, c, t))

    def wlsq(X, t):
        """1/sqrt(t)-weighted NON-NEGATIVE least squares: the polynomial
        op models are physically nonnegative in every coefficient, and
        unconstrained fits on few/noisy samples produce negative constants
        that break the merge heuristic (reference fits with LM +
        eigendecomposition-guarded steps, OptimizeCompModel.cpp:64-295;
        NNLS is the simpler guarantee)."""
        from scipy.optimize import nnls
        w = 1.0 / np.sqrt(np.maximum(t, 1e-9))
        sol, _ = nnls(X * w[:, None], t * w)
        return sol

    out = {}
    g = np.array(groups["potrf"] or [(8, 1, 0, 1e-5)])
    # batched ops: time per single instance ~ t / B
    out["potrf"] = wlsq(ComputationModel.d_potrf(g[:, 0]),
                        g[:, 3] / np.maximum(g[:, 1], 1))
    g = np.array(groups["trsm"] or [(8, 8, 0, 1e-5)])
    out["trsm"] = wlsq(ComputationModel.d_trsm(g[:, 0], g[:, 1]), g[:, 3])
    g = np.array(groups["syge"] or [(8, 8, 8, 1e-5)])
    out["syge"] = wlsq(ComputationModel.d_syge(g[:, 0], g[:, 1], g[:, 2]),
                       g[:, 3])
    g = np.array(groups["asmbl"] or [(1, 16, 0, 1e-5)])
    out["asmbl"] = wlsq(ComputationModel.d_asmbl(g[:, 0], g[:, 1]),
                        g[:, 3])
    return ComputationModel(potrf_params=out["potrf"],
                            trsm_params=out["trsm"],
                            syge_params=out["syge"],
                            asmbl_params=out["asmbl"])
