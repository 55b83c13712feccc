"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/, holds each against its
plain PyTorch twin on the card at every bucket shape of the main path,
and drives the planned factor + solve (create_solver -> Solver.factor
-> Solver.solve) on the reference's benchmark problems:

  MERI n=7     single f64 and f32, batch 16 (K1, K2, K3; the partial
               ops batched too)
  GRID 100x100 single f64, against the port's CPU twins
  FLAT n=1000  single f64 and f32, batch 8: one 3,000-wide supernode
               (K1-wide, K3-wide) under a narrow one (K1, K2, K3)
  FLAT+Schur   5k and 50k: every kernel against its twin; 50k (order
               153,000): single f64 and f32, a 50,000-origin dense
               level (K1 without products, K4), residuals from sparse
               products, timed without twins
  GRID         once more with every level forced dense, K4 against its
               twin on compact spaces of up to 15,411 rows
  WIDE_BELOW   a 540-wide lump (padded 1024) with 64 padded below rows
               on a dense level: K1-wide's below rows, K3-wide's below
               products and gather, K4 on a wide origin
  K3-rest wide against its twin and itself on the 50k corner (cp 3072)
               and WIDE_BELOW (cp 1024, below rows), f64 and f32, nrhs 1
               and 3, batch 2; at most 3 grids per call, in the traces
  K4 per level on every dense level of FLAT+Schur 50k and BAL 871 (its
               point level and the two wide camera levels): against its
               twin (f64, f32), against itself, timed, its bound
  partial      factor_up_to / factor_from / the four partial solves on
               MERI, GRID (against the CPU twins) and FLAT+Schur 50k
  PCG          the mixed direct/iterative solve on FLAT+Schur 50k, f64,
               with each of the four preconditioners: factor_up_to(t =
               50,000) -> solve_l_up_to -> preconditioner init -> pcg with
               add_mv_from(t) as the operator -> solve_lt_up_to (K3-rest,
               K5, the pseudo-factor, an f32 corner factor); residuals of
               the full system from K5 and from a sparse product
  refined      an f32 factor of FLAT+Schur 50k and solve_refined with
               f64 residuals through K5
  diff_solve   the differentiable solve on MERI against a central
               difference; check_factor
  SE3 BA       the LM optimizer's assembled gradient and Hessian (K6)
               against J^T r and J^T J computed densely; the demo twins
               (baspacho_tpu_torch/examples) on the default device
  BAL 871      LM on the 871-camera, 527,480-point scene (2,637,400
               observations, order 1,590,279), f64, PLANNED, through
               build_ba_optimizer -> build_solver -> optimize: directly
               (3 iterations) and with the partial factor + PCG and
               BlockJacobi (2), counted, host ms per stage, the costs and
               PCG iterations held to BAL_COSTS / BAL_PCG_ITERS; the first
               damped system's residuals; a bitwise rerun; K6 against
               its twin (f64, f32) and itself, timed, traced
  K1 per level on MERI, GRID and BAL 871's pair levels (k1_levels): each
               call against its twin (f64, f32), batched and rerun
               bitwise, each grid's device ms from a complete trace
               beside its bound and a library yardstick the port never
               calls; on a panel that is not positive definite
               (k1_not_pd), NaN in L and x from the failing column on
  K5 per bucket (k5_levels, last) of BAL 871's PCG operator
               add_mv_from(t) and of add_mv_from(0), and of FLAT+Schur
               50k's two: against its twin (f64 at nrhs 1 and 3, f32),
               batched and rerun bitwise, ms by events, device ms per grid
               from complete traces, bounds, torch.sparse.mm on the
               bucket's own sparse matrix (a yardstick the port never
               calls); the pcg stage of BAL's first damped system, 10
               iterations, traced (device ms per kernel, idle share)

  K1-wide per call (k1w_levels, after k1_levels) on FLAT's cp-3072 panel,
               Schur 50k's corner, WIDE_BELOW and BAL 871's camera levels
               (cp 1024, 3072 and 4096): against its twin (f64, f32),
               batched and rerun bitwise, ms by events, device ms per grid
               from complete traces, bounds, and cholesky_ex +
               solve_triangular per panel, a yardstick the port never
               calls; on panels that are not positive definite
               (k1_not_pd), NaN from the failing column on

  K3 per bucket and pass (k3_levels, after k5_levels) of one solve of
               MERI, GRID, FLAT, FLAT+Schur 50k and BAL 871's first damped
               system: against its twin (f64 at nrhs 1 and 3, f32),
               batched and rerun bitwise, ms by events, device ms per grid
               from complete traces, bounds, torch.sparse.mm with the
               bucket's below block as CSR (a yardstick the port never
               calls; the n x n product left out)
  K3-wide per bucket and pass (k3w_levels, after k3_levels) of one solve
               of FLAT, FLAT+Schur 50k, WIDE_BELOW and BAL 871's first
               damped system: as k3_levels, with per panel
               torch.linalg.solve_triangular (and, with below rows,
               torch.matmul with the below block) as the yardstick
  K2 per call (k2_levels, after k5_levels) of MERI's, GRID's and BAL
               871's factors (width 1), the L pass of BAL's and FLAT+Schur
               50k's solves (nrhs 1 and 3) and BAL's PCG operator
               add_mv_from(t): against its twin (f64, f32), batched and
               rerun bitwise, ms by events, device ms per grid from a
               complete trace, bounds, index_add_ (a yardstick the port
               never calls)
  K3-rest narrow per bucket and pass (k3r_levels, after k2_levels) of
               the partial solves of MERI and GRID (up to and from their
               split, and on the pseudo-factor), FLAT+Schur 50k (up to t
               = 50,000) and BAL 871 (up to its points, the PCG LM
               path; from its cameras on the pseudo-factor): as
               k3_levels, with batched torch.linalg.solve_triangular on
               the bucket's lower blocks as the yardstick
  K6 per family (k6_levels, last) of BAL 871's first assembly: against
               its twin (f64, f32) and a rerun, bitwise, ms by events,
               device ms per grid from a complete trace, the bounds of its
               short and long parts

With `--only k5` it builds the kernels and runs K5's phases alone (BAL
871's set-up and damped system, the PCG trace, k5_levels) and prints no
last line; with `--only k1w`, K1-wide's (k1_not_pd, BAL 871's direct LM
costs, k1w_levels); with `--only k3`, K3's (k3_levels, BAL 871's direct
LM costs); with `--only k6`, K6's (k6_levels, BAL 871's direct LM
costs); with `--only k3w`, K3-wide's (k3w_levels, BAL 871's direct LM
costs); with `--only k1`, K1's (k1_not_pd, k1_levels on MERI, GRID and
BAL 871, BAL 871's direct LM costs); with `--only k2`, K2's (k2_levels,
BAL 871's direct and PCG LM costs); with `--only k3r`, K3-rest
narrow's (k3r_levels, the same costs). Every run first checks that the
native symbolic library loads (baspacho_tpu_torch/native.py builds it
under a lock), and fails if it does not.

It checks the results, times the kernels against their twins (and,
where one PyTorch call computes the same function, against that call)
with CUDA events beside each kernel's bound (the larger of the bytes it
must move over 3.35 TB/s and its operations over 67 TFLOP/s), and reads
torch.profiler traces of the card for the device time per CUDA kernel
and the device's idle share. One line per phase; the
line before the last two holds the per-kernel JSON record, the next the
card's name and power limit; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed check raises, and the script exits non-zero without that
line. Without a CUDA device it refuses to run. It imports neither jax
nor baspacho_tpu.
"""

from __future__ import annotations

import copy
import functools
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

import baspacho_tpu_torch as T
from baspacho_tpu_torch import native
from baspacho_tpu_torch.ops import kernels
from baspacho_tpu_torch.ops.planned_backend import PlannedBackend
from baspacho_tpu_torch.ops.schedule import NARROW_MAX
from baspacho_tpu_torch.testing.flows import (ba_optimizer, ba_settings,
                                              dense_normal_equations,
                                              k6_vs_twin, pcg_flow)
from baspacho_tpu_torch.testing.problems import (flat1000, flat_schur5k,
                                                 flat_schur50k, grid100,
                                                 meri7, se3_ba, spd_data,
                                                 wide_below)

_PB = "baspacho_tpu/ops/planned_backend.py"
KERNELS = [
    ("bucket_factor", "baspacho_tpu_torch/csrc/bucket_factor.cu",
     f"{_PB}:1423"),
    ("wide_factor", "baspacho_tpu_torch/csrc/wide_factor.cu", f"{_PB}:1277"),
    ("segmented_subtract", "baspacho_tpu_torch/csrc/segmented_subtract.cu",
     f"{_PB}:1466"),
    ("bucket_solve", "baspacho_tpu_torch/csrc/bucket_solve.cu",
     f"{_PB}:2134"),
    ("wide_solve", "baspacho_tpu_torch/csrc/wide_solve.cu", f"{_PB}:2118"),
    ("dense_update", "baspacho_tpu_torch/csrc/dense_level.cu",
     f"{_PB}:1644"),
    ("tri_solve", "baspacho_tpu_torch/csrc/tri_solve.cu", f"{_PB}:2105"),
    ("wide_tri_solve", "baspacho_tpu_torch/csrc/tri_solve.cu",
     f"{_PB}:1192"),
    ("add_mv", "baspacho_tpu_torch/csrc/add_mv.cu", f"{_PB}:3078"),
    ("wide_add_mv", "baspacho_tpu_torch/csrc/add_mv.cu", f"{_PB}:3078"),
    ("grad_hess", "baspacho_tpu_torch/csrc/grad_hess.cu",
     "baspacho_tpu/optimizer/optimizer.py:334"),
]
NAMES = [k for k, _, _ in KERNELS]
# the __global__ functions each wrapper launches (csrc/*.cu)
GRIDS = {"bucket_factor": ("chol_warp_kernel", "chol_block_kernel",
                           "below_warp_kernel", "below_tile_kernel",
                           "prod_entry_kernel", "prod_tile_kernel"),
         "wide_factor": ("wide_tile_kernel", "wide_rows_kernel",
                         "wide_update_kernel"),
         "segmented_subtract": ("seg_short_kernel", "seg_chunk_kernel",
                                "seg_post_kernel"),
         "bucket_solve": ("solve_l_warp_kernel", "solve_lt_warp_kernel",
                          "solve_l_diag_kernel", "solve_lt_diag_kernel",
                          "solve_l_rows_kernel", "solve_lt_rows_kernel"),
         "wide_solve": ("wide_l_tile_kernel", "wide_l_post_kernel",
                        "wide_l_y_kernel", "wide_lt_rows_kernel",
                        "wide_lt_post_kernel", "wide_ltmv_kernel"),
         "dense_update": ("dense_wide_kernel", "dense_warp_kernel",
                          "dense_block_kernel"),
         "tri_solve": ("tri_l_warp_kernel", "tri_lt_warp_kernel",
                       "tri_l_diag_kernel", "tri_lt_diag_kernel",
                       "tri_l_rows_kernel", "tri_lt_rows_kernel"),
         "wide_tri_solve": ("tri_wide_pre_kernel", "tri_wide_chain_kernel",
                            "tri_wide_post_kernel"),
         "add_mv": ("mv_warp_kernel", "mv_chunk_kernel", "mv_post_kernel"),
         "wide_add_mv": ("wide_mv_chunk_kernel", "wide_mv_post_kernel"),
         "grad_hess": ("gh_chunk_kernel", "gh_short_kernel",
                       "gh_post_kernel")}
# the grids of the earlier designs of K1's below, K2, K3, K3-wide,
# K3-rest narrow and K6 (PERF.md), so that k1_levels, k2_levels,
# k3_levels, k3w_levels, k3r_levels and k6_levels also time a checkout of
# them, beside these
EARLIER_GRIDS = {"bucket_factor": ("below_kernel",),
                 "segmented_subtract": ("seg_sub_kernel",),
                 "bucket_solve": ("solve_l_kernel", "solve_lt_kernel"),
                 "wide_solve": ("wide_lmv_kernel", "wide_lpost_kernel",
                                "wide_ltpre_kernel"),
                 "tri_solve": ("tri_l_kernel", "tri_lt_kernel"),
                 "grad_hess": ("gh_warp_kernel", "gh_block_kernel")}
PRECONDS = ("IdentityPrecond", "BlockJacobiPrecond",
            "BlockGaussSeidelPrecond", "LowerPrecSolvePrecond")
# the narrow K5 runs on the refined path: PCG's operator covers only the
# corner, one wide panel
_PCG_COMMON = {"bucket_factor", "dense_update", "tri_solve",
               "segmented_subtract", "wide_add_mv"}
# the wrappers each main path must launch
PATH_KERNELS = {
    "meri7": {"bucket_factor", "segmented_subtract", "bucket_solve"},
    "flat1000": {"bucket_factor", "wide_factor", "segmented_subtract",
                 "bucket_solve", "wide_solve"},
    "flat_schur50k": set(NAMES[:6]),
    "wide_below": set(NAMES[:6]),
    "pcg_IdentityPrecond": _PCG_COMMON,
    "pcg_BlockJacobiPrecond": _PCG_COMMON,
    "pcg_BlockGaussSeidelPrecond": _PCG_COMMON | {"wide_tri_solve"},
    "pcg_LowerPrecSolvePrecond": _PCG_COMMON | {"wide_tri_solve",
                                                "wide_factor"},
    "refined_schur50k": {"bucket_factor", "wide_factor", "dense_update",
                         "segmented_subtract", "bucket_solve", "wide_solve",
                         "add_mv", "wide_add_mv"},
    # LM on BAL 871: K6, then the factor (points on a dense level, pair
    # levels, wide corner lumps) and the solve, or the partial factor,
    # the up-to solves and the corner mat-vec
    "bal_lm_direct": {"grad_hess", "bucket_factor", "wide_factor",
                      "dense_update", "segmented_subtract", "bucket_solve",
                      "wide_solve"},
    "bal_lm_pcg": {"grad_hess", "bucket_factor", "dense_update",
                   "segmented_subtract", "tri_solve", "add_mv",
                   "wide_add_mv"},
}
# the LM runs on BAL 871 damp additively (the reference's lambda * (1 +
# diag)): the scene leaves camera 870 unobserved, a zero Hessian block
# that the JAX package's diag * (1 + lambda) leaves singular
BAL_DAMP = {"damp_additive": True}
# BAL 871's LM costs and PCG iterations as the kernels gave them before
# K1's grids were redesigned (PERF.md, on an H100): a redesigned kernel
# must reproduce them to 1e-9
BAL_COSTS = {"direct": (2637106.9562431723, 1842769.3256449024,
                        1842660.9311453684, 1842660.833483782),
             "pcg": (2637106.9562431723, 1842769.3998866011,
                     1842660.9490706287)}
BAL_PCG_ITERS = [80, 80]
# FLAT+Schur 50k's PCG iterations (tol 1e-12) with each preconditioner
SCHUR_PCG_ITERS = {"IdentityPrecond": 4, "BlockJacobiPrecond": 4,
                   "BlockGaussSeidelPrecond": 2, "LowerPrecSolvePrecond": 2}
# the problems k3_levels and k3w_levels solve, beside BAL 871
K3_PROBLEMS = ("meri7", "grid100", "flat1000", "flat_schur50k")
K3W_PROBLEMS = ("flat1000", "flat_schur50k", "wide_below")
# K1's grids (csrc/bucket_factor.cu) by the part of the factor they do
K1_PARTS = {"chol_warp_kernel": "chol", "chol_block_kernel": "chol",
            "below_warp_kernel": "below", "below_tile_kernel": "below",
            "prod_entry_kernel": "prod", "prod_tile_kernel": "prod",
            **{k: "below" for k in EARLIER_GRIDS["bucket_factor"]}}
# the per-call phases' traces of a call (complete_trace): at most this
# many, until one shows every grid of every run (late in a long run most
# first traces lose records and some calls needed 3 tries on an H100,
# chip call 9, PR 12; one tiny call lost records in 5)
K1_TRACE_TRIES = 8
# the fewest counted runs a retake halves them to
TRACE_MIN_REPS = 3
# the least time of a call: the larger of its bytes over the memory rate
# and its operations over the peak rate (NVIDIA H100 SXM data sheet: HBM3
# 3.35 TB/s; 67 TFLOP/s in f64 on the tensor cores and in f32 off them)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = 67e12
# kernel vs twin: the two sum in different orders and the stored inverse
# amplifies rounding
KERNEL_RTOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def rel_abs(got: torch.Tensor, want: torch.Tensor):
    diff = (got - want).abs().max().item() if want.numel() else 0.0
    scale = want.abs().max().item() if want.numel() else 0.0
    return (diff / scale if scale > 0 else diff), diff


class CheckedOps:
    """Runs each kernel call of a path beside its twin (on clones of the
    same inputs, on the card), records the error of the kernel against
    the twin over what the call wrote, and goes on with the kernel's
    result."""

    def __init__(self):
        self.rel = {name: 0.0 for name in NAMES}
        self.abs = {name: 0.0 for name in NAMES}
        self.shapes = set()

    def _note(self, name, got, want):
        r, a = rel_abs(got, want)
        self.rel[name] = max(self.rel[name], r)
        self.abs[name] = max(self.abs[name], a)

    def bucket_factor(self, data, prod, off, rows, cols, cp, rp, prod_base):
        d2 = data.clone()
        p2 = prod.clone() if prod is not None else None
        kernels.bucket_factor_twin(d2, p2, off, rows, cols, cp, rp,
                                   prod_base)
        kernels.bucket_factor(data, prod, off, rows, cols, cp, rp,
                              prod_base)
        idx = off[:, None] + torch.arange((cp + rp) * cp, device=off.device)
        self._note("bucket_factor", data[:, idx], d2[:, idx])
        if rp and prod is not None:
            sl = slice(prod_base, prod_base + off.shape[0] * rp * rp)
            self._note("bucket_factor", prod[:, sl], p2[:, sl])
        self.shapes.add(("factor", cp, rp, prod is not None))

    def wide_factor(self, data, off, rows, cols, cp, rp, off_h, cols_h):
        d2 = data.clone()
        kernels.wide_factor_twin(d2, off, rows, cols, cp, rp, off_h, cols_h)
        kernels.wide_factor(data, off, rows, cols, cp, rp, off_h, cols_h)
        idx = off[:, None] + torch.arange((cp + rp) * cp, device=off.device)
        self._note("wide_factor", data[:, idx], d2[:, idx])
        self.shapes.add(("wide_factor", cp, rp))

    def segmented_subtract(self, out, src, tgt, seg_ptr, src_idx, width,
                           **layout):
        o2 = out.clone()
        kernels.segmented_subtract_twin(o2, src, tgt, seg_ptr, src_idx,
                                        width)
        kernels.segmented_subtract(out, src, tgt, seg_ptr, src_idx, width,
                                   **layout)
        b = out.shape[0]
        self._note("segmented_subtract", out.view(b, -1, width)[:, tgt],
                   o2.view(b, -1, width)[:, tgt])

    def _solve(self, name, data, vv, y, y_base, off, rows, cols, vec_off,
               below_idx, cp, rp, transpose, *extra):
        v2 = vv.clone()
        y2 = y.clone() if y is not None else None
        getattr(kernels, f"{name}_twin")(data, v2, y2, y_base, off, rows,
                                         cols, vec_off, below_idx, cp, rp,
                                         transpose, *extra)
        getattr(kernels, name)(data, vv, y, y_base, off, rows, cols,
                               vec_off, below_idx, cp, rp, transpose, *extra)
        xr = torch.arange(cp, device=off.device)
        xidx = (vec_off[:, None] + xr)[xr < cols[:, None]]
        self._note(name, vv[:, xidx], v2[:, xidx])
        if y is not None and not transpose and rp:
            sl = slice(y_base, y_base + off.shape[0] * rp)
            self._note(name, y[:, sl], y2[:, sl])
        self.shapes.add((name, cp, rp))

    def bucket_solve(self, *args):
        self._solve("bucket_solve", *args)

    def wide_solve(self, *args):
        self._solve("wide_solve", *args)

    def tri_solve(self, *args):
        self._solve("tri_solve", *args)

    def wide_tri_solve(self, *args):
        self._solve("wide_tri_solve", *args)

    def _mv(self, name, data, x, out, y, y_base, off, rows, cols, vec_off,
            below_idx, cp, rp, alpha):
        o2 = out.clone()
        y2 = y.clone() if y is not None else None
        getattr(kernels, f"{name}_twin")(data, x, o2, y2, y_base, off, rows,
                                         cols, vec_off, below_idx, cp, rp,
                                         alpha)
        getattr(kernels, name)(data, x, out, y, y_base, off, rows, cols,
                               vec_off, below_idx, cp, rp, alpha)
        xr = torch.arange(cp, device=off.device)
        xidx = (vec_off[:, None] + xr)[xr < cols[:, None]]
        self._note(name, out[:, xidx], o2[:, xidx])
        if rp:
            sl = slice(y_base, y_base + off.shape[0] * rp)
            self._note(name, y[:, sl], y2[:, sl])
        self.shapes.add((name, cp, rp))

    def add_mv(self, *args):
        self._mv("add_mv", *args)

    def wide_add_mv(self, *args):
        self._mv("wide_add_mv", *args)

    def dense_update(self, data, d):
        # the update alone first, on a buffer that holds only the origins'
        # x blocks (the targets' values would dwarf it), then the path's
        z = torch.zeros_like(data)
        for cp, rp, a, b in d.groups:
            idx = (d.org_xoff[a:b, None] +
                   torch.arange(rp * cp, device=data.device)).reshape(-1)
            z[:, idx] = data[:, idx]
        z2 = z.clone()
        kernels.dense_update_twin(z2, d)
        kernels.dense_update(z, d)
        self._note("dense_update", z, z2)
        before = data.clone()
        d2 = data.clone()
        kernels.dense_update_twin(d2, d)
        kernels.dense_update(data, d)
        wrote = (data != before) | (d2 != before)
        self._note("dense_update", data[wrote], d2[wrote])
        self.shapes.add(("dense_update", d.R, int(d.sp_cs.shape[0])))


class DenseCapture:
    """The kernels, for a factor program, keeping at each dense level a
    copy of the data K4 starts from (with the level's plan)."""

    def __init__(self):
        self.levels = []

    def __getattr__(self, name):
        return getattr(kernels, name)

    def dense_update(self, data, d):
        self.levels.append((data.clone(), d))
        kernels.dense_update(data, d)


def k4_levels(s, data, label: str, name_limit: str) -> list:
    """K4 on every dense level of one factor of `data` (single, f64): the
    update against its twin in f64 and f32 (CheckedOps), two runs from
    the same data bitwise equal, its time (CUDA events, mean of 5 after 2
    warm-up runs), the twin's (one run), and its bound from this level's
    plan; on a level with wide origins, their tile launches alone
    timed too. Returns one row per dense level."""
    cap = DenseCapture()
    s.factor_program()(data[None], ops=cap)
    sched = s.backend._factor_schedule(0, s.skel.num_lumps)
    ids = [i for i, lv in enumerate(sched) if lv[3] is not None]
    check(len(ids) == len(cap.levels) > 0, f"{label}: dense levels {ids}, "
          f"K4 calls {len(cap.levels)}")
    rows = []
    for lvl, (snap, d) in zip(ids, cap.levels):
        row = {"level": lvl, "origins": int(d.org_xoff.shape[0]), "R": d.R,
               "records": int(d.rec.shape[0]),
               "destinations": int(d.dst_off.shape[0]),
               "long_destinations": int(d.dst_long.shape[0])}
        for dt in (torch.float64, torch.float32):
            chk = CheckedOps()  # on a copy: snap stays the input
            chk.dense_update(snap.to(dt, copy=True), d)
            r = chk.rel["dense_update"]
            check(r <= KERNEL_RTOL[dt], f"dense_update vs twin on {label} "
                  f"level {lvl} {dt}: rel {r}")
            row[f"max_rel_{str(dt)[6:]}"] = r
            row["max_abs"] = max(row.get("max_abs", 0.0),
                                 chk.abs["dense_update"])
            del chk
        a, b = snap.clone(), snap.clone()
        kernels.dense_update(a, d)
        kernels.dense_update(b, d)
        check(torch.equal(a, b), f"dense_update on {label} level {lvl}: "
              "two runs differ")
        del a, b
        buf = snap.clone()
        row["ms"] = time_ms(lambda: kernels.dense_update(buf, d), 5)
        if d.wide:  # the wide origins' tile launches alone
            wide = copy.copy(d)
            wide.dst_short, wide.dst_long = d.dst_short[:0], d.dst_long[:0]
            row["wide_ms"] = time_ms(lambda: kernels.dense_update(buf, wide),
                                     5)
            row["wide_origins"] = [{"rows": w[1], "width": w[2],
                                    "tiles": w[8]} for w in d.wide]
        row["twin_ms"] = time_ms(lambda: kernels.dense_update_twin(buf, d),
                                 1, warmup=1)
        row["bound_ms"], row["bound_by"] = bound(*cost("dense_update",
                                                       (buf, d)))
        rows.append(row)
        del buf, snap
    log("k4_levels", case=label, card=name_limit, dtype="float64",
        limits={"float64": 1e-10, "float32": 1e-4}, bitwise_rerun=True,
        ms_per_factor=sum(r["ms"] for r in rows), levels=rows)
    return rows


class K1Capture:
    """The kernels, for a factor program, keeping a copy of the panels of
    each K1 call of the given levels before the call (`seq`: the level of
    each K1 call in program order): the panels packed one after the
    other, a bucket of their own."""

    def __init__(self, seq, levels):
        self.seq, self.levels, self.calls = list(seq), set(levels), []

    def __getattr__(self, name):
        return getattr(kernels, name)

    def bucket_factor(self, data, prod, off, rows, cols, cp, rp, prod_base):
        lvl = self.seq.pop(0)
        if lvl in self.levels:
            idx = off[:, None] + torch.arange((cp + rp) * cp,
                                              device=off.device)
            self.calls.append((lvl, data[:, idx].reshape(data.shape[0], -1),
                               rows, cols, cp, rp, prod is not None))
        kernels.bucket_factor(data, prod, off, rows, cols, cp, rp, prod_base)


def k1_levels(s, data, label: str, name_limit: str) -> list:
    """K1 on every level of one factor of `data` (single, f64) that is not
    dense, each call's panels packed as a bucket of their own: against
    its twin in f64 and f32 (CheckedOps), a batch of two (the second
    item scaled) against single runs and a rerun, and the bucket moved
    one value on (off 16-byte alignment) against itself, bitwise; per
    level, the device ms of each K1 grid from a trace of the level's
    calls that shows every grid of every run (retaken up to
    K1_TRACE_TRIES times), the buckets as [cp, rp, panels, widest real
    width, most real below rows], each grid's bound (k1_costs), and
    three yardsticks the port never calls, timed with CUDA events on the
    same inputs (padding as the identity): torch.linalg.cholesky_ex then
    solve_triangular(L, I) on the (B, cp, cp) diagonals for chol,
    solve_triangular(L^T, below, left=False) on the kernel's L for below,
    torch.matmul(x, x.mT) on the solved below rows for prod. Returns one
    row per level."""
    dev = data.device
    sched = s.backend._factor_schedule(0, s.skel.num_lumps)
    seq = [i for i, lv in enumerate(sched) for lb in lv[0]
           if lb.cp <= NARROW_MAX]
    cap = K1Capture(seq, [i for i, lv in enumerate(sched) if lv[3] is None])
    s.factor_program()(data[None], ops=cap)
    check(not cap.seq, f"{label}: K1 calls and the schedule disagree")
    out = []
    for lvl in sorted({c[0] for c in cap.calls}):
        row = {"level": lvl, "buckets": [], "max_rel": {}}
        work, lib = [], {"chol": 0.0, "below": 0.0, "prod": 0.0}
        costs, want = {}, {}
        for _, snap, rows, cols, cp, rp, with_prod in \
                (c for c in cap.calls if c[0] == lvl):
            B, h = cols.numel(), cp + rp
            off = torch.arange(B, device=dev) * h * cp
            P = (lambda b: torch.empty((b, B * rp * rp), dtype=snap.dtype,
                                       device=dev)) if with_prod and rp \
                else (lambda b: None)
            row["buckets"].append([cp, rp, B, int(cols.max()),
                                   int(rows.max()) if rp else 0])
            for dt in (torch.float64, torch.float32):
                chk = CheckedOps()  # on copies: snap stays the input
                p = P(1)
                chk.bucket_factor(snap.to(dt, copy=True), None if p is None
                                  else p.to(dt), off, rows, cols, cp, rp, 0)
                r, key = chk.rel["bucket_factor"], str(dt)[6:]
                check(r <= KERNEL_RTOL[dt], f"bucket_factor vs twin on "
                      f"{label} level {lvl} ({cp}, {rp}, {B}) {dt}: rel {r}")
                row["max_rel"][key] = max(row["max_rel"].get(key, 0.0), r)
            two, p2 = torch.cat([snap, snap * 1.01]), P(2)
            kernels.bucket_factor(two, p2, off, rows, cols, cp, rp, 0)
            for b in range(2):
                one, p1 = two[b:b + 1].clone(), P(1)
                for _ in range(2):  # the single run, then its rerun
                    one.copy_((snap * 1.01) if b else snap)
                    kernels.bucket_factor(one, p1, off, rows, cols, cp, rp,
                                          0)
                    check(torch.equal(one[0], two[b]) and
                          (p1 is None or torch.equal(p1[0], p2[b])),
                          f"bucket_factor on {label} level {lvl} ({cp}, "
                          f"{rp}, {B}): batch item {b} differs")
            # the bucket one value further on, off the 16-byte alignment
            # the below grid stages by: the same bits, value by value
            ref, p_ref = snap.clone(), P(1)
            kernels.bucket_factor(ref, p_ref, off, rows, cols, cp, rp, 0)
            moved, p_mv = snap.new_zeros((1, snap.shape[1] + 1)), P(1)
            moved[:, 1:] = snap
            kernels.bucket_factor(moved, p_mv, off + 1, rows, cols, cp, rp,
                                  0)
            check(torch.equal(moved[:, 1:], ref) and
                  (p_ref is None or torch.equal(p_mv, p_ref)),
                  f"bucket_factor on {label} level {lvl} ({cp}, {rp}, {B}): "
                  "one value further on, the result differs")
            del ref, moved, p_ref, p_mv
            w, p = snap.clone(), P(1)
            work.append((snap, w, p, off, rows, cols, cp, rp))
            for g in ("chol", "below" if rp > 0 else None,
                      None if p is None else "prod"):
                if g:
                    want[g] = want.get(g, 0) + 1
            for g, (by, op) in k1_costs((w, p, off, rows, cols, cp,
                                         rp)).items():
                c = costs.setdefault(g, [0.0, 0.0])
                c[0], c[1] = c[0] + by, c[1] + op
            kernels.bucket_factor(w, p, off, rows, cols, cp, rp, 0)
            ar = torch.arange(cp, device=dev)
            pad = ((ar[:, None] == ar) & (ar >= cols[:, None, None])) \
                .to(snap.dtype)
            if rp:  # x = below L^-T on the kernel's L
                Lf = torch.tril(w.view(B, h, cp)[:, :cp]) + pad
                bl = snap.view(B, h, cp)[:, cp:]
                lib["below"] += time_ms(lambda: torch.linalg.solve_triangular(
                    Lf.mT, bl, upper=True, left=False), 5)
            if p is not None:
                x = w.view(B, h, cp)[:, cp:]
                lib["prod"] += time_ms(lambda: torch.matmul(x, x.mT), 5)
            D = snap.view(B, h, cp)[:, :cp]
            sym = torch.tril(D) + torch.tril(D, -1).mT + pad
            eye = torch.eye(cp, dtype=D.dtype, device=dev).expand_as(sym)
            lib["chol"] += time_ms(lambda: torch.linalg.solve_triangular(
                torch.linalg.cholesky_ex(sym)[0], eye, upper=False), 5)

        def calls():
            for snap, w, p, off, rows, cols, cp, rp in work:
                kernels.bucket_factor(w.copy_(snap), p, off, rows, cols, cp,
                                      rp, 0)
        # only a trace that shows every grid of every run is read
        reps = int(min(50, max(3, 20.0 / max(time_ms(calls, 1), 1e-3))))
        by_grid, tr, row["trace"] = complete_trace(
            calls, tuple(K1_PARTS), sum(want.values()), reps,
            f"{label} level {lvl} {row['buckets']}")
        ms = {}
        for k, v in by_grid.items():
            ms[K1_PARTS[k]] = ms.get(K1_PARTS[k], 0.0) + v
        row["grids"] = want
        row["device_ms"] = ms
        row["bound_ms"] = {g: bound(*c)[0] for g, c in costs.items()}
        row["bound_by"] = {g: bound(*c)[1] for g, c in costs.items()}
        row["library_ms"] = {k: v for k, v in lib.items() if v}
        out.append(row)
        del work
    log("k1_levels", case=label, card=name_limit, dtype="float64",
        limits={"float64": 1e-10, "float32": 1e-4}, bitwise=True,
        library_calls={"chol": "torch.linalg.cholesky_ex + "
                               "solve_triangular(L, I)",
                       "below": "torch.linalg.solve_triangular(L.mT, below, "
                                "upper=True, left=False)",
                       "prod": "torch.matmul(x, x.mT)"},
        device_ms_per_factor={g: sum(r["device_ms"].get(g, 0.0)
                                     for r in out)
                              for g in ("chol", "below", "prod")},
        levels=out)
    return out


def spd_panels(cp: int, n: int, B: int, seed: int, dev, bad=None, rp=0,
               nr=0):
    """A bucket of B panels for K1: each the lower triangle of a random
    A A^T + n I (n x n), zero-padded to cp x cp, then rp below rows, the
    first nr of them random over the n real columns. bad = (panel,
    column): that panel's diagonal made negative at the column, so its
    Cholesky fails there. Returns data (1, B (cp + rp) cp), off, rows,
    cols."""
    rng = np.random.RandomState(seed)
    data = np.zeros((B, cp + rp, cp))
    for j in range(B):
        a = rng.rand(n, n) - 0.5
        data[j, :n, :n] = np.tril(a @ a.T + n * np.eye(n))
        data[j, cp:cp + nr, :n] = rng.rand(nr, n) - 0.5
    if bad is not None:
        data[bad[0], bad[1], bad[1]] = -1.0
    ix = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)
    return (torch.from_numpy(data.reshape(1, -1)).to(dev),
            ix(np.arange(B) * (cp + rp) * cp), ix([nr] * B), ix([n] * B))


def k1_not_pd(dev, name_limit: str) -> list:
    """K1 and K1-wide on a panel that is not positive definite, f64 and
    f32: in a bucket of two, the second panel's diagonal made negative at
    one column, for chol_warp (cp 4, 32), chol_block (cp 64, 256, 512)
    and K1-wide (cp 1024 at a column inside a tile and at a tile's first,
    cp 3072); L must be finite before that column and NaN in it from the
    diagonal down, and the first panel finite. K1's panels carry 37 real
    below rows (padded 40), through below_warp (cp 4) and below_tile: x
    must be finite before the column and NaN from it on."""
    out = []
    for dt in (torch.float64, torch.float32):
        for cp, n, col in ((4, 3, 1), (32, 30, 7), (64, 60, 40),
                           (256, 200, 150), (512, 282, 100),
                           (1024, 1000, 600), (1024, 1000, 384),
                           (3072, 2985, 2000)):
            wide = cp > NARROW_MAX
            rp, nr = (0, 0) if wide else (40, 37)
            data, off, rows, cols = spd_panels(cp, n, 2, 99, dev,
                                               bad=(1, col), rp=rp, nr=nr)
            data = data.to(dt)
            if wide:
                kernels.wide_factor(data, off, rows, cols, cp, 0,
                                    (0, cp * cp), (n, n))
            else:
                kernels.bucket_factor(data, None, off, rows, cols, cp, rp, 0)
            P = data.view(2, cp + rp, cp)
            L = torch.tril(P[1, :n, :n])
            x = P[1, cp:cp + nr, :n]
            check(bool(torch.isfinite(P[0]).all()) and
                  bool(torch.isfinite(L[:col, :col]).all()) and
                  bool(torch.isnan(L[col:, col]).all()) and
                  bool(torch.isfinite(x[:, :col]).all()) and
                  bool(torch.isnan(x[:, col:]).all()),
                  f"{'wide' if wide else 'bucket'}_factor on a panel not "
                  f"positive definite (cp {cp}, n {n}, column {col}, "
                  f"{dt}): not NaN from the failing column on, or NaN "
                  "elsewhere")
            out.append([str(dt)[6:], cp, n, col, nr])
    log("k1_not_pd", card=name_limit, cases=out,
        fields=["dtype", "cp", "n", "column", "below rows"])
    return out


class WideCapture:
    """The kernels, for a factor program, keeping a copy of the panels of
    each K1-wide call before the call, packed one after the other (a
    bucket of their own)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(kernels, name)

    def wide_factor(self, data, off, rows, cols, cp, rp, off_h, cols_h):
        idx = off[:, None] + torch.arange((cp + rp) * cp, device=off.device)
        self.calls.append((data[:, idx].reshape(data.shape[0], -1), rows,
                           cols, cp, rp, tuple(cols_h)))
        kernels.wide_factor(data, off, rows, cols, cp, rp, off_h, cols_h)


def k1w_levels(cases, name_limit: str) -> list:
    """K1-wide on every call of one factor of each case ((label, solver,
    data single f64)), each call's panels packed as a bucket of their
    own, as [cp, rp, panels, widest real width, most real below rows]:
    against its twin in f64 and f32 (CheckedOps); a batch of two (the
    second item scaled) against single runs and a rerun, bitwise, and
    the bucket moved one value on (its panels off 16-byte alignment)
    against itself, bitwise; the
    wrapper's ms by CUDA events, its twin's; device ms per grid from a
    trace that shows every grid of every run (complete_trace), with the
    trace's device busy ms per call and its kernels' ms; the bound
    (cost()); and wide_factor_library_call by events, a yardstick the
    port never calls. The timed and traced calls factor their own output
    again, in place: no grid's work depends on the values. Returns one
    row per call."""
    out = []
    for label, s, data in cases:
        cap = WideCapture()
        s.factor_program()(data[None], ops=cap)
        check(len(cap.calls) > 0, f"{label}: no K1-wide call")
        for snap, rows, cols, cp, rp, cols_h in cap.calls:
            B, h, dev = cols.numel(), cp + rp, snap.device
            off_h = tuple(b * h * cp for b in range(B))
            off = torch.tensor(off_h, dtype=torch.int64, device=dev)
            bucket = (off, rows, cols, cp, rp, off_h, cols_h)
            row = {"case": label,
                   "bucket": [cp, rp, B, int(cols.max()),
                              int(rows.max()) if rp else 0],
                   "max_rel": {}}
            what = f"wide_factor on {label} {row['bucket']}"
            for dt in (torch.float64, torch.float32):
                chk = CheckedOps()  # on a copy: snap stays the input
                chk.wide_factor(snap.to(dt, copy=True), *bucket)
                r, key = chk.rel["wide_factor"], str(dt)[6:]
                check(r <= KERNEL_RTOL[dt], f"{what} vs twin {dt}: rel {r}")
                row["max_rel"][key] = r
                del chk
            two = torch.cat([snap, snap * 1.01])
            kernels.wide_factor(two, *bucket)
            for b in range(2):
                one = two[b:b + 1].clone()
                for _ in range(2):  # the single run, then its rerun
                    one.copy_((snap * 1.01) if b else snap)
                    kernels.wide_factor(one, *bucket)
                    check(torch.equal(one[0], two[b]),
                          f"{what}: batch item {b} differs from its single "
                          "run")
            del two, one
            # the bucket one value further on, off the 16-byte alignment
            # the grids stage by: the same bits, value by value
            ref, moved = snap.clone(), snap.new_zeros((1, snap.shape[1] + 1))
            moved[:, 1:] = snap
            kernels.wide_factor(ref, *bucket)
            kernels.wide_factor(moved, off + 1, rows, cols, cp, rp,
                                tuple(o + 1 for o in off_h), cols_h)
            check(torch.equal(moved[:, 1:], ref),
                  f"{what}: one value further on, the result differs")
            del ref, moved
            w = snap.clone()
            run = functools.partial(kernels.wide_factor, w, *bucket)
            row["ms"] = time_ms(run, 10)
            row["twin_ms"] = time_ms(lambda: kernels.wide_factor_twin(
                w.copy_(snap), *bucket), 1, warmup=1)
            row["library_ms"] = time_ms(
                wide_factor_library_call(snap, *bucket), 5)
            kernels.reset_counts()
            run()
            torch.cuda.synchronize()
            grids = kernels.COUNTS["wide_factor"].grid_launches
            reps = int(min(20, max(3, 20.0 / max(row["ms"], 1e-3))))
            row["device_ms"], tr, row["trace"] = complete_trace(
                run, GRIDS["wide_factor"], grids, reps, what)
            row["grids"] = grids
            row["device_busy_ms"] = tr["device_busy_ms_per_call"]
            row["idle_share"] = tr["idle_share"]
            row["kernels_ms"] = tr["device_ms_per_call_by_kernel"]
            row["bound_ms"], row["bound_by"] = bound(
                *cost("wide_factor", (w, *bucket)))
            out.append(row)
            del w
    cases_ = [c for c, _, _ in cases]
    log("k1w_levels", card=name_limit, dtype="float64",
        limits={"float64": 1e-10, "float32": 1e-4}, bitwise=True,
        library_call="per panel torch.linalg.cholesky_ex + "
                     "solve_triangular(L, I) + solve_triangular(L.mT, "
                     "below, upper=True, left=False)",
        ms_by_case={c: sum(r["ms"] for r in out if r["case"] == c)
                    for c in cases_},
        device_busy_ms_by_case={c: sum(r["device_busy_ms"] for r in out
                                       if r["case"] == c) for c in cases_},
        library_ms_by_case={c: sum(r["library_ms"] for r in out
                                   if r["case"] == c) for c in cases_},
        bound_ms_by_case={c: sum(r["bound_ms"] for r in out
                                 if r["case"] == c) for c in cases_},
        buckets=out)
    return out


class MvCapture:
    """The kernels, for an add_mv program, keeping each K5 call's bucket:
    (wrapper, off, rows, cols, vec_off, below_idx, cp, rp)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(kernels, name)

    def _keep(self, name, data, x, out, y, y_base, *bucket_alpha):
        self.calls.append((name, *bucket_alpha[:-1]))
        getattr(kernels, name)(data, x, out, y, y_base, *bucket_alpha)

    def add_mv(self, *args):
        self._keep("add_mv", *args)

    def wide_add_mv(self, *args):
        self._keep("wide_add_mv", *args)


def mv_sparse(data, order: int, off, rows, cols, vec_off, below_idx, cp: int,
              rp: int):
    """The symmetric matrix one K5 bucket adds, M = sym(lower(diag)) on
    its panels' own rows plus below and below^T, as a CUDA sparse_csr
    tensor of the real entries (order x order), built from data[0]; for
    the torch.sparse.mm yardstick, which the port never calls."""
    dev, d = data.device, data[0]
    ii, mm = torch.tril_indices(cp, cp, device=dev)
    p, t = (ii[None] < cols[:, None]).nonzero(as_tuple=True)
    i, m = ii[t], mm[t]
    val = d[off[p] + i * cp + m]
    r, c = vec_off[p] + i, vec_off[p] + m
    strict = i != m
    rs, cs, vs = [r, c[strict]], [c, r[strict]], [val, val[strict]]
    if rp:
        bi = below_idx.view(-1, rp)
        live = ((torch.arange(rp, device=dev)[:, None] < rows[:, None, None])
                & (torch.arange(cp, device=dev) < cols[:, None, None])
                & (bi != order)[:, :, None])
        p, q, m = live.nonzero(as_tuple=True)
        val = d[off[p] + (cp + q) * cp + m]
        g, o = bi[p, q], vec_off[p] + m
        rs += [g, o]
        cs += [o, g]
        vs += [val, val]
    A = torch.sparse_coo_tensor(torch.stack([torch.cat(rs), torch.cat(cs)]),
                                torch.cat(vs), (order, order))
    return A.coalesce().to_sparse_csr()


def complete_trace(fn, names, want: int, reps: int, what: str) -> tuple:
    """Device ms per call of each of `names` (__global__ functions) from a
    trace of fn() that shows all `want` of their launches per call in
    every run (retaken up to K1_TRACE_TRIES times, the runs halved at
    each retake, down to TRACE_MIN_REPS; the profiler can lose whole
    runs' device records late in a long run, and in some traces the
    first launches' records: a retake waits longer first and runs a small
    kernel of another name and one call of fn ahead of the counted runs,
    whose records trace() leaves out); fails without one, naming `what`.
    Returns ({name: ms}, trace, {"reps": counted runs, "tries": traces
    taken})."""
    buf = torch.zeros(1024, device="cuda")
    tr, seen = {"launches_per_call_by_kernel": {}}, 0
    for tries in range(1, K1_TRACE_TRIES + 1):
        try:
            tr = trace(fn, reps, lead_in_s=min(1.0, TRACE_LEAD_IN_S * 4 **
                                               (tries - 1)),
                       prime=None if tries == 1 else
                       lambda: (buf.zero_(), fn()))
        except AssertionError:  # a trace with no device record at all
            if tries < K1_TRACE_TRIES:
                reps = max(TRACE_MIN_REPS, reps // 2)
            continue
        seen = sum(round(tr["launches_per_call_by_kernel"].get(k, 0) * reps)
                   for k in names)
        if seen == want * reps:
            ms = {k: tr["device_ms_per_call_by_kernel"].get(k, 0.0)
                  for k in names
                  if tr["launches_per_call_by_kernel"].get(k)}
            return ms, tr, {"reps": reps, "tries": tries}
        if tries < K1_TRACE_TRIES:
            reps = max(TRACE_MIN_REPS, reps // 2)
    shown = {k: v for k, v in tr["launches_per_call_by_kernel"].items()
             if k in names}
    raise AssertionError(f"{what}: no complete trace in {K1_TRACE_TRIES} "
                         f"tries; the last shows {seen} launches of {names} "
                         f"in {reps} runs ({shown} per run), want {want} "
                         "per run")


def k5_levels(s, cases, label: str, name_limit: str, alpha=0.7) -> list:
    """K5 on every bucket of each add_mv program in `cases` ((name, data,
    start lump): the data single, f64): each bucket as
    [cp, rp, panels, widest real width, most real below rows]; against
    its twin (f64 at nrhs 1 and 3, f32 at nrhs 1; CheckedOps); a batch
    of two (the second item's data scaled) against single runs and a
    rerun, bitwise; the wrapper's ms by CUDA events (nrhs 1), its twin's,
    device ms per grid from a complete trace, the bound (cost()), and
    torch.sparse.mm(A, x) on the bucket's own symmetric matrix (real
    entries, CSR built outside the timed call), a yardstick the port
    never calls; per case, the whole program's ms by events. Returns one
    row per bucket."""
    dev, order, out, program_ms = s.device, s.order, [], {}
    rng = np.random.RandomState(5)
    X = {n: torch.from_numpy(rng.rand(2, order, n) - 0.5).to(dev)
         for n in (1, 3)}
    for case, data, lump in cases:
        cap = MvCapture()
        s.program("add_mv", lump)(data[None], X[1][:1], X[1][:1] * 0, alpha,
                                  ops=cap)
        D = {torch.float64: data[None], torch.float32: data[None].float()}
        D2 = torch.stack([data, data * 1.01])
        ax = torch.zeros_like(X[1][0])  # sum of the buckets' A x
        for name, off, rows, cols, vec_off, below_idx, cp, rp in cap.calls:
            B = off.numel()
            fn = getattr(kernels, name)
            bucket = (off, rows, cols, vec_off, below_idx, cp, rp)

            def y_of(b, n, dt=torch.float64):
                return torch.full((b, B * rp, n), float("nan"), dtype=dt,
                                  device=dev) if rp else None
            row = {"case": case, "wrapper": name,
                   "bucket": [cp, rp, B, int(cols.max()),
                              int(rows.max()) if rp else 0],
                   "max_rel": {}}
            for dt, n in ((torch.float64, 1), (torch.float64, 3),
                          (torch.float32, 1)):
                chk = CheckedOps()
                x = X[n][:1].to(dt)
                chk._mv(name, D[dt], x, x.flip(1).contiguous(), y_of(1, n, dt),
                        0, *bucket, alpha)
                r, key = chk.rel[name], f"{str(dt)[6:]}_nrhs{n}"
                check(r <= KERNEL_RTOL[dt], f"{name} vs twin on {label} "
                      f"{case} {row['bucket']} {key}: rel {r}")
                row["max_rel"][key] = r
            o2, y2 = torch.zeros_like(X[1]), y_of(2, 1)
            fn(D2, X[1], o2, y2, 0, *bucket, alpha)
            for b in range(2):
                for _ in range(2):  # the single run, then its rerun
                    o1, y1 = torch.zeros_like(X[1][:1]), y_of(1, 1)
                    fn(D2[b:b + 1], X[1][b:b + 1], o1, y1, 0, *bucket, alpha)
                    check(torch.equal(o1[0], o2[b]) and
                          (y1 is None or torch.equal(y1[0], y2[b])),
                          f"{name} on {label} {case} {row['bucket']}: batch "
                          f"item {b} differs from its single run")
            del o2, y2
            x, o, y = X[1][:1], torch.zeros_like(X[1][:1]), y_of(1, 1)
            args = (D[torch.float64], x, o, y, 0, *bucket, alpha)
            run = functools.partial(fn, *args)
            twin = functools.partial(getattr(kernels, f"{name}_twin"), *args)
            row["ms"] = time_ms(run, 20)
            row["twin_ms"] = time_ms(twin, 2, warmup=1)
            kernels.reset_counts()
            run()
            torch.cuda.synchronize()
            grids = kernels.COUNTS[name].grid_launches
            reps = int(min(50, max(5, 5.0 / max(row["ms"], 1e-3))))
            row["device_ms"], tr, row["trace"] = complete_trace(
                run, GRIDS[name], grids, reps,
                f"{name} on {label} {case} {row['bucket']}")
            row["grids"] = grids
            row["bound_ms"], row["bound_by"] = bound(*cost(name, args))
            A = mv_sparse(D[torch.float64], order, *bucket)
            row["library_ms"] = time_ms(lambda: torch.sparse.mm(A, x[0]), 5)
            row["library_nnz"] = int(A.values().numel())
            ax += torch.sparse.mm(A, x[0])
            del A
            out.append(row)
        # the yardsticks' matrices add up to the program's operator; the
        # whole program (every bucket, then K2) timed by events
        prog = functools.partial(s.program("add_mv", lump), D[torch.float64],
                                 X[1][:1], torch.zeros_like(X[1][:1]), 1.0)
        want = prog()[0]
        program_ms[case] = time_ms(prog, 20)
        r, _ = rel_abs(ax, want)
        check(r <= 1e-10, f"{label} {case}: the buckets' sparse matrices "
              f"give rel {r} against the program")
        del D, D2
    log("k5_levels", case=label, card=name_limit, dtype="float64", nrhs=1,
        alpha=alpha, limits={"float64": 1e-10, "float32": 1e-4},
        bitwise=True, library_call="torch.sparse.mm(A, x), A the bucket's "
        "symmetric matrix as sparse_csr",
        program_ms=program_ms,
        ms_by_case={c: sum(r["ms"] for r in out if r["case"] == c)
                    for c, _, _ in cases},
        device_ms_by_case={c: sum(sum(r["device_ms"].values()) for r in out
                                  if r["case"] == c) for c, _, _ in cases},
        bound_ms_by_case={c: sum(r["bound_ms"] for r in out
                                 if r["case"] == c) for c, _, _ in cases},
        library_ms_by_case={c: sum(r["library_ms"] for r in out
                                   if r["case"] == c) for c, _, _ in cases},
        buckets=out)
    return out


class SolveCapture:
    """The kernels, for a solve program, keeping each call of one solve
    wrapper (bucket_solve or wide_solve): its pass and bucket,
    (transpose, off, rows, cols, vec_off, below_idx, cp, rp)."""

    def __init__(self, wrapper: str = "bucket_solve"):
        self.wrapper, self.calls = wrapper, []

    def __getattr__(self, name):
        fn = getattr(kernels, name)
        if name != self.wrapper:
            return fn

        def keep(data, vv, y, y_base, off, rows, cols, vec_off, below_idx,
                 cp, rp, transpose):
            self.calls.append((transpose, off, rows, cols, vec_off,
                               below_idx, cp, rp))
            fn(data, vv, y, y_base, off, rows, cols, vec_off, below_idx, cp,
               rp, transpose)
        return keep


def below_sparse(data, order: int, off, rows, cols, vec_off, below_idx,
                 cp: int, rp: int, transpose: bool):
    """The gather product of one K3 bucket as a CUDA sparse_csr matrix of
    its real below entries (sentinel rows left out), built from data[0]:
    Lt pass, order x order with below[r][j] at (vec_off + j, bidx[r]), so
    A @ vv is below^T vv[bidx] on the own rows; L pass, B rp x order with
    below[r][j] at (p rp + r, vec_off + j), so A @ vv is y. For the
    torch.sparse.mm yardstick, which the port never calls; the n x n
    product with the stored inverse is left out."""
    dev, d = data.device, data[0]
    bi = below_idx.view(-1, rp)
    live = ((torch.arange(rp, device=dev)[:, None] < rows[:, None, None])
            & (torch.arange(cp, device=dev) < cols[:, None, None])
            & (bi != order)[:, :, None])
    p, r, j = live.nonzero(as_tuple=True)
    val = d[off[p] + (cp + r) * cp + j]
    if transpose:
        idx, shape = torch.stack([vec_off[p] + j, bi[p, r]]), (order, order)
    else:
        idx, shape = torch.stack([p * rp + r, vec_off[p] + j]), \
            (off.numel() * rp, order)
    A = torch.sparse_coo_tensor(idx, val, shape)
    return A.coalesce().to_sparse_csr()


def tri_library_call(data, vv, off, rows, cols, vec_off, cp: int, rp: int,
                     transpose: bool):
    """K3-rest's substitution in one PyTorch call: batched
    torch.linalg.solve_triangular on the bucket's lower blocks (real
    columns, identity on the padded ones: kernels._lower_masked) with
    its RHS rows gathered, both built outside the timed call; the below
    products are left out. For a yardstick the port never calls."""
    order, dev = vv.shape[1], data.device
    L = kernels._lower_masked(
        kernels._bucket_panels(data, off, cp, rp)[0, :, :cp], cols)
    xr = torch.arange(cp, device=dev)
    xidx = torch.where(xr < cols[:, None], vec_off[:, None] + xr, order)
    x = torch.cat([vv[0], vv.new_zeros((1, vv.shape[2]))])[xidx]
    A = L.mT if transpose else L
    return lambda: torch.linalg.solve_triangular(A, x, upper=transpose)


# each solve phase: its log line, its layout, its yardstick
SOLVE_PHASES = {"bucket_solve": "k3_levels", "wide_solve": "k3w_levels",
                "tri_solve": "k3r_levels"}


def solve_levels(cases, wrapper: str, name_limit: str) -> list:
    """The phases k3_levels (wrapper bucket_solve: K3, its layout
    kernels.solve_layout), k3w_levels (wide_solve: K3-wide,
    kernels.wide_solve_layout) and k3r_levels (tri_solve: K3-rest narrow,
    kernels.tri_layout): the wrapper on every bucket and pass of the solves
    of each case ((label, solver, data single f64) or (label, solver,
    data, path): path(ops, v) runs the case's solve programs on the data
    with `ops`, by default the full solve of the factor `data`), as [cp,
    rp, panels, widest real width, most real below rows] with its
    layout: against its twin (f64 at nrhs 1 and 3, f32 at nrhs 1;
    CheckedOps); a batch of two (the second item's data scaled) against
    single runs and a rerun, bitwise, at nrhs 3; the wrapper's ms by
    CUDA events (nrhs 1, solving its own output again in place: no
    grid's work depends on the values), its twin's; device ms per grid
    from a complete trace, at nrhs 1 and at nrhs 3; the bound (cost(),
    nrhs 1); and a yardstick the port never calls (K3: torch.sparse.mm
    of the bucket's below block as CSR with the RHS, the n x n product
    left out; K3-wide: wide_solve_library_call on one panel; K3-rest:
    tri_library_call, the substitution alone). Returns one row per
    call."""
    out = []
    rng = np.random.RandomState(7)
    fn, twin = getattr(kernels, wrapper), getattr(kernels, f"{wrapper}_twin")
    names = GRIDS[wrapper] + EARLIER_GRIDS[wrapper]
    layout = {"bucket_solve": lambda cp, rp, B: getattr(
        kernels, "solve_layout", lambda *_: ())(cp, rp, B),
        "tri_solve": lambda cp, rp, B: getattr(
            kernels, "tri_layout", lambda *_: ())(cp, rp, B),
        "wide_solve": lambda cp, rp, B: getattr(
            kernels, "wide_solve_layout", lambda *_: ())(cp, rp)}[wrapper]
    for label, s, f, *path in cases:
        order, dev = s.order, f.device
        V = {n: torch.from_numpy(rng.rand(2, order, n) - 0.5).to(dev)
             for n in (1, 3)}
        cap = SolveCapture(wrapper)
        if path:
            path[0](cap, V[3][:1])
        else:
            s.solve_program()(f[None], V[3][:1], ops=cap)
        check(len(cap.calls) > 0, f"{label}: no {wrapper} call")
        D = {torch.float64: f[None], torch.float32: f[None].float()}
        D2 = torch.stack([f, f * 1.01])
        for transpose, *bucket in cap.calls:
            off, rows, cols, vec_off, _, cp, rp = bucket
            B, use_y = off.numel(), rp > 0 and not transpose
            bucket = (*bucket, transpose)

            def y_of(b, n, dt=torch.float64):
                return torch.full((b, B * rp, n), float("nan"), dtype=dt,
                                  device=dev) if use_y else None
            row = {"case": label, "pass": "Lt" if transpose else "L",
                   "bucket": [cp, rp, B, int(cols.max()),
                              int(rows.max()) if rp else 0],
                   "layout": layout(cp, rp, B), "max_rel": {}}
            what = f"{wrapper} on {label} {row['pass']} {row['bucket']}"
            for dt, n in ((torch.float64, 1), (torch.float64, 3),
                          (torch.float32, 1)):
                chk = CheckedOps()
                chk._solve(wrapper, D[dt], V[n][:1].to(dt), y_of(1, n, dt),
                           0, *bucket)
                r, key = chk.rel[wrapper], f"{str(dt)[6:]}_nrhs{n}"
                check(r <= KERNEL_RTOL[dt], f"{what} vs twin {key}: rel {r}")
                row["max_rel"][key] = r
            v2, y2 = V[3].clone(), y_of(2, 3)
            fn(D2, v2, y2, 0, *bucket)
            for b in range(2):
                for _ in range(2):  # the single run, then its rerun
                    v1, y1 = V[3][b:b + 1].clone(), y_of(1, 3)
                    fn(D2[b:b + 1], v1, y1, 0, *bucket)
                    check(torch.equal(v1[0], v2[b]) and
                          (y1 is None or torch.equal(y1[0], y2[b])),
                          f"{what}: batch item {b} differs from its single "
                          "run")
            del v2, y2
            v, y = V[1][:1].clone(), y_of(1, 1)
            args = (D[torch.float64], v, y, 0, *bucket)
            run = functools.partial(fn, *args)
            row["ms"] = time_ms(run, 20)
            row["twin_ms"] = time_ms(functools.partial(twin, *args), 1,
                                     warmup=1)
            kernels.reset_counts()
            run()
            torch.cuda.synchronize()
            grids = kernels.COUNTS[wrapper].grid_launches
            reps = int(min(50, max(5, 5.0 / max(row["ms"], 1e-3))))
            row["device_ms"], _, row["trace"] = complete_trace(
                run, names, grids, reps, what)
            row["grids"] = grids
            v3 = V[3][:1].clone()
            row["device_ms_nrhs3"], _, row["trace_nrhs3"] = complete_trace(
                functools.partial(fn, D[torch.float64], v3, y_of(1, 3), 0,
                                  *bucket), names, grids, reps,
                what + " nrhs 3")
            del v3
            row["bound_ms"], row["bound_by"] = bound(*cost(wrapper, args))
            row["library_ms"] = None
            if wrapper == "wide_solve":
                row["library_ms"] = time_ms(
                    wide_solve_library_call(args), 5) if B == 1 else None
            elif wrapper == "tri_solve":
                row["library_ms"] = time_ms(tri_library_call(
                    D[torch.float64], v, off, rows, cols, vec_off, cp, rp,
                    transpose), 5)
            elif rp:
                A = below_sparse(D[torch.float64], order, *bucket)
                row["library_ms"] = time_ms(lambda: torch.sparse.mm(A, v[0]),
                                            5)
                row["library_nnz"] = int(A.values().numel())
                del A
            out.append(row)
        del D, D2, V
    keys = sorted({(r["case"], r["pass"]) for r in out})

    def by(field):
        return {f"{c} {p}": sum(
            (sum(r[field].values()) if isinstance(r[field], dict)
             else r[field] or 0.0) for r in out
            if (r["case"], r["pass"]) == (c, p)) for c, p in keys}
    lib = {"bucket_solve": "torch.sparse.mm(A, vv), A the bucket's below "
                           "block as sparse_csr (Lt: below^T, the gather "
                           "product; L: below, y); the n x n product is "
                           "left out",
           "wide_solve": "per panel torch.linalg.solve_triangular on its "
                         "lower triangle, with below rows also "
                         "torch.matmul with the below block (L: y = below "
                         "x; Lt: below^T g, g the gathered rows)",
           "tri_solve": "batched torch.linalg.solve_triangular on the "
                        "bucket's masked lower blocks with its gathered "
                        "RHS rows, the substitution alone (the below "
                        "products left out)"}[wrapper]
    log(SOLVE_PHASES[wrapper], card=name_limit, dtype="float64", nrhs=1,
        limits={"float64": 1e-10, "float32": 1e-4}, bitwise=True,
        library_call=lib, ms_by_case=by("ms"),
        device_ms_by_case=by("device_ms"),
        device_ms_nrhs3_by_case=by("device_ms_nrhs3"),
        bound_ms_by_case=by("bound_ms"), library_ms_by_case=by("library_ms"),
        buckets=out)
    return out


def k3r_cases(probs, d64, bal_solver, bal_damped_data, bal_t: int,
              grid_from: bool = True) -> list:
    """k3r_levels' cases: every narrow K3-rest bucket of the partial
    solves on MERI's and GRID's split (the up-to solves on factor_up_to's
    output, the from-solves on factor_from's and on the pseudo-factor's,
    as partial_ops runs them; GRID's from-solves, 164 calls, only with
    grid_from), FLAT+Schur 50k's up-to solves at t = 50,000 (its
    50,000-panel level), and BAL 871's first damped system: the up-to
    solves of the PCG LM path (its 527,478-panel point bucket) and the
    from-solves on the pseudo-factored camera corner (the Gauss-Seidel
    preconditioner's data)."""
    def up_down(s, lo, hi, data):
        def path(ops, v):
            s.program("solve_lt", lo, hi)(
                data[None], s.program("solve_l", lo, hi)(data[None], v,
                                                         ops=ops), ops=ops)
        return path
    cases = []
    for p in ("meri7", "grid100", "flat_schur50k", "bal871"):
        if p == "bal871":
            s, d, t = bal_solver, bal_damped_data, bal_t
        else:
            s = probs[p]
            d = torch.from_numpy(d64[p]).to(bal_damped_data.device)
            t = SCHUR_T if p == "flat_schur50k" else split_span(s, p)
        tl, nl = s._lump_of_span(t), s.skel.num_lumps
        fu = s.program("factor", 0, tl)(d[None])[0]
        cases.append((f"{p} up_to", s, fu, up_down(s, 0, tl, fu)))
        if p == "grid100" and not grid_from:
            continue
        if p in ("meri7", "grid100"):
            ff = s.program("factor", tl, nl)(fu[None])[0]
            cases.append((f"{p} from", s, ff, up_down(s, tl, nl, ff)))
        if p != "flat_schur50k":
            pf = s.program("pseudo", t, s.skel.num_spans)(fu[None])[0]
            cases.append((f"{p} pseudo from", s, pf, up_down(s, tl, nl, pf)))
    return cases


class K2Capture:
    """The kernels, for a program, keeping each segmented_subtract call:
    its arguments and keywords (the plan's layout)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(kernels, name)

    def segmented_subtract(self, *args, **kw):
        self.calls.append((args, kw))
        kernels.segmented_subtract(*args, **kw)


def k2_levels(cases, name_limit: str) -> list:
    """K2 on every call of each case's path ((label, path(ops)): path
    runs a program with `ops`): the call's CSR (targets, sources, the
    longest segment, width) and, where the tree has one, its plan
    (kernels.SegLayout: short segments, chunks, segments with a post);
    against its twin (f64, f32; CheckedOps, on copies of the call's
    inputs); a batch of two (the second item's sources scaled) against
    single runs and a rerun, bitwise; ms by CUDA events and its twin's;
    device ms per grid from a complete trace; the bound (cost()); and
    index_add_ of the gathered sources (library_call), a yardstick the
    port never calls. Returns one row per call."""
    out = []
    fn = kernels.segmented_subtract
    names = GRIDS["segmented_subtract"] + EARLIER_GRIDS["segmented_subtract"]
    for label, path in cases:
        cap = K2Capture()
        path(cap)
        torch.cuda.synchronize()
        check(len(cap.calls) > 0, f"{label}: no segmented_subtract call")
        for i, (args, kw) in enumerate(cap.calls):
            out0, src, tgt, seg_ptr, src_idx, width = args
            lay = kw.get("layout")
            row = {"case": label, "call": i, "width": width,
                   "targets": int(tgt.numel()),
                   "sources": int(src_idx.numel()),
                   "longest": int(seg_ptr.diff().max()), "max_rel": {}}
            if lay is not None:
                row["plan"] = {"short": lay.n_short, "chunks": lay.n_chunk,
                               "post": lay.n_post, "idx32": lay.idx32}
            what = f"segmented_subtract on {label} call {i}"
            for dt in (torch.float64, torch.float32):
                chk = CheckedOps()
                chk.segmented_subtract(out0.to(dt, copy=True), src.to(dt),
                                       tgt, seg_ptr, src_idx, width, **kw)
                r = chk.rel["segmented_subtract"]
                check(r <= KERNEL_RTOL[dt], f"{what} vs twin {dt}: rel {r}")
                row["max_rel"][str(dt)[6:]] = r
            o2 = torch.cat([out0, out0])
            s2 = torch.cat([src, src * 1.01])
            fn(o2, s2, tgt, seg_ptr, src_idx, width, **kw)
            for b in range(2):
                for _ in range(2):  # the single run, then its rerun
                    o1 = out0.clone()
                    fn(o1, s2[b:b + 1], tgt, seg_ptr, src_idx, width, **kw)
                    check(torch.equal(o1[0], o2[b]),
                          f"{what}: batch item {b} differs from its single "
                          "run")
            del o2, s2
            o = out0.clone()
            args = (o, src, tgt, seg_ptr, src_idx, width)
            run = functools.partial(fn, *args, **kw)
            row["ms"] = time_ms(run, 20)
            row["twin_ms"] = time_ms(functools.partial(
                kernels.segmented_subtract_twin, *args), 1, warmup=1)
            kernels.reset_counts()
            run()
            torch.cuda.synchronize()
            grids = kernels.COUNTS["segmented_subtract"].grid_launches
            reps = int(min(50, max(5, 5.0 / max(row["ms"], 1e-3))))
            row["device_ms"], _, row["trace"] = complete_trace(
                run, names, grids, reps, what)
            row["grids"] = grids
            row["bound_ms"], row["bound_by"] = bound(
                *cost("segmented_subtract", args, kw))
            row["library_ms"] = time_ms(
                library_call("segmented_subtract", args), 5)
            out.append(row)
            del o
        del cap
    labels = list(dict.fromkeys(r["case"] for r in out))

    def by(field):
        return {c: sum((sum(r[field].values()) if isinstance(r[field], dict)
                        else r[field]) for r in out if r["case"] == c)
                for c in labels}
    log("k2_levels", card=name_limit, dtype="float64",
        limits={"float64": 1e-10, "float32": 1e-4}, bitwise=True,
        library_call="Tensor.index_add_(1, targets, src[:, src_idx], "
                     "alpha=-1) on a copy of out (library_call)",
        calls_by_case={c: sum(r["case"] == c for r in out) for c in labels},
        ms_by_case=by("ms"), device_ms_by_case=by("device_ms"),
        bound_ms_by_case=by("bound_ms"), library_ms_by_case=by("library_ms"),
        calls=out)
    return out


def k2_cases(probs, d64, bal_solver, bal_damped_data, bal_t: int) -> list:
    """k2_levels' cases: the factors of MERI and GRID (width 1), BAL
    871's factor of its first damped system (its pair levels 1-3), the L
    pass of BAL's and FLAT+Schur 50k's solves at nrhs 1 and 3, and BAL's
    PCG operator add_mv_from(t) on factor_up_to's output (nrhs 1)."""
    dev = bal_damped_data.device
    rng = np.random.RandomState(9)
    cases = []
    for p in ("meri7", "grid100"):
        s = probs[p]
        d = torch.from_numpy(d64[p]).to(dev)[None]
        cases.append((f"{p} factor", functools.partial(s.factor_program(),
                                                       d)))
    sb = bal_solver
    fb = sb.factor(bal_damped_data)
    cases.append(("bal871 factor", functools.partial(
        sb.factor_program(), bal_damped_data[None])))
    s50 = probs["flat_schur50k"]
    f50 = s50.factor(torch.from_numpy(d64["flat_schur50k"]).to(dev))
    for label, s, f in (("bal871", sb, fb), ("flat_schur50k", s50, f50)):
        for n in (1, 3):
            v = torch.from_numpy(rng.rand(1, s.order, n) - 0.5).to(dev)
            cases.append((f"{label} solve L nrhs {n}", functools.partial(
                s.program("solve_l", 0, s.skel.num_lumps), f[None], v)))
    tl = sb._lump_of_span(bal_t)
    part = sb.factor_up_to(bal_damped_data, bal_t)
    x = torch.from_numpy(rng.rand(1, sb.order, 1) - 0.5).to(dev)
    cases.append(("bal871 add_mv_from(t)", functools.partial(
        sb.program("add_mv", tl), part[None], x, torch.zeros_like(x), 1.0)))
    return cases


def k6_costs(W, plan) -> dict:
    """(bytes, operations) at the least of K6's two parts on one family,
    from its plan: "short" (the short grid) and "long" (the chunk and
    post grids), each reading the W values its records touch once
    (counted per part), its output elements read and written once and
    the index arrays it reads; a multiply-add per row of W per element
    of each record's block."""
    item, dev = W.element_size(), W.device
    F, rdim, tdw = W.shape
    out = {}
    for part in ("short", "long"):
        touched = torch.zeros((F, tdw), dtype=torch.bool, device=dev)
        by, ops = 0.0, 0.0
        for sg in (plan.hess, plan.grad):
            ids = getattr(sg, part)
            if ids.numel() == 0:
                continue
            s0, s1 = int(ids[0]), int(ids[-1]) + 1
            ptr = sg.ptr[s0:s1 + 1]
            cnt = ptr.diff()
            R, C = sg.rows[s0:s1], sg.cols[s0:s1]
            rec = sg.rec[int(ptr[0]):int(ptr[-1])]
            f, q = rec // plan.Q, rec % plan.Q
            Rr, Cr = torch.repeat_interleave(R, cnt), \
                torch.repeat_interleave(C, cnt)
            for qq, rr, cc in torch.unique(torch.stack([q, Rr, Cr]),
                                           dim=1).T.tolist():
                fs = f[(q == qq) & (Rr == rr) & (Cr == cc)][:, None]
                touched[fs, int(plan.tab_a[qq]) + torch.arange(
                    rr, device=dev)] = True
                touched[fs, int(plan.tab_b[qq]) + torch.arange(
                    cc, device=dev)] = True
            el = int((R * C).sum())
            idx = 2 * (s1 - s0) + cnt.numel() + 1 + rec.numel() + (
                sg.chunk_seg.numel() * 2 + sg.chunk_ptr.numel()
                if part == "long" else 0)
            by += item * 2 * el + 8 * idx
            ops += 2.0 * rdim * float((Rr * Cr).sum())
        out[part] = (by + item * rdim * int(touched.sum()), ops)
    return out


def k6_levels(opt, terms, name_limit: str) -> list:
    """K6 on one BAL 871 assembly: against its twin (f64, f32) and a
    rerun, bitwise (testing.flows.k6_vs_twin); per family, the wrapper's
    ms by CUDA events (adding into its own output again: no grid's work
    depends on the values), the twin's, device ms per grid from a
    complete trace, and the bound of the short part and of the long one
    (k6_costs). Returns one row per family."""
    s = opt.solver
    rel = {}
    for dt in (torch.float64, torch.float32):
        r, _, same = k6_vs_twin(opt, terms, dt)
        check(r <= KERNEL_RTOL[dt] and same, f"grad_hess vs twin on BAL 871 "
              f"{dt}: rel {r}, rerun bitwise {same}")
        rel[str(dt)[6:]] = r
    rows = []
    for fam, ((_, W), (_, plan)) in enumerate(zip(terms, opt._plans)):
        W = W.to(torch.float64).contiguous()
        h0 = torch.zeros(s.data_size, dtype=W.dtype, device=W.device)
        g0 = torch.zeros(s.order, dtype=W.dtype, device=W.device)
        run = functools.partial(kernels.grad_hess, W, h0, g0, plan)
        classes = hasattr(plan.hess, "short_classes")  # this design's
        row = {"family": fam, "F": W.shape[0], "rdim": plan.rdim,
               "tdw": plan.tdw}
        if classes:
            row["classes"] = {k: {
                "short": getattr(plan, k).short_classes.tolist(),
                "long": getattr(plan, k).long_classes.tolist(),
                "chunks": int(getattr(plan, k).chunk_seg.numel()),
                "chunk_rec": getattr(plan, k).chunk_rec}
                for k in ("hess", "grad")}
        row["ms"] = time_ms(run, 10)
        row["twin_ms"] = time_ms(functools.partial(
            kernels.grad_hess_twin, W, h0, g0, plan), 1, warmup=1)
        kernels.reset_counts()
        run()
        torch.cuda.synchronize()
        grids = kernels.COUNTS["grad_hess"].grid_launches
        reps = int(min(20, max(3, 5.0 / max(row["ms"], 1e-3))))
        row["device_ms"], tr, row["trace"] = complete_trace(
            run, GRIDS["grad_hess"] + EARLIER_GRIDS["grad_hess"], grids,
            reps, f"grad_hess on BAL 871 family {fam}")
        row["grids"] = grids
        row["device_busy_ms"] = tr["device_busy_ms_per_call"]
        if classes:
            row["bound_ms"], row["bound_by"] = {}, {}
            for part, c in k6_costs(W, plan).items():
                row["bound_ms"][part], row["bound_by"][part] = bound(*c)
            row["bound_ms_whole"], _ = bound(*cost("grad_hess",
                                                   (W, h0, g0, plan)))
        rows.append(row)
        del h0, g0
    log("k6_levels", card=name_limit, dtype="float64",
        limits={"float64": 1e-10, "float32": 1e-4}, max_rel=rel,
        bitwise_rerun=True, ms=sum(r["ms"] for r in rows),
        device_ms={g: sum(r["device_ms"].get(g, 0.0) for r in rows)
                   for g in GRIDS["grad_hess"] + EARLIER_GRIDS["grad_hess"]
                   if any(g in r["device_ms"] for r in rows)},
        families=rows)
    return rows


def bal_pcg_trace(s, damped, grad, t: int, name_limit: str,
                  iters: int = 10) -> None:
    """The pcg stage of mixed_solve on BAL's first damped system, with
    BlockJacobi, `iters` iterations (tolerance 0), traced: device ms per
    kernel, idle share, K5's grids against its counters (trace_checked);
    factor_up_to, solve_l_up_to and the preconditioner's init run
    before, untraced."""
    from baspacho_tpu_torch.optimizer import BlockJacobiPrecond
    from baspacho_tpu_torch.optimizer.pcg import pcg
    o = s.span_vector_offset(t)
    part = s.factor_up_to(damped, t)
    v = s.solve_l_up_to(part, t, -grad)
    pre = BlockJacobiPrecond(s, t)
    pre.init(part)

    def embed(r):
        full = torch.zeros_like(v)
        full[o:] = r
        return full

    def run():
        _, _, it = pcg(lambda r: pre.apply(embed(r))[o:],
                       lambda p: s.add_mv_from(part, t, embed(p),
                                               torch.zeros_like(v))[o:],
                       v[o:], 0.0, iters)
        check(it == iters, f"BAL PCG trace: {it} iterations, want {iters}")
    trace_checked("bal871", f"pcg_{iters}_iterations", run, 1,
                  dtype="float64", card=name_limit, iterations=iters,
                  precond="BlockJacobiPrecond")
    # the up-to solves around it (K3-rest narrow on the point bucket, K2
    # onto the cameras' rows)
    trace_checked("bal871", "solve_l_up_to + solve_lt_up_to",
                  lambda: s.solve_lt_up_to(part, t, s.solve_l_up_to(
                      part, t, -grad)), 3, dtype="float64", card=name_limit)


def wide_tri_checks(probs, d64, dev) -> dict:
    """K3-rest wide against its twin and against itself: on FLAT+Schur
    50k's corner (cp 3072) and on WIDE_BELOW (cp 1024, below rows), f64
    and f32, nrhs 1 and 3, batch 2, through solve_l_from / solve_lt_from
    on factor_from's and the pseudo-factor's data."""
    info = {}
    for pname in ("flat_schur50k", "wide_below"):
        s = probs[pname]
        t = split_span(s, pname)
        tl, nl = s._lump_of_span(t), s.skel.num_lumps
        for dt in (torch.float64, torch.float32):
            datas = batched(d64[pname], 2, dev).to(dt)
            fu = s.program("factor", 0, tl)(datas)
            fs = (s.program("factor", tl, nl)(fu),
                  s.program("pseudo", t, s.skel.num_spans)(fu))
            for nrhs in (1, 3):
                rb = torch.from_numpy(np.random.RandomState(nrhs).rand(
                    2, s.order, nrhs)).to(dev, dt)
                chk = CheckedOps()
                for f in fs:
                    for op in ("solve_l", "solve_lt"):
                        prog = s.program(op, tl, nl)
                        prog(f, rb, ops=chk)
                        check(torch.equal(prog(f, rb), prog(f, rb)),
                              f"{pname} {op}_from {dt} nrhs {nrhs}: two "
                              "runs differ")
                r = chk.rel["wide_tri_solve"]
                check(r <= KERNEL_RTOL[dt], f"wide_tri_solve vs twin on "
                      f"{pname} {dt} nrhs {nrhs} batch 2: rel {r}")
                check(any(sh[0] == "wide_tri_solve" for sh in chk.shapes),
                      f"{pname}: no wide_tri_solve call")
                info[f"{pname}_{str(dt)[6:]}_nrhs{nrhs}"] = {
                    "max_rel": r, "shapes": sorted(
                        sh for sh in chk.shapes if sh[0] == "wide_tri_solve")}
    log("k3_rest_wide_vs_twin", limits={"float64": 1e-10, "float32": 1e-4},
        batch=2, bitwise_rerun=True, **info)
    return info


def _host(t) -> np.ndarray:
    return np.asarray(t.tolist(), dtype=np.float64)


def _gathered(below_idx, rows, rp: int, order: int) -> tuple:
    """(the below_idx entries a call reads: the real below rows of its
    panels; the distinct vector rows they name, each read once however
    many panels gather it). The sentinel `order` names no row."""
    if rp == 0:
        return 0, 0
    live = torch.arange(rp, device=rows.device) < rows[:, None]
    idx = below_idx.view(-1, rp)[live]
    return int(idx.numel()), int(torch.unique(idx[idx != order]).numel())


def cost(name: str, args, kw=None) -> tuple:
    """(bytes, operations) that one wrapper call must move and do at the
    least, from its arguments (and keywords): each input element read
    once, each output written once (the index arrays it reads included,
    at the size it reads them: K2's from its plan, where the tree has
    one), the operations its real (unpadded) panels need. Reads its index
    arrays back to the host."""
    data = args[0]
    item, batch = data.element_size(), data.shape[0]
    if name == "segmented_subtract":
        out, src, tgt, seg_ptr, src_idx, width = args
        lay = (kw or {}).get("layout")
        ib = 8 if lay is None else lay.arrays["s_src"].element_size()
        ns, nt = src_idx.numel(), tgt.numel()
        return (batch * item * width * (ns + 2 * nt) +
                ib * (nt + seg_ptr.numel() + ns), batch * ns * width)
    if name == "dense_update":
        return k4_cost(data, args[1])
    if name == "bucket_factor":
        grids = k1_costs(args)
        # Linv (read by below) and x (read by prod) pass from one grid to
        # the next, and so do the index arrays: the call reads them once
        n, r = _host(args[4]), _host(args[3]) * (args[6] > 0)
        inner = batch * item * (("below" in grids) * n * (n + 1) / 2 +
                                ("prod" in grids) * r * n).sum() + \
            8 * 3 * args[2].numel() * (len(grids) - 1)
        return (sum(b for b, _ in grids.values()) - inner,
                sum(o for _, o in grids.values()))
    if name == "wide_factor":
        off, rows, cols, cp, rp = args[1:6]
        n, r = _host(cols), _host(rows) * (rp > 0)
        el = n * (n + 1) / 2 + r * n + n * n + r * n
        ops = 2 * n ** 3 / 3 + r * n * n
        return (batch * item * el.sum() + 8 * 3 * off.numel(),
                batch * ops.sum())
    if name in ("bucket_solve", "wide_solve", "tri_solve", "wide_tri_solve"):
        vv, off, rows, cols, below_idx, rp, transpose = (
            args[1], args[4], args[5], args[6], args[8], args[10], args[11])
        nrhs = vv.shape[2]
        n, r = _host(cols), _host(rows) * (rp > 0)
        # L pass: the RHS rows in and out, below . x out to y; Lt pass:
        # the RHS rows in and out, the gathered rows in (no y)
        el = n * (n + 1) / 2 + r * n + 2 * n * nrhs
        idx, rows_in = 4 * off.numel(), 0
        if transpose:
            live, rows_in = _gathered(below_idx, rows, rp, vv.shape[1])
            idx += live
        else:
            el = el + r * nrhs
        ops = n * n * nrhs + 2 * r * n * nrhs
        return (batch * item * (el.sum() + rows_in * nrhs) + 8 * idx,
                batch * ops.sum())
    if name == "grad_hess":
        # W read once, the touched Hessian and gradient elements read and
        # written once, the plan's index arrays the grids read; a
        # multiply-add per row of W per element of every record's block
        W, _, _, plan = args
        idx = plan.tab_a.numel() + plan.tab_b.numel() + sum(
            getattr(sg, k).numel() for sg in (plan.hess, plan.grad)
            for k in ("off", "stride", "ptr", "rec", "chunk_seg",
                      "chunk_p0", "chunk_ptr"))
        return (item * (W.numel() + 2 * (plan.hess.elements +
                                         plan.grad.elements)) + 8 * idx,
                2 * (plan.hess.macs + plan.grad.macs))
    if name in ("add_mv", "wide_add_mv"):
        x, off, rows, cols, below_idx, rp = (args[1], args[5], args[6],
                                             args[7], args[9], args[11])
        nrhs = x.shape[2]
        n, r = _host(cols), _host(rows) * (rp > 0)
        # x's own rows in, out's rows in and out, below . x out to y, the
        # gathered rows of x in
        el = n * (n + 1) / 2 + r * n + 3 * n * nrhs + r * nrhs
        live, rows_in = _gathered(below_idx, rows, rp, x.shape[1])
        ops = 2 * n * n * nrhs + 4 * r * n * nrhs
        return (batch * item * (el.sum() + rows_in * nrhs) +
                8 * (4 * off.numel() + live), batch * ops.sum())
    raise KeyError(name)


def k1_costs(args) -> dict:
    """K1's (bytes, operations) per grid at the least, from one call's
    arguments (data, prod, off, rows, cols, cp, rp, prod_base), for its
    real panels: chol reads the lower triangle (n (n + 1) / 2) and writes
    L and Linv^T (n^2), 2 n^3 / 3 flops (the Cholesky and the inverse);
    below reads Linv and the below rows and writes x (r x n), r n^2
    flops; prod (when the call has one) reads x and writes each panel's
    rp x rp product slice, zeros included (the buffer is uninitialised),
    r (r + 1) n flops: the symmetric product's r (r + 1) / 2 n
    multiply-adds. Each grid reads off, rows, cols."""
    data, prod, off, rows, cols, cp, rp = args[:7]
    item, batch = data.element_size(), data.shape[0]
    n, r = _host(cols), _host(rows) * (rp > 0)
    w = batch * item
    idx = 8 * 3 * off.numel()
    out = {"chol": (w * (n * (n + 1) / 2 + n * n).sum() + idx,
                    batch * (2 * n ** 3 / 3).sum())}
    if rp > 0:
        out["below"] = (w * (n * (n + 1) / 2 + 2 * r * n).sum() + idx,
                        batch * (r * n * n).sum())
        if prod is not None:
            out["prod"] = (w * (r * n + rp * rp).sum() + idx,
                           batch * (r * (r + 1) * n).sum())
    return out


def k4_cost(data, d) -> tuple:
    """K4's (bytes, operations) at the least: each origin's real below
    block x read once, each target element read and written once (the
    union of the narrow destinations' elements and the wide origins'
    targets), the plan's arrays; a multiply-add per record, element of
    its destination and column, and per column and element (i, j) of a
    wide origin's product whose row chain is at or past its column
    chain (this run's plan)."""
    dev, item, batch = data.device, data.element_size(), data.shape[0]

    def ranges(counts):  # per element: its owner, its index in the owner
        own = torch.repeat_interleave(
            torch.arange(counts.shape[0], device=dev), counts)
        k = torch.arange(own.shape[0], device=dev) - \
            (torch.cumsum(counts, 0) - counts)[own]
        return own, k
    x_el = int((d.org_rows * d.org_cols).sum())
    dst, _ = ranges(d.dst_ptr.diff())
    macs = int((d.dst_rows[dst] * d.dst_cols[dst] *
                (d.rec[:, 1] & 0xffff)).sum())
    q, k = ranges(d.dst_rows * d.dst_cols)
    tgt = [d.dst_off[q] + k // d.dst_cols[q] * d.dst_ld[q] +
           k % d.dst_cols[q]]
    for _, rows, n, _, r0, p0, c0, _, _ in d.wide:
        rch, rin = d.w_rch[r0:r0 + rows], d.w_rin[r0:r0 + rows]
        end = torch.cumsum(torch.bincount(rch), 0)  # past each chain
        i, j = ranges(end[rch])  # (i, j): j before the end of i's chain
        a, b = rch[i], rch[j]
        tgt.append(d.w_pt[p0 + a * (a + 1) // 2 + b] +
                   rin[i] * d.w_cld[c0 + b] + rin[j])
        macs += i.shape[0] * n
    t_el = int(torch.unique(torch.cat(tgt)).numel())
    idx = sum(getattr(d, k).numel() for k in (
        "rec", "dst_off", "dst_ld", "dst_rows", "dst_cols", "dst_nk",
        "dst_ptr", "dst_short", "dst_long", "w_tile", "w_rch", "w_rin",
        "w_pt", "w_cld"))
    return (batch * item * (x_el + 2 * t_el) + 8 * idx, 2 * batch * macs)


def pseudo_cost(s, span: int, item: int = 8) -> tuple:
    """(bytes, operations) of pseudo_factor_from(span) at the least: each
    span's diagonal block (lower triangle) and the rows below it in its
    lump read once and written once, a Cholesky and a triangular solve
    of those rows per span."""
    sk = s.skel
    sp = np.arange(span, sk.num_spans)
    n = np.diff(sk.span_start)[sp]
    lump = sk.span_to_lump[sp]
    rows = (np.diff(sk.lump_start)[lump] - sk.span_offset_in_lump[sp] - n +
            sk.below_rows[lump])
    el = n * (n + 1) / 2 + rows * n
    return 2 * item * el.sum(), (n ** 3 / 3 + rows * n * n).sum()


def bound(bytes_: float, ops: float):
    """(bound ms, "bytes" or "operations")."""
    tb, to = bytes_ / PEAK_BYTES_S, ops / PEAK_FLOPS_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def library_call(name: str, args):
    """One PyTorch call (or a pair) that computes what this wrapper call
    computes on the same inputs, where there is one; else None. K2: an
    index_add_ of the gathered sources; K3-wide and K3-rest wide on one
    panel: wide_solve_library_call; K1-wide:
    cholesky_ex and two triangular solves per panel; K6: einsum and
    index_add_ per block pair."""
    if name == "segmented_subtract":
        out, src, tgt, seg_ptr, src_idx, width = args
        b = out.shape[0]
        e_tgt = torch.repeat_interleave(tgt, seg_ptr.diff())
        o, sv = out.clone().view(b, -1, width), src.view(b, -1, width)
        return lambda: o.index_add_(1, e_tgt, sv[:, src_idx], alpha=-1)
    if name in ("wide_solve", "wide_tri_solve"):
        if args[4].shape[0] != 1 or args[0].shape[0] != 1:
            return None
        return wide_solve_library_call(args)
    if name == "wide_factor":
        return wide_factor_library_call(*args)
    if name == "grad_hess":
        return k6_library_call(*args)
    return None


def wide_solve_library_call(args):
    """K3-wide's function in PyTorch calls, per panel, on its real rows
    and columns read from the same buffer: the L pass
    torch.linalg.solve_triangular(L, b) (it reads only the lower
    triangle, so the stored inverse above is ignored), then, with below
    rows, torch.matmul(below, x) for y; the Lt pass b - torch.matmul(
    below^T, g), g the gathered rows (gathered here, outside the timed
    call; a sentinel gives a zero row), then solve_triangular(L^T, .).
    For a yardstick the port never calls."""
    data, vv, _, _, off, rows, cols, vec_off, below_idx, cp, rp, \
        transpose = args[:12]
    order, jobs = vv.shape[1], []
    ext = torch.cat([vv[0], vv.new_zeros((1, vv.shape[2]))])
    for p in range(off.shape[0]):
        n, o, v0 = int(cols[p]), int(off[p]), int(vec_off[p])
        r = int(rows[p]) if rp else 0
        L = kernels._panel_view(data, o, cp, 0, 0, n, n)[0]
        below = kernels._panel_view(data, o, cp, cp, 0, r, n)[0] \
            if r else None
        g = ext[below_idx.view(-1, rp)[p, :r].clamp(max=order)] \
            if r and transpose else None
        jobs.append((L, vv[0, v0:v0 + n].clone(), below, g))

    def run():
        for L, b, below, g in jobs:
            if transpose:
                t = b - torch.matmul(below.mT, g) if g is not None else b
                torch.linalg.solve_triangular(L.mT, t, upper=True)
            else:
                x = torch.linalg.solve_triangular(L, b, upper=False)
                if below is not None:
                    torch.matmul(below, x)
    return run


def wide_factor_library_call(data, off, rows, cols, cp, rp, off_h, cols_h):
    """K1-wide's function in PyTorch calls, as k1_levels times K1's chol
    and below: per panel, torch.linalg.cholesky_ex then
    solve_triangular(L, I) on its real diagonal block (mirrored), and
    solve_triangular(L^T, below, left=False) on its real below rows;
    the operands copied here, outside the timed call."""
    jobs, nrows = [], _host(rows) if rp else None
    for b, (o, n) in enumerate(zip(off_h, cols_h)):
        D = kernels._panel_view(data, o, cp, 0, 0, n, n)
        sym = torch.tril(D) + torch.tril(D, -1).mT
        eye = torch.eye(n, dtype=data.dtype, device=data.device)
        r = int(nrows[b]) if rp else 0
        below = kernels._panel_view(data, o, cp, cp, 0, r, n).clone() \
            if r else None
        jobs.append((sym, eye.expand_as(sym), below))

    def run():
        for sym, eye, below in jobs:
            L = torch.linalg.cholesky_ex(sym)[0]
            torch.linalg.solve_triangular(L, eye, upper=False)
            if below is not None:
                torch.linalg.solve_triangular(L.mT, below, upper=True,
                                              left=False)
    return run


def k6_library_call(W, hdata, grad, plan):
    """K6's function in PyTorch calls, two per block pair (an einsum and
    an index_add_, the JAX package's formula) on copies of the outputs;
    the scatter indices are built here, outside the timed call."""
    dev, jobs, r = W.device, [], W[:, :, -1]
    hd, gd = hdata.clone(), grad.clone()
    for a, td, vec_off in plan.vecs:
        idx = (vec_off[:, None] + torch.arange(td, device=dev)).reshape(-1)
        jobs.append((gd, idx, "bri,br->bi", W[:, :, a:a + td], r))
    for a, ti, b, tj, off, stride, flip in plan.pairs:
        e = torch.arange(ti * tj, device=dev)
        rr, cc = e // tj, e % tj
        idx = torch.where(flip[:, None], off[:, None] + cc * stride[:, None]
                          + rr, off[:, None] + rr * stride[:, None] + cc)
        jobs.append((hd, idx.reshape(-1), "bri,brj->bij", W[:, :, a:a + ti],
                     W[:, :, b:b + tj]))

    def run():
        for out, idx, eq, x, y in jobs:
            out.index_add_(0, idx, torch.einsum(eq, x, y).reshape(-1))
    return run


class TimedOps:
    """Records a pair of CUDA events around every call of `ops`, to sum
    the device time per kernel (or per twin) over one run of a path;
    with `costs`, also each call's bytes and operations (cost()) and, for
    the kernels that have one, its library call (library_call()), timed
    after the run, and the calls themselves, replayed back to back as
    the library calls are (replay_ms()), so the two compare like for
    like: the events around a single call also hold its host work."""

    def __init__(self, ops, costs: bool = False):
        self.ops = ops
        self.costs = costs
        self.events = {name: [] for name in NAMES}
        self.work = {name: [0.0, 0.0] for name in NAMES}
        self.libs = {name: [] for name in NAMES}
        self.calls = {name: [] for name in NAMES}
        for name in NAMES:
            setattr(self, name, functools.partial(self._timed, name))

    def _timed(self, name, *args, **kw):
        if self.costs:
            lib = library_call(name, args)
            if lib is not None:
                self.libs[name].append(lib)
            self.calls[name].append((args, kw))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        getattr(self.ops, name)(*args, **kw)
        b.record()
        self.events[name].append((a, b))
        if self.costs:
            by, op = cost(name, args, kw)
            self.work[name][0] += by
            self.work[name][1] += op

    def ms(self):
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v)
                for k, v in self.events.items() if v}

    def bounds(self):
        return {k: bound(*self.work[k]) for k, v in self.events.items()
                if v}

    def replay_ms(self, name: str) -> float:
        """The recorded calls of one kernel replayed back to back, timed
        as library_ms times the library calls (they update their outputs
        in place again, which changes no time)."""
        calls = self.calls[name]
        fn = getattr(self.ops, name)
        return time_ms(lambda: [fn(*a, **kw) for a, kw in calls], 3,
                       warmup=1)

    def library_ms(self):
        """Per kernel, the summed time of the library calls replaying its
        calls (None unless every call of it had one)."""
        out = {}
        for k, v in self.events.items():
            if v and len(self.libs[k]) == len(v):
                out[k] = sum(time_ms(f, 3, warmup=1) for f in self.libs[k])
            elif v:
                out[k] = None
        return out


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _short(name: str) -> str:
    """A CUDA kernel's function name without its namespace and
    arguments."""
    m = re.search(r"(\w+)(?:<[^()]*>)?\(", name)
    return m.group(1) if m else name[:60]


TRACE_LEAD_IN_S = 0.05


def counted_device_events(events, device, mark: str = "counted_runs"):
    """The device records (device_type `device`) of the work that starts
    once the range `mark` opens (its first record, on the host or the
    device): the records before it (a warm-up's, a primer's) and the
    range's own record on the device's timeline are left out."""
    start = min(e.time_range.start for e in events if e.name == mark)
    return [e for e in events if e.device_type == device and
            e.time_range.start >= start and e.name != mark]


def trace(fn, reps: int, lead_in_s: float = TRACE_LEAD_IN_S, prime=None):
    """Runs fn() `reps` times under torch.profiler (after one warm-up
    call, a lead-in of `lead_in_s` and, when given, prime() inside the
    profiler) and reads the device activity of those runs (the work
    that starts after the counted range opens) off the trace:
    device time and launches per kernel name, the number of device
    activities, and the busy time as the union of their intervals on the
    trace timeline. The idle share is
    1 - busy / (last end - first start) over the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the profiler loses, in about 1 trace of 100, the device records
        # of the launches of its first few ms (tools/trace_loss.py), so
        # the host waits before the first call
        time.sleep(lead_in_s)
        if prime is not None:
            prime()
            torch.cuda.synchronize()
        with record_function("counted_runs"):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    ev = counted_device_events(prof.events(), DeviceType.CUDA)
    check(len(ev) > 0, "the profiler saw no device activity")
    by_name, n_name = {}, {}
    for e in ev:
        k = _short(e.name)
        by_name[k] = by_name.get(k, 0.0) + e.time_range.elapsed_us()
        n_name[k] = n_name.get(k, 0) + 1
    iv = sorted((e.time_range.start, e.time_range.end) for e in ev)
    busy, (a, b) = 0.0, iv[0]
    for s, e in iv[1:]:
        if s > b:
            busy, a, b = busy + (b - a), s, e
        else:
            b = max(b, e)
    busy += b - a
    span = iv[-1][1] - iv[0][0]
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    rest = ranked[12:]
    return {"reps": reps,
            "wall_ms_per_call": wall * 1e3 / reps,
            "device_span_ms_per_call": span / 1e3 / reps,
            "device_busy_ms_per_call": busy / 1e3 / reps,
            "idle_share": 1.0 - busy / span,
            "device_activities_per_call": len(ev) / reps,
            "device_ms_per_call_by_kernel": {
                k: v / 1e3 / reps for k, v in ranked[:12]},
            # the kernels below the top 12, summed
            "other_kernels": {
                "names": len(rest),
                "device_ms_per_call": sum(v for _, v in rest) / 1e3 / reps,
                "launches_per_call": sum(n_name[k] for k, _ in rest) / reps},
            "launches_per_call_by_kernel": {
                k: v / reps for k, v in n_name.items()}}


def factor_residual(solver, data: np.ndarray, f: np.ndarray) -> float:
    dense = solver.skel.densify(data.astype(np.float64),
                                fill_upper_half=True)
    L = np.tril(solver.skel.densify(f.astype(np.float64)))
    return float(np.linalg.norm(L @ L.T - dense) / np.linalg.norm(dense))


def solve_residual(solver, data: np.ndarray, x: np.ndarray,
                   b: np.ndarray) -> float:
    dense = solver.skel.densify(data.astype(np.float64),
                                fill_upper_half=True)
    return float(np.linalg.norm(dense @ x - b) / np.linalg.norm(b))


def sparse_lower(solver, data: np.ndarray):
    """scipy CSR of the lower triangle (row >= column) that the skeleton
    stores in `data`, in the solver's internal order: every chain block,
    without padding and without the stored inverse above the diagonal."""
    import scipy.sparse as sp
    sk = solver.skel
    span_size = np.diff(sk.span_start)
    lump = np.repeat(np.arange(sk.num_lumps), np.diff(sk.chain_col_ptr))
    s = sk.chain_row_span
    h, w = span_size[s], np.diff(sk.lump_start)[lump]
    cnt = h * w
    e = np.repeat(np.arange(len(s)), cnt)
    k = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    i, c = k // w[e], k % w[e]
    row = sk.span_start[s][e] + i
    col = sk.lump_start[lump][e] + c
    keep = row >= col
    idx = sk.chain_data[e] + i * sk.col_stride[lump][e] + c
    n = solver.order
    return sp.csr_matrix((data.astype(np.float64)[idx[keep]],
                          (row[keep], col[keep])), shape=(n, n))


def sparse_matrix(solver, data: np.ndarray):
    """scipy CSR of the whole symmetric matrix held in `data`."""
    import scipy.sparse as sp
    lo = sparse_lower(solver, data)
    return (lo + lo.T - sp.diags(lo.diagonal())).tocsr()


SCHUR_T = 50000  # the end of FLAT+Schur 50k's elimination range


def split_span(s, pname: str) -> int:
    """The partial ops' split: the end of the elimination range on
    FLAT+Schur 50k, a lump boundary near the middle elsewhere."""
    if pname == "flat_schur50k":
        return SCHUR_T
    return int(s.skel.lump_to_span[max(1, s.skel.num_lumps // 2)])


def pcg_path(s, d, b, precond: str, t: int = SCHUR_T, tol: float = 1e-12,
             max_iters: int = 200) -> dict:
    """The mixed direct/iterative solve (testing/flows.py, the flow that
    tests/test_torch_pcg.py holds against the JAX package) on the card.
    Returns the solution, the iterations and host seconds of the
    preconditioner's init and of the pcg loop (synchronised)."""
    stamps = {}

    def mark(stage):
        torch.cuda.synchronize()
        stamps[stage] = time.perf_counter()
    x, it, _ = pcg_flow(s, d, b, precond, t, tol, max_iters, mark=mark)
    return {"x": x, "iterations": it,
            "init_s": stamps["init"] - stamps["up_to"],
            "pcg_s": stamps["pcg"] - stamps["init"]}


def partial_ops(s, pname, d, b, ops) -> None:
    """The partial ops of a path through `ops`: the up-to solves on
    factor_up_to's output, the from-solves on factor_from's and on the
    pseudo-factor's, add_mv from 0 and from the split."""
    t = split_span(s, pname)
    tl, nl = s._lump_of_span(t), s.skel.num_lumps
    fu = s.program("factor", 0, tl)(d)
    ff = s.program("factor", tl, nl)(fu)
    pf = s.program("pseudo", t, s.skel.num_spans)(fu)
    for bb in (b, b[..., :1].contiguous()):
        s.program("solve_l", 0, tl)(fu, bb, ops=ops)
        s.program("solve_lt", 0, tl)(fu, bb, ops=ops)
        for f in (ff, pf):
            s.program("solve_l", tl, nl)(f, bb, ops=ops)
            s.program("solve_lt", tl, nl)(f, bb, ops=ops)
        s.program("add_mv", 0)(d, bb, bb * 0.5, 0.7, ops=ops)
        s.program("add_mv", tl)(d, bb, bb * 0.5, -1.3, ops=ops)


def partial_batch_bitwise(s, pname, datas, rb) -> None:
    """Checks that every item of a batched factor_up_to, partial solve
    and add_mv_from equals the same call on that item alone, bitwise."""
    t = split_span(s, pname)
    fu = s.factor_up_to(datas, t)
    ff = s.factor_from(fu, t)
    runs = [("factor_up_to", fu, lambda i: s.factor_up_to(datas[i], t)),
            ("add_mv_from", s.add_mv_from(datas, t, rb, rb, 0.5),
             lambda i: s.add_mv_from(datas[i], t, rb[i], rb[i], 0.5))]
    for m, f in (("solve_l_up_to", fu), ("solve_lt_up_to", fu),
                 ("solve_l_from", ff), ("solve_lt_from", ff)):
        runs.append((m, getattr(s, m)(f, t, rb),
                     lambda i, m=m, f=f: getattr(s, m)(f[i], t, rb[i])))
    for m, got, single in runs:
        for i in range(datas.shape[0]):
            check(torch.equal(got[i], single(i)),
                  f"{pname} batch item {i} {m} differs")


def sparse_residuals(solver, data, f, x=None, b=None, seed=0):
    """Residuals from sparse products, for orders where a dense matrix
    does not fit: the factor's on a random probe z,
    |L (L^T z) - A z| / |A z|, and the solve's |A x - b| / |b|."""
    import scipy.sparse as sp
    lo = sparse_lower(solver, data)
    A = lo + lo.T - sp.diags(lo.diagonal())
    L = sparse_lower(solver, f)
    z = np.random.RandomState(seed).rand(solver.order)
    az = A @ z
    fr = float(np.linalg.norm(L @ (L.T @ z) - az) / np.linalg.norm(az))
    sr = None if x is None else \
        float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))
    return fr, sr


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def counted(name: str, fn):
    """Runs fn() with every launch counter set to 0 just before it and
    reads the counters just after; checks that the path launched each of
    its kernels and ran no twin."""
    torch.cuda.synchronize()
    kernels.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = {k: (v.launches, v.twin_calls, v.grid_launches)
              for k, v in kernels.COUNTS.items()}
    for k in PATH_KERNELS[name]:
        check(counts[k][0] > 0, f"{k} was not launched on the {name} path")
    for k, (_, tw, _) in counts.items():
        check(tw == 0, f"{k}'s twin ran on the GPU {name} path")
    return out, counts


def factor_solve(s, d, b):
    f = s.factor(d)
    return f, s.solve(f, b)


def batched(data_np, batch, dev):
    d = torch.from_numpy(data_np).to(dev)
    return torch.stack([d * (1.0 + 0.01 * i) for i in range(batch)])


def stage_clock(stamps: list):
    """A mark(stage) callback for Optimizer.mark: synchronises the card
    and appends (stage, host seconds) to `stamps`."""
    def mark(stage):
        torch.cuda.synchronize()
        stamps.append((stage, time.perf_counter()))
    return mark


def lm_breakdown(stamps: list) -> list:
    """Host ms per stage of an optimize() run from its stamps (the first
    is the start): one entry for the first gradient / Hessian, then one
    per LM iteration (its trials' damp + factor, solve and retract +
    cost, summed, then the next point's Jacobians and K6)."""
    iters, cur, prev = [], {}, stamps[0][1]
    for stage, t in stamps[1:]:
        cur[stage] = cur.get(stage, 0.0) + (t - prev) * 1e3
        prev = t
        if stage == "damp_factor":
            cur["trials"] = cur.get("trials", 0) + 1
        if stage == "assembly":
            iters.append(cur)
            cur = {}
    return iters + ([cur] if cur else [])


def reset_values(opt, values0) -> None:
    for fam, v in zip(opt.families, values0):
        fam.values = v.clone()


def bal_setup(dev):
    """BAL 871 x 527,480 through build_ba_optimizer -> build_solver on
    the card, PLANNED, f64, with the host seconds of each set-up stage,
    the first-call device programs of both LM paths included."""
    from baspacho_tpu_torch.bal import make_random_bal
    from baspacho_tpu_torch.testing.problems import BAL871
    t0 = time.perf_counter()
    prob = make_random_bal(**BAL871)
    t1 = time.perf_counter()
    stamps = [("start", time.perf_counter())]
    opt = ba_optimizer(prob, ba_settings(T.BackendType.PLANNED, 1), dev,
                       mark=stage_clock(stamps))
    s = opt.solver
    nl, tl = s.skel.num_lumps, s._lump_of_span(opt.elim_end_span)
    sched = s.backend._factor_schedule(0, nl)
    s.backend._solve_schedule(0, nl)
    s.factor_program()
    s.solve_program()
    for op, a, b in (("factor", 0, tl), ("solve_l", 0, tl),
                     ("solve_lt", 0, tl)):
        s.program(op, a, b)
    s.program("add_mv", tl)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    unseen = sorted(set(range(prob.num_cameras)) -
                    set(prob.obs_cam.tolist()))
    info = {
        "cameras": prob.num_cameras, "points": prob.num_points,
        "observations": prob.num_observations, "unobserved_cameras": unseen,
        "order": s.order, "data_size": s.data_size, "lumps": nl,
        "levels": [{"dense": lv[3] is not None,
                    "buckets": [[b.cp, b.rp, len(b.off)] for b in lv[0]]}
                   for lv in sched],
        "k6_plan": [{"rdim": p.rdim, "tdw": p.tdw,
                     "hess_blocks": p.hess.ptr.numel() - 1,
                     "hess_long": p.hess.long.numel(),
                     "grad_blocks": p.grad.ptr.numel() - 1,
                     "grad_long": p.grad.long.numel(),
                     "records": p.hess.rec.numel() + p.grad.rec.numel()}
                    for _, p in opt._plans],
        "problem_s": t1 - t0,
        "graph_and_create_solver_s": stamps[1][1] - stamps[0][1],
        "assembly_plans_s": stamps[2][1] - stamps[1][1],
        "programs_s": t2 - stamps[2][1]}
    return opt, [f.values.clone() for f in opt.families], info


def bal_damped(opt, values0, settings) -> tuple:
    """BAL's first damped system from the start values: (damped Hessian
    data, gradient, damping), damped additively as the LM loop does."""
    s = opt.solver
    reset_values(opt, values0)
    _, grad, hdata = opt.compute_grad_hess([f.values for f in opt.families])
    idx = torch.from_numpy(s.skel.damp_indices()).to(hdata.device)
    lam = settings.init_damping
    damped = hdata.clone()
    damped[idx] = damped[idx] * (1.0 + lam) + lam
    return damped, grad, lam


def bal_phase(dev, name_limit: str) -> dict:
    """LM on BAL 871 x 527,480, f64, PLANNED, on the card: the direct
    path counted (3 iterations, per-stage host ms), the residuals of the
    first damped system, a bitwise rerun of one iteration, the partial
    factor + PCG path with BlockJacobi counted (2 iterations), K6 against
    its twin (f64, f32) and against itself, K6 timed. Returns what the
    record and the trace phase need."""
    opt, values0, info = bal_setup(dev)
    s = opt.solver
    log("bal871_setup", card=name_limit, **info)
    out = {"opt": opt, "values0": values0}

    # the direct LM path, counted
    direct = ba_settings(T.BackendType.PLANNED, 3, **BAL_DAMP)
    stamps = [("start", time.perf_counter())]
    opt.mark = stage_clock(stamps)
    st, out["c_direct"] = counted("bal_lm_direct",
                                  lambda: opt.optimize(direct))
    opt.mark = None
    costs = st["costs"]
    check(st["iters"] >= 1 and all(b < a for a, b in zip(costs, costs[1:])),
          f"BAL 871 direct LM: the cost must fall on every accepted step: "
          f"{costs}")
    check(all(bool(torch.isfinite(f.values).all()) for f in opt.families),
          "BAL 871 direct LM: non-finite values")
    check(len(costs) == len(BAL_COSTS["direct"]) and
          all(abs(a / b - 1) <= 1e-9 for a, b in zip(costs,
                                                      BAL_COSTS["direct"])),
          f"BAL 871 direct LM costs {costs}, expected "
          f"{BAL_COSTS['direct']}")
    log("bal871_lm_direct", card=name_limit, dtype="float64",
        settings={"max_iters": 3, **BAL_DAMP}, iterations=st["iters"],
        costs=costs, stages_ms=lm_breakdown(stamps),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches={k: v[0] for k, v in out["c_direct"].items() if v[0]})

    # residuals of the first damped system: the factor's on a random
    # probe from scipy sparse products (sparse_residuals), the solve's
    # through add_mv_from(0)
    damped, grad, lam = bal_damped(opt, values0, direct)
    f = s.factor(damped)
    x = s.solve(f, -grad)
    r = s.add_mv_from(damped, 0, x, torch.zeros_like(x)) + grad
    solve_res = float(r.norm() / grad.norm())
    factor_res, _ = sparse_residuals(s, damped.cpu().numpy(),
                                     f.cpu().numpy())
    check(factor_res <= 1e-10 and solve_res <= 1e-10,
          f"BAL 871 damped system: factor residual {factor_res}, solve "
          f"residual {solve_res}")
    del f, x, r
    log("bal871_residuals", limit=1e-10, damping=lam, **BAL_DAMP,
        factor_residual_probe=factor_res, solve_residual=solve_res)

    # K4 on each dense level of that system's factor (the point level and
    # the wide camera levels): against its twin, against itself, timed; K1
    # on its pair levels runs at the end (main, k1_levels)
    out["k4"] = k4_levels(s, damped, "bal871", name_limit)
    out["damped"], out["grad"] = damped, grad

    # one LM iteration twice from the same start: the same bits
    one = ba_settings(T.BackendType.PLANNED, 1, **BAL_DAMP)
    runs = []
    for _ in range(2):
        reset_values(opt, values0)
        c = opt.optimize(one)["costs"]
        runs.append((c, [f.values.clone() for f in opt.families]))
    check(runs[0][0] == runs[1][0] == costs[:2] and
          all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1])),
          "BAL 871: a rerun of the first LM iteration differs")
    log("bal871_rerun", bitwise_equal=True, costs=runs[0][0])
    del runs

    # the partial factor + PCG path with BlockJacobi, counted
    reset_values(opt, values0)
    pcg = ba_settings(T.BackendType.PLANNED, 2, pcg=True, **BAL_DAMP)
    stamps = [("start", time.perf_counter())]
    opt.mark = stage_clock(stamps)
    st, out["c_pcg"] = counted("bal_lm_pcg", lambda: opt.optimize(pcg))
    opt.mark = None
    pc = st["costs"]
    check(st["iters"] >= 1 and all(b < a for a, b in zip(pc, pc[1:])),
          f"BAL 871 PCG LM: the cost must fall on every accepted step: {pc}")
    check(len(pc) == len(BAL_COSTS["pcg"]) and
          all(abs(a / b - 1) <= 1e-9 for a, b in zip(pc, BAL_COSTS["pcg"]))
          and list(st["pcg_iters"]) == BAL_PCG_ITERS,
          f"BAL 871 PCG LM costs {pc}, iterations {st['pcg_iters']}; "
          f"expected {BAL_COSTS['pcg']}, {BAL_PCG_ITERS}")
    log("bal871_lm_pcg", card=name_limit, dtype="float64",
        settings={"max_iters": 2, "precond": "BlockJacobiPrecond",
                  "pcg_tol": pcg.pcg_tol, "pcg_max_iters": pcg.pcg_max_iters,
                  **BAL_DAMP},
        iterations=st["iters"], costs=pc, pcg_iterations=st["pcg_iters"],
        stages_ms=lm_breakdown(stamps),
        launches={k: v[0] for k, v in out["c_pcg"].items() if v[0]})

    # K6 against its twin on BAL 871's assembly (the twin's index_add_
    # sums with atomics on the card: a tolerance), and against itself
    reset_values(opt, values0)
    terms = opt.jacobians([f.values for f in opt.families])
    out["terms"] = terms
    rel, absd = {}, 0.0
    for dt in (torch.float64, torch.float32):
        r, a, same = k6_vs_twin(opt, terms, dt)
        check(r <= KERNEL_RTOL[dt], f"grad_hess vs twin on BAL 871 {dt}: "
              f"rel {r}")
        check(same, f"grad_hess on BAL 871 {dt}: two runs differ")
        rel[f"bal871_{str(dt)[6:]}"], absd = r, max(absd, a)
    out["rel"], out["abs"] = rel, absd
    log("bal871_k6_vs_twin", limits={"float64": 1e-10, "float32": 1e-4},
        max_rel=rel, bitwise_rerun=True)

    # K6 timed over one assembly (both families), f64, beside its twin,
    # its bound and the einsum + index_add_ calls
    h0 = torch.zeros(s.data_size, dtype=torch.float64, device=dev)
    g0 = torch.zeros(s.order, dtype=torch.float64, device=dev)
    got = {}
    for impl, ops in (("kernels", kernels), ("twins", kernels.TWINS)):
        for warm in (True, False):
            tops = TimedOps(ops, costs=warm and impl == "kernels")
            for (_, W), (_, plan) in zip(terms, opt._plans):
                tops.grad_hess(W, h0.clone(), g0.clone(), plan)
            if warm and impl == "kernels":
                out["bound"] = tops.bounds()["grad_hess"]
                out["library_ms"] = tops.library_ms()["grad_hess"]
                out["back_to_back_ms"] = tops.replay_ms("grad_hess")
        got[impl] = tops.ms()["grad_hess"]
    out["ms"], out["plain_ms"] = got["kernels"], got["twins"]
    log("time_per_kernel", case="bal871 f64 one assembly", card=name_limit,
        kernel="grad_hess", kernel_ms=got["kernels"], twin_ms=got["twins"],
        bound_ms=out["bound"][0], bound_by=out["bound"][1],
        library_ms=out["library_ms"],
        kernel_back_to_back_ms=out["back_to_back_ms"],
        library_call="torch.einsum + Tensor.index_add_, two calls per "
                     "block pair and per gradient slot")
    del h0, g0
    return out


def se3_dense_check(dev) -> dict:
    """The assembled gradient and Hessian of the SE3 bundle adjustment of
    tests/test_optimizer.py against J^T r and J^T J computed densely, on
    the card."""
    import baspacho_tpu_torch.optimizer as TO
    opt = se3_ba(TO, device=dev)[0]
    opt.build_solver(TO.OptimizerSettings(backend=T.BackendType.PLANNED))
    vals = [f.values for f in opt.families]
    _, grad, hdata = opt.compute_grad_hess(vals)
    g, H = dense_normal_equations(opt, vals)
    hd = opt.solver.skel.densify(hdata.cpu().numpy(), fill_upper_half=True)
    gr = float(np.abs(grad.cpu().numpy() - g).max() / np.abs(g).max())
    hr = float(np.abs(hd - H).max() / np.abs(H).max())
    check(gr <= 1e-12 and hr <= 1e-12,
          f"SE3 BA assembly vs dense: grad rel {gr}, hessian rel {hr}")
    return {"grad_rel": gr, "hessian_rel": hr, "limit": 1e-12}


def demo_twins() -> dict:
    """The demo twins (baspacho_tpu_torch/examples) on the card, through
    their default device; their own output is dropped."""
    import contextlib
    import io
    from baspacho_tpu_torch.examples import (diff_solve, optimize_ba,
                                             optimize_simple)
    with contextlib.redirect_stdout(io.StringIO()):
        simple = optimize_simple.main([])
        ba = optimize_ba.main([])
        diff = diff_solve.main(["--steps", "400"])
    out = {"optimize_simple_costs": simple["costs"],
           "optimize_ba_costs": ba["costs"],
           "diff_solve_loss_first_last": [diff["losses"][0],
                                          diff["losses"][-1]]}
    check(simple["final_cost"] < 1e-16 and
          all(b < a for a, b in zip(ba["costs"], ba["costs"][1:])) and
          diff["losses"][-1] < 0.5 * diff["losses"][0],
          f"demo twins on the card: {out}")
    return out


def trace_checked(label: str, what: str, fn, reps: int, **fields) -> None:
    """Traces fn (trace()) and checks that the trace's count of each
    wrapper's grids equals the wrappers' own grid-launch counters over
    one call."""
    kernels.reset_counts()
    fn()
    torch.cuda.synchronize()
    grids = {k: v.grid_launches for k, v in kernels.COUNTS.items()}
    calls = kernels.COUNTS["wide_tri_solve"].launches
    check(grids["wide_tri_solve"] <= 3 * calls, f"{label} {what}: "
          f"wide_tri_solve launched {grids['wide_tri_solve']} grids in "
          f"{calls} calls (at most 3 each)")
    tr = trace(fn, reps)
    seen = tr.pop("launches_per_call_by_kernel")
    off = {k: sum(seen.get(e, 0) for e in names)
           for k, names in GRIDS.items()}
    off = {k: n for k, n in off.items() if n != grids[k]}
    check(not off, f"{label} {what}: the trace shows {off} grids per "
          f"call, the counters {grids}; per kernel {seen}")
    log("trace", case=label, op=what, **fields,
        grid_launches_per_call={k: v for k, v in grids.items() if v}, **tr)


def k5_phase(schur50, d50, opt, damped, name_limit: str) -> dict:
    """k5_levels on BAL 871 (the PCG operator add_mv_from(t) on
    factor_up_to's output, and add_mv_from(0) on the damped system) and
    on FLAT+Schur 50k (add_mv_from(0), and add_mv_from(t) on its
    factor_up_to)."""
    s = opt.solver
    t = opt.elim_end_span
    out = {"bal871": k5_levels(
        s, [("add_mv_from(t)", s.factor_up_to(damped, t),
             s._lump_of_span(t)), ("add_mv_from(0)", damped, 0)],
        "bal871", name_limit)}
    out["flat_schur50k"] = k5_levels(
        schur50, [("add_mv_from(0)", d50, 0),
                  ("add_mv_from(t)", schur50.factor_up_to(d50, SCHUR_T),
                   schur50._lump_of_span(SCHUR_T))],
        "flat_schur50k", name_limit)
    return out


def k5_only(dev, name_limit: str) -> int:
    """`--only k5`: the build, then K5's phases alone (k5_phase and the
    BAL PCG trace), for iterating on K5 without the whole run."""
    t0 = time.perf_counter()
    log("build", library=kernels.build())
    kernels._lib()
    schur50 = flat_schur50k(T, device=dev)
    d50 = torch.from_numpy(spd_data(schur50, 1)).to(dev)
    opt, values0, _ = bal_setup(dev)
    damped, grad, _ = bal_damped(
        opt, values0, ba_settings(T.BackendType.PLANNED, 1, **BAL_DAMP))
    bal_pcg_trace(opt.solver, damped, grad, opt.elim_end_span, name_limit)
    k5_phase(schur50, d50, opt, damped, name_limit)
    log("k5_only", seconds=time.perf_counter() - t0)
    print(card(), flush=True)
    return 0


def k1w_only(dev, name_limit: str) -> int:
    """`--only k1w`: the build, then K1-wide's phases alone: the NaN
    pattern (k1_not_pd), BAL 871's direct LM held to BAL_COSTS, and
    k1w_levels on FLAT n=1000, FLAT+Schur 50k, WIDE_BELOW and BAL 871's
    first damped system, for iterating on K1-wide without the whole
    run."""
    t0 = time.perf_counter()
    log("build", library=kernels.build())
    kernels._lib()
    k1_not_pd(dev, name_limit)
    cases = []
    for pname, make in (("flat1000", flat1000),
                        ("flat_schur50k", flat_schur50k),
                        ("wide_below", wide_below)):
        s = make(T, device=dev)
        cases.append((pname, s, torch.from_numpy(spd_data(s, 1)).to(dev)))
    opt, values0, _ = bal_setup(dev)
    bal_direct_costs(opt, name_limit)
    damped, _, _ = bal_damped(
        opt, values0, ba_settings(T.BackendType.PLANNED, 3, **BAL_DAMP))
    cases.append(("bal871", opt.solver, damped))
    k1w_levels(cases, name_limit)
    log("k1w_only", seconds=time.perf_counter() - t0)
    print(card(), flush=True)
    return 0


def bal_direct_costs(opt, name_limit: str) -> list:
    """BAL 871's direct LM (3 iterations) from the set-up's values, its
    costs held to BAL_COSTS."""
    costs = opt.optimize(ba_settings(T.BackendType.PLANNED, 3,
                                     **BAL_DAMP))["costs"]
    check(len(costs) == len(BAL_COSTS["direct"]) and
          all(abs(a / b - 1) <= 1e-9 for a, b in zip(costs,
                                                      BAL_COSTS["direct"])),
          f"BAL 871 direct LM costs {costs}, expected {BAL_COSTS['direct']}")
    log("bal871_lm_direct", card=name_limit, costs=costs)
    return costs


def solve_cases(probs, d64, names, bal_solver, bal_damped_data) -> list:
    """solve_levels' cases: the factor of each named problem's data and
    of BAL 871's first damped system."""
    dev = bal_damped_data.device
    cases = [(p, probs[p], probs[p].factor(torch.from_numpy(d64[p]).to(dev)))
             for p in names]
    cases.append(("bal871", bal_solver, bal_solver.factor(bal_damped_data)))
    return cases


def solve_only(wrapper: str, dev, name_limit: str) -> int:
    """`--only k3` (wrapper bucket_solve) and `--only k3w` (wide_solve):
    the build, then the wrapper's phase alone (solve_levels on
    K3_PROBLEMS or K3W_PROBLEMS and BAL 871's first damped system) and
    BAL 871's direct LM held to BAL_COSTS, for iterating on
    csrc/bucket_solve.cu or csrc/wide_solve.cu without the whole run."""
    t0 = time.perf_counter()
    log("build", library=kernels.build())
    kernels._lib()
    names = K3_PROBLEMS if wrapper == "bucket_solve" else K3W_PROBLEMS
    makers = {"meri7": meri7, "grid100": grid100, "flat1000": flat1000,
              "flat_schur50k": flat_schur50k, "wide_below": wide_below}
    probs = {p: makers[p](T, device=dev) for p in names}
    d64 = {k: spd_data(s, 1) for k, s in probs.items()}
    opt, values0, _ = bal_setup(dev)
    damped, _, _ = bal_damped(
        opt, values0, ba_settings(T.BackendType.PLANNED, 1, **BAL_DAMP))
    solve_levels(solve_cases(probs, d64, names, opt.solver, damped), wrapper,
                 name_limit)
    reset_values(opt, values0)
    bal_direct_costs(opt, name_limit)
    log({"bucket_solve": "k3_only", "wide_solve": "k3w_only"}[wrapper],
        seconds=time.perf_counter() - t0)
    print(card(), flush=True)
    return 0


def bal_pcg_costs(opt, name_limit: str) -> list:
    """BAL 871's PCG LM (2 iterations, BlockJacobi) from the set-up's
    values, its costs and PCG iterations held to BAL_COSTS and
    BAL_PCG_ITERS."""
    st = opt.optimize(ba_settings(T.BackendType.PLANNED, 2, pcg=True,
                                  **BAL_DAMP))
    costs = st["costs"]
    check(len(costs) == len(BAL_COSTS["pcg"]) and
          all(abs(a / b - 1) <= 1e-9 for a, b in zip(costs, BAL_COSTS["pcg"]))
          and list(st["pcg_iters"]) == BAL_PCG_ITERS,
          f"BAL 871 PCG LM costs {costs}, iterations {st['pcg_iters']}; "
          f"expected {BAL_COSTS['pcg']}, {BAL_PCG_ITERS}")
    log("bal871_lm_pcg", card=name_limit, costs=costs,
        pcg_iterations=st["pcg_iters"])
    return costs


def level_only(which: str, dev, name_limit: str) -> int:
    """`--only k2` and `--only k3r`: the build, then k2_levels (k2_cases)
    or k3r_levels (k3r_cases) alone on MERI, GRID, FLAT+Schur 50k and
    BAL 871's first damped system, and BAL 871's direct and PCG LM held
    to BAL_COSTS and BAL_PCG_ITERS, for iterating on
    csrc/segmented_subtract.cu or the narrow grids of csrc/tri_solve.cu
    without the whole run."""
    t0 = time.perf_counter()
    log("build", library=kernels.build())
    kernels._lib()
    probs = {p: make(T, device=dev) for p, make in (
        ("meri7", meri7), ("grid100", grid100),
        ("flat_schur50k", flat_schur50k))}
    d64 = {k: spd_data(s, 1) for k, s in probs.items()}
    opt, values0, _ = bal_setup(dev)
    damped, _, _ = bal_damped(
        opt, values0, ba_settings(T.BackendType.PLANNED, 1, **BAL_DAMP))
    t = opt.elim_end_span
    if which == "k2":
        k2_levels(k2_cases(probs, d64, opt.solver, damped, t), name_limit)
    else:
        solve_levels(k3r_cases(probs, d64, opt.solver, damped, t),
                     "tri_solve", name_limit)
    del damped
    for costs in (bal_direct_costs, bal_pcg_costs):
        reset_values(opt, values0)
        costs(opt, name_limit)
    log(f"{which}_only", seconds=time.perf_counter() - t0)
    print(card(), flush=True)
    return 0


def k1_only(dev, name_limit: str) -> int:
    """`--only k1`: the build, then K1's phases alone (k1_not_pd, and
    k1_levels and a trace of the whole factor on MERI and GRID,
    k1_levels on BAL 871's pair levels) and BAL 871's direct LM held to
    BAL_COSTS, for iterating on csrc/bucket_factor.cu without the whole
    run."""
    t0 = time.perf_counter()
    log("build", library=kernels.build())
    kernels._lib()
    k1_not_pd(dev, name_limit)
    for p, make in (("meri7", meri7), ("grid100", grid100)):
        s = make(T, device=dev)
        d = torch.from_numpy(spd_data(s, 1)).to(dev)
        k1_levels(s, d, p, name_limit)
        # the whole factor, so that K1's grids read beside the rest
        log("k1_factor_trace", case=p, card=name_limit, dtype="float64",
            **trace(functools.partial(s.factor_program(), d[None]), 5))
    opt, values0, _ = bal_setup(dev)
    damped, _, _ = bal_damped(
        opt, values0, ba_settings(T.BackendType.PLANNED, 1, **BAL_DAMP))
    k1_levels(opt.solver, damped, "bal871", name_limit)
    del damped
    reset_values(opt, values0)
    bal_direct_costs(opt, name_limit)
    log("k1_only", seconds=time.perf_counter() - t0)
    print(card(), flush=True)
    return 0


def k6_only(dev, name_limit: str) -> int:
    """`--only k6`: the build, then K6's phase alone (k6_levels on BAL
    871's first assembly) and BAL 871's direct LM held to BAL_COSTS, for
    iterating on csrc/grad_hess.cu without the whole run."""
    t0 = time.perf_counter()
    log("build", library=kernels.build())
    kernels._lib()
    opt, values0, _ = bal_setup(dev)
    k6_levels(opt, opt.jacobians([f.values for f in opt.families]),
              name_limit)
    bal_direct_costs(opt, name_limit)
    log("k6_only", seconds=time.perf_counter() - t0)
    print(card(), flush=True)
    return 0


def main(argv=()) -> int:
    # 1. card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only "
                         "on the GPU")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_limit = card()
    kind = torch.cuda.get_device_name(0)
    log("card", nvidia_smi=name_limit, kind=kind,
        capability=list(torch.cuda.get_device_capability(0)),
        torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0])
    # every process of the run takes the same analysis path: the native
    # symbolic library's (baspacho_tpu_torch/native.py builds it under a
    # lock)
    loaded = native.available()
    log("native", symbolic_library_loaded=loaded)
    check(loaded, "the native symbolic library did not load (see the "
          "warning above): the analysis would run its Python fallback")
    only = {"k5": k5_only, "k1w": k1w_only, "k6": k6_only, "k1": k1_only,
            "k3": functools.partial(solve_only, "bucket_solve"),
            "k3w": functools.partial(solve_only, "wide_solve"),
            "k2": functools.partial(level_only, "k2"),
            "k3r": functools.partial(level_only, "k3r")}
    if len(argv) == 2 and argv[0] == "--only" and argv[1] in only:
        return only[argv[1]](dev, name_limit)
    if argv:
        raise SystemExit(f"chip_smoke: unknown arguments {list(argv)} (none, "
                         f"or --only with one of {sorted(only)})")

    # 2. build
    t0 = time.perf_counter()
    so = kernels.build()
    kernels._lib()
    t_build = time.perf_counter() - t0
    log("build", seconds=t_build, library=so)

    # 3. problems: host analysis (create_solver), the level schedule and
    # the device programs, timed apart
    probs, info = {}, {}
    for pname, make in (("meri7", meri7), ("grid100", grid100),
                        ("flat1000", flat1000),
                        ("flat_schur5k", flat_schur5k),
                        ("flat_schur50k", flat_schur50k),
                        ("wide_below", wide_below)):
        t0 = time.perf_counter()
        s = make(T, device=dev)
        t1 = time.perf_counter()
        sched = s.backend._factor_schedule(0, s.skel.num_lumps)
        s.backend._solve_schedule(0, s.skel.num_lumps)
        t2 = time.perf_counter()
        s.factor_program()
        s.solve_program()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        probs[pname] = s
        info[pname] = {
            "order": s.order, "lumps": s.skel.num_lumps,
            "levels": len(sched), "data_size": s.data_size,
            "widest_cp": int(s.skel.col_stride.max()),
            "dense_levels": [i for i, lv in enumerate(sched)
                             if lv[3] is not None],
            "dense_R": [lv[3].R for lv in sched if lv[3] is not None],
            "dense_origins": [len(lv[3].org_xoff) for lv in sched
                              if lv[3] is not None],
            "pairs_elements": sum(int((lv[1].rs * lv[1].cs).sum())
                                  for lv in sched if lv[1] is not None),
            "create_solver_s": t1 - t0, "schedule_s": t2 - t1,
            "programs_s": t3 - t2}
    log("analysis", **info)
    meri, grid, flat = probs["meri7"], probs["grid100"], probs["flat1000"]
    schur5, schur50 = probs["flat_schur5k"], probs["flat_schur50k"]
    rng = np.random.RandomState(0)
    rhs = {k: rng.rand(s.order, 3) for k, s in probs.items()}
    d64 = {k: spd_data(s, 1) for k, s in probs.items()}

    # 4. kernels vs twins on the card, at every bucket of each path
    # (the bucket shapes each covers are logged with the f64 errors)
    max_abs = {k: 0.0 for k in NAMES}
    errs = {}
    for dt in (torch.float64, torch.float32):
        np_dt = np.float64 if dt == torch.float64 else np.float32
        for pname in ("meri7", "grid100", "flat1000", "flat_schur5k",
                      "flat_schur50k", "wide_below"):
            s = probs[pname]
            chk = CheckedOps()
            d = torch.from_numpy(d64[pname].astype(np_dt)).to(dev)[None]
            b = torch.from_numpy(rhs[pname].astype(np_dt)).to(dev)[None]
            f = s.factor_program()(d, ops=chk)
            s.solve_program()(f, b, ops=chk)
            if pname != "flat_schur5k":
                partial_ops(s, pname, d, b, chk)
            torch.cuda.synchronize()
            for k in NAMES:
                check(chk.rel[k] <= KERNEL_RTOL[dt],
                      f"{k} vs twin on {pname} {dt}: rel {chk.rel[k]}")
                max_abs[k] = max(max_abs[k], chk.abs[k])
            errs[f"{pname}_{str(dt)[6:]}"] = {
                "max_rel": {k: v for k, v in chk.rel.items() if v},
                **({"shapes": sorted(chk.shapes)}
                   if dt == torch.float64 else {})}
    log("kernels_vs_twins", limits={"float64": 1e-10, "float32": 1e-4},
        errors=errs)

    # 4b. K4 beyond the Schur shapes: GRID with every level forced dense
    # (compact spaces up to 15,411 rows, tiled; origins up to 512 wide)
    # against its twin, and the factor against the pair-level one
    forced = PlannedBackend(grid.plan, assembly="dense")
    chk = CheckedOps()
    d = torch.from_numpy(d64["grid100"]).to(dev)[None]
    fd = forced.make_factor(0, grid.skel.num_lumps, dev)(d, ops=chk)
    frel, _ = rel_abs(fd[0], grid.factor(d[0]))
    check(chk.rel["dense_update"] <= KERNEL_RTOL[torch.float64],
          f"dense_update vs twin on forced-dense GRID: "
          f"{chk.rel['dense_update']}")
    check(frel <= 1e-10, f"forced-dense GRID factor vs pairs: rel {frel}")
    log("dense_forced_grid", max_rel=chk.rel["dense_update"],
        factor_rel_vs_pairs=frel,
        compact_rows=[lv[3].R for lv in forced._factor_schedule(
            0, grid.skel.num_lumps) if lv[3] is not None])

    # 4c. WIDE_BELOW through the entry points, f64: the wide factor's
    # below rows, the wide solve's below products, K4 on a wide origin
    wb = probs["wide_below"]
    d = torch.from_numpy(d64["wide_below"]).to(dev)
    b = torch.from_numpy(rhs["wide_below"]).to(dev)
    (f, x), c_wb = counted("wide_below", lambda: factor_solve(wb, d, b))
    fr = factor_residual(wb, d64["wide_below"], f.cpu().numpy())
    sr = solve_residual(wb, d64["wide_below"], x.cpu().numpy(),
                        rhs["wide_below"])
    check(fr <= 1e-10, f"WIDE_BELOW f64 factor residual {fr}")
    check(sr <= 1e-10, f"WIDE_BELOW f64 solve residual {sr}")
    log("wide_below", factor_residual=fr, solve_residual=sr,
        launches={k: v[0] for k, v in c_wb.items()})

    # 4d. K3-rest wide against its twin and itself, batch 2, on the 50k
    # corner and WIDE_BELOW
    wide_tri_checks(probs, d64, dev)

    # 5. MERI n=7, f64, single: the main path, counted
    d = torch.from_numpy(d64["meri7"]).to(dev)
    b = torch.from_numpy(rhs["meri7"]).to(dev)
    (f, x), c_meri = counted("meri7", lambda: factor_solve(meri, d, b))
    f_np, x_np = f.cpu().numpy(), x.cpu().numpy()
    check(bool(np.all(np.isfinite(f_np))) and f_np.shape ==
          (meri.data_size,), "MERI factor not finite / wrong shape")
    check(x_np.shape == rhs["meri7"].shape, "MERI solve has the wrong shape")
    fr = factor_residual(meri, d64["meri7"], f_np)
    sr = solve_residual(meri, d64["meri7"], x_np, rhs["meri7"])
    check(fr <= 1e-10, f"MERI f64 factor residual {fr}")
    check(sr <= 1e-10, f"MERI f64 solve residual {sr}")
    log("meri_f64", factor_residual=fr, solve_residual=sr,
        launches={k: v[0] for k, v in c_meri.items()},
        grid_launches={k: v[2] for k, v in c_meri.items()})

    # 6. MERI f32
    d32 = d64["meri7"].astype(np.float32)
    f32 = meri.factor(torch.from_numpy(d32).to(dev)).cpu().numpy()
    fr32 = factor_residual(meri, d32, f32)
    check(fr32 <= 1e-5, f"MERI f32 factor residual {fr32}")
    log("meri_f32", factor_residual=fr32)

    # 7. batches: each item bitwise equal to its single run; determinism
    for pname, nb in (("meri7", 16), ("flat1000", 8)):
        s = probs[pname]
        datas = batched(d64[pname], nb, dev)
        rb = torch.from_numpy(np.random.RandomState(nb).rand(
            nb, s.order, 3)).to(dev)
        fb = s.factor(datas)
        xb = s.solve(fb, rb)
        for i in range(nb):
            fi = s.factor(datas[i])
            check(torch.equal(fb[i], fi), f"{pname} batch item {i} factor "
                  "differs")
            check(torch.equal(xb[i], s.solve(fi, rb[i])),
                  f"{pname} batch item {i} solve differs")
        d1 = datas[0]
        check(torch.equal(s.factor(d1), s.factor(d1)),
              f"{pname}: two factors of one buffer differ")
        partial_batch_bitwise(s, pname, datas, rb)
        log("batch", case=pname, items=nb, bitwise_equal_to_single=True,
            partial_ops_bitwise_equal_to_single=True,
            determinism_bitwise=True)
    check(torch.equal(f, meri.factor(d)), "MERI factor differs from phase 5")

    # 8. GRID 100x100, f64: against the port's own CPU twin run
    cpu = T.solver_from_skeleton(T.skeleton_arrays(grid.skel),
                                 grid.permutation, grid.sparse_elim_ranges,
                                 device="cpu")
    t0 = time.perf_counter()
    fg = grid.factor(torch.from_numpy(d64["grid100"]).to(dev))
    xg = grid.solve(fg, torch.from_numpy(rhs["grid100"]).to(dev))
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    fc = cpu.factor(torch.from_numpy(d64["grid100"]))
    xc = cpu.solve(fc, torch.from_numpy(rhs["grid100"]))
    t_cpu = time.perf_counter() - t0
    ferr, _ = rel_abs(fg.cpu(), fc)
    serr, _ = rel_abs(xg.cpu(), xc)
    check(bool(torch.isfinite(fg).all()), "GRID factor not finite")
    check(ferr <= 1e-10, f"GRID factor vs CPU twin: rel {ferr}")
    check(serr <= 1e-10, f"GRID solve vs CPU twin: rel {serr}")
    log("grid_f64", factor_rel_vs_cpu_twin=ferr, solve_rel_vs_cpu_twin=serr,
        gpu_factor_solve_host_seconds=t_gpu, cpu_twin_seconds=t_cpu)

    # 9. FLAT n=1000: the main path counted, f64 and f32
    d = torch.from_numpy(d64["flat1000"]).to(dev)
    b = torch.from_numpy(rhs["flat1000"]).to(dev)
    (ff, xf), c_flat = counted("flat1000", lambda: factor_solve(flat, d, b))
    fr = factor_residual(flat, d64["flat1000"], ff.cpu().numpy())
    sr = solve_residual(flat, d64["flat1000"], xf.cpu().numpy(),
                        rhs["flat1000"])
    check(fr <= 1e-10, f"FLAT f64 factor residual {fr}")
    check(sr <= 1e-10, f"FLAT f64 solve residual {sr}")
    d32 = d64["flat1000"].astype(np.float32)
    fr32 = factor_residual(flat, d32, flat.factor(
        torch.from_numpy(d32).to(dev)).cpu().numpy())
    check(fr32 <= 1e-5, f"FLAT f32 factor residual {fr32}")
    log("flat1000", factor_residual=fr, solve_residual=sr,
        f32_factor_residual=fr32,
        launches={k: v[0] for k, v in c_flat.items()},
        grid_launches={k: v[2] for k, v in c_flat.items()})

    # 10. FLAT + Schur 50k: the main path counted, f64 and f32, kernels
    # only; residuals from sparse products (a dense A would take 187 GB)
    d = torch.from_numpy(d64["flat_schur50k"]).to(dev)
    b = torch.from_numpy(rhs["flat_schur50k"]).to(dev)
    (fs, xs), c_schur = counted("flat_schur50k",
                                lambda: factor_solve(schur50, d, b))
    fs_np = fs.cpu().numpy()
    check(bool(np.all(np.isfinite(fs_np))), "Schur 50k factor not finite")
    fr, sr = sparse_residuals(schur50, d64["flat_schur50k"], fs_np,
                              xs.cpu().numpy(), rhs["flat_schur50k"])
    check(fr <= 1e-10, f"Schur 50k f64 factor residual {fr}")
    check(sr <= 1e-10, f"Schur 50k f64 solve residual {sr}")
    check(torch.equal(fs, schur50.factor(d)) and
          torch.equal(schur50.factor(d), schur50.factor(d)),
          "Schur 50k: two factors of one buffer differ")
    d32 = d64["flat_schur50k"].astype(np.float32)
    f32 = schur50.factor(torch.from_numpy(d32).to(dev)).cpu().numpy()
    fr32, _ = sparse_residuals(schur50, d32, f32)
    check(fr32 <= 1e-5, f"Schur 50k f32 factor residual {fr32}")
    log("flat_schur50k", factor_residual_probe=fr, solve_residual=sr,
        f32_factor_residual_probe=fr32, determinism_bitwise=True,
        launches={k: v[0] for k, v in c_schur.items()},
        grid_launches={k: v[2] for k, v in c_schur.items()})

    # 10a. K4 on the 50k level: against its twin, against itself, timed
    k4_50k = k4_levels(schur50, d, "flat_schur50k", name_limit)

    # 10b. partial identities, f64: factor_from(factor_up_to(d, t), t)
    # against factor(d), and the four partial solves and the corner
    # mat-vec against the port's CPU twins (MERI, GRID)
    part_info = {}
    for pname in ("meri7", "grid100", "flat_schur50k"):
        s = probs[pname]
        t = split_span(s, pname)
        d = torch.from_numpy(d64[pname]).to(dev)
        full = s.factor(d)
        fu = s.factor_up_to(d, t)
        ff = s.factor_from(fu, t)
        frel, _ = rel_abs(ff, full)
        check(frel <= 1e-12, f"{pname}: up_to + from vs factor, rel {frel}")
        row = {"split_span": t, "up_to_from_vs_factor_rel": frel,
               "bitwise": bool(torch.equal(ff, full))}
        if pname != "flat_schur50k":
            twin = cpu if pname == "grid100" else T.solver_from_skeleton(
                T.skeleton_arrays(s.skel), s.permutation,
                s.sparse_elim_ranges, device="cpu")
            bg = torch.from_numpy(rhs[pname]).to(dev)
            bc = torch.from_numpy(rhs[pname])
            for m, f in (("solve_l_up_to", fu), ("solve_lt_up_to", fu),
                         ("solve_l_from", ff), ("solve_lt_from", ff)):
                r, _ = rel_abs(getattr(s, m)(f, t, bg).cpu(),
                               getattr(twin, m)(f.cpu(), t, bc))
                check(r <= 1e-10, f"{pname} {m} vs CPU twin: rel {r}")
                row[f"{m}_rel_vs_cpu_twin"] = r
            r, _ = rel_abs(s.add_mv_from(d, t, bg, bg, 0.5).cpu(),
                           twin.add_mv_from(d.cpu(), t, bc, bc, 0.5))
            check(r <= 1e-10, f"{pname} add_mv_from vs CPU twin: rel {r}")
            row["add_mv_from_rel_vs_cpu_twin"] = r
        part_info[pname] = row
    log("partial_identities", limits={"up_to_from": 1e-12,
                                      "vs_cpu_twin": 1e-10}, **part_info)

    # 10c. PCG on FLAT+Schur 50k, f64, each preconditioner: the path
    # counted, then timed; residuals of the full system from K5 (add_mv
    # from span 0, every bucket) and from a sparse product
    d = torch.from_numpy(d64["flat_schur50k"]).to(dev)
    b_np = rhs["flat_schur50k"][:, 0].copy()
    b1 = torch.from_numpy(b_np).to(dev)
    A50 = sparse_matrix(schur50, d64["flat_schur50k"])
    pcg_info, c_pcg = {}, {}
    for pre in PRECONDS:
        out, c = counted(f"pcg_{pre}",
                         functools.partial(pcg_path, schur50, d, b1, pre))
        mv = schur50.add_mv_from(d, 0, out["x"], torch.zeros_like(b1))
        x_np = out["x"].cpu().numpy()
        r_k5 = float((mv - b1).norm() / b1.norm())
        r_sp = float(np.linalg.norm(A50 @ x_np - b_np) / np.linalg.norm(b_np))
        check(r_k5 <= 1e-10 and r_sp <= 1e-10,
              f"PCG {pre}: residual {r_k5} (K5), {r_sp} (sparse)")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = pcg_path(schur50, d, b1, pre)
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
        its = (out["iterations"], again["iterations"])
        check(its == (SCHUR_PCG_ITERS[pre],) * 2, f"PCG {pre}: iterations "
              f"{its} in two runs, want {SCHUR_PCG_ITERS[pre]}")
        c_pcg[f"pcg_{pre}"] = c
        pcg_info[pre] = {
            "iterations": out["iterations"], "residual_k5": r_k5,
            "residual_sparse": r_sp, "path_ms": path_s * 1e3,
            "init_ms": again["init_s"] * 1e3, "pcg_ms": again["pcg_s"] * 1e3,
            "ms_per_iteration": again["pcg_s"] * 1e3 /
            max(again["iterations"], 1),
            "launches": {k: v[0] for k, v in c.items() if v[0]}}
    log("pcg_schur50k", card=name_limit, dtype="float64", tol=1e-12,
        max_iters=200, limit=1e-10, corner_order=schur50.order -
        schur50.span_vector_offset(SCHUR_T),
        pseudo_factor_bound_ms=bound(*pseudo_cost(schur50, SCHUR_T))[0],
        **pcg_info)

    # 10d. refinement: an f32 factor of FLAT+Schur 50k, f64 residuals
    # through K5; the iterations needed for 1e-10, then that solve alone
    # counted (the residual checks' launches stay out of its counts)
    d32 = torch.from_numpy(d64["flat_schur50k"].astype(np.float32)).to(dev)
    f32 = schur50.factor(d32)
    res = []
    for k in range(5):
        x = schur50.solve_refined(d, f32, b1, iterations=k)
        r = schur50.add_mv_from(d, 0, x, torch.zeros_like(b1))
        res.append((float((r - b1).norm() / b1.norm()), x))
    need = next((k for k, (r, _) in enumerate(res) if r <= 1e-10), None)
    check(need is not None, f"refinement never reached 1e-10: "
          f"{[r for r, _ in res]}")
    x_ref, c_ref = counted("refined_schur50k", lambda: schur50.solve_refined(
        d, schur50.factor(d32), b1, need))
    check(torch.equal(x_ref, res[need][1]),
          "refined solve differs from its first run")
    r_sp = float(np.linalg.norm(A50 @ x_ref.cpu().numpy() - b_np) /
                 np.linalg.norm(b_np))
    check(r_sp <= 1e-10, f"refined residual (sparse) {r_sp}")
    ref_ms = time_ms(lambda: schur50.solve_refined(d, f32, b1, need), 5)
    log("refined_schur50k", card=name_limit, limit=1e-10,
        iterations_needed=need, residual_by_iterations=[r for r, _ in res],
        residual_sparse=r_sp, solve_refined_ms=ref_ms,
        launches={k: v[0] for k, v in c_ref.items() if v[0]})

    # 10e. the differentiable solve on MERI, f64: <grad, d> against a
    # central difference along random directions (live slots of the
    # data, and the rhs); check_factor
    fsolve = meri.make_differentiable_solve()
    d = torch.from_numpy(d64["meri7"]).to(dev)
    b = torch.from_numpy(rhs["meri7"]).to(dev)
    g = np.random.RandomState(11)
    w = torch.from_numpy(g.rand(meri.order, 3)).to(dev)
    ri, _ = meri.skel.data_coords()
    dh = torch.from_numpy((ri != meri.order) *
                          (2 * g.rand(meri.data_size) - 1)).to(dev)
    db = torch.from_numpy(2 * g.rand(meri.order, 3) - 1).to(dev)
    h, bb = d.clone().requires_grad_(), b.clone().requires_grad_()
    (w * fsolve(h, bb)).sum().backward()
    eps = 1e-4
    diff = {}
    for what, an, plus, minus in (
            ("data", (h.grad * dh).sum(), (d + eps * dh, b),
             (d - eps * dh, b)),
            ("rhs", (bb.grad * db).sum(), (d, b + eps * db),
             (d, b - eps * db))):
        fd = ((w * fsolve(*plus)).sum() - (w * fsolve(*minus)).sum()) / \
            (2 * eps)
        r = float((an - fd).abs() / fd.abs())
        check(r <= 1e-6, f"diff_solve {what}: <grad, d> vs central "
              f"difference, rel {r}")
        diff[what] = {"grad_dot_d": float(an), "central_difference": float(fd),
                      "rel": r}
    f = meri.factor(d)
    bad = f.clone()
    bad[int(meri.skel.damp_indices()[5])] *= -1
    check(meri.check_factor(f) and not meri.check_factor(bad),
          "check_factor: true on a factor, false with a negative diagonal")
    log("diff_solve", limit=1e-6, eps=eps, check_factor_ok=True, **diff)

    # 10f. the LM optimizer: the SE3 BA's assembly against the dense
    # normal equations; LM on BAL 871 x 527,480 (direct and PCG), K6
    # against its twin, timed
    log("se3_ba_dense", card=name_limit, **se3_dense_check(dev))
    log("demos", card=name_limit, **demo_twins())
    bal = bal_phase(dev, name_limit)
    c_direct, c_balpcg = bal["c_direct"], bal["c_pcg"]
    max_abs["grad_hess"] = bal["abs"]
    for case, r in bal["rel"].items():
        errs[case] = {"max_rel": {"grad_hess": r}}

    # 11. times: kernels vs twins on the card (CUDA events, after warm-up)
    for label, pname, batch, reps, twins in (
            ("meri_single", "meri7", 1, 20, True),
            ("meri_batch16", "meri7", 16, 10, True),
            ("grid_single", "grid100", 1, 10, True),
            ("flat_single", "flat1000", 1, 10, True),
            ("flat_batch8", "flat1000", 8, 3, True),
            ("schur5k_single", "flat_schur5k", 1, 10, True),
            ("schur50k_single", "flat_schur50k", 1, 10, False)):
        s = probs[pname]
        dd = batched(d64[pname], batch, dev)
        bb = torch.from_numpy(rhs[pname]).to(dev).expand(batch, -1, -1) \
            .contiguous()
        fp, sp = s.factor_program(), s.solve_program()
        fprod = fp(dd)
        row = {}
        impls = (("kernels", kernels), ("twins", kernels.TWINS)) if twins \
            else (("kernels", kernels),)
        for impl, ops in impls:
            row[f"factor_ms_{impl}"] = time_ms(lambda: fp(dd, ops=ops), reps)
            row[f"solve_ms_{impl}"] = time_ms(lambda: sp(fprod, bb, ops=ops),
                                              reps)
        log("time", case=label, batch=batch, nrhs=3, card=name_limit,
            dtype="float64", **row)

    # per-kernel device time over one f64 factor + solve of the case that
    # runs the kernel: MERI for K1, K2, K3; FLAT for K1-wide, K3-wide;
    # FLAT+Schur 5k for K4; beside each kernel's bound from the same run
    # and its library call, where one computes the same function
    per, per_case = {"kernels": {}, "twins": {}}, {}
    bounds, library, back_to_back = {}, {}, {}
    for pname, names in (("meri7", ("bucket_factor", "segmented_subtract",
                                    "bucket_solve")),
                         ("flat1000", ("wide_factor", "wide_solve")),
                         ("flat_schur5k", ("dense_update",))):
        s = probs[pname]
        dd = torch.from_numpy(d64[pname]).to(dev)[None]
        bb = torch.from_numpy(rhs[pname]).to(dev)[None]
        got = {}
        for impl, ops in (("kernels", kernels), ("twins", kernels.TWINS)):
            # the warm-up run also takes the costs and the library calls
            # (they read index arrays back to the host), then the
            # measured run
            for warm in (True, False):
                tops = TimedOps(ops, costs=warm and impl == "kernels")
                s.solve_program()(s.factor_program()(dd, ops=tops), bb,
                                  ops=tops)
                if warm and impl == "kernels":
                    bd, lib = tops.bounds(), tops.library_ms()
                    b2b = {k: tops.replay_ms(k) for k in names
                           if lib[k] is not None}
            got[impl] = tops.ms()
            for k in names:
                per[impl][k] = got[impl][k]
                per_case[k] = f"{pname} f64 factor+solve"
            if impl == "kernels":
                for k in names:
                    bounds[k], library[k] = bd[k], lib[k]
                back_to_back.update(b2b)
        log("time_per_kernel", case=f"{pname} f64 factor+solve",
            card=name_limit, kernels_ms=got["kernels"],
            twins_ms=got["twins"],
            bound_ms={k: bounds[k][0] for k in names},
            library_ms={k: library[k] for k in names},
            kernels_back_to_back_ms=b2b)

    # the new kernels on the PCG path of FLAT+Schur 50k, f64, nrhs 1:
    # K3-rest narrow over solve_l_up_to + solve_lt_up_to, K3-rest wide
    # over solve_l_from + solve_lt_from on the pseudo-factored corner, K5
    # over add_mv_from(0) (the residual), K5 wide over add_mv_from(t)
    s = schur50
    tl, nl = s._lump_of_span(SCHUR_T), s.skel.num_lumps
    dd = torch.from_numpy(d64["flat_schur50k"]).to(dev)[None]
    bb = b1[None, :, None].contiguous()
    zz = torch.zeros_like(bb)
    part = s.program("factor", 0, tl)(dd)
    pf = s.program("pseudo", SCHUR_T, s.skel.num_spans)(part)
    runs = {
        "tri_solve": ("solve_l_up_to + solve_lt_up_to", lambda ops: s.program(
            "solve_lt", 0, tl)(part, s.program("solve_l", 0, tl)(
                part, bb, ops=ops), ops=ops)),
        "wide_tri_solve": ("solve_l_from + solve_lt_from, pseudo-factored "
                           "corner", lambda ops: s.program(
                               "solve_lt", tl, nl)(pf, s.program(
                                   "solve_l", tl, nl)(pf, bb, ops=ops),
                                   ops=ops)),
        "add_mv": ("add_mv_from(0)", lambda ops: s.program("add_mv", 0)(
            dd, bb, zz, 1.0, ops=ops)),
        "wide_add_mv": ("add_mv_from(t) on factor_up_to's corner",
                        lambda ops: s.program("add_mv", tl)(
                            part, bb, zz, 1.0, ops=ops))}
    for k, (what, run) in runs.items():
        got = {}
        for impl, ops in (("kernels", kernels), ("twins", kernels.TWINS)):
            for warm in (True, False):
                tops = TimedOps(ops, costs=warm and impl == "kernels")
                run(tops)
                if warm and impl == "kernels":
                    bounds[k] = tops.bounds()[k]
                    library[k] = tops.library_ms()[k]
                    if library[k] is not None:
                        back_to_back[k] = tops.replay_ms(k)
            got[impl] = tops.ms()[k]
        per["kernels"][k], per["twins"][k] = got["kernels"], got["twins"]
        per_case[k] = f"flat_schur50k f64 nrhs 1 {what}"
        log("time_per_kernel", case=per_case[k], card=name_limit,
            kernel=k, kernel_ms=got["kernels"], twin_ms=got["twins"],
            bound_ms=bounds[k][0], bound_by=bounds[k][1],
            library_ms=library[k],
            kernel_back_to_back_ms=back_to_back.get(k))

    per["kernels"]["grad_hess"] = bal["ms"]
    per["twins"]["grad_hess"] = bal["plain_ms"]
    bounds["grad_hess"], library["grad_hess"] = bal["bound"], \
        bal["library_ms"]
    back_to_back["grad_hess"] = bal["back_to_back_ms"]
    per_case["grad_hess"] = "bal871 f64 one assembly (2 families)"
    # K4 where it costs most: BAL 871's point level (its other levels and
    # the Schur levels beside it)
    k4_bal = bal["k4"]
    pt = k4_bal[0]
    max_abs["dense_update"] = max(max_abs["dense_update"],
                                  *(r["max_abs"] for r in k4_50k + k4_bal))
    by_case = {"dense_update": {
        per_case["dense_update"]: per["kernels"]["dense_update"],
        **{f"flat_schur50k level {r['level']}": r["ms"] for r in k4_50k},
        **{f"bal871 level {r['level']}": r["ms"] for r in k4_bal}}}
    per["kernels"]["dense_update"], per["twins"]["dense_update"] = \
        pt["ms"], pt["twin_ms"]
    bounds["dense_update"] = (pt["bound_ms"], pt["bound_by"])
    per_case["dense_update"] = f"bal871 f64 level {pt['level']} (points)"

    # 12. trace: device time per CUDA kernel and the device's idle share,
    # factor and solve apart; the trace's count of each wrapper's grids
    # must equal the wrappers' own grid-launch counters
    for label, pname, batch, reps in (
            ("meri_single", "meri7", 1, 5),
            ("meri_batch16", "meri7", 16, 5),
            ("grid_single", "grid100", 1, 5),
            ("flat_single", "flat1000", 1, 5),
            ("schur50k_single", "flat_schur50k", 1, 3),
            *((f"pcg_{p}", p, 1, 2) for p in PRECONDS)):
        if label.startswith("pcg_"):
            d = torch.from_numpy(d64["flat_schur50k"]).to(dev)
            todo = (("path", functools.partial(pcg_path, schur50, d, b1,
                                                pname)),)
        else:
            s = probs[pname]
            dd = batched(d64[pname], batch, dev)
            bb = torch.from_numpy(rhs[pname]).to(dev) \
                .expand(batch, -1, -1).contiguous()
            fp, sp = s.factor_program(), s.solve_program()
            fprod = fp(dd)
            todo = (("factor", functools.partial(fp, dd)),
                    ("solve", functools.partial(sp, fprod, bb)))
        for what, fn in todo:
            trace_checked(label, what, fn, reps, batch=batch,
                          nrhs=1 if label.startswith("pcg_") else 3,
                          dtype="float64", card=name_limit)
    # BAL 871: K6 over one assembly, and one LM iteration from the start
    # (optimize(max_iters=1): Jacobians, K6, damp + factor, solve,
    # retract + cost, Jacobians and K6 at the new point)
    opt = bal["opt"]
    one = ba_settings(T.BackendType.PLANNED, 1, **BAL_DAMP)

    def lm_iteration():
        reset_values(opt, bal["values0"])
        opt.optimize(one)
    trace_checked("bal871", "k6_assembly",
                  lambda: opt.assemble(bal["terms"], torch.float64), 3,
                  dtype="float64", card=name_limit)
    trace_checked("bal871", "lm_iteration", lm_iteration, 1,
                  dtype="float64", card=name_limit)
    bal_pcg_trace(opt.solver, bal["damped"], bal["grad"], opt.elim_end_span,
                  name_limit)

    # 13. K1 on panels that are not positive definite; per level on
    # MERI, GRID and BAL 871's pair levels, last: its many short traces
    # come after the strict ones above (the profiler has lost a whole
    # call's device records in a trace taken after them)
    k1_not_pd(dev, name_limit)
    k1_meri = k1_levels(meri, torch.from_numpy(d64["meri7"]).to(dev),
                        "meri7", name_limit)
    k1_grid = k1_levels(grid, torch.from_numpy(d64["grid100"]).to(dev),
                        "grid100", name_limit)
    k1_bal = k1_levels(bal["opt"].solver, bal["damped"], "bal871",
                       name_limit)
    # 13b. K1-wide on every wide bucket of FLAT, Schur 50k's corner,
    # WIDE_BELOW and BAL 871's camera levels
    k1w = k1w_levels(
        [(p, probs[p], torch.from_numpy(d64[p]).to(dev))
         for p in ("flat1000", "flat_schur50k", "wide_below")] +
        [("bal871", bal["opt"].solver, bal["damped"])], name_limit)
    # 14. K5 per bucket on BAL 871's and FLAT+Schur 50k's mat-vecs
    k5 = k5_phase(schur50, torch.from_numpy(d64["flat_schur50k"]).to(dev),
                  opt, bal["damped"], name_limit)
    # 15. K3 per bucket and pass of MERI's, GRID's, FLAT's, Schur 50k's
    # and BAL 871's solves, K3-wide per bucket and pass of FLAT's, Schur
    # 50k's, WIDE_BELOW's and BAL 871's; K6 per family and grid of BAL's
    # assembly
    # K2 per call of MERI's, GRID's and BAL 871's factors, BAL's and
    # Schur 50k's L passes and BAL's PCG operator; K3-rest narrow per
    # bucket and pass of the partial solves
    k2 = k2_levels(k2_cases(probs, d64, opt.solver, bal["damped"],
                            opt.elim_end_span), name_limit)
    k3r = solve_levels(k3r_cases(probs, d64, opt.solver, bal["damped"],
                                 opt.elim_end_span, grid_from=False),
                       "tri_solve", name_limit)
    k3 = solve_levels(solve_cases(probs, d64, K3_PROBLEMS, opt.solver,
                                  bal["damped"]), "bucket_solve", name_limit)
    k3w = solve_levels(solve_cases(probs, d64, K3W_PROBLEMS, opt.solver,
                                   bal.pop("damped")), "wide_solve",
                       name_limit)
    k6 = k6_levels(opt, bal["terms"], name_limit)
    by_case["wide_factor"] = {
        f"{r['case']} {r['bucket'][:2]} (k1w_levels)": r["ms"] for r in k1w}
    by_case["bucket_factor"] = {
        f"{c} f64 factor, device ms (trace)": sum(
            sum(r["device_ms"].values()) for r in rows)
        for c, rows in (("meri7", k1_meri), ("grid100", k1_grid),
                        ("bal871 pair levels", k1_bal))}
    # K5's record is BAL's PCG operator, where 640 of its 645 narrow and
    # 480 of its 493 wide launches run: one add_mv_from(t), its buckets'
    # calls summed (k5_levels; torch.sparse.mm per bucket the library)
    for k in ("add_mv", "wide_add_mv"):
        by_case[k] = {f"{p} {r['case']} {r['bucket'][:2]}": r["ms"]
                      for p, rows in k5.items() for r in rows
                      if r["wrapper"] == k}
        by_case[k][f"{per_case[k]} (TimedOps)"] = per["kernels"][k]
        op = [r for r in k5["bal871"]
              if r["case"] == "add_mv_from(t)" and r["wrapper"] == k]
        per["kernels"][k] = sum(r["ms"] for r in op)
        per["twins"][k] = sum(r["twin_ms"] for r in op)
        bounds[k] = (sum(r["bound_ms"] for r in op),
                     max(op, key=lambda r: r["bound_ms"])["bound_by"])
        library[k] = sum(r["library_ms"] for r in op)
        per_case[k] = ("bal871 f64 nrhs 1 add_mv_from(t), the PCG operator: "
                       "its buckets' calls summed (k5_levels)")

    by_case["bucket_solve"] = {
        f"{c} {p} (k3_levels)": sum(r["ms"] for r in k3
                                    if (r["case"], r["pass"]) == (c, p))
        for c, p in sorted({(r["case"], r["pass"]) for r in k3})}
    by_case["wide_solve"] = {
        f"{r['case']} {r['pass']} {r['bucket'][:2]} (k3w_levels)": r["ms"]
        for r in k3w}
    by_case["grad_hess"] = {
        f"bal871 family {r['family']} (k6_levels)": r["ms"] for r in k6}
    by_case["segmented_subtract"] = {
        f"{c} (k2_levels)": sum(r["ms"] for r in k2 if r["case"] == c)
        for c in dict.fromkeys(r["case"] for r in k2)}
    by_case["tri_solve"] = {
        f"{c} {p} (k3r_levels)": sum(r["ms"] for r in k3r
                                     if (r["case"], r["pass"]) == (c, p))
        for c, p in sorted({(r["case"], r["pass"]) for r in k3r})}
    # K3-rest's yardstick on the case TimedOps times: batched
    # solve_triangular per bucket of Schur 50k's up-to solves (k3r_levels)
    library["tri_solve"] = sum(r["library_ms"] for r in k3r
                               if r["case"] == "flat_schur50k up_to")
    paths = {"meri7": c_meri, "flat1000": c_flat, "flat_schur50k": c_schur,
             **c_pcg, "refined_schur50k": c_ref, "bal_lm_direct": c_direct,
             "bal_lm_pcg": c_balpcg}
    record = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(c[k][0] for c in paths.values()),
         "launches_by_path": {p: c[k][0] for p, c in paths.items()
                              if c[k][0]},
         "grid_launches": sum(c[k][2] for c in paths.values()),
         "max_abs_err": max_abs[k],
         "max_rel_err": {c: e["max_rel"][k] for c, e in errs.items()
                         if k in e["max_rel"]},
         "ms": per["kernels"][k], "plain_ms": per["twins"][k],
         "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": library[k], "timed_on": per_case[k],
         # where a library call is timed: the kernel's calls replayed
         # back to back, as the library calls are
         "ms_back_to_back": back_to_back.get(k),
         **({"ms_by_case": by_case[k]} if k in by_case else {})}
        for k, src, rep in KERNELS]}
    print(json.dumps(record), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
