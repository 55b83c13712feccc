"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/, holds each against its
plain PyTorch twin on the card at every bucket shape of the main path,
and drives the planned factor + solve (create_solver -> Solver.factor
-> Solver.solve) on the reference's benchmark problems:

  MERI n=7     single f64 and f32, batch 16 (K1, K2, K3)
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

It checks the results, times the kernels against their twins with CUDA
events, and reads a torch.profiler trace of the card for the device time
per CUDA kernel and the device's idle share. One line per phase; the
line before the last two holds the per-kernel JSON record, the next the
card's name and power limit; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed check raises, and the script exits non-zero without that
line. Without a CUDA device it refuses to run. It imports neither jax
nor baspacho_tpu.
"""

from __future__ import annotations

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
from baspacho_tpu_torch.testing.problems import (flat1000, flat_schur5k,
                                                 flat_schur50k, grid100,
                                                 meri7, spd_data,
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
]
NAMES = [k for k, _, _ in KERNELS]
# the __global__ functions each wrapper launches (csrc/*.cu)
GRIDS = {"bucket_factor": ("chol_inv_kernel", "below_kernel", "prod_kernel"),
         "wide_factor": ("wide_tile_kernel", "wide_trsm_kernel",
                         "wide_embed_kernel"),
         "segmented_subtract": ("seg_sub_kernel",),
         "bucket_solve": ("solve_l_kernel", "solve_lt_kernel"),
         "wide_solve": ("wide_lmv_kernel", "wide_lpost_kernel",
                        "wide_ltpre_kernel", "wide_ltmv_kernel"),
         "dense_update": ("dense_level_kernel",)}
# the wrappers each main path must launch
PATH_KERNELS = {
    "meri7": {"bucket_factor", "segmented_subtract", "bucket_solve"},
    "flat1000": {"bucket_factor", "wide_factor", "segmented_subtract",
                 "bucket_solve", "wide_solve"},
    "flat_schur50k": set(NAMES),
    "wide_below": set(NAMES),
}
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

    def segmented_subtract(self, out, src, tgt, seg_ptr, src_idx, width):
        o2 = out.clone()
        kernels.segmented_subtract_twin(o2, src, tgt, seg_ptr, src_idx,
                                        width)
        kernels.segmented_subtract(out, src, tgt, seg_ptr, src_idx, width)
        b = out.shape[0]
        self._note("segmented_subtract", out.view(b, -1, width)[:, tgt],
                   o2.view(b, -1, width)[:, tgt])

    def _solve(self, name, data, vv, y, y_base, off, rows, cols, vec_off,
               below_idx, cp, rp, transpose):
        v2 = vv.clone()
        y2 = y.clone() if y is not None else None
        getattr(kernels, f"{name}_twin")(data, v2, y2, y_base, off, rows,
                                         cols, vec_off, below_idx, cp, rp,
                                         transpose)
        getattr(kernels, name)(data, vv, y, y_base, off, rows, cols,
                               vec_off, below_idx, cp, rp, transpose)
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


class TimedOps:
    """Records a pair of CUDA events around every call of `ops`, to sum
    the device time per kernel (or per twin) over one run of a path."""

    def __init__(self, ops):
        self.ops = ops
        self.events = {name: [] for name in NAMES}
        for name in NAMES:
            setattr(self, name, functools.partial(self._timed, name))

    def _timed(self, name, *args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        getattr(self.ops, name)(*args)
        b.record()
        self.events[name].append((a, b))

    def ms(self):
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v)
                for k, v in self.events.items() if v}


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


def trace(fn, reps: int):
    """Runs fn() `reps` times under torch.profiler (after one warm-up
    call) and reads the device activity off the trace: device time and
    launches per kernel name, the number of device activities, and the
    busy time as
    the union of their intervals on the trace timeline. The idle share is
    1 - busy / (last end - first start) over the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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


def main() -> int:
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

    # 2. build
    t0 = time.perf_counter()
    so = kernels.build()
    kernels._lib()
    t_build = time.perf_counter() - t0
    log("build", seconds=t_build, library=so,
        native_symbolic_loaded=native._load() is not None)

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
        log("batch", case=pname, items=nb, bitwise_equal_to_single=True,
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
    # FLAT+Schur 5k for K4
    per, per_case = {"kernels": {}, "twins": {}}, {}
    for pname, names in (("meri7", ("bucket_factor", "segmented_subtract",
                                    "bucket_solve")),
                         ("flat1000", ("wide_factor", "wide_solve")),
                         ("flat_schur5k", ("dense_update",))):
        s = probs[pname]
        dd = torch.from_numpy(d64[pname]).to(dev)[None]
        bb = torch.from_numpy(rhs[pname]).to(dev)[None]
        got = {}
        for impl, ops in (("kernels", kernels), ("twins", kernels.TWINS)):
            for _ in range(2):  # warm-up, then the measured run
                tops = TimedOps(ops)
                s.solve_program()(s.factor_program()(dd, ops=tops), bb,
                                  ops=tops)
            got[impl] = tops.ms()
            for k in names:
                per[impl][k] = got[impl][k]
                per_case[k] = pname
        log("time_per_kernel", case=f"{pname} f64 factor+solve",
            card=name_limit, kernels_ms=got["kernels"],
            twins_ms=got["twins"])

    # 12. trace: device time per CUDA kernel and the device's idle share,
    # factor and solve apart; the trace's count of each wrapper's grids
    # must equal the wrappers' own grid-launch counters
    for label, pname, batch, reps in (
            ("meri_single", "meri7", 1, 5),
            ("meri_batch16", "meri7", 16, 5),
            ("grid_single", "grid100", 1, 5),
            ("flat_single", "flat1000", 1, 5),
            ("schur50k_single", "flat_schur50k", 1, 3)):
        s = probs[pname]
        dd = batched(d64[pname], batch, dev)
        bb = torch.from_numpy(rhs[pname]).to(dev).expand(batch, -1, -1) \
            .contiguous()
        fp, sp = s.factor_program(), s.solve_program()
        fprod = fp(dd)
        for what, fn in (("factor", lambda: fp(dd)),
                         ("solve", lambda: sp(fprod, bb))):
            kernels.reset_counts()
            fn()
            torch.cuda.synchronize()
            grids = {k: v.grid_launches for k, v in kernels.COUNTS.items()}
            tr = trace(fn, reps)
            seen = tr["launches_per_call_by_kernel"]
            for k, names in GRIDS.items():
                n = sum(seen.get(e, 0) for e in names)
                check(n == grids[k], f"{label} {what}: the trace shows {n} "
                      f"grids of {k} per call, its counter {grids[k]}")
            del tr["launches_per_call_by_kernel"]
            log("trace", case=label, op=what, batch=batch, nrhs=3,
                dtype="float64", card=name_limit,
                grid_launches_per_call={k: v for k, v in grids.items() if v},
                **tr)

    paths = {"meri7": c_meri, "flat1000": c_flat, "flat_schur50k": c_schur}
    record = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(c[k][0] for c in paths.values()),
         "launches_by_path": {p: c[k][0] for p, c in paths.items()},
         "grid_launches": sum(c[k][2] for c in paths.values()),
         "max_abs_err": max_abs[k],
         "max_rel_err": {c: e["max_rel"][k] for c, e in errs.items()
                         if k in e["max_rel"]},
         "ms": per["kernels"][k], "plain_ms": per["twins"][k],
         "timed_on": f"{per_case[k]} f64 factor+solve"}
        for k, src, rep in KERNELS]}
    print(json.dumps(record), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
