"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's three CUDA kernels from csrc/, holds each against
its plain PyTorch twin on the card at every bucket shape of the main
path, drives the planned factor + solve (create_solver -> Solver.factor
-> Solver.solve) on the reference's MERI n=7 problem (single f64 and
f32, batch 16) and on GRID 100x100, checks the results, times the
kernels against their twins with CUDA events, and reads a torch.profiler
trace of the card for the device time per CUDA kernel and the device's
idle share. One line per phase; the
line before the last holds the per-kernel JSON record and the card's
name and power limit; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed check raises, and the script exits non-zero without that
line. Without a CUDA device it refuses to run. It imports neither jax
nor baspacho_tpu.
"""

from __future__ import annotations

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
from baspacho_tpu_torch.testing.problems import grid100, meri7, spd_data

KERNELS = [
    ("bucket_factor", "baspacho_tpu_torch/csrc/bucket_factor.cu",
     "baspacho_tpu/ops/planned_backend.py:1423"),
    ("segmented_subtract", "baspacho_tpu_torch/csrc/segmented_subtract.cu",
     "baspacho_tpu/ops/planned_backend.py:1466"),
    ("bucket_solve", "baspacho_tpu_torch/csrc/bucket_solve.cu",
     "baspacho_tpu/ops/planned_backend.py:2134"),
]
# the __global__ functions each wrapper launches (csrc/*.cu)
GRIDS = {"bucket_factor": ("chol_inv_kernel", "below_kernel", "prod_kernel"),
         "segmented_subtract": ("seg_sub_kernel",),
         "bucket_solve": ("solve_l_kernel", "solve_lt_kernel")}
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
        self.rel = {name: 0.0 for name, _, _ in KERNELS}
        self.abs = {name: 0.0 for name, _, _ in KERNELS}
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
        if rp:
            sl = slice(prod_base, prod_base + off.shape[0] * rp * rp)
            self._note("bucket_factor", prod[:, sl], p2[:, sl])
        self.shapes.add((cp, rp))

    def segmented_subtract(self, out, src, tgt, seg_ptr, src_idx, width):
        o2 = out.clone()
        kernels.segmented_subtract_twin(o2, src, tgt, seg_ptr, src_idx,
                                        width)
        kernels.segmented_subtract(out, src, tgt, seg_ptr, src_idx, width)
        b = out.shape[0]
        self._note("segmented_subtract", out.view(b, -1, width)[:, tgt],
                   o2.view(b, -1, width)[:, tgt])

    def bucket_solve(self, data, vv, y, y_base, off, rows, cols, vec_off,
                     below_idx, cp, rp, transpose):
        v2 = vv.clone()
        y2 = y.clone() if y is not None else None
        kernels.bucket_solve_twin(data, v2, y2, y_base, off, rows, cols,
                                  vec_off, below_idx, cp, rp, transpose)
        kernels.bucket_solve(data, vv, y, y_base, off, rows, cols, vec_off,
                             below_idx, cp, rp, transpose)
        xr = torch.arange(cp, device=off.device)
        xidx = (vec_off[:, None] + xr)[xr < cols[:, None]]
        self._note("bucket_solve", vv[:, xidx], v2[:, xidx])
        if y is not None and not transpose and rp:
            sl = slice(y_base, y_base + off.shape[0] * rp)
            self._note("bucket_solve", y[:, sl], y2[:, sl])


class TimedOps:
    """Records a pair of CUDA events around every call of `ops`, to sum
    the device time per kernel (or per twin) over one run of a path."""

    def __init__(self, ops):
        self.ops = ops
        self.events = {name: [] for name, _, _ in KERNELS}

    def _timed(self, name, *args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        getattr(self.ops, name)(*args)
        b.record()
        self.events[name].append((a, b))

    def bucket_factor(self, *args):
        self._timed("bucket_factor", *args)

    def segmented_subtract(self, *args):
        self._timed("segmented_subtract", *args)

    def bucket_solve(self, *args):
        self._timed("bucket_solve", *args)

    def ms(self):
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v)
                for k, v in self.events.items()}


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
    return {"reps": reps,
            "wall_ms_per_call": wall * 1e3 / reps,
            "device_span_ms_per_call": span / 1e3 / reps,
            "device_busy_ms_per_call": busy / 1e3 / reps,
            "idle_share": 1.0 - busy / span,
            "device_activities_per_call": len(ev) / reps,
            "device_ms_per_call_by_kernel": {
                k: v / 1e3 / reps for k, v in sorted(
                    by_name.items(), key=lambda kv: -kv[1])},
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


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


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

    # problems: host analysis once, the same skeleton on the card and CPU
    t0 = time.perf_counter()
    meri = meri7(T, device=dev)
    grid = grid100(T, device=dev)
    log("analysis", seconds=time.perf_counter() - t0,
        meri={"order": meri.order, "data_size": meri.data_size,
              "levels": meri.backend.num_levels},
        grid={"order": grid.order, "data_size": grid.data_size,
              "levels": grid.backend.num_levels})
    meri_d64 = spd_data(meri, 1)
    meri_d32 = spd_data(meri, 1, np.float32)
    grid_d64 = spd_data(grid, 1)
    rng = np.random.RandomState(0)
    meri_b = rng.rand(meri.order, 3)
    grid_b = rng.rand(grid.order, 3)

    # 3. kernels vs twins on the card, at every bucket of both paths
    max_abs = {k: 0.0 for k, _, _ in KERNELS}
    errs = {}
    for dt in (torch.float64, torch.float32):
        np_dt = np.float64 if dt == torch.float64 else np.float32
        for pname, s in (("meri", meri), ("grid", grid)):
            chk = CheckedOps()
            d = torch.from_numpy(spd_data(s, 1, np_dt)).to(dev)[None]
            b = torch.from_numpy((meri_b if s is meri else grid_b)
                                 .astype(np_dt)).to(dev)[None]
            f = s.factor_program()(d, ops=chk)
            s.solve_program()(f, b, ops=chk)
            torch.cuda.synchronize()
            for k, _, _ in KERNELS:
                check(chk.rel[k] <= KERNEL_RTOL[dt],
                      f"{k} vs twin on {pname} {dt}: rel {chk.rel[k]}")
                max_abs[k] = max(max_abs[k], chk.abs[k])
            errs[f"{pname}_{str(dt)[6:]}"] = {
                "max_rel": chk.rel, "bucket_shapes": len(chk.shapes)}
    log("kernels_vs_twins", limits={"float64": 1e-10, "float32": 1e-4},
        errors=errs)

    # 4. MERI n=7, f64, single: the main path, counted
    d = torch.from_numpy(meri_d64).to(dev)
    b = torch.from_numpy(meri_b).to(dev)
    torch.cuda.synchronize()
    kernels.reset_counts()
    f = meri.factor(d)
    x = meri.solve(f, b)
    torch.cuda.synchronize()
    counts = {k: (v.launches, v.twin_calls, v.grid_launches)
              for k, v in kernels.COUNTS.items()}
    for k, (n, tw, _) in counts.items():
        check(n > 0, f"{k} was not launched on the main path")
        check(tw == 0, f"{k}'s twin ran on the GPU main path")
    f_np, x_np = f.cpu().numpy(), x.cpu().numpy()
    check(bool(np.all(np.isfinite(f_np))) and f_np.shape ==
          (meri.data_size,), "MERI factor not finite / wrong shape")
    check(x_np.shape == meri_b.shape, "MERI solve has the wrong shape")
    fr = factor_residual(meri, meri_d64, f_np)
    sr = solve_residual(meri, meri_d64, x_np, meri_b)
    check(fr <= 1e-10, f"MERI f64 factor residual {fr}")
    check(sr <= 1e-10, f"MERI f64 solve residual {sr}")
    log("meri_f64", factor_residual=fr, solve_residual=sr,
        launches={k: v[0] for k, v in counts.items()},
        grid_launches={k: v[2] for k, v in counts.items()},
        twin_calls={k: v[1] for k, v in counts.items()})

    # 5. MERI f32
    f32 = meri.factor(torch.from_numpy(meri_d32).to(dev)).cpu().numpy()
    fr32 = factor_residual(meri, meri_d32, f32)
    check(fr32 <= 1e-5, f"MERI f32 factor residual {fr32}")
    log("meri_f32", factor_residual=fr32)

    # 6. MERI batch 16, f64: each item bitwise equal to its single run
    nb = 16
    datas = torch.stack([d * (1.0 + 0.01 * i) for i in range(nb)])
    rhs = torch.from_numpy(rng.rand(nb, meri.order, 3)).to(dev)
    fb = meri.factor(datas)
    xb = meri.solve(fb, rhs)
    for i in range(nb):
        fi = meri.factor(datas[i])
        check(torch.equal(fb[i], fi), f"batch item {i} factor differs")
        check(torch.equal(xb[i], meri.solve(fi, rhs[i])),
              f"batch item {i} solve differs")
    log("meri_batch16", items=nb, bitwise_equal_to_single=True)

    # 7. determinism
    check(torch.equal(meri.factor(d), meri.factor(d)),
          "two factors of one buffer differ")
    check(torch.equal(f, meri.factor(d)), "factor differs from phase 4")
    log("determinism", bitwise=True)

    # 8. GRID 100x100, f64: against the port's own CPU twin run
    cpu = T.solver_from_skeleton(T.skeleton_arrays(grid.skel),
                                 grid.permutation, grid.sparse_elim_ranges,
                                 device="cpu")
    t0 = time.perf_counter()
    fg = grid.factor(torch.from_numpy(grid_d64).to(dev))
    xg = grid.solve(fg, torch.from_numpy(grid_b).to(dev))
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    fc = cpu.factor(torch.from_numpy(grid_d64))
    xc = cpu.solve(fc, torch.from_numpy(grid_b))
    t_cpu = time.perf_counter() - t0
    ferr, _ = rel_abs(fg.cpu(), fc)
    serr, _ = rel_abs(xg.cpu(), xc)
    check(bool(torch.isfinite(fg).all()), "GRID factor not finite")
    check(ferr <= 1e-10, f"GRID factor vs CPU twin: rel {ferr}")
    check(serr <= 1e-10, f"GRID solve vs CPU twin: rel {serr}")
    log("grid_f64", factor_rel_vs_cpu_twin=ferr, solve_rel_vs_cpu_twin=serr,
        gpu_factor_solve_host_seconds=t_gpu, cpu_twin_seconds=t_cpu)

    # 9. times: kernels vs twins on the card (CUDA events, after warm-up)
    times = {}
    for label, s, data_np, b_np, batch, reps in (
            ("meri_single", meri, meri_d64, meri_b, 1, 20),
            ("meri_batch16", meri, meri_d64, meri_b, 16, 10),
            ("grid_single", grid, grid_d64, grid_b, 1, 10)):
        dd = torch.from_numpy(data_np).to(dev)
        dd = torch.stack([dd * (1.0 + 0.01 * i) for i in range(batch)])
        bb = torch.from_numpy(b_np).to(dev).expand(batch, -1, -1) \
            .contiguous()
        fp, sp = s.factor_program(), s.solve_program()
        ff = fp(dd)
        row = {}
        for impl, ops in (("kernels", kernels), ("twins", kernels.TWINS)):
            row[f"factor_ms_{impl}"] = time_ms(lambda: fp(dd, ops=ops), reps)
            row[f"solve_ms_{impl}"] = time_ms(lambda: sp(ff, bb, ops=ops),
                                              reps)
        times[label] = row
        log("time", case=label, batch=batch, nrhs=b_np.shape[1],
            card=name_limit, dtype="float64", **row)

    # per-kernel device time over one MERI f64 factor + solve
    per = {}
    for impl, ops in (("kernels", kernels), ("twins", kernels.TWINS)):
        for _ in range(2):  # warm-up, then the measured run
            tops = TimedOps(ops)
            ff = meri.factor_program()(d[None], ops=tops)
            meri.solve_program()(ff, b[None], ops=tops)
        per[impl] = tops.ms()
    log("time_per_kernel", case="meri_single f64 factor+solve",
        card=name_limit, kernels_ms=per["kernels"], twins_ms=per["twins"])

    # 10. trace: device time per CUDA kernel and the device's idle share,
    # factor and solve apart; the trace's count of each wrapper's grids
    # must equal the wrappers' own grid-launch counters
    for label, s, data_np, b_np, batch in (
            ("meri_single", meri, meri_d64, meri_b, 1),
            ("meri_batch16", meri, meri_d64, meri_b, 16),
            ("grid_single", grid, grid_d64, grid_b, 1)):
        dd = torch.from_numpy(data_np).to(dev)
        dd = torch.stack([dd * (1.0 + 0.01 * i) for i in range(batch)])
        bb = torch.from_numpy(b_np).to(dev).expand(batch, -1, -1) \
            .contiguous()
        fp, sp = s.factor_program(), s.solve_program()
        ff = fp(dd)
        for what, fn in (("factor", lambda: fp(dd)),
                         ("solve", lambda: sp(ff, bb))):
            kernels.reset_counts()
            fn()
            torch.cuda.synchronize()
            grids = {k: v.grid_launches for k, v in kernels.COUNTS.items()}
            tr = trace(fn, 5)
            seen = tr["launches_per_call_by_kernel"]
            for k, names in GRIDS.items():
                n = sum(seen.get(e, 0) for e in names)
                check(n == grids[k], f"{label} {what}: the trace shows {n} "
                      f"grids of {k} per call, its counter {grids[k]}")
            log("trace", case=label, op=what, batch=batch, nrhs=b_np.shape[1],
                dtype="float64", card=name_limit,
                grid_launches_per_call=grids, **tr)

    record = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[k][0], "grid_launches": counts[k][2],
         "max_abs_err": max_abs[k],
         "max_rel_err": {c: e["max_rel"][k] for c, e in errs.items()},
         "ms": per["kernels"][k], "plain_ms": per["twins"][k]}
        for k, src, rep in KERNELS]}
    print(json.dumps(record), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
