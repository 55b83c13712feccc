"""A short first check of K6 (csrc/grad_hess.cu) on the card, apart from
chip_smoke.py.

Run from the repository root on a machine with a CUDA card:

    python3 tools/k6_check.py

It prints what ptxas reports for grad_hess.cu (registers, shared memory,
spills), builds the kernels, and holds K6 against its plain twin (f64 and
f32) and against itself (bitwise) on the SE3 bundle adjustment of
tests/test_optimizer.py, a small BAL scene and a 120-camera window-mode
one; the SE3 BA's assembly against the dense normal equations; then on
BAL 871 x 527,480 its set-up, the Jacobians' seconds, K6 and its twin
timed with CUDA events over one assembly, and one LM iteration with the
host ms of each stage. One JSON line per check.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import baspacho_tpu_torch as T  # noqa: E402
import baspacho_tpu_torch.optimizer as TO  # noqa: E402
from baspacho_tpu_torch import bal as TB  # noqa: E402
from baspacho_tpu_torch.ops import kernels  # noqa: E402
from baspacho_tpu_torch.testing.flows import (  # noqa: E402
    ba_settings, dense_normal_equations, k6_vs_twin)
from baspacho_tpu_torch.testing.problems import BAL871, se3_ba  # noqa: E402


def log(**fields) -> None:
    print(json.dumps(fields), flush=True)


def against_twin(opt, terms) -> dict:
    """testing.flows.k6_vs_twin in f64 and f32."""
    out = {}
    for dt in (torch.float64, torch.float32):
        r, _, same = k6_vs_twin(opt, terms, dt)
        out[str(dt)[6:]] = {"rel": r, "bitwise": same}
    return out


def event_ms(fn) -> float:
    """CUDA-event ms of one call of fn, after one warm-up call."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k6_check: no CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         os.devnull, os.path.join(kernels.CSRC, "grad_hess.cu")],
        capture_output=True, text=True)
    print(out.stdout, out.stderr, flush=True)
    t0 = time.perf_counter()
    kernels.build()
    kernels._lib()
    log(build_s=time.perf_counter() - t0)

    small = {
        "se3": lambda: se3_ba(TO, device=dev)[0],
        "bal_small": lambda: TB.build_ba_optimizer(TB.make_random_bal(
            n_cams=6, n_pts=60, track_len=3, seed=4, noise=0.5), huber=1.0,
            device=dev)[0],
        "bal_120": lambda: TB.build_ba_optimizer(TB.make_random_bal(
            **{**BAL871, "n_cams": 120, "n_pts": 8000}), device=dev)[0]}
    for name, make in small.items():
        opt = make()
        opt.build_solver(TO.OptimizerSettings(backend=T.BackendType.PLANNED))
        vals = [f.values for f in opt.families]
        res = against_twin(opt, opt.jacobians(vals))
        if name == "se3":
            _, grad, hdata = opt.compute_grad_hess(vals)
            g, H = dense_normal_equations(opt, vals)
            hd = opt.solver.skel.densify(hdata.cpu().numpy(),
                                         fill_upper_half=True)
            res["dense_rel"] = [
                float(np.abs(grad.cpu().numpy() - g).max() / np.abs(g).max()),
                float(np.abs(hd - H).max() / np.abs(H).max())]
        log(case=name, **res)

    t0 = time.perf_counter()
    prob = TB.make_random_bal(**BAL871)
    t1 = time.perf_counter()
    opt = TB.build_ba_optimizer(prob, device=dev)[0]
    settings = ba_settings(T.BackendType.PLANNED, 1, damp_additive=True)
    s = opt.build_solver(settings)
    torch.cuda.synchronize()
    log(case="bal871", problem_s=t1 - t0,
        build_solver_s=time.perf_counter() - t1, order=s.order,
        data_size=s.data_size, lumps=s.skel.num_lumps)
    vals = [f.values for f in opt.families]
    t0 = time.perf_counter()
    terms = opt.jacobians(vals)
    torch.cuda.synchronize()
    log(case="bal871", jacobians_s=time.perf_counter() - t0,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        **against_twin(opt, terms))
    for dt in (torch.float64, torch.float32):
        Ws = [W.to(dt).contiguous() for _, W in terms]
        ms = {}
        for impl, fn in (("k6_ms", kernels.grad_hess),
                         ("twin_ms", kernels.grad_hess_twin)):
            h = torch.zeros(s.data_size, dtype=dt, device=dev)
            g = torch.zeros(s.order, dtype=dt, device=dev)
            ms[impl] = event_ms(lambda: [fn(W, h, g, plan) for W, (_, plan)
                                         in zip(Ws, opt._plans)])
        log(case="bal871", dtype=str(dt)[6:], **ms)
    stamps = [("start", time.perf_counter())]

    def mark(stage):
        torch.cuda.synchronize()
        stamps.append((stage, time.perf_counter()))
    opt.mark = mark
    stats = opt.optimize(settings)
    log(case="bal871", lm=stats, stages_ms=[
        (a[0], (a[1] - b[1]) * 1e3) for a, b in zip(stamps[1:], stamps)],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return 0


if __name__ == "__main__":
    sys.exit(main())
