"""Runs flows of the solver on N ranks over torch.distributed.

`launch(n, cases, backend, device)` saves each case (a solver's skeleton
and the inputs of one flow) to a temporary directory, starts n processes
with torch.multiprocessing (spawn) that meet through a file:// store
there, and returns what they wrote. Every rank rebuilds the solver with
solver_from_skeleton (no ordering work), runs the case's flow, and
writes a hash of its outputs with its launch counts, collective bytes,
rerun check and times; rank 0 also writes the outputs (and, for a case
run on the plain twins too, the twins' outputs). The workers live
here, so that a spawned child imports this package only.

Flows (FLOWS):
  factor_sharded  Solver.factor_sharded(data)
  solve_sharded   Solver.solve_sharded(factor, rhs), rhs (order,) or
                  (order, nrhs)
  dp              the data-parallel batch: each rank factors and solves
                  its contiguous rows of (data (B, data_size), rhs (B,
                  order, nrhs)) with Solver.factor / solve; the rows are
                  all-gathered to every rank

The group handed to the solver is a 1-D DeviceMesh when the backend is
its device type's own (gloo on the CPU, NCCL on CUDA), else the default
process group: gloo with CUDA tensors (every rank on one card; NCCL
refuses two ranks on one GPU).
"""

from __future__ import annotations

import datetime
import hashlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from .. import solver as solver_mod
from ..ops import kernels, planned_backend


@dataclass
class Case:
    """One flow on one solver: `inputs` are numpy arrays (see FLOWS),
    `reps` timed runs after the checked one and its rerun, `plain` also
    runs the sharded programs on the kernels' plain twins (their outputs
    returned, their runs timed)."""
    name: str
    solver: object
    flow: str
    inputs: Dict[str, np.ndarray]
    reps: int = 0
    plain: bool = False


@dataclass
class Result:
    """What the ranks wrote for one case: rank 0's outputs (and its
    twins' outputs in `plain`, for a case with `plain`), and per rank its
    hash of the outputs and its record (launches, collective bytes,
    rerun_equal, ms, plain_ms, and the case's seconds on the rank, the
    solver's rebuild included where the case is its first)."""
    outputs: Dict[str, np.ndarray]
    hashes: List[str]
    records: List[dict] = field(default_factory=list)
    plain: Dict[str, np.ndarray] = field(default_factory=dict)


def _factor_sharded(s, mesh, a, ops):
    if ops is kernels:
        return {"factor": s.factor_sharded(a["data"], mesh)}
    fn = s.sharded_program("factor_sharded", mesh)
    return {"factor": fn(a["data"][None].contiguous(), ops=ops)[0]}


def _solve_sharded(s, mesh, a, ops):
    if ops is kernels:
        return {"solution": s.solve_sharded(a["factor"], a["rhs"], mesh)}
    fn = s.sharded_program("solve_sharded", mesh)
    v = a["rhs"] if a["rhs"].ndim == 2 else a["rhs"][:, None]
    x = fn(a["factor"][None].contiguous(), v[None], ops=ops)[0]
    return {"solution": x if a["rhs"].ndim == 2 else x[:, 0]}


def _dp(s, mesh, a, ops):
    group = solver_mod.shard_group(mesh)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    B = a["data"].shape[0]
    if B % n:
        raise ValueError(f"dp: batch {B} does not split over {n} ranks")
    lo, hi = r * B // n, (r + 1) * B // n
    f = s.factor(a["data"][lo:hi])
    x = s.solve(f, a["rhs"][lo:hi])
    out = {}
    for k, t in (("factor", f), ("solution", x)):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=group)
        out[k] = torch.cat(parts)
    return out


FLOWS = {"factor_sharded": _factor_sharded, "solve_sharded": _solve_sharded,
         "dp": _dp}


def _save_solver(path: str, s) -> None:
    arrays = {f"skel_{k}": v for k, v in
              solver_mod.skeleton_arrays(s.skel).items()}
    np.savez(path, **arrays, permutation=np.asarray(s.permutation),
             elim=np.asarray(s.sparse_elim_ranges, dtype=np.int64),
             backend=np.array(s.backend_type.value))


def _load_solver(path: str, dev):
    with np.load(path, allow_pickle=False) as z:
        arrays = {k[5:]: z[k] for k in z.files if k.startswith("skel_")}
        return solver_mod.solver_from_skeleton(
            arrays, z["permutation"], z["elim"].tolist(), device=dev,
            backend=solver_mod.BackendType(str(z["backend"])))


def _save_case(path: str, case: Case, solver_index: int) -> None:
    np.savez(path, solver=np.array(solver_index), flow=np.array(case.flow),
             reps=np.array(case.reps), plain=np.array(case.plain),
             **{f"in_{k}": v for k, v in case.inputs.items()})


def _hash(out: Dict[str, torch.Tensor]) -> str:
    h = hashlib.sha256()
    for k in sorted(out):
        h.update(k.encode())
        h.update(out[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _times(run, reps: int, dev) -> list:
    """ms of each of `reps` runs started together on every rank: CUDA
    events on the rank's stream on a card, the host clock on the CPU."""
    ms = []
    for _ in range(reps):
        dist.barrier()
        _sync(dev)
        if dev.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            run()
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
        else:
            t0 = time.perf_counter()
            run()
            ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def _mesh(backend: str, dev: torch.device, n: int):
    native = {"cpu": "gloo", "cuda": "nccl"}[dev.type]
    if backend == native:
        from torch.distributed.device_mesh import init_device_mesh
        return init_device_mesh(dev.type, (n,))
    return dist.group.WORLD


def _run_case(tmp: str, i: int, solvers: dict, dev, mesh, rank: int):
    """Case i on this rank; `solvers` caches the solvers rebuilt so far
    by their index."""
    t0 = time.perf_counter()
    with np.load(os.path.join(tmp, f"{i}.npz"), allow_pickle=False) as z:
        j = int(z["solver"])
        a = {k[3:]: torch.from_numpy(z[k]).to(dev) for k in z.files
             if k.startswith("in_")}
        flow = FLOWS[str(z["flow"])]
        reps, plain = int(z["reps"]), bool(z["plain"])
    if j not in solvers:
        solvers[j] = _load_solver(os.path.join(tmp, f"solver{j}.npz"), dev)
    s = solvers[j]
    kernels.reset_counts()
    planned_backend.reset_comm()
    out = flow(s, mesh, a, kernels)
    _sync(dev)
    comm = planned_backend.COMM
    rec = {"launches": {k: c.launches for k, c in kernels.COUNTS.items()
                        if c.launches},
           "twin_calls": {k: c.twin_calls for k, c in kernels.COUNTS.items()
                          if c.twin_calls},
           "collectives": comm.calls, "sent_bytes": comm.sent_bytes,
           "received_bytes": comm.received_bytes}
    again = flow(s, mesh, a, kernels)
    rec["rerun_equal"] = all(torch.equal(out[k], again[k]) for k in out)
    del again
    rec["ms"] = _times(lambda: flow(s, mesh, a, kernels), reps, dev)
    twin = {}
    if plain:
        twin = flow(s, mesh, a, kernels.TWINS)
        rec["plain_ms"] = _times(lambda: flow(s, mesh, a, kernels.TWINS),
                                 reps, dev)
    rec["hash"] = _hash(out)
    rec["seconds"] = time.perf_counter() - t0
    with open(os.path.join(tmp, f"{i}.{rank}.json"), "w") as f:
        json.dump(rec, f)
    if rank == 0:
        np.savez(os.path.join(tmp, f"{i}.out.npz"),
                 **{k: v.detach().cpu().numpy() for k, v in out.items()},
                 **{f"plain_{k}": v.detach().cpu().numpy()
                    for k, v in twin.items()})


def _worker(rank: int, n: int, backend: str, device: str, tmp: str,
            n_cases: int, timeout_s: float) -> None:
    """One rank: join the group, run every case, leave the group."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'store')}",
        world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        mesh, solvers = _mesh(backend, dev, n), {}
        for i in range(n_cases):
            _run_case(tmp, i, solvers, dev, mesh, rank)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(n: int, cases: List[Case], backend: str = "gloo",
           device=None, timeout_s: float = 600.0) -> List[Result]:
    """Runs the cases on n ranks (one process each, spawned) and returns
    their results in order. `device` is read as the solvers read it
    (solver.resolve_device): the CUDA card unless one is named, and
    without a card it raises; on CUDA rank r runs on card r modulo the
    card count. Raises if a rank fails or the run outlasts `timeout_s`;
    no process outlives the call."""
    import torch.multiprocessing as mp
    device = solver_mod.resolve_device(device).type
    with tempfile.TemporaryDirectory(prefix="baspacho_ranks_") as tmp:
        index = {}  # one skeleton file per solver
        for i, c in enumerate(cases):
            if id(c.solver) not in index:
                index[id(c.solver)] = len(index)
                _save_solver(os.path.join(tmp, f"solver{len(index) - 1}.npz"),
                             c.solver)
            _save_case(os.path.join(tmp, f"{i}.npz"), c, index[id(c.solver)])
        ctx = mp.start_processes(
            _worker, args=(n, backend, device, tmp, len(cases), timeout_s),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=5.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks ran past {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(30)
        results = []
        for i in range(len(cases)):
            recs = []
            for r in range(n):
                with open(os.path.join(tmp, f"{i}.{r}.json")) as f:
                    recs.append(json.load(f))
            with np.load(os.path.join(tmp, f"{i}.out.npz")) as z:
                outs = {k: z[k] for k in z.files
                        if not k.startswith("plain_")}
                plain = {k[6:]: z[k] for k in z.files
                         if k.startswith("plain_")}
            results.append(Result(outs, [rec["hash"] for rec in recs],
                                  recs, plain))
        return results
