"""K3-rest narrow's two grids on the same small buckets, side by side.

Run from the repository root on a machine with a CUDA card:

    python3 tools/tri_layout_probe.py

K3-rest narrow (ops/kernels.py `tri_solve`, csrc/tri_solve.cu) runs a
bucket on its warp grid or on its CTA grid by `kernels.tri_layout`:
buckets of cp-4 panels of at most 64 below rows take the warp grid at
any panel count (`TRI_WARP_CP`, `TRI_WARP_ROWS`), the others from
SOLVE_WARP_PANELS panels on. This script takes every bucket of
MERI's and GRID's partial solves (up to and from a middle lump, f64)
that could take either grid (4 <= cp <= 32, rp cp <= 1024, fewer than
SOLVE_WARP_PANELS panels) and runs it both ways, in both passes, at
nrhs 1 and 3: each against the plain twin (1e-10), then its device us
per call from a complete trace (chip_smoke.complete_trace, 20 runs).
One JSON line per bucket, a total line, the card's name and power limit.
"""

from __future__ import annotations

import functools
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import baspacho_tpu_torch as T  # noqa: E402
import chip_smoke as C  # noqa: E402
from baspacho_tpu_torch.ops import kernels  # noqa: E402
from baspacho_tpu_torch.testing.problems import (grid100, meri7,  # noqa: E402
                                                 spd_data)

# (TRI_WARP_CP, TRI_WARP_ROWS) that send every such bucket to each grid
GRIDS = {"cta": (0, 0), "warp": (32, 1024)}


def bucket_rows(make, dev) -> list:
    s = make(T, device=dev)
    d = torch.from_numpy(spd_data(s, 1)).to(dev)
    t = C.split_span(s, make.__name__)
    tl, nl = s._lump_of_span(t), s.skel.num_lumps
    fu = s.program("factor", 0, tl)(d[None])[0]
    ff = s.program("factor", tl, nl)(fu[None])[0]
    rng = np.random.RandomState(3)
    rows = []
    for label, data, lo, hi in (("up_to", fu, 0, tl), ("from", ff, tl, nl)):
        cap = C.SolveCapture("tri_solve")
        v = torch.from_numpy(rng.rand(1, s.order, 3)).to(dev)
        s.program("solve_lt", lo, hi)(
            data[None], s.program("solve_l", lo, hi)(data[None], v, ops=cap),
            ops=cap)
        for tr, off, rws, cols, vec_off, bidx, cp, rp in cap.calls:
            B = off.numel()
            if not (4 <= cp <= 32 and rp * cp <= kernels.SOLVE_WARP_ELEMS
                    and B < kernels.SOLVE_WARP_PANELS):
                continue
            row = {"case": f"{make.__name__} {label}",
                   "pass": "Lt" if tr else "L", "bucket": [cp, rp, B]}
            for grid, (wcp, wrows) in GRIDS.items():
                kernels.TRI_WARP_CP, kernels.TRI_WARP_ROWS = wcp, wrows
                for n in (1, 3):
                    vv = torch.from_numpy(rng.rand(1, s.order, n)).to(dev)
                    y = torch.zeros(1, B * rp, n, dtype=vv.dtype,
                                    device=dev) if rp and not tr else None
                    bucket = (off, rws, cols, vec_off, bidx, cp, rp, tr)
                    chk = C.CheckedOps()
                    chk._solve("tri_solve", data[None], vv.clone(),
                               None if y is None else y.clone(), 0, *bucket)
                    C.check(chk.rel["tri_solve"] <= 1e-10,
                            f"{row} {grid} nrhs {n}: {chk.rel['tri_solve']}")
                    run = functools.partial(kernels.tri_solve, data[None],
                                            vv, y, 0, *bucket)
                    kernels.reset_counts()
                    run()
                    torch.cuda.synchronize()
                    ms, _, _ = C.complete_trace(
                        run, C.GRIDS["tri_solve"],
                        kernels.COUNTS["tri_solve"].grid_launches, 20,
                        str(row))
                    row[f"{grid}_nrhs{n}_us"] = sum(ms.values()) * 1e3
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tri_layout_probe: no CUDA device")
    dev = torch.device("cuda:0")
    kernels.build()
    default = kernels.TRI_WARP_CP, kernels.TRI_WARP_ROWS
    rows = bucket_rows(meri7, dev) + bucket_rows(grid100, dev)
    kernels.TRI_WARP_CP, kernels.TRI_WARP_ROWS = default
    keys = [f"{g}_nrhs{n}_us" for g in GRIDS for n in (1, 3)]
    print(json.dumps({"buckets": len(rows),
                      "total_us": {k: sum(r[k] for r in rows) for k in keys},
                      "cp4_total_us": {k: sum(r[k] for r in rows
                                              if r["bucket"][0] == 4)
                                       for k in keys}}), flush=True)
    print(C.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
