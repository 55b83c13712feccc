"""The stats profile's timer on GRID 100x100's chol grids, two restores
side by side, against traces.

Run from the repository root on a machine with a CUDA card:

    python3 tools/stats_timer_probe.py

`stats.profile_factor` times each piece of a bucket from restored
operands with `stats._Timer` (CUDA events behind a torch.cuda._sleep).
This script takes every factor bucket of GRID 100x100 (f64, batch 1)
and times its chol grid (K1 at rp = 0, the potrf record) two ways,
level by level on the factor's own data: `whole`, the whole buffer
copied back before each run, and `span`, the span of the buffer that
holds the bucket's panels copied back (what profile_factor does). Each
way gives the timer's median (events) and, from a trace of the same
runs, the chol grid's median device time and the gap from the sleep's
end to the grid's start. Beside them, the same grid's median device
time in a trace of 5 whole factors. One JSON line per level, a total
line (ms summed over the buckets), the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import baspacho_tpu_torch as T  # noqa: E402
import chip_smoke as C  # noqa: E402
from baspacho_tpu_torch import stats  # noqa: E402
from baspacho_tpu_torch.ops import kernels  # noqa: E402
from baspacho_tpu_torch.ops.planned_backend import factor_input  # noqa: E402,E501
from baspacho_tpu_torch.testing.problems import grid100, spd_data  # noqa: E402,E501

REPS = 5
WAYS = ("whole", "span")


def is_chol(e) -> bool:
    return C._short(e.name).startswith("chol_")


def factor_chol_us(s, d, n_buckets: int) -> np.ndarray:
    """Median device us of each bucket's chol grid over 5 traced
    factors (K1 launches one chol grid a bucket, in schedule order)."""
    s.factor(d)
    torch.cuda.synchronize()
    ev, _ = C.traced_events(lambda: [s.factor(d) for _ in range(REPS)])
    ev = [e for e in ev if is_chol(e)]
    C.check(len(ev) == REPS * n_buckets,
            f"factor trace: {len(ev)} chol grids, {REPS * n_buckets} "
            "launched")
    us = np.array([e.time_range.elapsed_us() for e in ev])
    return np.median(us.reshape(REPS, n_buckets), axis=0)


def timed_runs(s, d) -> tuple:
    """Each bucket's chol grid timed both ways (WAYS), level by level on
    the factor's data: (events ms per way per bucket, the buckets'
    (level, cp, rp, B))."""
    be, dev = s.backend, s.device
    timer = stats._Timer(dev, REPS)
    ext = factor_input(d[None], be._pad_idx(dev))
    events, shapes = {w: [] for w in WAYS}, []
    for li, level in enumerate(be._factor_levels(0, s.skel.num_lumps,
                                                 dev)):
        pre = ext.clone()
        prod = be._level_prod(ext, level)
        for b in level.buckets:
            lo, hi = stats._panel_span([b])

            def chol(b=b):
                kernels.bucket_factor(ext, None, b.off, b.rows, b.cols,
                                      b.cp, 0, b.prod_base)

            def whole():
                ext.copy_(pre)

            def span(lo=lo, hi=hi):
                ext[:, lo:hi].copy_(pre[:, lo:hi])
            for w, restore in zip(WAYS, (whole, span)):
                events[w].append(timer(restore, chol) * 1e3)
            shapes.append((li, b.cp, b.rp, int(b.off.shape[0])))
        ext.copy_(pre)
        be._factor_buckets(ext, prod, level, kernels)
        be._level_update(ext, prod, level, kernels)
    torch.cuda.synchronize()
    return events, shapes


def window_us(ev: list, n_buckets: int) -> dict:
    """Per way, the timed runs' chol grids (C.timed_windows; the timer's
    warm-up runs have no sleep before them): median device us per bucket
    and median gap from the sleep's end to the grid's start."""
    runs = C.timed_windows(ev)
    C.check(len(runs) == len(WAYS) * REPS * n_buckets and
            all(len(w) == 1 and is_chol(w[0]) for _, w in runs),
            f"probe trace: {len(runs)} timed runs, "
            f"{len(WAYS) * REPS * n_buckets} chol runs made")
    dur = np.array([w[0].time_range.elapsed_us() for _, w in runs])
    gap = np.array([w[0].time_range.start - t for t, w in runs])
    shape = (n_buckets, len(WAYS), REPS)
    dur, gap = (np.median(a.reshape(shape), axis=2) for a in (dur, gap))
    return {w: (dur[:, i], gap[:, i]) for i, w in enumerate(WAYS)}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("stats_timer_probe: no CUDA device")
    dev = torch.device("cuda:0")
    kernels.build()
    kernels._lib()
    s = grid100(T, device=dev)
    d = torch.from_numpy(spd_data(s, 1)).to(dev)
    timed_runs(s, d)  # the programs' first calls
    ev, _ = C.traced_events(lambda: timed_runs(s, d))
    events, shapes = timed_runs(s, d)
    nb = len(shapes)
    win = window_us(ev, nb)
    fac = factor_chol_us(s, d, nb)
    for li in sorted({sh[0] for sh in shapes}):
        ix = [i for i, sh in enumerate(shapes) if sh[0] == li]
        row = {"level": li, "buckets": [list(shapes[i][1:]) for i in ix],
               "factor_trace_us": float(fac[ix].sum())}
        for w in WAYS:
            row[w] = {"events_us": sum(events[w][i] for i in ix) * 1e3,
                      "trace_us": float(win[w][0][ix].sum()),
                      "gap_us": float(win[w][1][ix].sum())}
        print(json.dumps(row), flush=True)
    total = {"case": "grid100", "dtype": "float64", "buckets": nb,
             "reps": REPS, "factor_trace_ms": float(fac.sum()) / 1e3}
    for w in WAYS:
        total[w] = {"events_ms": float(sum(events[w])),
                    "trace_ms": float(win[w][0].sum()) / 1e3,
                    "gap_ms": float(win[w][1].sum()) / 1e3}
    print(json.dumps(total), flush=True)
    print(C.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
