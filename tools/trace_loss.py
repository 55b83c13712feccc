"""Looks for kernel records that a torch.profiler trace of the port loses.

Run from the repository root on a machine with a CUDA card:

    python3 tools/trace_loss.py [--rounds N]

chip_smoke.py checks that a trace shows as many grids of each kernel as
the launch counters say were launched. This script repeats, `--rounds`
times, what that phase traces on MERI n=7 and FLAT n=1000 (f64, nrhs 3):
one warm-up call, then a trace of 5 calls of the factor, then of the
solve. For every trace it compares three counts per CUDA kernel name:

  counter   the wrappers' grid-launch counters for one call, times 5
  events    device records in prof.events() (what chip_smoke.py reads)
  raw       device records in the profiler's kineto results

and matches every runtime launch record (cudaLaunchKernel, on the host)
with a device record through their shared correlation id. A launch with no
device record is a lost record: it is reported with the call it belonged
to, its place in that call and the kernel at that place in the other
calls. Each trace is taken twice, once as chip_smoke.py took it before
and once with a lead-in: the host sleeps `--lead-in` seconds inside the
profiler before the first call. One JSON line per trace with losses
(into chiprun_out/trace_loss.jsonl), then a summary line per variant.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from baspacho_tpu_torch.ops import kernels  # noqa: E402
from baspacho_tpu_torch.testing.problems import (flat1000, meri7,  # noqa: E402
                                                 spd_data)

REPS = 5


def short(name: str) -> str:
    m = re.search(r"(\w+)(?:<[^()]*>)?\(", name)
    return m.group(1) if m else name[:60]


def one_trace(fn, lead_in_s: float):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(lead_in_s)
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    raw = list(prof.profiler.kineto_results.events())
    dev = [e for e in raw if e.device_type() == DeviceType.CUDA]
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    launches = sorted((e for e in raw if e.device_type() == DeviceType.CPU
                       and "LaunchKernel" in e.name()),
                      key=lambda e: e.start_ns())
    by_corr = {e.correlation_id(): e for e in dev}
    count = lambda names: {k: names.count(k) for k in set(names)}  # noqa
    per_call = len(launches) // REPS if len(launches) % REPS == 0 else None
    lost = []
    t0 = min(e.start_ns() for e in raw)
    t1 = max(e.end_ns() for e in raw)
    for i, e in enumerate(launches):
        if e.correlation_id() in by_corr:
            continue
        row = {"launch": i, "host_ms_from_trace_start":
               (e.start_ns() - t0) / 1e6,
               "host_ms_to_trace_end": (t1 - e.start_ns()) / 1e6}
        if per_call:
            call, place = divmod(i, per_call)
            same = [by_corr.get(launches[c * per_call + place]
                                .correlation_id()) for c in range(REPS)]
            row.update(call=call, place=place, kernel=next(
                (short(k.name()) for k in same if k is not None), None))
        lost.append(row)
    return {"raw": count([short(e.name()) for e in dev]),
            "events": count([short(e.name) for e in events]),
            "runtime_launches": len(launches),
            "device_records_with_a_launch": sum(
                e.correlation_id() in by_corr for e in launches),
            "lost": lost}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--lead-in", type=float, default=0.05)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_loss: no CUDA device")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels._lib()
    cases = []
    for pname, make in (("meri7", meri7), ("flat1000", flat1000)):
        s = make(__import__("baspacho_tpu_torch"), device=dev)
        d = torch.from_numpy(spd_data(s, 1)).to(dev)[None]
        b = torch.rand(1, s.order, 3, dtype=torch.float64, device=dev)
        fp, sp = s.factor_program(), s.solve_program()
        f = fp(d)
        cases += [(pname, "factor", lambda fp=fp, d=d: fp(d)),
                  (pname, "solve", lambda sp=sp, f=f, b=b: sp(f, b))]
    os.makedirs("chiprun_out", exist_ok=True)
    log = open(os.path.join("chiprun_out", "trace_loss.jsonl"), "w")
    stats = {v: {"traces": 0, "traces_with_losses": 0,
                 "traces_short_of_seg_sub_in_events": 0,
                 "traces_short_of_seg_sub_in_raw": 0,
                 "lost_device_records": 0, "lost_by_kernel": {},
                 "lost_calls": {}, "latest_lost_host_ms": 0.0,
                 "share_of_launches_matched": [1.0, 0.0]}
             for v in ("no_lead_in", "lead_in")}
    t_start = time.perf_counter()
    for rnd in range(args.rounds):
        for pname, op, fn in cases:
            for variant, lead in (("no_lead_in", 0.0),
                                  ("lead_in", args.lead_in)):
                st = stats[variant]
                kernels.reset_counts()
                fn()
                torch.cuda.synchronize()
                want = {k: v.grid_launches * REPS
                        for k, v in kernels.COUNTS.items()
                        if v.grid_launches}
                tr = one_trace(fn, lead)
                st["traces"] += 1
                share = tr["device_records_with_a_launch"] / max(
                    tr["runtime_launches"], 1)
                m = st["share_of_launches_matched"]
                m[0], m[1] = min(m[0], share), max(m[1], share)
                want_seg = want.get("segmented_subtract", 0)
                for src in ("raw", "events"):
                    st[f"traces_short_of_seg_sub_in_{src}"] += \
                        tr[src].get("seg_sub_kernel", 0) != want_seg
                st["lost_device_records"] += len(tr["lost"])
                st["traces_with_losses"] += bool(tr["lost"])
                for row in tr["lost"]:
                    k = str(row.get("kernel"))
                    st["lost_by_kernel"][k] = st["lost_by_kernel"].get(k,
                                                                       0) + 1
                    c = str(row.get("call"))
                    st["lost_calls"][c] = st["lost_calls"].get(c, 0) + 1
                    st["latest_lost_host_ms"] = max(
                        st["latest_lost_host_ms"],
                        row["host_ms_from_trace_start"])
                if tr["lost"] or sum(tr["raw"].values()) != \
                        sum(tr["events"].values()):
                    log.write(json.dumps({
                        "round": rnd, "case": pname, "op": op,
                        "variant": variant, "counter_grids": want,
                        **tr}) + "\n")
    log.close()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for variant, st in stats.items():
        print(json.dumps({"variant": variant, "reps_per_trace": REPS,
                          "lead_in_s": args.lead_in
                          if variant == "lead_in" else 0.0, **st}),
              flush=True)
    print(json.dumps({"seconds": time.perf_counter() - t_start,
                      "card": card, "torch": torch.__version__}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
