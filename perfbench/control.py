"""Readings for the limit of a cell's check, in one process: the
program's residuals on many seeds, its float32 path (the control) on a
few, and each planted fault (perfbench/faults.py) on a few, each in a
short window at the cell's own size and load.

  python3 perfbench/control.py --workload grid-200-b8.refactor \\
      --seeds 1-12 --control-seeds 101-103 --fault-seeds 201-203 \\
      --seconds 2

Prints one line per reading (kind, seed, steps, residual_max) and a
summary line of JSON. Needs the card, as run.py does.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from perfbench import faults, harness  # noqa: E402


def seeds(spec: str) -> list:
    out = []
    for part in filter(None, spec.split(",")):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="101-103")
    ap.add_argument("--fault-seeds", default="201-203")
    ap.add_argument("--seconds", type=float, default=2.0)
    a = ap.parse_args(argv)
    wl, cfg, traffic = harness.cell_spec(harness.benchmark(), a.workload)
    harness.require_cards(wl["chips"])
    cell = harness.Cell(cfg, traffic, torch.device("cuda", 0), {})
    print(f"set-up {time.perf_counter() - START:.1f} s", flush=True)
    limit = cfg["residual_limit"]
    runs = [("program", s, None, None) for s in seeds(a.seeds)]
    runs += [("control_float32", s, "float32", None)
             for s in seeds(a.control_seeds)]
    runs += [(name, s, None, f) for name, f in faults.FAULTS.items()
             if faults.applies(name, cfg["batch"])
             for s in seeds(a.fault_seeds)]
    readings = {}
    for kind, seed, dtype, fault in runs:
        cell.load(seed, dtype)
        if fault is not None:
            fault(cell)
        run = harness.Run(stages={})
        cell.window(a.seconds, run)
        chk = cell.check(limit)
        readings.setdefault(kind, []).append(chk["residual_max"])
        print(f"{kind} seed {seed}: {run.steps} steps, "
              f"{chk['checked']} checked, residual_max "
              f"{chk['residual_max']!r}, correct {chk['failed'] == 0}",
              flush=True)
        faults.remove(cell)
    summary = {k: {"n": len(v), "min": min(v), "max": max(v)}
               for k, v in readings.items()}
    print(json.dumps({"workload": a.workload, "limit": limit,
                      "readings": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
