"""The facade's replays (Solver.graphs, ops/chain.py) beyond the
benchmark's steps, on the card, for a comparison of two checkouts:

  lm      BAL 871 x 527,480, f64, PLANNED: optimize() direct (ITERS
          iterations) and with the partial factor + PCG (BlockJacobi),
          each run twice from the same start; per run the host ms of
          each iteration's stages (chip_smoke.py's stamps, the card
          synchronised at each) and the slots' calls by kind.
  cells   the benchmark's three cells (grid-200-b8.refactor,
          bal-871.refactor, bal-871-mixed.refine) loaded in one process
          and kept, STEPS steps each after their warm-up; the card's
          memory allocated and reserved, peak and now, and after
          empty_cache, and the slots' calls by kind.

  python3 tools/graphs_probe.py lm|cells

A checkout without Solver.graphs reports no slots. Prints one JSON line
a record. Needs the card.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from baspacho_tpu_torch import BackendType  # noqa: E402
from perfbench import harness  # noqa: E402

ITERS = 4
STEPS = 20
SEED = 1732050807
CELLS = ("grid-200-b8.refactor", "bal-871.refactor", "bal-871-mixed.refine")


def say(**kw):
    print(json.dumps(kw), flush=True)


def slots(solver) -> dict:
    """(eager, captures, replays, moves, retired) per slot key."""
    graphs = getattr(solver, "graphs", None)
    if graphs is None:
        return {}
    return {" ".join(map(str, k)): (s.eager, s.captures, s.replays, s.moves,
                                    s.retired)
            for k, s in graphs.slots.items()}


def memory() -> dict:
    gb = 1e-9
    return {"allocated_gb": torch.cuda.memory_allocated() * gb,
            "reserved_gb": torch.cuda.memory_reserved() * gb,
            "peak_allocated_gb": torch.cuda.max_memory_allocated() * gb,
            "peak_reserved_gb": torch.cuda.max_memory_reserved() * gb}


def lm(dev) -> None:
    opt, values0, _ = cs.bal_setup(dev)
    for name, pcg in (("direct", False), ("pcg", True)):
        settings = cs.ba_settings(BackendType.PLANNED, ITERS, pcg=pcg,
                                  **cs.BAL_DAMP)
        for run in range(2):
            cs.reset_values(opt, values0)
            stamps = [("start", time.perf_counter())]
            opt.mark = cs.stage_clock(stamps)
            st = opt.optimize(settings)
            opt.mark = None
            iters = cs.lm_breakdown(stamps)[1:]
            say(part="lm", path=name, run=run, iterations=st["iters"],
                costs=st["costs"], stages_ms=iters,
                factor_solve_ms=[it.get("damp_factor", 0.0) +
                                 it.get("solve", 0.0) for it in iters],
                total_ms=(stamps[-1][1] - stamps[0][1]) * 1e3,
                slots=slots(opt.solver), **memory())


def cells(dev) -> None:
    torch.cuda.reset_peak_memory_stats()
    kept = []
    for name in CELLS:
        _, cfg, traffic = harness.cell_spec(harness.benchmark(), name)
        cell = harness.Cell(cfg, traffic, dev, {})
        cell.load(SEED)
        for i in range(STEPS):
            cell.mix.step(i, harness.no_span)
        torch.cuda.synchronize()
        kept.append(cell)
        say(part="cells", loaded=name, slots=slots(cell.solver), **memory())
    torch.cuda.empty_cache()
    say(part="cells", kept=list(CELLS), after_empty_cache=True, **memory())


def main(argv) -> int:
    if len(argv) != 1 or argv[0] not in ("lm", "cells"):
        raise SystemExit("usage: tools/graphs_probe.py lm|cells")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    say(part="card", card=harness.power_limit(), torch=torch.__version__)
    (lm if argv[0] == "lm" else cells)(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
