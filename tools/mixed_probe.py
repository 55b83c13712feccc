"""BAL 871 in mixed precision on the card, beside its float64 twin: the
cell bal-871-mixed.refine's set-up and one seed's damped system, then

  factor    the float32 factor of the cast against the float64 factor of
            the same system (largest difference over the largest entry
            of the buffer), check_factor of both, reruns bitwise;
  solve     relative residuals by the plain reference of the f64 solve,
            the f32 solve alone and solve_refined at 1 and 2 rounds;
            solve_refined bitwise on a rerun.

The kernels' device times of either precision are in the breakdown of a
traced benchmark run (bal-871.refactor, bal-871-mixed.refine).

  python3 tools/mixed_probe.py --seed 2236067977

Prints one JSON line a part. Needs the card.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from perfbench import harness  # noqa: E402

WORKLOAD = "bal-871-mixed.refine"


def say(**kw):
    print(json.dumps(kw), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2236067977)
    a = ap.parse_args(argv)
    wl, cfg, traffic = harness.cell_spec(harness.benchmark(), WORKLOAD)
    harness.require_cards(wl["chips"])
    dev = torch.device("cuda", 0)
    stages = {}
    cell = harness.Cell(cfg, traffic, dev, stages)
    cell.load(a.seed)
    say(part="setup", card=harness.power_limit(), stages=stages)
    mix, s = cell.mix, cell.solver
    mix.step(0, harness.no_span)      # step 0's damped system and its cast
    f64 = s.factor(mix.damped)
    f32 = s.factor(mix.low)
    again = s.factor(mix.low)
    torch.cuda.synchronize()
    top = float(f64.abs().max())
    diff = float((f32.double() - f64).abs().max())
    say(part="factor", dtype=str(f32.dtype),
        finite=bool(torch.isfinite(f32).all()),
        check_factor_f32=s.check_factor(f32),
        check_factor_f64=s.check_factor(f64), max_abs_diff=diff,
        max_abs_f64=top, relative=diff / top,
        rerun_bitwise=bool(torch.equal(f32, again)))
    del again
    x64 = s.solve(f64, mix.rhs)
    x32 = s.solve(f32, mix.rhs.float()).double()
    x1 = s.solve_refined(mix.damped, f32, mix.rhs, iterations=1)
    x2 = s.solve_refined(mix.damped, f32, mix.rhs, iterations=2)
    x2b = s.solve_refined(mix.damped, f32, mix.rhs, iterations=2)
    say(part="solve", residual_f64=mix.judge(0, x64),
        residual_f32=mix.judge(0, x32), residual_refined_1=mix.judge(0, x1),
        residual_refined_2=mix.judge(0, x2),
        refined_rerun_bitwise=bool(torch.equal(x2, x2b)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
