"""Runs one cell of the benchmark once and prints its result line.

  python3 perfbench/run.py --workload bal-871.refactor --seed 7 \\
      --seconds 10 --trace 0

Run from the root of a checkout on a machine with the cards the cell
asks for; without them it exits with code 2 and prints no result. The
last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and last the numbers
compared with their limits); the numbers compared are also the last
lines of standard error. Set-up (structure, analysis, programs, inputs,
two warm steps, the kernels' build on a checkout's first run) counts as
setup_s; then steps run for --seconds; --trace 1 adds a profiled run of a
few steps and reports the per-layer metrics instead of the end-to-end
ones.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        result = harness.run_cell(a.workload, a.seed, a.seconds,
                                  bool(a.trace), START)
    except harness.NoCard as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    for k, v in result["checks"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
