"""Bundle adjustment demo (reference examples/OptimizeBaAtLarge.cpp; the
JAX package's examples/optimize_ba.py): loads a BAL file (or generates a
synthetic scene), Schur-eliminates the landmarks, and runs
Levenberg-Marquardt with a Huber loss on the planned backend.

    python -m baspacho_tpu_torch.examples.optimize_ba [problem.txt[.gz]]
        [--device cpu]
"""

from __future__ import annotations

import argparse

from baspacho_tpu_torch import BackendType
from baspacho_tpu_torch.bal import (build_ba_optimizer, load_bal,
                                    make_random_bal)
from baspacho_tpu_torch.optimizer import OptimizerSettings


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", nargs="?")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.path:
        prob = load_bal(args.path)
    else:
        prob = make_random_bal(n_cams=8, n_pts=200, track_len=5, seed=0,
                               noise=0.5)
    print(f"cameras={prob.num_cameras} points={prob.num_points} "
          f"observations={prob.num_observations}")
    opt, pts, cams = build_ba_optimizer(prob, huber=100.0,
                                        device=args.device)
    stats = opt.optimize(OptimizerSettings(
        max_iters=20, backend=BackendType.PLANNED, verbose=True))
    print("final cost:", stats["final_cost"])
    return stats


if __name__ == "__main__":
    main()
