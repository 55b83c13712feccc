"""1-D spring chain demo (reference examples/OptimizeSimple.cpp; the JAX
package's examples/optimize_simple.py): variables x_i pulled to unit
spacing by spring factors plus one anchor.

    python -m baspacho_tpu_torch.examples.optimize_simple [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from baspacho_tpu_torch.optimizer import (Optimizer, OptimizerSettings,
                                          VariableFamily)


def main(argv=None, n: int = 20):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    rng = np.random.RandomState(0)
    opt = Optimizer(device=args.device)
    xs = opt.add_variable_family(VariableFamily(rng.rand(n, 1) * 10))

    opt.add_factor_family(lambda a, b: (b - a) - 1.0,
                          [(xs, np.arange(n - 1)), (xs, np.arange(1, n))])
    opt.add_factor_family(lambda a: a, [(xs, np.array([0]))])

    stats = opt.optimize(OptimizerSettings(max_iters=25, verbose=True))
    print("final cost:", stats["final_cost"])
    print("solution:", opt.families[xs].values[:, 0].cpu().numpy().round(6))
    return stats


if __name__ == "__main__":
    main()
