"""Mixed direct/iterative solve demo (reference examples/PCG_Sample.cpp;
the JAX package's examples/pcg_sample.py): partially factor up to the
end of the sparse elimination range, solve the remaining corner by PCG
under a selectable preconditioner (testing/flows.py pcg_flow), and
check the residual with the solver's block mat-vec.

    python -m baspacho_tpu_torch.examples.pcg_sample [jacobi|gauss_seidel]
        [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from baspacho_tpu_torch import Settings, create_solver
from baspacho_tpu_torch.testing import SparseMatGenerator, random_spd_data
from baspacho_tpu_torch.testing.flows import pcg_flow

PRECONDS = {"jacobi": "BlockJacobiPrecond",
            "gauss_seidel": "BlockGaussSeidelPrecond"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("precond", nargs="?", default="jacobi",
                    choices=sorted(PRECONDS))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    gen = SparseMatGenerator.gen_flat(20, 0.3, seed=42)
    gen.add_schur_set(80, 0.1)
    ss = gen.to_structure()
    solver = create_solver(Settings(), np.full(ss.order, 3), ss,
                           sparse_elim_ranges=[0, 80], device=args.device)
    data = random_spd_data(solver.data_size, solver.order, 7)
    data = torch.from_numpy(solver.skel.damp(data, 0.0, solver.order * 1.5))
    rhs = torch.from_numpy(np.random.RandomState(0).rand(solver.order))
    data, rhs = data.to(solver.device), rhs.to(solver.device)
    x, iters, _ = pcg_flow(solver, data, rhs, PRECONDS[args.precond])
    # residual check against the full matrix
    mv = solver.add_mv_from(data, 0, x, torch.zeros_like(x))
    resid = float((mv - rhs).abs().max())
    print(f"PCG iters={iters}  residual={resid:.3e}")
    return {"iterations": int(iters), "residual": resid}


if __name__ == "__main__":
    main()
