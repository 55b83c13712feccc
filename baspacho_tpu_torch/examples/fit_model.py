"""Computation-model fitting demo (reference examples/OptimizeCompModel.cpp;
the JAX package's examples/fit_model.py): profiles the planned factor
schedule piece by piece on the device's kernels and least-squares fits
the polynomial cost models used by the supernode-merge heuristic.

    python -m baspacho_tpu_torch.examples.fit_model [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from baspacho_tpu_torch import BackendType, Settings, create_solver
from baspacho_tpu_torch.stats import fit_computation_model
from baspacho_tpu_torch.testing import SparseMatGenerator, random_spd_data


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    gen = SparseMatGenerator.gen_flat(300, 0.05, seed=37)
    ss = gen.to_structure()
    solver = create_solver(Settings(backend=BackendType.PLANNED),
                           np.full(ss.order, 3), ss, device=args.device)
    data = random_spd_data(solver.data_size, solver.order, 0, np.float32)
    data = np.asarray(solver.skel.damp(data, 0.0, solver.order * 1.5),
                      dtype=np.float32)
    records = solver.profile_ops(torch.from_numpy(data).to(solver.device),
                                 reps=3)
    for r in records[:10]:
        print(f"{r[0]:6s} {r[1]:5d} {r[2]:7d} {r[3]:5d} {r[4]*1e3:8.3f} ms")
    cm = fit_computation_model(records)
    print("potrf:", cm.potrf_params)
    print("trsm: ", cm.trsm_params)
    print("syge: ", cm.syge_params)
    print("asmbl:", cm.asmbl_params)
    return {"records": list(records), "model": cm}


if __name__ == "__main__":
    main()
