"""Differentiable sparse solve: gradients through H x = b (the JAX
package's examples/diff_solve.py).

The reference library is the GPU solver behind Theseus, whose core idea
is differentiable optimization layers: the solution of the block-sparse
normal equations is differentiated with respect to the matrix data and
the right-hand side by the implicit function theorem instead of
unrolling the factorization. `Solver.make_differentiable_solve`
packages exactly that as a torch.autograd.Function:

    x = H^{-1} b,   bar_b = H^{-1} g,   bar_H = -sym(bar_b x^T)|_blocks

Here: fit spring-chain stiffnesses so the equilibrium matches a target,
an outer loss minimized by Adam THROUGH the sparse solve.

    python -m baspacho_tpu_torch.examples.diff_solve [--device cpu]
        [--steps 2400]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from baspacho_tpu_torch import Settings, create_solver
from baspacho_tpu_torch.sparse_structure import SparseStructure
from baspacho_tpu_torch.utils import cum_sum_vec


def setup(n: int, device):
    """The chain's solver, its differentiable solve and hdata_of(log_k):
    the chain-spring Hessian data from per-spring log-stiffness."""
    # chain structure: tridiagonal blocks of size 1
    rows = [[i] if i == 0 else [i - 1, i] for i in range(n)]
    ss = SparseStructure(cum_sum_vec([len(r) for r in rows]),
                         np.concatenate(rows))
    solver = create_solver(Settings(), np.ones(n, dtype=np.int64), ss,
                           device=device)
    acc = solver.accessor()
    diag_off = torch.tensor([acc.diag_block_offset(i)[0] for i in range(n)],
                            device=solver.device)
    off_off = torch.tensor([acc.block_offset(i, i - 1)[0]
                            for i in range(1, n)], device=solver.device)

    def hdata_of(log_k):
        k = torch.exp(log_k)                     # (n-1,) spring stiffness
        h = torch.zeros(solver.data_size, dtype=log_k.dtype,
                        device=log_k.device)
        h = h.index_add(0, diag_off[:1], k[:1] + 1.0)  # anchor at x_0
        h = h.index_add(0, diag_off[1:-1], k[:-1] + k[1:])
        h = h.index_add(0, diag_off[-1:], k[-1:])
        return h.index_add(0, off_off, -k)

    return solver, solver.make_differentiable_solve(), hdata_of


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--steps", type=int, default=2400)
    args = ap.parse_args(argv)
    n = 16
    solver, fsolve, hdata_of = setup(n, args.device)
    dev = solver.device
    b = torch.ones(n, dtype=torch.float64, device=dev)

    # recover hidden spring stiffnesses from the observed equilibrium
    rng = np.random.RandomState(0)
    log_k_true = torch.from_numpy(rng.randn(n - 1) * 0.5).to(dev)
    target = fsolve(hdata_of(log_k_true), b).detach()

    def loss(log_k):
        x = fsolve(hdata_of(log_k), b)
        return torch.sum((x - target) ** 2)

    log_k = torch.zeros(n - 1, dtype=torch.float64, device=dev,
                        requires_grad=True)
    adam = torch.optim.Adam([log_k], lr=0.05)
    losses = []
    for step in range(args.steps):
        adam.zero_grad()
        v = loss(log_k)
        v.backward()
        v = v.detach()
        adam.step()
        losses.append(v.item())
        if (step + 1) % 400 == 0:
            print(f"iter {step + 1}: loss {losses[-1]:.6e}")
    final = loss(log_k).item()
    print(f"final loss: {final:.6e}")
    x = fsolve(hdata_of(log_k.detach()), b)
    print("equilibrium vs target max err:",
          float(torch.max(torch.abs(x - target))))
    return {"losses": losses, "final_loss": final,
            "log_k": log_k.detach()}


if __name__ == "__main__":
    main()
