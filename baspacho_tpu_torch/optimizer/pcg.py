"""Preconditioned conjugate gradient.

Port of baspacho_tpu/optimizer/pcg.py (the reference's PCG.cpp:13-101):
the same updates and stopping rule, as a Python loop. The stopping test
reads the residual norm back to the host once per iteration (one device
synchronisation each), where the JAX package keeps the loop on the
device in a `lax.while_loop`.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def pcg(apply_inv_m: Callable, apply_a: Callable, b: torch.Tensor,
        tol: float, max_iters: int
        ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Solve A x = b. Returns (x, final_r_norm2, num_iters)."""
    x = torch.zeros_like(b)
    r = b.clone()
    z = apply_inv_m(r)
    p = z
    rz = _dot(r, z)
    target = float(tol * tol * _dot(b, b))
    it = 0
    while it < max_iters and float(_dot(r, r)) > target:
        ap = apply_a(p)
        alpha = rz / _dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = apply_inv_m(r)
        rz_new = _dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    return x, _dot(r, r), it
