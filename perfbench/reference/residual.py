"""The plain reference: the damped system rebuilt from the benchmark's
inputs, and the residual of a solution against it.

For the LM damping lambda, the damped matrix is the input with each
diagonal scalar d replaced by d * (1 + lambda) + lambda (the port's
additive LM damping). The reference multiplies it into a solution block
by block in plain PyTorch, in float64 whatever the solution's type, and
returns each system's relative residual |A x - b|_2 / |b|_2. Nothing of
the program is read but the solution it is judging.
"""

from __future__ import annotations

import torch

from .inputs import Inputs, scalar_index


def damped_matvec(inp: Inputs, lam: float, x: torch.Tensor) -> torch.Tensor:
    """A_lambda x for x (batch, order, nrhs) in the user numbering,
    float64."""
    x = x.to(torch.float64)
    y = torch.zeros_like(x)
    for b in inp.diag:
        s = b.vals.shape[-1]
        idx = scalar_index(inp.offsets, b.rows, s)
        d = b.vals.to(torch.float64).clone()
        dd = d.diagonal(dim1=2, dim2=3)
        dd.copy_(dd * (1 + lam) + lam)
        y.index_add_(1, idx.reshape(-1), _rows(
            torch.einsum("bnij,bnjk->bnik", d, x[:, idx])))
    for b in inp.off:
        sr, sc = b.vals.shape[-2:]
        ri = scalar_index(inp.offsets, b.rows, sr)
        ci = scalar_index(inp.offsets, b.cols, sc)
        v = b.vals.to(torch.float64)
        y.index_add_(1, ri.reshape(-1), _rows(
            torch.einsum("bnij,bnjk->bnik", v, x[:, ci])))
        y.index_add_(1, ci.reshape(-1), _rows(
            torch.einsum("bnij,bnik->bnjk", v, x[:, ri])))
    return y


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(batch, n, s, k) -> (batch, n * s, k)."""
    return t.reshape(t.shape[0], -1, t.shape[-1])


def relative_residuals(inp: Inputs, lam: float,
                       x: torch.Tensor) -> torch.Tensor:
    """|A_lambda x - b|_2 / |b|_2 of each system and column (batch,
    nrhs), float64; NaN or inf where x is not finite."""
    b = inp.rhs.to(torch.float64)
    r = damped_matvec(inp, lam, x) - b
    return torch.linalg.vector_norm(r, dim=1) / \
        torch.linalg.vector_norm(b, dim=1)
