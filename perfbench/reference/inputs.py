"""The benchmark's inputs: the values of a configuration's blocks and the
right-hand sides, made on the device from the seed.

Every block of the pattern gets values in [-1, 1); each diagonal block is
symmetric, and each diagonal scalar is the sum of the absolute values of
the rest of its row plus 1 + u, u in [0, 1): the matrix is strictly
diagonally dominant with a positive diagonal, so it is SPD with every
eigenvalue at least 1, and stays so under LM damping. Blocks are kept in
the user's parameter numbering, one tensor per (rows, cols) size class,
so the program and the reference are handed the same numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .pattern import Pattern


@dataclass
class Blocks:
    """Blocks of one size class: (row, col) parameters and their values
    (batch, n, sr, sc). Diagonal classes have rows == cols."""
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor


@dataclass
class Inputs:
    diag: List[Blocks]
    off: List[Blocks]
    rhs: torch.Tensor       # (batch, order, 1), user numbering
    offsets: torch.Tensor   # first scalar of each parameter

    @property
    def batch(self) -> int:
        return self.rhs.shape[0]


def scalar_index(offsets: torch.Tensor, params: torch.Tensor,
                 size: int) -> torch.Tensor:
    """(n, size) scalar rows of parameters of `size` scalars each."""
    return offsets[params][:, None] + torch.arange(size,
                                                   device=offsets.device)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make_inputs(pat: Pattern, batch: int, seed: int, device) -> Inputs:
    """The values of `pat` for `batch` systems, and a right-hand side for
    each, in float64 from `seed`: a handful of large draws on `device`."""
    g = generator(seed, device)
    dev = torch.device(device)
    offsets = torch.as_tensor(pat.offsets, device=dev)
    sizes = pat.sizes
    order = pat.order

    def uniform(*shape):
        return torch.rand(shape, generator=g, device=dev,
                          dtype=torch.float64) * 2 - 1

    rowabs = torch.zeros(batch, order, device=dev, dtype=torch.float64)
    r_all, c_all = pat.off_diagonal()
    off = []
    for sr, sc in sorted(set(zip(sizes[r_all].tolist(),
                                 sizes[c_all].tolist()))):
        sel = (sizes[r_all] == sr) & (sizes[c_all] == sc)
        rows = torch.as_tensor(r_all[sel], device=dev)
        cols = torch.as_tensor(c_all[sel], device=dev)
        vals = uniform(batch, len(rows), sr, sc)
        a = vals.abs()
        rowabs.index_add_(1, scalar_index(offsets, rows, sr).reshape(-1),
                          a.sum(3).reshape(batch, -1))
        rowabs.index_add_(1, scalar_index(offsets, cols, sc).reshape(-1),
                          a.sum(2).reshape(batch, -1))
        off.append(Blocks(rows, cols, vals))
    diag = []
    for s in sorted(set(sizes.tolist())):
        params = torch.as_tensor(np.nonzero(sizes == s)[0], device=dev)
        r = uniform(batch, len(params), s, s)
        sym = (r + r.transpose(2, 3)) / 2
        sym.diagonal(dim1=2, dim2=3).zero_()
        idx = scalar_index(offsets, params, s).reshape(-1)
        rowabs.index_add_(1, idx, sym.abs().sum(3).reshape(batch, -1))
        diag.append(Blocks(params, params, sym))
    dominance = rowabs + 1 + torch.rand(batch, order, generator=g,
                                        device=dev, dtype=torch.float64)
    for b in diag:
        s = b.vals.shape[-1]
        idx = scalar_index(offsets, b.rows, s)
        b.vals.diagonal(dim1=2, dim2=3).copy_(dominance[:, idx])
    rhs = uniform(batch, order, 1)
    return Inputs(diag, off, rhs, offsets)


def lambdas(seed: int, count: int, log10_range) -> List[float]:
    """The LM damping of each step, cycled: log-uniform over
    10**log10_range, from the seed."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    lo, hi = log10_range
    return (10.0 ** rng.uniform(lo, hi, size=count)).tolist()
