"""Preconditioners for PCG on the (partially factored) bottom-right corner.

Port of baspacho_tpu/optimizer/preconditioner.py (the reference's
Preconditioner.h:15-206): Jacobi gathers the corner's span diagonal
blocks into same-size batches and runs one batched Cholesky and
triangular solve per size; Gauss-Seidel reuses the solver's
pseudo-factor and partial solves; the lower-precision preconditioner
factors the corner in float32 (escalating damping until finite) and
solves in float32 for a float64 outer solve.

All follow one protocol:
  init(mat_data)  -> precomputes from the matrix's numeric data
  apply(v)        -> M^-1 v (identity outside the corner)
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..accessor import CoalescedAccessor


class IdentityPrecond:
    def __init__(self, solver, span_index: int):
        pass

    def init(self, data):
        pass

    def apply(self, v):
        return v


class BlockJacobiPrecond:
    """Per-span diagonal block inverse via batched Cholesky."""

    def __init__(self, solver, span_index: int):
        self.solver = solver
        sk = solver.skel
        span_size = sk.span_start[1:] - sk.span_start[:-1]
        buckets: Dict[int, List[int]] = {}
        for s in range(span_index, sk.num_spans):
            buckets.setdefault(int(span_size[s]), []).append(s)
        acc = CoalescedAccessor(sk)
        dev = solver.device
        self.buckets = []
        for size, spans in sorted(buckets.items()):
            offs, strides = acc.diag_block_offset(np.array(spans))
            offs = np.atleast_1d(offs)
            strides = np.atleast_1d(strides)
            ar = np.arange(size)
            gidx = offs[:, None, None] + ar[None, :, None] * \
                strides[:, None, None] + ar[None, None, :]
            vec = sk.span_start[np.array(spans)][:, None] + ar[None, :]
            self.buckets.append((size, torch.from_numpy(gidx).to(dev),
                                 torch.from_numpy(vec).to(dev)))
        self._ls = None

    def init(self, data):
        data = self.solver._as_tensor(data)
        ls = []
        for size, gidx, vec in self.buckets:
            blocks = data[gidx]
            blocks = torch.tril(blocks) + torch.tril(blocks, -1).mT
            ls.append(torch.linalg.cholesky(blocks))
        self._ls = ls

    def apply(self, v):
        v = self.solver._as_tensor(v)
        vec1d = v.ndim == 1
        if vec1d:
            v = v[:, None]
        out = v.clone()
        for (size, gidx, vec), L in zip(self.buckets, self._ls):
            x = torch.linalg.solve_triangular(L, v[vec], upper=False)
            out[vec] = torch.linalg.solve_triangular(L.mT, x, upper=True)
        return out[:, 0] if vec1d else out


class BlockGaussSeidelPrecond:
    """Pseudo-factor of the corner (per-span diagonal Cholesky + column
    normalization) used as a forward/backward Gauss-Seidel sweep."""

    def __init__(self, solver, span_index: int):
        self.solver = solver
        self.span_index = span_index
        self._pseudo = None

    def init(self, data):
        self._pseudo = self.solver.pseudo_factor_from(data, self.span_index)

    def apply(self, v):
        s = self.span_index
        v = self.solver.solve_l_from(self._pseudo, s, v)
        return self.solver.solve_lt_from(self._pseudo, s, v)


class LowerPrecSolvePrecond:
    """Factor the corner in float32 (escalating damping until finite) and
    use float32 solves as the preconditioner of a float64 outer solve."""

    def __init__(self, solver, span_index: int, max_tries: int = 12):
        self.solver = solver
        self.span_index = span_index
        self.max_tries = max_tries
        self._factor = None

    def init(self, data):
        data32 = self.solver._as_tensor(data).to(torch.float32)
        damp_idx = torch.from_numpy(self.solver.skel.damp_indices()) \
            .to(data32.device)
        beta = 0.0
        for i in range(self.max_tries):
            trial = data32
            if beta != 0.0:
                trial = data32.clone()
                trial[..., damp_idx] *= 1.0 + beta
            f = self.solver.factor_from(trial, self.span_index)
            if bool(torch.isfinite(f).all()):
                self._factor = f
                return
            beta = 1e-4 * (4.0 ** i)
        raise RuntimeError("LowerPrecSolvePrecond: factorization stayed "
                           "non-finite under escalating damping")

    def apply(self, v):
        v = self.solver._as_tensor(v)
        s = self.span_index
        v32 = self.solver.solve_l_from(self._factor, s, v.to(torch.float32))
        v32 = self.solver.solve_lt_from(self._factor, s, v32)
        return v32.to(v.dtype)
