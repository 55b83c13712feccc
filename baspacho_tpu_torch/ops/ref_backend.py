"""Reference numeric backend in plain torch: one op per lump and board.

Port of baspacho_tpu/ops/ref_backend.py (`UnrolledBackend`, the analog
of the reference's BackendRef, MatOpsRef.cpp): every panel offset of the
symbolic plan is a Python int, and the factor, solves and mat-vec loop
over lumps in order. Panels are strided views of the flat buffer (the
REF skeleton is unpadded, the row stride is the lump width), block
updates are matrix products, and assembly is `index_add_` with the
plan's precomputed indices (deterministic). The programs take and
return batched tensors: data (batch, data_size), vectors (batch, order,
nrhs); they run on any device, with no hand-written kernel.

`make_pseudo_factor` is shared with the planned backend (which delegates
to it, as the JAX package does), batched by span size instead of the
JAX package's loop over spans.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .plan import NumericPlan, ensure_boards


def _view(data, offset: int, rows: int, stride: int, cols: int):
    """(batch, rows, cols) view of the block at a flat offset with the
    given row stride."""
    return data.as_strided((data.shape[0], rows, cols),
                           (data.stride(0), stride, 1),
                           data.storage_offset() + offset)


def _sym(a):
    """The symmetric matrix whose lower triangle `a` holds."""
    return torch.tril(a) + torch.tril(a, -1).mT


def _chol(a):
    """Cholesky from the lower triangle; NaN where it fails (as
    jax.lax.linalg.cholesky), so check_factor sees the failure."""
    L, info = torch.linalg.cholesky_ex(_sym(a))
    return torch.where((info > 0)[..., None, None], torch.nan, L)


def _with_trash(data):
    """A copy of `data` (batch, data_size) with one zero slot appended."""
    return torch.cat([data, data.new_zeros((data.shape[0], 1))], 1)


def _i64(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)) \
        .to(device)


class UnrolledBackend:
    """Builds numeric programs from a NumericPlan by looping over its
    lumps."""

    def __init__(self, plan: NumericPlan):
        ensure_boards(plan)
        self.plan = plan

    # -- factor ---------------------------------------------------------
    def _factor_ext(self, start_lump: int, end_lump: int,
                    device) -> Callable:
        """The factor loop in place on `ext`, the data (batch, data_size)
        with one trash slot appended, which takes the scatters of upper
        block pairs."""
        plan = self.plan
        num_lumps = plan.skel.num_lumps
        lumps = plan.lumps
        boards = {l: [(b, _i64(b.scatter_idx.reshape(-1), device))
                      for b in lumps[l].boards
                      if start_lump <= b.origin_lump < end_lump]
                  for l in range(start_lump, num_lumps)}

        def factor_ext(ext: torch.Tensor) -> None:
            for l in range(start_lump, num_lumps):
                ld = lumps[l]
                for b, idx in boards[l]:
                    panel = _view(ext, b.src_offset, b.full_rows,
                                  b.src_stride, b.width)
                    prod = panel @ panel[:, :b.sub_rows].mT
                    ext.index_add_(1, idx, prod.reshape(ext.shape[0], -1),
                                   alpha=-1)
                if l < end_lump:
                    diag = _view(ext, ld.col_offset, ld.size, ld.stride,
                                 ld.size)
                    L = _chol(diag)
                    diag.copy_(L)
                    if ld.below > 0:
                        below = _view(ext, ld.below_offset, ld.below,
                                      ld.stride, ld.size)
                        below.copy_(torch.linalg.solve_triangular(
                            L.mT, below, upper=True, left=False))

        return factor_ext

    def make_factor(self, start_lump: int, end_lump: int,
                    device) -> Callable:
        loop = self._factor_ext(start_lump, end_lump, device)

        def factor(data: torch.Tensor) -> torch.Tensor:
            ext = _with_trash(data)
            loop(ext)
            return ext[:, :-1].contiguous()

        return factor

    def make_factor_body(self, start_lump: int, end_lump: int,
                         device) -> Callable:
        """The factor in place on a contiguous (batch, data_size) buffer:
        make_factor's loop on a copy with the trash slot, copied back (a
        chain, ops/chain.py, runs it again and again on one buffer)."""
        loop = self._factor_ext(start_lump, end_lump, device)

        def factor_body(data: torch.Tensor) -> None:
            ext = _with_trash(data)
            loop(ext)
            data.copy_(ext[:, :-1])

        return factor_body

    # -- solves ---------------------------------------------------------
    def _below_idx(self, start: int, end: int, device):
        return {l: _i64(self.plan.lumps[l].below_row_idx, device)
                for l in range(start, end) if self.plan.lumps[l].below > 0}

    def make_solve_l_body(self, start_lump: int, end_lump: int,
                          device) -> Callable:
        """The L pass in place on a contiguous (batch, order, nrhs) RHS;
        make_solve_l runs it on a copy."""
        lumps = self.plan.lumps
        bidx = self._below_idx(start_lump, end_lump, device)

        def solve_l_body(data: torch.Tensor, vv: torch.Tensor) -> None:
            for l in range(start_lump, end_lump):
                ld = lumps[l]
                L = torch.tril(_view(data, ld.col_offset, ld.size,
                                     ld.stride, ld.size))
                sl = slice(ld.vec_offset, ld.vec_offset + ld.size)
                x = torch.linalg.solve_triangular(L, vv[:, sl], upper=False)
                vv[:, sl] = x
                if ld.below > 0:
                    below = _view(data, ld.below_offset, ld.below,
                                  ld.stride, ld.size)
                    vv.index_add_(1, bidx[l], below @ x, alpha=-1)

        return solve_l_body

    def make_solve_l(self, start_lump: int, end_lump: int,
                     device) -> Callable:
        body = self.make_solve_l_body(start_lump, end_lump, device)

        def solve_l(data: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
            vv = v.clone(memory_format=torch.contiguous_format)
            body(data, vv)
            return vv

        return solve_l

    def make_solve_lt(self, start_lump: int, end_lump: int,
                      device) -> Callable:
        lumps = self.plan.lumps
        bidx = self._below_idx(start_lump, end_lump, device)

        def solve_lt(data: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
            vv = v.clone(memory_format=torch.contiguous_format)
            for l in range(end_lump - 1, start_lump - 1, -1):
                ld = lumps[l]
                L = torch.tril(_view(data, ld.col_offset, ld.size,
                                     ld.stride, ld.size))
                sl = slice(ld.vec_offset, ld.vec_offset + ld.size)
                x = vv[:, sl]
                if ld.below > 0:
                    below = _view(data, ld.below_offset, ld.below,
                                  ld.stride, ld.size)
                    x = x - below.mT @ vv[:, bidx[l]]
                vv[:, sl] = torch.linalg.solve_triangular(L.mT, x,
                                                          upper=True)
            return vv

        return solve_lt

    # -- symmetric block mat-vec (bottom-right corner) ------------------
    def make_add_mv(self, start_lump: int, device) -> Callable:
        lumps = self.plan.lumps
        num_lumps = self.plan.skel.num_lumps
        bidx = self._below_idx(start_lump, num_lumps, device)

        def add_mv(data, x, out, alpha: float) -> torch.Tensor:
            oo = out.clone(memory_format=torch.contiguous_format)
            for l in range(start_lump, num_lumps):
                ld = lumps[l]
                sym = _sym(_view(data, ld.col_offset, ld.size, ld.stride,
                                 ld.size))
                sl = slice(ld.vec_offset, ld.vec_offset + ld.size)
                xl = x[:, sl]
                contrib = alpha * (sym @ xl)
                if ld.below > 0:
                    below = _view(data, ld.below_offset, ld.below,
                                  ld.stride, ld.size)
                    oo.index_add_(1, bidx[l], below @ xl, alpha=alpha)
                    contrib = contrib + alpha * (below.mT @ x[:, bidx[l]])
                oo[:, sl] += contrib
            return oo

        return add_mv

    def make_pseudo_factor(self, start_span: int, end_span: int,
                           device) -> Callable:
        return make_pseudo_factor(self.plan, start_span, end_span, device)


def make_pseudo_factor(plan: NumericPlan, start_span: int, end_span: int,
                       device) -> Callable:
    """Per span s in [start_span, end_span): L_s = chol(diag block of s)
    written over the block (zeros above its diagonal, as the JAX
    package writes it), and every row of the span's columns below the
    block, in its lump's diagonal block (below1) and below panel
    (below2), multiplied by L_s^-T. The spans are independent, so the
    program gathers all spans of one size into one batch: one batched
    Cholesky, one batched triangular inverse and one product over all
    their rows, where the JAX package loops over the spans (a corner of
    1,000 spans would cost thousands of launches)."""
    sk = plan.skel
    s = np.arange(start_span, end_span, dtype=np.int64)
    size = (sk.span_start[1:] - sk.span_start[:-1])[s]
    lump_size = sk.lump_start[1:] - sk.lump_start[:-1]
    sl = sk.span_to_lump[s]
    stride = sk.col_stride[sl]
    base = sk.panel_base[sl]
    off_in = sk.span_offset_in_lump[s]
    diag_off = base + off_in * (1 + stride)
    b1_rows = lump_size[sl] - off_in - size
    b1_off = base + (off_in + size) * stride + off_in
    b2_rows = sk.below_rows[sl]
    b2_off = base + stride * stride + off_in

    groups = []
    for n in np.unique(size):
        g = np.nonzero(size == n)[0]
        ar = np.arange(n, dtype=np.int64)
        didx = diag_off[g, None, None] + ar[:, None] * stride[g, None, None] \
            + ar
        # first element of every row below a span, span by span
        cnt = np.stack([b1_rows[g], b2_rows[g]], 1).reshape(-1)
        first = np.stack([b1_off[g], b2_off[g]], 1).reshape(-1)
        step = np.repeat(stride[g], 2)
        tot = int(cnt.sum())
        within = np.arange(tot, dtype=np.int64) - \
            np.repeat(np.cumsum(cnt) - cnt, cnt)
        row0 = np.repeat(first, cnt) + within * np.repeat(step, cnt)
        rspan = np.repeat(np.repeat(np.arange(len(g)), 2), cnt)
        groups.append((int(n), _i64(didx.reshape(-1), device),
                       _i64(row0[:, None] + ar, device), _i64(rspan, device),
                       len(g)))

    def pseudo_factor(data: torch.Tensor) -> torch.Tensor:
        out = data.clone(memory_format=torch.contiguous_format)
        batch = data.shape[0]
        for n, didx, ridx, rspan, S in groups:
            L = _chol(data[:, didx].view(batch, S, n, n))
            out[:, didx] = L.reshape(batch, -1)
            if ridx.shape[0]:
                eye = torch.eye(n, dtype=data.dtype, device=data.device)
                linv = torch.linalg.solve_triangular(L, eye.expand_as(L),
                                                     upper=False)
                rows = data[:, ridx]  # (batch, R, n)
                # x = row . L^-T, per row with its span's inverse
                x = torch.einsum("zrk,zrjk->zrj", rows, linv[:, rspan])
                out[:, ridx] = x
        return out

    return pseudo_factor
