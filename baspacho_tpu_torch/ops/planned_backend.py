"""Planned backend, numeric half: the level-scheduled factor and solve in
torch, through the hand-written kernels (ops/kernels.py).

Counterpart of `PlannedBackend.make_factor` / `make_solve`
(baspacho_tpu/ops/planned_backend.py:1559, :2383). Per level, the factor
runs K1 (bucket_factor; K1-wide wide_factor for panels wider than 512)
on each bucket, then the level's update: on a pair level K2
(segmented_subtract) over the block pairs of the products K1 wrote; on a
dense level (ops/schedule.py) K1 writes no product and K4
(dense_update) sums the origins' x x^T straight into the targets. The
solve runs K3 (bucket_solve; K3-wide wide_solve) per bucket, level by
level, with the L pass's below updates applied by K2 through a per-level
CSR of RHS rows, on either kind of level.

Partial ranges (make_factor over [start, end), make_solve_l /
make_solve_lt) run the same level schedule over the range's lumps; a
range's updates and below rows may land on lumps past it. Solves over
the full range read the stored inverse (K3); any other range has none,
or runs on pseudo-factored data, and substitutes on the lower triangle
(K3-rest tri_solve / wide_tri_solve). The block mat-vec (make_add_mv)
runs K5 (add_mv / wide_add_mv) on the range's lumps bucketed by shape,
then one K2 for the rows below them.

Unlike the JAX package, buffers carry no [trash, zero] margins: every
kernel masks its own ragged edges, and the solve skips sentinel rows
instead of reading a zero row. Buffers are updated in place (the factor
works on a copy of its input), which the JAX package, being functional,
cannot do.

Every host array a program needs moves to the device once, when the
program is built; a factor or solve call then does no host-to-device
traffic beyond the launches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from . import kernels
from .ref_backend import make_pseudo_factor
from .schedule import NARROW_MAX, DenseUpdate, LumpBucket, PlannedSchedule, \
    SegmentCSR, pair_csr, solve_csr


@dataclass
class DevBucket:
    """A LumpBucket's descriptors as int64 tensors on the device."""
    cp: int
    rp: int
    prod_base: int
    off: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    vec_off: torch.Tensor
    below_idx: torch.Tensor
    off_h: tuple   # host copies of off and cols (wide panels' views)
    cols_h: tuple

    @property
    def wide(self) -> bool:
        return self.cp > NARROW_MAX


@dataclass
class DevCSR:
    n_tgt: int
    tgt: torch.Tensor
    seg_ptr: torch.Tensor
    src_idx: torch.Tensor
    layout: Optional[kernels.SegLayout]  # K2's grids (on a CUDA device)


def _i64(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)) \
        .to(device)


def _dev_bucket(lb: LumpBucket, device) -> DevBucket:
    return DevBucket(cp=lb.cp, rp=lb.rp, prod_base=lb.prod_base,
                     off=_i64(lb.off, device), rows=_i64(lb.rows, device),
                     cols=_i64(lb.cols, device),
                     vec_off=_i64(lb.vec_off, device),
                     below_idx=_i64(lb.below_idx, device),
                     off_h=tuple(int(o) for o in lb.off),
                     cols_h=tuple(int(c) for c in lb.cols))


class DevDense:
    """A DenseUpdate's arrays as int64 tensors on the device (same
    names), its scalars and its origin groups."""

    def __init__(self, du: DenseUpdate, device):
        for k, v in vars(du).items():
            setattr(self, k, _i64(v, device) if isinstance(v, np.ndarray)
                    else v)


def _dev_csr(csr: SegmentCSR, device) -> DevCSR:
    cuda = torch.device(device).type == "cuda"
    return DevCSR(n_tgt=len(csr.tgt), tgt=_i64(csr.tgt, device),
                  seg_ptr=_i64(csr.seg_ptr, device),
                  src_idx=_i64(csr.src_idx, device),
                  layout=kernels.SegLayout(csr.tgt, csr.seg_ptr, csr.src_idx,
                                           device) if cuda else None)


class PlannedBackend(PlannedSchedule):
    """Builds factor and solve programs for one device. A program is a
    Python callable over batched tensors: factor(data (batch, data_size))
    and solve(data, v (batch, order, nrhs)). `ops` selects the kernels
    (the default) or their plain twins (`kernels.TWINS`, for comparison
    and timing on the card)."""

    def make_factor(self, start_lump: int, end_lump: int,
                    device) -> Callable:
        sched = self._factor_schedule(start_lump, end_lump)
        sk = self.plan.skel
        pad_idx = _i64(np.nonzero(sk.padding_mask() == 0)[0], device)
        levels = []
        for lump_buckets, pairs, ptot, dense in sched:
            csr = _dev_csr(pair_csr(pairs), device) if ptot else None
            dd = DevDense(dense, device) if dense is not None else None
            levels.append(([_dev_bucket(lb, device) for lb in lump_buckets],
                           csr, ptot, dd))

        def factor(data: torch.Tensor, ops=kernels) -> torch.Tensor:
            ext = data.clone(memory_format=torch.contiguous_format)
            # padding must hold zeros (see block_matrix.py): the JAX
            # package multiplies by the padding mask, here the padded
            # slots are filled by index
            if pad_idx.numel():
                ext.index_fill_(1, pad_idx, 0)
            for buckets, csr, ptot, dense in levels:
                prod = ext.new_empty((ext.shape[0], ptot)) if ptot else None
                for b in buckets:
                    if b.wide:
                        ops.wide_factor(ext, b.off, b.rows, b.cols, b.cp,
                                        b.rp, b.off_h, b.cols_h)
                    else:
                        ops.bucket_factor(ext, prod, b.off, b.rows, b.cols,
                                          b.cp, b.rp, b.prod_base)
                if csr is not None and csr.n_tgt:
                    ops.segmented_subtract(ext, prod, csr.tgt, csr.seg_ptr,
                                           csr.src_idx, 1, layout=csr.layout)
                if dense is not None:
                    ops.dense_update(ext, dense)
            return ext

        return factor

    def _solve_levels(self, start_lump: int, end_lump: int, device):
        """Per level of [start_lump, end_lump): its device buckets, their
        offsets into the level's below-product buffer y, y's rows, and
        the K2 CSR that applies y to the RHS rows."""
        order = self.plan.skel.order
        levels = []
        for buckets in self._solve_schedule(start_lump, end_lump):
            row_base, ytot = _row_bases(buckets)
            csr = _dev_csr(solve_csr(buckets, row_base, order), device)
            levels.append(([_dev_bucket(lb, device) for lb in buckets],
                           row_base, ytot, csr))
        return levels

    def _full_range(self, start_lump: int, end_lump: int) -> bool:
        """Stored-inverse solves only apply to the full factor range:
        partial solves also run on pseudo-factored data (Gauss-Seidel
        preconditioner), which carries no stored inverse."""
        return start_lump == 0 and end_lump == self.plan.skel.num_lumps

    @staticmethod
    def _diag_solve(ops, b: DevBucket, use_inv: bool, data, vv, y, y_base,
                    transpose: bool) -> None:
        """One bucket's diagonal solve: K3 / K3-wide on the stored
        inverse, or K3-rest / K3-rest wide by substitution."""
        args = (data, vv, y, y_base, b.off, b.rows, b.cols, b.vec_off,
                b.below_idx, b.cp, b.rp, transpose)
        if use_inv:
            (ops.wide_solve if b.wide else ops.bucket_solve)(*args)
        elif b.wide:
            ops.wide_tri_solve(*args, b.off_h, b.cols_h)
        else:
            ops.tri_solve(*args)

    def _l_pass(self, levels, use_inv, data, vv, ops) -> None:
        batch, _, nrhs = vv.shape
        for buckets, row_base, ytot, csr in levels:
            y: Optional[torch.Tensor] = \
                vv.new_empty((batch, ytot, nrhs)) if ytot else None
            for b, base in zip(buckets, row_base):
                self._diag_solve(ops, b, use_inv, data, vv, y, base, False)
            if csr.n_tgt:
                ops.segmented_subtract(vv, y, csr.tgt, csr.seg_ptr,
                                       csr.src_idx, nrhs, layout=csr.layout)

    def _lt_pass(self, levels, use_inv, data, vv, ops) -> None:
        for buckets, _, _, _ in reversed(levels):
            for b in buckets:
                self._diag_solve(ops, b, use_inv, data, vv, None, 0, True)

    def make_solve(self, start_lump: int, end_lump: int,
                   device) -> Callable:
        """Full-range solve on a factor from make_factor (it reads the
        stored inverse): L pass over levels in order, Lt pass in
        reverse."""
        if not self._full_range(start_lump, end_lump):
            raise NotImplementedError(
                "the fused solve reads the stored inverse of a full-range "
                "factor; partial ranges run make_solve_l / make_solve_lt")
        levels = self._solve_levels(start_lump, end_lump, device)

        def solve(data: torch.Tensor, v: torch.Tensor,
                  ops=kernels) -> torch.Tensor:
            vv = v.clone(memory_format=torch.contiguous_format)
            self._l_pass(levels, True, data, vv, ops)
            self._lt_pass(levels, True, data, vv, ops)
            return vv

        return solve

    def make_solve_l(self, start_lump: int, end_lump: int,
                     device) -> Callable:
        """L pass over the lumps [start_lump, end_lump), level by level
        (make_solve_l, planned_backend.py:2201): the stored inverse on
        the full range, substitution (K3-rest) on any other; below
        updates, also into rows past the range, through K2."""
        levels = self._solve_levels(start_lump, end_lump, device)
        use_inv = self._full_range(start_lump, end_lump)

        def solve_l(data: torch.Tensor, v: torch.Tensor,
                    ops=kernels) -> torch.Tensor:
            vv = v.clone(memory_format=torch.contiguous_format)
            self._l_pass(levels, use_inv, data, vv, ops)
            return vv

        return solve_l

    def make_solve_lt(self, start_lump: int, end_lump: int,
                      device) -> Callable:
        """Lt pass over the lumps [start_lump, end_lump), levels in
        reverse (make_solve_lt, planned_backend.py:2219); below rows are
        read from anywhere in the RHS."""
        levels = self._solve_levels(start_lump, end_lump, device)
        use_inv = self._full_range(start_lump, end_lump)

        def solve_lt(data: torch.Tensor, v: torch.Tensor,
                     ops=kernels) -> torch.Tensor:
            vv = v.clone(memory_format=torch.contiguous_format)
            self._lt_pass(levels, use_inv, data, vv, ops)
            return vv

        return solve_lt

    def make_add_mv(self, start_lump: int, device) -> Callable:
        """out + alpha M x over the lumps >= start_lump (make_add_mv,
        planned_backend.py:3078): the lumps bucketed by shape with no
        level order, K5 / K5-wide on every bucket (own rows in place,
        below rows into y), then one K2 over the range's below rows.
        Returns a new tensor; `out` is not modified."""
        order = self.plan.skel.order
        buckets = self._bucket_lumps(
            np.arange(start_lump, self.plan.skel.num_lumps, dtype=np.int64),
            with_below_idx=True)
        row_base, ytot = _row_bases(buckets)
        csr = _dev_csr(solve_csr(buckets, row_base, order), device)
        dbs = [_dev_bucket(lb, device) for lb in buckets]

        def add_mv(data: torch.Tensor, x: torch.Tensor, out: torch.Tensor,
                   alpha: float, ops=kernels) -> torch.Tensor:
            oo = out.clone(memory_format=torch.contiguous_format)
            batch, _, nrhs = oo.shape
            y = oo.new_empty((batch, ytot, nrhs)) if ytot else None
            for b, base in zip(dbs, row_base):
                (ops.wide_add_mv if b.wide else ops.add_mv)(
                    data, x, oo, y, base, b.off, b.rows, b.cols, b.vec_off,
                    b.below_idx, b.cp, b.rp, alpha)
            if csr.n_tgt:
                ops.segmented_subtract(oo, y, csr.tgt, csr.seg_ptr,
                                       csr.src_idx, nrhs, layout=csr.layout)
            return oo

        return add_mv

    def make_pseudo_factor(self, start_span: int, end_span: int,
                           device) -> Callable:
        """The per-span pseudo-factor: a cold path (Gauss-Seidel set-up)
        in plain torch, shared with the REF backend, as the JAX package
        delegates it (planned_backend.py:3135)."""
        return make_pseudo_factor(self.plan, start_span, end_span, device)


def _row_bases(buckets):
    """Offsets of each bucket's below rows in a level's y buffer, and its
    size."""
    row_base, ytot = [], 0
    for lb in buckets:
        row_base.append(ytot)
        ytot += len(lb.off) * lb.rp
    return row_base, ytot
