"""Planned backend, numeric half: the level-scheduled factor and solve in
torch, through the three hand-written kernels (ops/kernels.py).

Counterpart of `PlannedBackend.make_factor` / `make_solve`
(baspacho_tpu/ops/planned_backend.py:1559, :2383) on the sparse-level
path. Per level, the factor runs K1 (bucket_factor) on each bucket, then
K2 (segmented_subtract) once over the level's block pairs; the solve
runs K3 (bucket_solve) per bucket, level by level, with the L pass's
below updates applied by K2 through a per-level CSR of RHS rows.

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
from .schedule import LumpBucket, PlannedSchedule, SegmentCSR, pair_csr, \
    solve_csr


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


@dataclass
class DevCSR:
    n_tgt: int
    tgt: torch.Tensor
    seg_ptr: torch.Tensor
    src_idx: torch.Tensor


def _i64(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)) \
        .to(device)


def _dev_bucket(lb: LumpBucket, device) -> DevBucket:
    return DevBucket(cp=lb.cp, rp=lb.rp, prod_base=lb.prod_base,
                     off=_i64(lb.off, device), rows=_i64(lb.rows, device),
                     cols=_i64(lb.cols, device),
                     vec_off=_i64(lb.vec_off, device),
                     below_idx=_i64(lb.below_idx, device))


def _dev_csr(csr: SegmentCSR, device) -> DevCSR:
    return DevCSR(n_tgt=len(csr.tgt), tgt=_i64(csr.tgt, device),
                  seg_ptr=_i64(csr.seg_ptr, device),
                  src_idx=_i64(csr.src_idx, device))


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
        for lump_buckets, pairs, ptot in sched:
            csr = _dev_csr(pair_csr(pairs), device) if ptot else None
            levels.append(([_dev_bucket(lb, device) for lb in lump_buckets],
                           csr, ptot))

        def factor(data: torch.Tensor, ops=kernels) -> torch.Tensor:
            ext = data.clone(memory_format=torch.contiguous_format)
            # padding must hold zeros (see block_matrix.py): the JAX
            # package multiplies by the padding mask, here the padded
            # slots are filled by index
            if pad_idx.numel():
                ext.index_fill_(1, pad_idx, 0)
            for buckets, csr, ptot in levels:
                prod = ext.new_empty((ext.shape[0], ptot)) if ptot else None
                for b in buckets:
                    ops.bucket_factor(ext, prod, b.off, b.rows, b.cols,
                                      b.cp, b.rp, b.prod_base)
                if csr is not None and csr.n_tgt:
                    ops.segmented_subtract(ext, prod, csr.tgt, csr.seg_ptr,
                                           csr.src_idx, 1)
            return ext

        return factor

    def make_solve(self, start_lump: int, end_lump: int,
                   device) -> Callable:
        """Full-range solve on a factor from make_factor (it reads the
        stored inverse): L pass over levels in order, Lt pass in
        reverse."""
        if start_lump != 0 or end_lump != self.plan.skel.num_lumps:
            raise NotImplementedError(
                "partial-range solves read no stored inverse; they come "
                "with the partial-ops slice")
        sched = self._solve_schedule(start_lump, end_lump)
        order = self.plan.skel.order
        levels = []
        for buckets in sched:
            row_base, ytot = [], 0
            for lb in buckets:
                row_base.append(ytot)
                ytot += len(lb.off) * lb.rp
            csr = _dev_csr(solve_csr(buckets, row_base, order), device)
            levels.append(([_dev_bucket(lb, device) for lb in buckets],
                           row_base, ytot, csr))

        def solve(data: torch.Tensor, v: torch.Tensor,
                  ops=kernels) -> torch.Tensor:
            vv = v.clone(memory_format=torch.contiguous_format)
            batch, _, nrhs = vv.shape
            for buckets, row_base, ytot, csr in levels:
                y: Optional[torch.Tensor] = \
                    vv.new_empty((batch, ytot, nrhs)) if ytot else None
                for b, base in zip(buckets, row_base):
                    ops.bucket_solve(data, vv, y, base, b.off, b.rows,
                                     b.cols, b.vec_off, b.below_idx, b.cp,
                                     b.rp, False)
                if csr.n_tgt:
                    ops.segmented_subtract(vv, y, csr.tgt, csr.seg_ptr,
                                           csr.src_idx, nrhs)
            for buckets, _, _, _ in reversed(levels):
                for b in buckets:
                    ops.bucket_solve(data, vv, None, 0, b.off, b.rows,
                                     b.cols, b.vec_off, b.below_idx, b.cp,
                                     b.rp, True)
            return vv

        return solve
