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

A level on the device is one record per pass, a FactorLevel or a
SolveLevel; every factor program runs one walk over them (_factor_walk),
every solve program the L walk (_l_pass) and the Lt walk (_lt_pass).

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
cannot do; make_factor_body / make_solve_body are the in-place programs
themselves, which a chain (ops/chain.py) runs again and again on one
buffer. make_factor / make_solve copy inside the span factor.input /
solve.input (trace.py), and run their levels through the facade's
GraphSlot where it hands one (ops/chain.py: replayed as a CUDA graph,
captured or eager).

One factor or solve can be split over the ranks of a torch.distributed
process group (make_factor_sharded / make_solve_sharded, the JAX
package's shard_map programs): every rank runs K1-K4 on its share of
each level's large buckets (ops/schedule.py factor_share /
solve_share), and per level one all-gather shares the factored panels,
or one all-reduce sums a dense level's update or a solve level's RHS
changes: the walks add them where a level's record has its `share`
set (a level with nothing to split has none). The collectives run on
the tensors' own device through the group given; nothing is copied to
the host by this module, and a failed collective raises.

Every host array a program needs moves to the device once, when the
program is built; a factor or solve call then does no host-to-device
traffic beyond the launches.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import trace
from . import kernels
from .ref_backend import make_pseudo_factor
from .schedule import NARROW_MAX, DenseUpdate, LumpBucket, PlannedSchedule, \
    SegmentCSR, factor_share, pair_csr, solve_csr, solve_share


# the factor's copy of its input outside a GraphSlot
_UNPOOLED = nullcontext()


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
    with trace.span("programs.upload"):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)) \
            .to(device)


def _dev_bucket(lb: LumpBucket, device) -> DevBucket:
    with trace.span("programs.upload"):
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


class DevShare:
    """A FactorShare's or SolveShare's index arrays as int64 tensors on
    the device (same names), its scalars as they are, and `n`, the ranks
    it is shared over. Its buckets and dense update go to the level's
    record instead."""

    def __init__(self, share, n: int, device):
        self.n = n
        for k, v in vars(share).items():
            if k not in ("buckets", "dense"):
                setattr(self, k, _i64(v, device)
                        if isinstance(v, np.ndarray) else v)


def _dev_csr(csr: SegmentCSR, device) -> DevCSR:
    cuda = torch.device(device).type == "cuda"
    return DevCSR(n_tgt=len(csr.tgt), tgt=_i64(csr.tgt, device),
                  seg_ptr=_i64(csr.seg_ptr, device),
                  src_idx=_i64(csr.src_idx, device),
                  layout=kernels.SegLayout(csr.tgt, csr.seg_ptr, csr.src_idx,
                                           device) if cuda else None)


@dataclass(slots=True)
class FactorLevel:
    """One level of a factor on the device: K1 / K1-wide on `buckets`,
    then K2 over `csr` (its `pairs` block pairs, `elements` elements,
    from a product buffer of `ptot`) or, on a dense level, K4's `dense`.
    With `share` (a sharded level with a split bucket) the buckets are
    the rank's, and where `share.targets` is set `dense` holds the
    rank's origins (None without any)."""
    buckets: List[DevBucket]
    csr: Optional[DevCSR]
    ptot: int
    dense: Optional[DevDense]
    share: Optional[DevShare]
    pairs: int
    elements: int


@dataclass(slots=True)
class SolveLevel:
    """One level of a solve on the device: its `buckets`, their offsets
    in the below-product buffer y (`row_base`), y's rows (`ytot`), the K2
    CSR that applies y to the RHS rows, and per bucket whether its lumps
    all lie in the sparse-elimination range (`elim`, for stats.py). With
    `share` (a sharded level with a split bucket) the buckets are the
    rank's."""
    buckets: List[DevBucket]
    row_base: List[int]
    ytot: int
    csr: DevCSR
    share: Optional[DevShare]
    elim: Tuple[bool, ...]


class PlannedBackend(PlannedSchedule):
    """Builds factor and solve programs for one device. A program is a
    Python callable over batched tensors: factor(data (batch, data_size))
    and solve(data, v (batch, order, nrhs)). `ops` selects the kernels
    (the default), their plain twins (`kernels.TWINS`, for comparison
    and timing on the card) or the timed wrappers (`kernels.timed`,
    which the facade hands while tracing is on)."""

    def __init__(self, plan, assembly: Optional[str] = None):
        super().__init__(plan, assembly)
        # device arrays per key (levels of a range, the padding's index):
        # the programs of a range and its profile (stats.py) share them
        self._device_cache = {}

    def _factor_levels(self, start_lump: int, end_lump: int, device,
                       share: Optional[Tuple[int, int]] = None
                       ) -> List[FactorLevel]:
        """The FactorLevels of [start_lump, end_lump): the whole levels,
        or with `share` = (n, r) as rank r of n runs them (ops/schedule.py
        factor_share)."""
        key = ("factor", start_lump, end_lump, share, torch.device(device))
        levels = self._device_cache.get(key)
        if levels is None:
            levels = [self._factor_level(level, share, device) for level in
                      self._factor_schedule(start_lump, end_lump)]
            self._device_cache[key] = levels
        return levels

    def _factor_level(self, level, share, device) -> FactorLevel:
        """The FactorLevel of one level of the host schedule."""
        lump_buckets, pairs, ptot, dense = level
        sh = None
        if share is not None:
            sh = factor_share(self, level, *share)
            lump_buckets, dense = sh.buckets, sh.dense
        csr = pair_csr(pairs) if ptot else None
        return FactorLevel(
            csr=_dev_csr(csr, device) if ptot else None, ptot=ptot,
            dense=DevDense(dense, device) if dense is not None else None,
            buckets=[_dev_bucket(lb, device) for lb in lump_buckets],
            share=DevShare(sh, share[0], device)
            if sh is not None and sh.pack_len else None,
            pairs=len(pairs.rs) if ptot else 0,
            elements=len(csr.src_idx) if ptot else 0)

    def _pad_idx(self, device) -> torch.Tensor:
        """The data buffer's padded slots (block_matrix.py), on the
        device."""
        key = ("padding", torch.device(device))
        pad_idx = self._device_cache.get(key)
        if pad_idx is None:
            with trace.span("programs.schedule"):
                pad = np.nonzero(self.plan.skel.padding_mask() == 0)[0]
            pad_idx = _i64(pad, device)
            self._device_cache[key] = pad_idx
        return pad_idx

    @staticmethod
    def _level_prod(ext: torch.Tensor,
                    level: FactorLevel) -> Optional[torch.Tensor]:
        """The product buffer of a pair level (None on a dense level)."""
        ptot = level.ptot
        return ext.new_empty((ext.shape[0], ptot)) if ptot else None

    @staticmethod
    def _factor_buckets(ext, prod, level: FactorLevel, ops) -> None:
        """K1 / K1-wide on every bucket of the level."""
        for b in level.buckets:
            if b.wide:
                ops.wide_factor(ext, b.off, b.rows, b.cols, b.cp, b.rp,
                                b.off_h, b.cols_h)
            else:
                ops.bucket_factor(ext, prod, b.off, b.rows, b.cols, b.cp,
                                  b.rp, b.prod_base)

    @staticmethod
    def _level_update(ext, prod, level: FactorLevel, ops) -> None:
        """The level's update: K2 over its block pairs, or K4."""
        csr, dense = level.csr, level.dense
        if csr is not None and csr.n_tgt:
            ops.segmented_subtract(ext, prod, csr.tgt, csr.seg_ptr,
                                   csr.src_idx, 1, layout=csr.layout)
        if dense is not None:
            ops.dense_update(ext, dense)

    def _factor_walk(self, levels: List[FactorLevel], ext: torch.Tensor,
                     ops, group=None) -> None:
        """The factor's levels in place on a buffer whose padded slots
        hold zeros: per level K1 on its buckets, then its update. A level
        with a share gathers the ranks' factored panels after its buckets
        and, where its share has targets, sums its dense update over the
        ranks of `group` in place of it."""
        for level in levels:
            prod = self._level_prod(ext, level)
            self._factor_buckets(ext, prod, level, ops)
            sh = level.share
            if sh is not None:
                _share_panels(ext, prod, sh, group)
            if sh is None or sh.targets is None:
                self._level_update(ext, prod, level, ops)
            else:
                _sum_dense(ext, level.dense, sh.targets, group, ops)

    def make_factor_body(self, start_lump: int, end_lump: int, device,
                         group=None) -> Callable:
        """The factor of [start_lump, end_lump) in place on a contiguous
        (batch, data_size) buffer: its padded slots zeroed by index, as
        factor_input zeroes its copy's, then the levels (with `group`,
        as this rank of it runs them). make_factor runs the same levels
        on factor_input's copy of its input; a chain (ops/chain.py) runs
        this body again and again on one buffer."""
        levels = self._factor_levels(start_lump, end_lump, device,
                                     _share_of(group))
        pad_idx = self._pad_idx(device)

        def factor_body(ext: torch.Tensor, ops=kernels) -> None:
            zero_padding(ext, pad_idx)
            self._factor_walk(levels, ext, ops, group)

        return factor_body

    def make_factor(self, start_lump: int, end_lump: int,
                    device) -> Callable:
        """The factor on a copy of its input, made inside the span
        factor.input (trace.py). With a `slot` (ops/chain.py GraphSlot)
        the copy comes from its solver's memory pool and the levels run
        through the slot: replayed, captured or eager."""
        levels = self._factor_levels(start_lump, end_lump, device)
        pad_idx = self._pad_idx(device)

        def walk(ext: torch.Tensor, ops) -> None:
            self._factor_walk(levels, ext, ops)

        def factor(data: torch.Tensor, ops=kernels,
                   slot=None) -> torch.Tensor:
            with trace.span("factor.input"), \
                    _UNPOOLED if slot is None else slot.allocating(device):
                ext = factor_input(data, pad_idx)
            if slot is None:
                walk(ext, ops)
            else:
                slot.run("factor.graph", walk, (ext,), ops)
            return ext

        return factor

    def _solve_levels(self, start_lump: int, end_lump: int, device,
                      share: Optional[Tuple[int, int]] = None
                      ) -> List[SolveLevel]:
        """The SolveLevels of [start_lump, end_lump): the whole levels,
        or with `share` = (n, r) as rank r of n runs them (ops/schedule.py
        solve_share)."""
        key = ("solve", start_lump, end_lump, share, torch.device(device))
        levels = self._device_cache.get(key)
        if levels is None:
            ranges = self.plan.sparse_elim_ranges
            elim_end = int(self.plan.skel.span_to_lump[ranges[-1]]) \
                if ranges else 0
            levels = [self._solve_level(buckets, share, elim_end, device)
                      for buckets in self._solve_schedule(start_lump,
                                                          end_lump)]
            self._device_cache[key] = levels
        return levels

    def _solve_level(self, buckets, share, elim_end: int,
                     device) -> SolveLevel:
        """The SolveLevel of one level of the host schedule's buckets."""
        sh = None
        if share is not None:
            sh = solve_share(self, buckets, *share)
            buckets = sh.buckets
        row_base, ytot = _row_bases(buckets)
        csr = _dev_csr(solve_csr(buckets, row_base, self.plan.skel.order),
                       device)
        return SolveLevel(
            buckets=[_dev_bucket(lb, device) for lb in buckets],
            row_base=row_base, ytot=ytot, csr=csr,
            share=DevShare(sh, share[0], device)
            if sh is not None and sh.rows_l is not None else None,
            elim=tuple(bool(elim_end and len(lb.members) and
                            lb.members.max() < elim_end) for lb in buckets))

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

    @staticmethod
    def _level_y(vv: torch.Tensor,
                 level: SolveLevel) -> Optional[torch.Tensor]:
        """The below-product buffer of a solve level (None without below
        rows)."""
        ytot = level.ytot
        return vv.new_empty((vv.shape[0], ytot, vv.shape[2])) if ytot \
            else None

    def _l_buckets(self, level: SolveLevel, use_inv, data, vv, y,
                   ops) -> None:
        """The L pass's diagonal solves of the level's buckets."""
        for b, base in zip(level.buckets, level.row_base):
            self._diag_solve(ops, b, use_inv, data, vv, y, base, False)

    @staticmethod
    def _l_scatter(level: SolveLevel, vv, y, ops) -> None:
        """The L pass's below updates of the level: K2 over its CSR."""
        csr = level.csr
        if csr.n_tgt:
            ops.segmented_subtract(vv, y, csr.tgt, csr.seg_ptr, csr.src_idx,
                                   vv.shape[2], layout=csr.layout)

    def _l_pass(self, levels: List[SolveLevel], use_inv, data, vv, ops,
                group=None) -> None:
        """The L walk, levels in order; a level with a share sums its
        changes of the RHS rows over the ranks of `group`."""
        for level in levels:
            sh = level.share
            if sh is not None:
                old = vv[:, sh.rows_l]
            y = self._level_y(vv, level)
            self._l_buckets(level, use_inv, data, vv, y, ops)
            self._l_scatter(level, vv, y, ops)
            if sh is not None:
                _sum_rows(vv, old, sh.rows_l, group)

    def _lt_pass(self, levels: List[SolveLevel], use_inv, data, vv, ops,
                 group=None) -> None:
        """The Lt walk, levels in reverse, as _l_pass sums the rows."""
        for level in reversed(levels):
            sh = level.share
            if sh is not None:
                old = vv[:, sh.rows_lt]
            for b in level.buckets:
                self._diag_solve(ops, b, use_inv, data, vv, None, 0, True)
            if sh is not None:
                _sum_rows(vv, old, sh.rows_lt, group)

    def make_solve_body(self, start_lump: int, end_lump: int, device,
                        group=None) -> Callable:
        """Full-range solve on a factor from make_factor (it reads the
        stored inverse), in place on a contiguous (batch, order, nrhs)
        RHS: L pass over levels in order, Lt pass in reverse (with
        `group`, as this rank of it runs them). make_solve runs it on a
        copy of its RHS."""
        if not self._full_range(start_lump, end_lump):
            raise NotImplementedError(
                "the fused solve reads the stored inverse of a full-range "
                "factor; partial ranges run make_solve_l / make_solve_lt")
        levels = self._solve_levels(start_lump, end_lump, device,
                                    _share_of(group))

        def solve_body(data: torch.Tensor, vv: torch.Tensor,
                       ops=kernels) -> None:
            self._l_pass(levels, True, data, vv, ops, group)
            self._lt_pass(levels, True, data, vv, ops, group)

        return solve_body

    def make_solve(self, start_lump: int, end_lump: int,
                   device) -> Callable:
        """The solve on a copy of its right-hand side, made inside the
        span solve.input (trace.py). With a `slot` (ops/chain.py
        GraphSlot) the copy is the slot's own right-hand side, the passes
        run through the slot (replayed, captured or eager), and the
        solution is copied out of it."""
        body = self.make_solve_body(start_lump, end_lump, device)

        def solve(data: torch.Tensor, v: torch.Tensor, ops=kernels,
                  slot=None) -> torch.Tensor:
            with trace.span("solve.input"):
                if slot is None:
                    vv = v.clone(memory_format=torch.contiguous_format)
                else:
                    vv = slot.static_rhs(v)
                    vv.copy_(v)
            if slot is None:
                body(data, vv, ops)
                return vv
            slot.run("solve.graph", body, (data, vv), ops)
            return vv.clone()

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

    # -- one factor or solve sharded over the ranks of a process group --
    def make_factor_sharded(self, start_lump: int, end_lump: int, group,
                            device) -> Callable:
        """One factor (batch 1) sharded over the ranks of `group`
        (make_factor_sharded, planned_backend.py:2068): data replicated
        in, the same factor out on every rank. Per level, each rank runs
        K1 / K1-wide on its share of every bucket of at least
        n * SHARD_MIN_B panels and on the smaller buckets whole; one
        all-gather then carries the shares' factored panels (and, on a
        pair level, their products), and K2 runs replicated. A dense
        level with a split bucket runs K4 on each rank's origins into
        zeroed targets and sums them with one all-reduce."""
        body = self.make_factor_body(start_lump, end_lump, device, group)

        def factor(data: torch.Tensor, ops=kernels) -> torch.Tensor:
            ext = data.clone(memory_format=torch.contiguous_format)
            body(ext, ops)
            return ext

        return factor

    def make_solve_sharded(self, start_lump: int, end_lump: int, group,
                           device) -> Callable:
        """One solve (batch 1) sharded over the ranks of `group` on a
        factor from make_factor / make_factor_sharded (it reads the
        stored inverse; make_solve_sharded, planned_backend.py:2949).
        Per level and pass, each rank runs K3 / K3-wide on its share of
        every split bucket (the replicated buckets on rank 0) and, in
        the L pass, K2 over its own CSR; the changes of the RHS rows the
        level touches are summed by one all-reduce. A level with no
        split bucket runs replicated, with no collective."""
        body = self.make_solve_body(start_lump, end_lump, device, group)

        def solve(data: torch.Tensor, v: torch.Tensor,
                  ops=kernels) -> torch.Tensor:
            vv = v.clone(memory_format=torch.contiguous_format)
            body(data, vv, ops)
            return vv

        return solve


def _share_of(group) -> Optional[Tuple[int, int]]:
    """(ranks, this rank) of a process group; None without one."""
    return None if group is None else (dist.get_world_size(group),
                                       dist.get_rank(group))


@dataclass
class CommCount:
    """Collectives of the sharded programs in this process and their
    payload: an all-gather sends the rank's part and receives the n - 1
    others, an all-reduce sends and receives its tensor."""
    calls: int = 0
    sent_bytes: int = 0
    received_bytes: int = 0


COMM = CommCount()


def reset_comm() -> None:
    COMM.calls = COMM.sent_bytes = COMM.received_bytes = 0


def _all_gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(n,) + x.shape: every rank's x, in rank order."""
    out = x.new_empty((n,) + tuple(x.shape))
    dist.all_gather(list(out.unbind(0)), x, group=group)
    COMM.calls += 1
    COMM.sent_bytes += x.nbytes
    COMM.received_bytes += (n - 1) * x.nbytes
    return out


def _all_reduce(x: torch.Tensor, group) -> None:
    dist.all_reduce(x, group=group)
    COMM.calls += 1
    COMM.sent_bytes += x.nbytes
    COMM.received_bytes += x.nbytes


def _share_panels(ext, prod, sh: DevShare, group) -> None:
    """Every rank's factored shares (panels, and products on a pair
    level) into ext and prod: one all-gather of the packs."""
    batch, nd = ext.shape[0], sh.pack_data.shape[0]
    pack = ext.new_empty((batch, sh.pack_len))
    pack[:, :nd] = ext[:, sh.pack_data]
    if sh.pack_prod.shape[0]:
        pack[:, nd:nd + sh.pack_prod.shape[0]] = prod[:, sh.pack_prod]
    got = _all_gather(pack, group, sh.n).transpose(0, 1).reshape(batch, -1)
    ext.index_copy_(1, sh.unpack_data_dst, got[:, sh.unpack_data_src])
    if sh.unpack_prod_dst.shape[0]:
        prod.index_copy_(1, sh.unpack_prod_dst, got[:, sh.unpack_prod_src])


def _sum_dense(ext, dense: Optional[DevDense], targets, group,
               ops) -> None:
    """A dense level's update summed over the ranks: K4 on this rank's
    origins (`dense`, None without any) into the zeroed targets leaves
    -U_r there; one all-reduce of the targets gives -U, added to their
    saved values. Only the target elements are zeroed: K4 reads x from
    the origins' panels."""
    t0 = ext[:, targets]
    ext.index_fill_(1, targets, 0)
    if dense is not None:
        ops.dense_update(ext, dense)
    u = ext[:, targets]
    _all_reduce(u, group)
    ext.index_copy_(1, targets, t0 + u)


def _sum_rows(vv, old, rows, group) -> None:
    """The ranks' changes of the RHS rows `rows` since `old` summed by
    one all-reduce, then added to `old`."""
    delta = vv[:, rows] - old
    _all_reduce(delta, group)
    vv[:, rows] = old + delta


def factor_input(data: torch.Tensor, pad_idx: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `data` (batch, data_size), which the factor
    updates in place, with its padded slots `pad_idx` set to zero.
    Padding must hold zeros (see block_matrix.py): the JAX package
    multiplies by the padding mask, here the padded slots are filled by
    index."""
    ext = data.clone(memory_format=torch.contiguous_format)
    zero_padding(ext, pad_idx)
    return ext


def zero_padding(ext: torch.Tensor, pad_idx: torch.Tensor) -> None:
    """The padded slots `pad_idx` of a (batch, data_size) buffer set to
    zero, in place."""
    if pad_idx.numel():
        ext.index_fill_(1, pad_idx, 0)


def _row_bases(buckets):
    """Offsets of each bucket's below rows in a level's y buffer, and its
    size."""
    row_base, ytot = [], 0
    for lb in buckets:
        row_base.append(ytot)
        ytot += len(lb.off) * lb.rp
    return row_base, ytot
