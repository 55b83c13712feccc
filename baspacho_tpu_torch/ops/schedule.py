"""Host schedule of the planned factor and solve (numpy only).

The host half of `baspacho_tpu/ops/planned_backend.py`, copied close to
line for line so a diff against the original shows what changed:

  * padding policy `pad_dim` / `storage_pad` / `_pad_pow2` (shared with
    the skeleton's storage layout, so both packages build the same
    padded buffer);
  * `LumpBucket` / `PairBucket` and the per-level bucketing
    `_bucket_lumps` (without the TPU panel-footprint cap, which exists
    for the TPU's (8, 128) tiling);
  * the block-pair enumeration `_build_pairs`, which returns one flat
    run list per level: the JAX package's shape groups, padding and
    chunking serve XLA's static shapes, and nothing here reads them;
  * `_factor_schedule` / `_solve_schedule`.

Every level takes the block-pair assembly: the dense compact-U update
is a mechanism tuned to the TPU's scatter cost and is not ported yet.

Added for the hand-written kernels: `pair_csr` and `solve_csr` turn a
level's contributions into a target-sorted CSR (stable in origin order),
which the deterministic segmented-subtract kernel consumes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from .plan import NumericPlan


def pad_dim(x: int, floor: int = 1) -> int:
    """Bucket-shape padding: next power of two (with a floor) up to 512,
    then next multiple of 512. Coarse pow2 padding keeps bucket count low
    for the long tail of small shapes, while the 512-multiple regime caps
    the waste on large panels. Floors (8 for panel rows, 4 for block
    dims) collapse tiny shapes into single buckets."""
    if x <= floor:
        return floor
    if x <= 512:
        return int(2 ** int(np.ceil(np.log2(x))))
    return ((x + 511) // 512) * 512


PAD_ROWS = 8    # floor for below-diag panel rows
PAD_COLS = 4    # floor for lump widths / pair block dims


def storage_pad(below_rows, widths):
    """Padded panel shape policy shared by the skeleton storage layout and
    the planned backend's buckets: power-of-two with floors; columns with
    no below rows get no row padding."""
    below_rows = np.asarray(below_rows, dtype=np.int64)
    prp = np.where(below_rows == 0, 0, _pad_pow2(below_rows, PAD_ROWS))
    return prp, _pad_pow2(np.asarray(widths, dtype=np.int64), PAD_COLS)


def _i32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.int32)


def _pad_pow2(x: np.ndarray, floor: int) -> np.ndarray:
    """Vectorized pad_dim (pow2 up to 512, then 512-multiples)."""
    x = np.maximum(np.asarray(x, dtype=np.int64), floor)
    p2 = np.int64(1) << np.ceil(np.log2(x)).astype(np.int64)
    return np.where(x <= 512, p2, (x + 511) // 512 * 512)


@dataclass
class LumpBucket:
    """Same-padded-shape supernode panels factored as one batched op.

    Each panel is [(cp x cp) padded diag | (rp x cp) padded below] at
    flat offset `off`."""
    rp: int              # padded below rows
    cp: int              # padded lump width (= panel row stride)
    off: np.ndarray      # (B,) panel flat-data offsets
    rows: np.ndarray     # (B,) actual below rows
    cols: np.ndarray     # (B,) actual lump widths
    vec_off: np.ndarray  # (B,) RHS offsets
    below_idx: np.ndarray = None  # (B, rp) RHS rows of below rows (solve)
    prod_base: int = 0   # offset of this bucket's outer products in the
    #                      level's concatenated flat product buffer
    members: list = None  # lump ids in bucket order


@dataclass
class PairBucket:
    """Run-coalesced update blocks of one level, in enumeration order
    (origin column, then column run, then row run). Each entry subtracts
    a (rs x cs) block of the level product buffer into a contiguous-rows
    region of a target panel; rows are maximal runs of consecutive spans
    (adjacent chains in the target column, hence contiguous memory in the
    padded layout). The JAX package splits these into shape groups padded
    for XLA's static shapes; the hand-written assembly reads them per
    element (`pair_csr`), so here they stay one flat list."""
    src_base: np.ndarray    # (P,) flat offset of block in product buffer
    src_stride: np.ndarray  # (P,) product row stride (rp of origin bucket)
    rs: np.ndarray          # (P,) rows
    cs: np.ndarray          # (P,) cols
    c0: np.ndarray          # (P,) column offset inside the target panel
    tgt_row_start: np.ndarray  # (P,) flat offset of the block's first row
    #                            at column 0 of the target panel
    tgt_stride: np.ndarray  # (P,) per-pair target panel stride


class PlannedSchedule:
    """Level schedule of one plan: lump buckets, product-buffer offsets
    and assembly block pairs per level (host, cached per lump range)."""

    def __init__(self, plan: NumericPlan):
        self.plan = plan
        self.num_levels = int(plan.lump_levels.max()) + 1 \
            if len(plan.lump_levels) else 0
        self._sched_cache: Dict[Tuple[int, int], list] = {}
        self._solve_cache: Dict[Tuple[int, int], list] = {}
        # global chain lookup: key (lump_of_chain, row_span) is globally
        # ascending in chain storage order -> one searchsorted resolves any
        # (target lump, span) to its chain index
        sk = plan.skel
        chain_lump = np.repeat(
            np.arange(sk.num_lumps, dtype=np.int64),
            sk.chain_col_ptr[1:] - sk.chain_col_ptr[:-1])
        self._chain_keys = chain_lump * sk.num_spans + sk.chain_row_span

    def _by_level(self, start: int, end: int) -> List[np.ndarray]:
        """Lump ids of [start, end) grouped by schedule level (ascending),
        preserving id order within a level."""
        lv = np.asarray(self.plan.lump_levels[start:end])
        ids = np.arange(start, end, dtype=np.int64)
        order = np.argsort(lv, kind="stable")
        lv_s, ids_s = lv[order], ids[order]
        brk = (np.nonzero(np.diff(lv_s))[0] + 1).tolist()
        bounds = [0, *brk, len(ids_s)]
        return [ids_s[a:b] for a, b in zip(bounds[:-1], bounds[1:])]

    def _factor_schedule(self, start: int, end: int):
        key = (start, end)
        sched = self._sched_cache.get(key)
        if sched is None:
            sched = [self._build_level(lds, with_below_idx=True)
                     for lds in self._by_level(start, end)]
            self._sched_cache[key] = sched
        return sched

    def _build_level(self, lds, with_below_idx=False):
        """Bucket the level's lumps (`lds` is an array of lump ids);
        assign product-buffer offsets to buckets with below rows;
        enumerate the assembly block pairs. Returns
        (lump_buckets, pairs, product-buffer size)."""
        lds = np.asarray(lds, dtype=np.int64)
        lump_buckets = self._bucket_lumps(lds, with_below_idx)
        prod_total = 0
        origin_pos: Dict[int, Tuple[int, int]] = {}
        for lb in lump_buckets:
            if lb.rp == 0:
                continue
            lb.prod_base = prod_total
            for bi, l in enumerate(lb.members.tolist()):
                origin_pos[l] = (prod_total + bi * lb.rp * lb.rp, lb.rp)
            prod_total += len(lb.off) * lb.rp * lb.rp
        pairs = self._build_pairs(lds, origin_pos)
        return lump_buckets, pairs, prod_total

    def _bucket_lumps(self, lds, with_below_idx: bool) -> List[LumpBucket]:
        """Group the lump ids by padded panel shape (fully vectorized)."""
        plan = self.plan
        order = plan.skel.order
        lds = np.asarray(lds, dtype=np.int64)
        prp_a = plan.lump_prp[lds]
        cp_a = plan.lump_strides[lds]
        co_a = plan.lump_col_offset[lds]
        sort_idx = np.lexsort((co_a, cp_a, prp_a))
        g_all = lds[sort_idx]
        prp_s, cp_s, co_s = prp_a[sort_idx], cp_a[sort_idx], co_a[sort_idx]
        brk = (np.nonzero((prp_s[1:] != prp_s[:-1]) |
                          (cp_s[1:] != cp_s[:-1]))[0] + 1).tolist()
        bounds = [0, *brk, len(g_all)]
        ptr = plan.below_row_ptr
        flat = plan.below_rows_flat
        out = []
        for a, b in zip(bounds[:-1], bounds[1:]):
            g = g_all[a:b]
            rp, cp = int(prp_s[a]), int(cp_s[a])
            bidx = None
            if with_below_idx:
                bidx = np.full((len(g), max(rp, 1)), order, dtype=np.int32)
                cnt = ptr[g + 1] - ptr[g]
                tot = int(cnt.sum())
                if tot:
                    ii = np.repeat(np.arange(len(g)), cnt)
                    ex = np.concatenate([[0], np.cumsum(cnt)[:-1]])
                    jj = np.arange(tot, dtype=np.int64) - np.repeat(ex, cnt)
                    src = np.repeat(ptr[g] - ex, cnt) + \
                        np.arange(tot, dtype=np.int64)
                    bidx[ii, jj] = flat[src]
            lb = LumpBucket(
                rp=rp, cp=cp, off=_i32(co_s[a:b]),
                rows=_i32(plan.lump_total_rows[g] - plan.lump_sizes[g]),
                cols=_i32(plan.lump_sizes[g]),
                vec_off=_i32(plan.lump_vec_offset[g]),
                below_idx=bidx)
            lb.members = g
            out.append(lb)
        return out

    def _build_pairs(self, lds, origin_pos) -> PairBucket:
        """Run-coalesced lower block pairs of all level columns.

        Below-diagonal spans of each origin column are grouped into
        maximal runs of consecutive span ids; column-side runs are split
        at target-lump boundaries, row-side runs additionally at the
        target's diag/below panel boundary (the padded layout has a gap
        there). Every (row_run >= col_run) pair is one rectangle — the
        run-diagonal rectangle includes upper span pairs, which is safe:
        they land in the never-read upper half of the target's diagonal
        block (the reference likewise subtracts whole square blocks on
        diagonal pairs, MatOpsRef.cpp:163-171). Vectorized with a global
        sorted (lump, span) chain-key lookup."""
        sk = self.plan.skel
        span_size = sk.span_start[1:] - sk.span_start[:-1]
        col_stride = sk.col_stride
        ck = self._chain_keys
        S = sk.num_spans

        parts = []  # per column: (src, sstride, rs, cs, c0, trs) arrays
        for o in np.asarray(lds, dtype=np.int64):
            o = int(o)
            if o not in origin_pos:
                continue
            base, rp = origin_pos[o]
            cs_, ce_ = int(sk.chain_col_ptr[o]), int(sk.chain_col_ptr[o + 1])
            nd = int(sk.lump_to_span[o + 1] - sk.lump_to_span[o])
            spans = sk.chain_row_span[cs_ + nd:ce_]
            nb = len(spans)
            if nb == 0:
                continue
            sizes = span_size[spans]
            row_offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
            tlump = sk.span_to_lump[spans]
            # column runs: consecutive spans, same target lump
            brk_col = np.nonzero((spans[1:] != spans[:-1] + 1) |
                                 (tlump[1:] != tlump[:-1]))[0] + 1
            cbounds = np.concatenate([[0], brk_col, [nb]])
            # row runs: consecutive spans, split at each target's
            # diag/below boundary — computed per column run below
            brk_row = np.nonzero(spans[1:] != spans[:-1] + 1)[0] + 1
            rbounds_all = np.concatenate([[0], brk_row, [nb]])

            for cb in range(len(cbounds) - 1):
                j0, j1 = int(cbounds[cb]), int(cbounds[cb + 1])
                t = int(tlump[j0])
                stride = int(col_stride[t])
                t_end_span = int(sk.lump_to_span[t + 1])
                c0 = int(sk.span_offset_in_lump[spans[j0]])
                ccols = int(row_offs[j1 - 1] + sizes[j1 - 1] - row_offs[j0])
                # row runs start at this column run (i >= j ordering)
                ri = j0
                while ri < nb:
                    # find end of this row run
                    nxt = rbounds_all[np.searchsorted(rbounds_all, ri,
                                                      side="right")]
                    re = int(nxt)
                    # split at the target's diag/below boundary
                    if spans[ri] < t_end_span:
                        # run starts inside target lump's own spans
                        inside = np.searchsorted(spans[ri:re], t_end_span)
                        re_eff = ri + int(inside)
                    else:
                        re_eff = re
                    if re_eff == ri:
                        re_eff = re  # entire run below the boundary
                    seg_end = re_eff
                    # locate first span's chain in target column
                    s0 = int(spans[ri])
                    pos = int(np.searchsorted(ck, t * S + s0))
                    assert sk.chain_row_span[pos] == s0, \
                        "missing fill chain in target column"
                    rrows = int(row_offs[seg_end - 1] + sizes[seg_end - 1] -
                                row_offs[ri])
                    parts.append((
                        base + int(row_offs[ri]) * rp + int(row_offs[j0]),
                        rp, rrows, ccols, c0,
                        int(sk.chain_data[pos]),
                        stride))
                    ri = seg_end
        arr = np.array(parts, dtype=np.int64).reshape(-1, 7).T
        src, sstride, rs, cls, c0, trs, stride = arr
        return PairBucket(src_base=src, src_stride=sstride, rs=rs, cs=cls,
                          c0=c0, tgt_row_start=trs, tgt_stride=stride)

    def _solve_schedule(self, start: int, end: int) -> List[List[LumpBucket]]:
        key = (start, end)
        sched = self._solve_cache.get(key)
        if sched is None:
            # the factor schedule's lump buckets are built with the same
            # (with_below_idx=True) layout — reuse them
            fs = self._sched_cache.get(key)
            if fs is not None:
                sched = [lev[0] for lev in fs]
            else:
                sched = [self._bucket_lumps(lds, with_below_idx=True)
                         for lds in self._by_level(start, end)]
            self._solve_cache[key] = sched
        return sched


@dataclass
class SegmentCSR:
    """Target-sorted contributions of one level's assembly:
    out[tgt[t]] -= sum(src[src_idx[seg_ptr[t]:seg_ptr[t + 1]]]).
    Within a segment, contributions keep their origin order, so the sum
    is taken in one fixed order (bitwise deterministic)."""
    tgt: np.ndarray      # (T,) int64 target positions, ascending
    seg_ptr: np.ndarray  # (T + 1,) int64 segment extents into src_idx
    src_idx: np.ndarray  # (N,) int64 source positions


def _csr(tgt: np.ndarray, src: np.ndarray, origin: np.ndarray) -> SegmentCSR:
    order = np.lexsort((origin, tgt))
    tgt, src = tgt[order], src[order]
    starts = np.concatenate([[True], tgt[1:] != tgt[:-1]]) \
        if len(tgt) else np.zeros(0, dtype=bool)
    pos = np.nonzero(starts)[0]
    seg_ptr = np.concatenate([pos, [len(tgt)]]).astype(np.int64)
    return SegmentCSR(tgt=tgt[pos].astype(np.int64), seg_ptr=seg_ptr,
                      src_idx=src.astype(np.int64))


def pair_csr(pb: PairBucket) -> SegmentCSR:
    """CSR over data elements of one factor level's block pairs: every
    (r < rs, c < cs) element of every pair rectangle contributes
    prod[src_base + r * src_stride + c] to
    data[tgt_row_start + c0 + r * tgt_stride + c]."""
    n_el = pb.rs * pb.cs
    p = np.repeat(np.arange(len(n_el)), n_el)
    k = np.arange(int(n_el.sum()), dtype=np.int64) - \
        np.repeat(np.cumsum(n_el) - n_el, n_el)
    r, c = k // pb.cs[p], k % pb.cs[p]
    # the targets of one rectangle are distinct: origin order is the
    # order of the pairs' enumeration
    return _csr(pb.tgt_row_start[p] + pb.c0[p] + r * pb.tgt_stride[p] + c,
                pb.src_base[p] + r * pb.src_stride[p] + c, p)


def solve_csr(buckets: List[LumpBucket], row_base: List[int],
              order: int) -> SegmentCSR:
    """CSR over RHS rows of one solve level's below updates: row r of
    panel b of bucket i contributes y[row_base[i] + b * rp + r] to RHS
    row below_idx[b, r]. Sentinel rows (== order) are skipped."""
    tgts, srcs, origins = [], [], []
    for lb, base in zip(buckets, row_base):
        if lb.rp == 0:
            continue
        bidx = lb.below_idx.astype(np.int64)
        B, rp = bidx.shape
        src = base + np.arange(B * rp, dtype=np.int64).reshape(B, rp)
        keep = bidx != order
        tgts.append(bidx[keep])
        srcs.append(src[keep])
        origins.append(np.broadcast_to(
            np.asarray(lb.members, dtype=np.int64)[:, None], (B, rp))[keep])
    if not tgts:
        z = np.zeros(0, np.int64)
        return SegmentCSR(z, np.zeros(1, np.int64), z)
    return _csr(np.concatenate(tgts), np.concatenate(srcs),
                np.concatenate(origins))
