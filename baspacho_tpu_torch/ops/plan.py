"""Numeric plans: static index descriptors extracted from the skeleton.

The symbolic/numeric split of the reference (SymbolicCtx precomputing index
maps once, NumericCtx replaying them per factor call) becomes, on TPU:
everything data-dependent is precomputed **here** as NumPy arrays, then
baked into jitted functions as constants. No host<->device index traffic
ever happens at numeric time — this also fixes the reference's per-lump
`prepareAssemble` host-loop FIXME (MatOpsCuda.cu:474).

Descriptors:
  * LumpDesc — one supernode column: where its (rows x cols) panel lives in
    the flat data vector, plus scatter indices for the below-diagonal rows'
    positions in a RHS vector.
  * BoardDesc — one pending update of a later column by an earlier one:
    gather offsets of the source sub/full panels and a precomputed
    (R_full x R_sub) flat-index scatter matrix into the data vector.

The plan lists lumps in elimination order; `lump_levels` additionally
level-schedules the elimination tree (lumps whose columns don't depend on
each other share a level) — the planned backend batches all same-shape
lumps of a level into single XLA ops.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..block_matrix import CoalescedBlockMatrixSkel


@dataclass
class BoardDesc:
    target_lump: int
    origin_lump: int
    src_offset: int      # flat-data offset of the board's first chain
    src_stride: int      # origin panel row stride (padded column width)
    full_rows: int       # rows from board start to end of origin column
    sub_rows: int        # rows of the board itself (into target lump)
    width: int           # origin lump size (k of the gemm)
    scatter_idx: np.ndarray  # (full_rows, sub_rows) flat indices into data


@dataclass
class LumpDesc:
    index: int
    col_offset: int      # flat-data offset of column panel (= panel base)
    total_rows: int      # diag + below-diag logical rows
    size: int            # lump width (= diag rows)
    stride: int          # panel row stride (padded width, >= size)
    prp: int             # padded below-row count (>= total_rows - size)
    vec_offset: int      # position of lump in a RHS vector
    below_row_idx: np.ndarray  # (total_rows - size,) RHS positions of below rows
    boards: List[BoardDesc] = field(default_factory=list)

    @property
    def below(self) -> int:
        return self.total_rows - self.size

    @property
    def below_offset(self) -> int:
        return self.col_offset + self.stride * self.stride


@dataclass
class SpanDesc:
    """Per-span info for pseudo-factor / sparse per-span ops. The rows
    below a span split into two regions in the padded panel: the rest of
    the diagonal block (within-lump spans after it) and the below panel."""
    span: int
    diag_offset: int
    stride: int
    size: int
    below1_offset: int   # within-diag rows below the span
    below1_rows: int
    below2_offset: int   # below-panel rows (restricted to span's columns)
    below2_rows: int


@dataclass
class NumericPlan:
    """Per-lump geometry as flat arrays (at BAL scale — 500k+ lumps —
    per-lump Python objects cost tens of seconds to build and iterate;
    the planned backend consumes these arrays directly). The `lumps`
    LumpDesc view is materialized lazily for the unrolled ref backend."""
    skel: CoalescedBlockMatrixSkel
    sparse_elim_ranges: List[int]
    lump_levels: np.ndarray  # (num_lumps,) level-schedule depth of each lump
    lump_col_offset: np.ndarray   # (L,) panel flat-data offsets
    lump_total_rows: np.ndarray   # (L,) diag + below logical rows
    lump_sizes: np.ndarray        # (L,) widths
    lump_strides: np.ndarray      # (L,) padded widths (panel row stride)
    lump_prp: np.ndarray          # (L,) padded below-row counts
    lump_vec_offset: np.ndarray   # (L,) RHS positions
    below_rows_flat: np.ndarray   # concatenated below-row RHS indices
    below_row_ptr: np.ndarray     # (L+1,) extents into below_rows_flat
    max_factor_lump: int = -1
    boards_built: bool = False
    _spans: Optional[List[SpanDesc]] = None
    _lumps: Optional[List[LumpDesc]] = None

    @property
    def spans(self) -> List[SpanDesc]:
        if self._spans is None:
            self._spans = _build_spans(self.skel)
        return self._spans

    @property
    def lumps(self) -> List[LumpDesc]:
        if self._lumps is None:
            co = self.lump_col_offset.tolist()
            tr = self.lump_total_rows.tolist()
            sz = self.lump_sizes.tolist()
            st = self.lump_strides.tolist()
            pb = self.lump_prp.tolist()
            vo = self.lump_vec_offset.tolist()
            rp = self.below_row_ptr.tolist()
            self._lumps = [
                LumpDesc(index=l, col_offset=co[l], total_rows=tr[l],
                         size=sz[l], stride=st[l], prp=pb[l],
                         vec_offset=vo[l],
                         below_row_idx=self.below_rows_flat[rp[l]:rp[l + 1]])
                for l in range(len(co))]
        return self._lumps


def build_plan(skel: CoalescedBlockMatrixSkel, sparse_elim_ranges,
               max_factor_lump: int = -1) -> NumericPlan:
    """max_factor_lump: boards originating at lumps >= this are skipped —
    with partial fill policies (AddFillForGivenElims/None) the skeleton
    legitimately lacks the fill chains those updates would target, and the
    solver's canFactorUpTo forbids executing them anyway."""
    sk = skel
    num_lumps = sk.num_lumps
    if max_factor_lump < 0:
        max_factor_lump = num_lumps
    span_start = sk.span_start
    span_size = span_start[1:] - span_start[:-1]
    lump_size_arr = sk.lump_start[1:] - sk.lump_start[:-1]

    # vectorized per-lump geometry
    cs_arr = sk.chain_col_ptr[:-1]
    ce_arr = sk.chain_col_ptr[1:]
    total_rows_arr = np.where(ce_arr > cs_arr,
                              sk.chain_rows_till_end[ce_arr - 1], 0)
    col_offset_arr = sk.chain_data[cs_arr]
    n_diag = sk.lump_to_span[1:] - sk.lump_to_span[:-1]

    # global expansion of all below-diagonal chain rows (RHS positions),
    # with per-lump extents — each LumpDesc gets a view. int32
    # throughout: these are the largest symbolic-analysis temporaries
    # (tens of millions of entries at BAL scale); C++ fills them in one
    # pass, the numpy fallback in a repeat/cumsum pipeline.
    from .. import native
    fast = native.try_plan_below_rows(span_start, sk.lump_to_span,
                                      sk.chain_col_ptr, sk.chain_row_span,
                                      int(sk.below_rows.sum()))
    if fast is not None:
        global_rows, lump_row_ptr = fast
    else:
        chain_lump = np.repeat(np.arange(num_lumps, dtype=np.int32),
                               ce_arr - cs_arr)
        chain_pos = np.arange(len(sk.chain_row_span), dtype=np.int32) - \
            cs_arr.astype(np.int32)[chain_lump]
        below_chain = chain_pos >= n_diag.astype(np.int32)[chain_lump]
        b_spans = sk.chain_row_span[below_chain]
        b_lump = chain_lump[below_chain]
        b_sizes = span_size.astype(np.int32)[b_spans]
        b_starts = span_start.astype(np.int32)[b_spans]
        tot = int(b_sizes.sum())
        ex_cum = np.concatenate(
            [np.zeros(1, np.int32), np.cumsum(b_sizes, dtype=np.int32)[:-1]]) \
            if len(b_sizes) else np.empty(0, np.int32)
        global_rows = (np.repeat(b_starts - ex_cum, b_sizes) +
                       np.arange(tot, dtype=np.int32)) \
            if tot else np.empty(0, np.int32)
        lump_row_counts = np.bincount(b_lump, weights=b_sizes,
                                      minlength=num_lumps).astype(np.int64)
        lump_row_ptr = np.concatenate([[0], np.cumsum(lump_row_counts)])

    # per-span/per-lump descriptor OBJECTS are built lazily — only the
    # ref backend and pseudo-factor need them, and at BAL scale 500k+
    # Python objects cost tens of seconds (see NumericPlan.lumps/spans)

    # level schedule: level(l) = 1 + max(level of columns updating l);
    # the updating columns of l are its row-boards' origin lumps
    # (loop-carried recurrence: C++ fast path, Python fallback)
    from .. import native
    levels = native.try_level_schedule(sk.board_row_ptr,
                                       sk.board_col_lump, max_factor_lump)
    if levels is None:
        levels = np.zeros(num_lumps, dtype=np.int64)
        bc = sk.board_col_lump
        for l in range(num_lumps):
            r0, r1 = int(sk.board_row_ptr[l]), int(sk.board_row_ptr[l + 1])
            origins = bc[r0:r1]
            origins = origins[(origins < l) & (origins < max_factor_lump)]
            if len(origins):
                levels[l] = int(levels[origins].max()) + 1

    return NumericPlan(skel=sk, sparse_elim_ranges=list(sparse_elim_ranges),
                       lump_levels=levels,
                       lump_col_offset=sk.panel_base[:num_lumps],
                       lump_total_rows=total_rows_arr,
                       lump_sizes=lump_size_arr,
                       lump_strides=sk.col_stride,
                       lump_prp=sk.padded_below,
                       lump_vec_offset=sk.lump_start[:num_lumps],
                       below_rows_flat=global_rows,
                       below_row_ptr=lump_row_ptr,
                       max_factor_lump=max_factor_lump)


def _build_spans(sk: CoalescedBlockMatrixSkel) -> List[SpanDesc]:
    span_start = sk.span_start
    span_size = span_start[1:] - span_start[:-1]
    lump_size_arr = sk.lump_start[1:] - sk.lump_start[:-1]
    sl = sk.span_to_lump[:-1]
    stride_arr = sk.col_stride[sl]
    base_arr = sk.panel_base[sl]
    off_in = sk.span_offset_in_lump[:-1]
    diag_off_arr = base_arr + off_in * (1 + stride_arr)
    b1_rows = lump_size_arr[sl] - off_in - span_size
    b1_off = base_arr + (off_in + span_size) * stride_arr + off_in
    b2_rows = sk.below_rows[sl]
    b2_off = base_arr + stride_arr * stride_arr + off_in
    return [SpanDesc(span=s, diag_offset=int(diag_off_arr[s]),
                     stride=int(stride_arr[s]), size=int(span_size[s]),
                     below1_offset=int(b1_off[s]),
                     below1_rows=int(b1_rows[s]),
                     below2_offset=int(b2_off[s]),
                     below2_rows=int(b2_rows[s]))
            for s in range(sk.num_spans)]


def ensure_boards(plan: "NumericPlan") -> None:
    """Materialize per-board gather/scatter descriptors (used only by the
    unrolled reference backend; the planned backend derives its block-pair
    schedule directly)."""
    if plan.boards_built:
        return
    sk = plan.skel
    span_start = sk.span_start
    span_size = span_start[1:] - span_start[:-1]
    for l in range(sk.num_lumps):
        for r_ptr in range(int(sk.board_row_ptr[l]),
                           int(sk.board_row_ptr[l + 1])):
            o = int(sk.board_col_lump[r_ptr])
            if o >= l or o >= plan.max_factor_lump:
                continue  # diag board / origin beyond factorable range
            board_ord = int(sk.board_col_ord[r_ptr])
            plan.lumps[l].boards.append(
                _build_board(sk, span_start, span_size, l, o, board_ord))
    plan.boards_built = True


def _build_board(sk: CoalescedBlockMatrixSkel, span_start, span_size,
                 target: int, origin: int, board_ord: int) -> BoardDesc:
    cs = int(sk.chain_col_ptr[origin])
    bs = int(sk.board_col_ptr[origin])
    be = int(sk.board_col_ptr[origin + 1])
    chain0 = int(sk.board_chain_col_ord[bs + board_ord])      # board start
    chain1 = int(sk.board_chain_col_ord[bs + board_ord + 1])  # board end
    chain_end = int(sk.board_chain_col_ord[be - 1])           # column end
    width = int(sk.lump_start[origin + 1] - sk.lump_start[origin])

    rect_row_begin = int(sk.chain_rows_till_end[cs + chain0 - 1]) \
        if chain0 > 0 else 0
    sub_rows = int(sk.chain_rows_till_end[cs + chain1 - 1]) - rect_row_begin
    full_rows = int(sk.chain_rows_till_end[cs + chain_end - 1]) - rect_row_begin
    src_offset = int(sk.chain_data[cs + chain0])

    # scatter indices: product rows = origin-column spans chain0..chain_end,
    # product cols = origin-column spans chain0..chain1 (spans of target lump)
    tgt_cs = int(sk.chain_col_ptr[target])
    tgt_ce = int(sk.chain_col_ptr[target + 1])
    tgt_c = int(sk.col_stride[target])
    tgt_spans = sk.chain_row_span[tgt_cs:tgt_ce]

    col_spans = sk.chain_row_span[cs + chain0:cs + chain1]
    row_spans = sk.chain_row_span[cs + chain0:cs + chain_end]

    # per product block-col: offset of span's columns inside target panel
    col_offsets = sk.span_offset_in_lump[col_spans]
    col_sizes = span_size[col_spans]
    # per product block-row: flat offset of that span's chain in target col
    pos = tgt_cs + np.searchsorted(tgt_spans, row_spans)
    assert np.all(sk.chain_row_span[pos] == row_spans), \
        "missing fill chain in target column"
    row_data = sk.chain_data[pos]
    row_sizes = span_size[row_spans]

    # upper-triangle block pairs (bi < bj) are not stored in the factor:
    # redirect them to the sacrificial trash slot at index data_size (the
    # numeric functions pad the data vector by one element)
    trash = sk.data_size
    scatter = np.full((full_rows, sub_rows), trash, dtype=np.int64)
    r0 = 0
    for bi in range(len(row_spans)):
        rs = int(row_sizes[bi])
        base = int(row_data[bi])
        c0 = 0
        for bj in range(min(bi + 1, len(col_spans))):
            csz = int(col_sizes[bj])
            coff = int(col_offsets[bj])
            scatter[r0:r0 + rs, c0:c0 + csz] = (
                base + coff +
                np.arange(rs, dtype=np.int64)[:, None] * tgt_c +
                np.arange(csz, dtype=np.int64)[None, :])
            c0 += csz
        r0 += rs

    return BoardDesc(target_lump=target, origin_lump=origin,
                     src_offset=src_offset,
                     src_stride=int(sk.col_stride[origin]),
                     full_rows=full_rows, sub_rows=sub_rows, width=width,
                     scatter_idx=scatter)
