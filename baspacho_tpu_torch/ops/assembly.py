"""Host plan of K6, the LM optimizer's gradient / Hessian assembly.

The JAX package (baspacho_tpu/optimizer/optimizer.py:334-363) forms
every factor's J_k^T r and J_k^T J_l with einsums and scatter-adds them
into the gradient and the coalesced Hessian buffer with `.at[].add`. The
port sorts every contribution by its destination block once per
optimizer, here, so that csrc/grad_hess.cu can sum each block's
contributions in a fixed order without atomics (ops/kernels.py
`grad_hess`).

One family's Jacobians travel in one buffer W (F, rdim, tdw): the
weighted Jacobian of each live slot side by side (slot k in columns
col_off[k] .. col_off[k] + td_k), then the weighted residual as the last
column. A "term" q names two column offsets (tab_a[q], tab_b[q]) of W:
pair p contributes terms 2p (block stored as is: rows from slot k) and
2p + 1 (stored transposed, `flip`: rows from slot l); the gradient of
live slot i is term 2 * npairs + i, whose second column is the residual.
A record f * Q + q adds sum_r W[f, r, tab_a[q] + i] * W[f, r, tab_b[q] + j]
to element (i, j) of its segment's block.

The segments of one output are ordered in classes: the short ones (at
most LONG_SEG records) first, in classes of equal (rows, cols, records),
each a run of segments that the kernel's short grid covers with one
thread per row, its segment, row and records found from the class's
first segment and first record by division; then the long ones,
in classes of equal (rows, cols), whose records are cut into chunks of
`chunk_rec` records, a CTA each, summed into partial blocks that a post
grid adds in chunk order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

LONG_SEG = 32  # segments with more records than this are cut into chunks
GH_CHUNK_REC = 256  # records of a long segment's chunk (csrc/grad_hess.cu
#                     kMaxChunkRec: a thread loads one record's offsets)
GH_LONG_RC = 256  # rows + cols of a long segment's block at most (the
#                    chunk grid's 256 threads hold a row each)
GH_CLASS_ELEMS = 1 << 30  # elements of one class entry at most (the short
#                           grid's 32-bit element index)
GH_PIECE_BYTES = 8 << 20  # W bytes of one piece of the short grid's layout
#                           (a part of the H100's 50 MB L2)
GH_PIECE_ELEMS = 1 << 16  # elements of a class's piece at least


@dataclass
class Segments:
    """Destination blocks of one output (Hessian data or gradient), each
    rows x cols elements at off + i * stride + j, with its records
    rec[ptr[s]:ptr[s + 1]] in the order they are added."""
    off: torch.Tensor
    stride: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    ptr: torch.Tensor
    rec: torch.Tensor
    short: torch.Tensor   # ids of segments with <= LONG_SEG records
    long: torch.Tensor    # ids of the others, after the short ones
    max_rc_long: int      # the largest rows + cols among the long ones
    elements: int         # output elements the segments cover
    macs: int             # multiply-adds the records need
    # (first segment, segments, rows, cols, records a segment, first
    # record) of each class entry of the short and of the long segments
    # (host int64, for the launches; records 0 for the long ones)
    short_classes: np.ndarray
    long_classes: np.ndarray
    chunk_rec: int             # records per chunk of a long segment
    chunk_seg: torch.Tensor    # the long segment of each chunk, in order
    chunk_p0: torch.Tensor     # its first record
    chunk_ptr: torch.Tensor    # chunks of long segment first_long + i:
    #                            chunk_ptr[i] .. chunk_ptr[i + 1]
    max_e_long: int            # the largest rows x cols among the long


@dataclass
class FamilyAssembly:
    """K6's plan of one factor family (see the module docstring)."""
    rdim: int
    tdw: int
    Q: int
    tab_a: torch.Tensor
    tab_b: torch.Tensor
    hess: Segments
    grad: Segments
    # (output: 0 hess, 1 grad, then a Segments class entry) of the short
    # grid's and the post grid's class entries, in launch order
    short_entries: np.ndarray
    long_entries: np.ndarray
    # the same contributions in the JAX package's form, for the plain
    # twin: (column of slot k, ti, column of slot l, tj, off, stride,
    # flip) per pair and (column, td, vec_off) per live slot
    pairs: List[tuple]
    vecs: List[tuple]


def _classes(first, rows, cols, count, rec0) -> np.ndarray:
    """(first segment, segments, rows, cols, records a segment, first
    record) of each run of equal (rows, cols, count) among segments
    first, first + 1, ... (count[i] records from rec0[i]); a run past
    GH_CLASS_ELEMS elements is cut into several entries."""
    out = []
    n = len(rows)
    cut = np.flatnonzero((np.diff(rows) != 0) | (np.diff(cols) != 0) |
                         (np.diff(count) != 0)) + 1
    for a, b in zip(np.r_[0, cut], np.r_[cut, n]) if n else ():
        R, C = int(rows[a]), int(cols[a])
        step = max(1, GH_CLASS_ELEMS // (R * C))
        for s0 in range(a, b, step):
            out.append((first + s0, min(step, b - s0), R, C, int(count[a]),
                        int(rec0[s0])))
    return np.asarray(out, dtype=np.int64).reshape(-1, 6)


def _segments(off, stride, rows, cols, rec, rdim: int, device) -> Segments:
    """Sorts the records by destination (stable: the order they were
    given in stays within a block), cuts them into segments, orders the
    segments in classes of equal (long, rows, cols) and cuts the long
    ones' records into chunks."""
    order = np.argsort(off, kind="stable")
    off, stride, rows, cols, rec = (a[order] for a in
                                    (off, stride, rows, cols, rec))
    n = len(off)
    starts = np.flatnonzero(np.diff(off)) + 1 if n else np.zeros(0, np.int64)
    starts = np.concatenate([[0], starts]).astype(np.int64) if n else starts
    ptr = np.append(starts, n).astype(np.int64)
    seg_of = np.repeat(np.arange(len(starts)), np.diff(ptr))
    for a, what in ((stride, "stride"), (rows, "rows"), (cols, "cols")):
        if not np.array_equal(a, a[starts][seg_of]):
            raise ValueError(f"K6 plan: records of one block disagree on "
                             f"its {what}")
    s_rows, s_cols = rows[starts], cols[starts]
    count = np.diff(ptr)
    is_long = count > LONG_SEG
    # segments in classes: short before long, then by rows, by cols, the
    # short ones by records (stable: destination order within a class);
    # their records follow
    perm = np.lexsort((np.where(is_long, 0, count), s_cols, s_rows,
                       is_long))
    cnt = count[perm]
    new_ptr = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
    take = np.repeat(ptr[:-1][perm] - new_ptr[:-1], cnt) + \
        np.arange(n, dtype=np.int64)
    s_off, s_stride = off[starts][perm], stride[starts][perm]
    s_rows, s_cols, is_long = s_rows[perm], s_cols[perm], is_long[perm]
    n_short = int((~is_long).sum())
    rc_long = (s_rows + s_cols)[is_long]
    max_rc = int(rc_long.max(initial=0))
    if max_rc > GH_LONG_RC:
        raise ValueError(f"K6 plan: a long block of {max_rc} rows + columns, "
                         f"past {GH_LONG_RC}")
    chunk_rec = GH_CHUNK_REC if max_rc else 0
    # the long segments' chunks, in segment order, then record order
    lcnt = cnt[n_short:]
    nch = -(-lcnt // max(chunk_rec, 1))
    chunk_ptr = np.concatenate([[0], np.cumsum(nch)]).astype(np.int64)
    ch_of = np.repeat(np.arange(len(lcnt)), nch)
    ch_k = np.arange(int(chunk_ptr[-1])) - chunk_ptr[:-1][ch_of]
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        a, dtype=np.int64)).to(device)
    nseg = len(perm)
    return Segments(
        off=dev(s_off), stride=dev(s_stride), rows=dev(s_rows),
        cols=dev(s_cols), ptr=dev(new_ptr), rec=dev(rec[take]),
        short=dev(np.arange(n_short)), long=dev(np.arange(n_short, nseg)),
        max_rc_long=max_rc,
        elements=int((s_rows * s_cols).sum()),
        macs=int((rows * cols).sum()) * rdim,
        short_classes=_classes(0, s_rows[:n_short], s_cols[:n_short],
                               cnt[:n_short], new_ptr[:n_short]),
        long_classes=_classes(n_short, s_rows[n_short:], s_cols[n_short:],
                              np.zeros(nseg - n_short, np.int64),
                              new_ptr[n_short:-1]),
        chunk_rec=chunk_rec, chunk_seg=dev(n_short + ch_of),
        chunk_p0=dev(new_ptr[n_short:-1][ch_of] + ch_k * chunk_rec),
        chunk_ptr=dev(chunk_ptr),
        max_e_long=int((s_rows * s_cols)[is_long].max(initial=0)))


def _entries(hess: Segments, grad: Segments, w_bytes: int) -> tuple:
    """The class entries of both outputs as the short grid and the post
    grid run them: (output, first segment, segments, rows, cols, records
    a segment, first record). The short classes are cut into pieces of a
    K-th of their segments, K = W's bytes / GH_PIECE_BYTES (a class into
    fewer, of GH_PIECE_ELEMS elements at least), and laid out piece by
    piece: the segments of one piece of every class read the W rows of
    about one K-th of the factors when W is in factor order along the
    destinations (BAL: a range of points' blocks, camera-point blocks and
    gradients), so that L2 keeps them between the classes."""
    K = max(1, -(-w_bytes // GH_PIECE_BYTES))
    slots = []
    for o, seg in enumerate((hess, grad)):
        for s0, n, R, C, cnt, rec0 in seg.short_classes.tolist():
            k = int(min(K, max(1, n * R * C // GH_PIECE_ELEMS)))
            for j in range(k):
                a, b = j * n // k, (j + 1) * n // k
                if b > a:
                    slots.append((j * K // k, o, s0 + a, b - a, R, C, cnt,
                                  rec0 + a * cnt))
    slots.sort(key=lambda e: e[0])  # stable: output and class order kept
    short = np.asarray([e[1:] for e in slots], np.int64).reshape(-1, 7)
    long = np.asarray([(o, *e) for o, seg in enumerate((hess, grad))
                       for e in seg.long_classes.tolist()],
                      np.int64).reshape(-1, 7)
    return short, long


def build_family_assembly(
        F: int, rdim: int, tdims: Sequence[int],
        vec_offs: Sequence, pairs: Sequence[Tuple], device
        ) -> FamilyAssembly:
    """K6's plan of one family of F factors. tdims[k] is slot k's tangent
    dim; vec_offs[k] its (F,) gradient offsets, or None for a fixed slot
    (no columns in W, no records); pairs the family's (k, l, off, stride,
    flip) Hessian blocks, k <= l among the live slots, with the (F,)
    offset, stride and flip of each factor's block (the accessor's)."""
    live = [k for k, v in enumerate(vec_offs) if v is not None]
    col = {}
    c = 0
    for k in live:
        col[k] = c
        c += int(tdims[k])
    res_col, tdw = c, c + 1
    npairs = len(pairs)
    Q = 2 * npairs + len(live)
    tab_a = np.zeros(Q, np.int64)
    tab_b = np.zeros(Q, np.int64)
    f = np.arange(F, dtype=np.int64)
    h_parts = []
    twin_pairs = []
    for p, (k, l, off, stride, flip) in enumerate(pairs):
        ti, tj = int(tdims[k]), int(tdims[l])
        tab_a[2 * p], tab_b[2 * p] = col[k], col[l]
        tab_a[2 * p + 1], tab_b[2 * p + 1] = col[l], col[k]
        flip = np.asarray(flip, dtype=bool)
        off = np.asarray(off, dtype=np.int64)
        stride = np.asarray(stride, dtype=np.int64)
        h_parts.append((off, stride, np.where(flip, tj, ti),
                        np.where(flip, ti, tj), f * Q + 2 * p + flip))
        twin_pairs.append((col[k], ti, col[l], tj,
                           *(torch.from_numpy(np.ascontiguousarray(a))
                             .to(device) for a in (off, stride, flip))))
    g_parts = []
    twin_vecs = []
    for i, k in enumerate(live):
        td = int(tdims[k])
        q = 2 * npairs + i
        tab_a[q], tab_b[q] = col[k], res_col
        vo = np.asarray(vec_offs[k], dtype=np.int64)
        g_parts.append((vo, np.ones(F, np.int64), np.full(F, td, np.int64),
                        np.ones(F, np.int64), f * Q + q))
        twin_vecs.append((col[k], td, torch.from_numpy(vo).to(device)))

    def cat(parts, i):
        return np.concatenate([pt[i] for pt in parts]) if parts else \
            np.zeros(0, np.int64)

    hess = _segments(*(cat(h_parts, i) for i in range(5)), rdim, device)
    grad = _segments(*(cat(g_parts, i) for i in range(5)), rdim, device)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    short, long = _entries(hess, grad, F * rdim * tdw * 8)
    return FamilyAssembly(rdim=rdim, tdw=tdw, Q=Q, tab_a=t(tab_a),
                          tab_b=t(tab_b), hess=hess, grad=grad,
                          short_entries=short, long_entries=long,
                          pairs=twin_pairs, vecs=twin_vecs)
