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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

LONG_SEG = 32  # segments with more records than this get a CTA each


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
    long: torch.Tensor    # ids of the others
    max_rc_long: int      # the largest rows + cols among the long ones
    elements: int         # output elements the segments cover
    macs: int             # multiply-adds the records need


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
    # the same contributions in the JAX package's form, for the plain
    # twin: (column of slot k, ti, column of slot l, tj, off, stride,
    # flip) per pair and (column, td, vec_off) per live slot
    pairs: List[tuple]
    vecs: List[tuple]


def _segments(off, stride, rows, cols, rec, rdim: int, device) -> Segments:
    """Sorts the records by destination (stable: the order they were
    given in stays within a block) and cuts them into segments."""
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
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        a, dtype=np.int64)).to(device)
    return Segments(
        off=dev(off[starts]), stride=dev(stride[starts]), rows=dev(s_rows),
        cols=dev(s_cols), ptr=dev(ptr), rec=dev(rec),
        short=dev(np.flatnonzero(~is_long)), long=dev(np.flatnonzero(is_long)),
        max_rc_long=int((s_rows + s_cols)[is_long].max(initial=0)),
        elements=int((s_rows * s_cols).sum()),
        macs=int((rows * cols).sum()) * rdim)


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
    return FamilyAssembly(rdim=rdim, tdw=tdw, Q=Q, tab_a=t(tab_a),
                          tab_b=t(tab_b), hess=hess, grad=grad,
                          pairs=twin_pairs, vecs=twin_vecs)
