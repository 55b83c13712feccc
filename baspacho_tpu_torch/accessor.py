"""Block accessors: locate (row-span, col-span) blocks in flat factor data.

Counterpart of upstream BaSpaCho: baspacho/Accessor.h. Two flavors:

  * `CoalescedAccessor` — works in internal (post-reordering) span ids.
  * `PermutedCoalescedAccessor` — works in the user's original parameter
    ids, applying the solver's reordering; when the permutation swaps the
    pair's order the block is the transpose of the stored one (`flip`).

Besides scalar lookups, both provide **vectorized** index computation
(`block_offsets` on arrays of pairs) returning (offset, stride, flip)
arrays — these feed jit-ready gather/scatter index plans, e.g. assembling
a Hessian from factor-graph edges in one `.at[].add`, which replaces the
reference's per-block device loops and its atomic-locked CPU accumulation
(deterministic by construction under XLA).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class CoalescedAccessor:
    def __init__(self, skel):
        self.skel = skel
        self._chain_keys = None

    def _keys(self) -> np.ndarray:
        """Global sorted chain key (lump_of_chain * num_spans + row_span):
        ascending in chain storage order, so ONE searchsorted resolves any
        (col lump, row span) to its chain — no per-element bisect loops."""
        if self._chain_keys is None:
            sk = self.skel
            chain_lump = np.repeat(
                np.arange(sk.num_lumps, dtype=np.int64),
                sk.chain_col_ptr[1:] - sk.chain_col_ptr[:-1])
            self._chain_keys = (chain_lump * sk.num_spans +
                                sk.chain_row_span)
        return self._chain_keys

    def param_size(self, span) -> np.ndarray:
        s = self.skel.span_start
        return s[np.asarray(span) + 1] - s[np.asarray(span)]

    def param_start(self, span) -> np.ndarray:
        return self.skel.span_start[np.asarray(span)]

    def block_offsets(self, row_span, col_span) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized: (offset, stride) of blocks (row_span, col_span).
        Requires row_span >= col_span elementwise (lower half)."""
        sk = self.skel
        row_span = np.asarray(row_span, dtype=np.int64)
        col_span = np.asarray(col_span, dtype=np.int64)
        assert np.all(row_span >= col_span)
        lump = sk.span_to_lump[col_span]
        lump_size = sk.col_stride[lump]
        off_in_lump = sk.span_offset_in_lump[col_span]
        rs = np.atleast_1d(row_span)
        pos = np.searchsorted(self._keys(),
                              np.atleast_1d(lump) * sk.num_spans + rs)
        assert np.all(sk.chain_row_span[pos] == rs), \
            "block not present in factor"
        offs = sk.chain_data[pos] + np.atleast_1d(off_in_lump)
        strides = np.atleast_1d(lump_size)
        if np.isscalar(row_span) or row_span.ndim == 0:
            return int(offs[0]), int(strides[0])
        return offs, strides

    def block_offset(self, row_span: int, col_span: int) -> Tuple[int, int]:
        return self.block_offsets(int(row_span), int(col_span))

    def diag_block_offset(self, span) -> Tuple[np.ndarray, np.ndarray]:
        sk = self.skel
        span_arr = np.asarray(span, dtype=np.int64)
        lump = sk.span_to_lump[span_arr]
        lump_size = sk.col_stride[lump]
        off_in_lump = sk.span_offset_in_lump[span_arr]
        base = sk.panel_base[lump]
        off = base + off_in_lump * (1 + lump_size)
        if np.isscalar(span) or span_arr.ndim == 0:
            return int(off), int(lump_size)
        return off, lump_size

    def block(self, data, row_span: int, col_span: int) -> np.ndarray:
        """Read a block out of flat data (numpy or jax array) as 2-D."""
        off, stride = self.block_offset(row_span, col_span)
        rs = int(self.param_size(row_span))
        cs = int(self.param_size(col_span))
        idx = off + np.arange(rs)[:, None] * stride + np.arange(cs)[None, :]
        return data[idx]

    def diag_block(self, data, span: int) -> np.ndarray:
        off, stride = self.diag_block_offset(span)
        n = int(self.param_size(span))
        idx = off + np.arange(n)[:, None] * stride + np.arange(n)[None, :]
        return data[idx]


class PermutedCoalescedAccessor:
    def __init__(self, skel, permutation):
        """permutation[user_param] = internal span index."""
        self.plain = CoalescedAccessor(skel)
        self.perm = np.asarray(permutation, dtype=np.int64)

    def param_size(self, index) -> np.ndarray:
        return self.plain.param_size(self.perm[np.asarray(index)])

    def param_start(self, index) -> np.ndarray:
        return self.plain.param_start(self.perm[np.asarray(index)])

    def block_offsets(self, row_index, col_index):
        """Vectorized (offset, stride, flip) for user-indexed block pairs."""
        row_arr = np.asarray(row_index, dtype=np.int64)
        if row_arr.ndim == 1 and len(row_arr) > 4096:
            # C++ fast path: one pass, per-lump binary search, no
            # temporaries (the dominant cost of optimizer assembly-plan
            # construction at BAL scale)
            from . import native
            sk = self.plain.skel
            fast = native.try_perm_block_offsets(
                row_arr, np.asarray(col_index, dtype=np.int64), self.perm,
                sk.span_to_lump, sk.col_stride, sk.span_offset_in_lump,
                sk.chain_col_ptr, sk.chain_row_span, sk.chain_data)
            if fast is not None:
                return fast
        pr = self.perm[row_arr]
        pc = self.perm[np.asarray(col_index, dtype=np.int64)]
        hi, lo = np.maximum(pr, pc), np.minimum(pr, pc)
        off, stride = self.plain.block_offsets(hi, lo)
        flip = pr < pc
        return off, stride, flip

    def block_offset(self, row_index: int, col_index: int):
        off, stride, flip = self.block_offsets(int(row_index), int(col_index))
        return off, stride, bool(flip)

    def diag_block_offset(self, index):
        return self.plain.diag_block_offset(self.perm[np.asarray(index)])

    def block(self, data, row_index: int, col_index: int) -> np.ndarray:
        off, stride, flip = self.block_offset(row_index, col_index)
        rs = int(self.param_size(row_index))
        cs = int(self.param_size(col_index))
        if not flip:
            idx = off + np.arange(rs)[:, None] * stride + np.arange(cs)[None, :]
        else:  # stored transposed: result[i, j] = stored[j, i]
            idx = off + np.arange(cs)[None, :] * stride + np.arange(rs)[:, None]
        return data[idx]

    def diag_block(self, data, index: int) -> np.ndarray:
        return self.plain.diag_block(data, int(self.perm[index]))
