"""Block-level sparse structure (CSR/CSC of *blocks*, not scalars).

TPU-native counterpart of the reference's SparseStructure
(upstream BaSpaCho: baspacho/SparseStructure.{h,cpp}). All operations
here are host-side symbolic analysis, run once per sparsity pattern; they
are written with vectorized NumPy (counting sorts, bucketed pair
enumeration) rather than element loops, so large bundle-adjustment patterns
(hundreds of thousands of blocks) stay fast on the host.

Semantics notes (shared with the reference so behavior matches):
  * `ptrs/inds` is CSR: inds[ptrs[i]:ptrs[i+1]] are the column ids of row i.
    For a symmetric matrix we usually store the lower half in CSR form
    (equivalently the upper half in CSC form).
  * `fill_reducing_permutation` returns `perm` with perm[i] = the old index
    that moves to position i.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .utils import cum_sum_vec


def _csr_from_pairs(rows: np.ndarray, cols: np.ndarray, order: int,
                    dedup: bool = True, sort: bool = True) -> "SparseStructure":
    """Build CSR structure from (row, col) index pairs via counting sort."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    from . import native
    fast = native.try_pairs_to_csr(rows, cols, order, dedup, sort or dedup)
    if fast is not None:
        return SparseStructure(fast[0], fast[1])
    if dedup or sort:
        key = rows * np.int64(order) + cols
        if dedup:
            key = np.unique(key)
        else:
            key.sort(kind="stable")
        rows = key // order
        cols = key % order
    else:
        # group by row (stable: preserves within-row entry order)
        order_idx = np.argsort(rows, kind="stable")
        rows = rows[order_idx]
        cols = cols[order_idx]
    counts = np.bincount(rows, minlength=order)
    ptrs = cum_sum_vec(counts)
    return SparseStructure(ptrs, cols)


@dataclass
class SparseStructure:
    ptrs: np.ndarray  # int64, length order+1
    inds: np.ndarray  # int64

    def __init__(self, ptrs, inds):
        self.ptrs = np.ascontiguousarray(ptrs, dtype=np.int64)
        self.inds = np.ascontiguousarray(inds, dtype=np.int64)

    @property
    def order(self) -> int:
        return len(self.ptrs) - 1

    def row_lengths(self) -> np.ndarray:
        return self.ptrs[1:] - self.ptrs[:-1]

    def expanded_rows(self) -> np.ndarray:
        """Row index of every entry (COO expansion of the CSR rows)."""
        return np.repeat(np.arange(self.order, dtype=np.int64), self.row_lengths())

    def sort_indices(self) -> "SparseStructure":
        return _csr_from_pairs(self.expanded_rows(), self.inds, self.order,
                               dedup=False, sort=True)

    def transpose(self) -> "SparseStructure":
        """Swap rows and columns; output rows are in input-row order (stable)."""
        from . import native
        fast = native.try_transpose(self.ptrs, self.inds)
        if fast is not None:
            return SparseStructure(fast[0], fast[1])
        rows = self.expanded_rows()
        # stable counting sort by column gives transposed rows sorted per row
        perm = np.argsort(self.inds, kind="stable")
        counts = np.bincount(self.inds, minlength=self.order)
        return SparseStructure(cum_sum_vec(counts), rows[perm])

    def clear(self, clear_lower: bool = True) -> "SparseStructure":
        """Drop strictly-lower (or strictly-upper) entries; keep diagonal."""
        rows = self.expanded_rows()
        if clear_lower:
            keep = self.inds >= rows
        else:
            keep = self.inds <= rows
        counts = np.bincount(rows[keep], minlength=self.order)
        return SparseStructure(cum_sum_vec(counts), self.inds[keep])

    def symmetric_permutation(self, map_perm, lower_half: bool = True,
                              sort_indices: bool = True) -> "SparseStructure":
        """Relabel node i as map_perm[i]; fold each entry into the requested
        half (row>=col if lower_half). Assumes only one half is stored."""
        map_perm = np.asarray(map_perm, dtype=np.int64)
        assert len(map_perm) == self.order
        from . import native
        fast = native.try_sym_perm(self.ptrs, self.inds, map_perm,
                                   lower_half, sort_indices)
        if fast is not None:
            return SparseStructure(fast[0], fast[1])
        new_r = map_perm[self.expanded_rows()]
        new_c = map_perm[self.inds]
        if lower_half:
            rows, cols = np.maximum(new_r, new_c), np.minimum(new_r, new_c)
        else:
            rows, cols = np.minimum(new_r, new_c), np.maximum(new_r, new_c)
        # NOTE: reference does not dedup here (duplicate inputs stay), but all
        # our call sites have unique entries; dedup=False keeps parity.
        return _csr_from_pairs(rows, cols, self.order, dedup=False,
                               sort=sort_indices)

    def add_independent_elimination_fill(self, elim_start: int, elim_end: int,
                                         sort_idx: bool = True) -> "SparseStructure":
        """Fill resulting from eliminating the independent range [start, end).

        Assumes lower-half CSR. Eliminating block-column i connects every
        pair of rows that share an entry in column i: for each i in range,
        with R_i = {rows k > i that reference i}, add entries (max, min)
        over all pairs of R_i. Only rows >= elim_end gain entries (the range
        is independent, so R_i contains no in-range rows besides... in
        general entries with target row < elim_end are filtered like the
        reference, which only processes rows >= elim_end).

        Matches reference SparseStructure.cpp:161-222 behavior, re-expressed
        as bucketed all-pairs enumeration instead of per-row tag walks.
        """
        ord_ = self.order
        if elim_end == ord_:
            return self

        from . import native
        fast = native.try_indep_elim_fill(self.ptrs, self.inds,
                                          elim_start, elim_end)
        if fast is not None:
            return SparseStructure(fast[0], fast[1])

        rows_all = self.expanded_rows()
        cols_all = self.inds

        # column lists of the elim range: entries (k, i) with i in range, k > i
        in_range = (cols_all >= elim_start) & (cols_all < elim_end) & \
                   (rows_all > cols_all)
        er, ec = rows_all[in_range], cols_all[in_range]
        # bucket columns by #rows and enumerate pairs within each column
        pair_rows = [rows_all, np.arange(ord_, dtype=np.int64)]
        pair_cols = [cols_all, np.arange(ord_, dtype=np.int64)]
        if len(ec):
            sort_ord = np.argsort(ec, kind="stable")
            er_s = er[sort_ord]
            counts = np.bincount(ec - elim_start, minlength=elim_end - elim_start)
            offsets = cum_sum_vec(counts)
            nbs = counts[counts > 1]
            col_of = np.nonzero(counts > 1)[0]
            starts = offsets[:-1][counts > 1]
            for nb in np.unique(nbs):
                sel = nbs == nb
                st = starts[sel]
                # gather row lists -> (G, nb)
                gather = st[:, None] + np.arange(nb, dtype=np.int64)[None, :]
                rl = er_s[gather]
                iu, ju = np.triu_indices(nb, k=1)
                a = rl[:, iu].ravel()
                b = rl[:, ju].ravel()
                hi = np.maximum(a, b)
                lo = np.minimum(a, b)
                keep = hi >= elim_end  # rows < elim_end keep original pattern
                pair_rows.append(hi[keep])
                pair_cols.append(lo[keep])

        rows_cat = np.concatenate(pair_rows)
        cols_cat = np.concatenate(pair_cols)
        result = _csr_from_pairs(rows_cat, cols_cat, ord_, dedup=True, sort=True)
        if not sort_idx:
            return result  # already sorted; flag kept for API parity
        return result

    def add_full_elimination_fill(self) -> "SparseStructure":
        """Full symbolic Cholesky fill (lower CSR in, lower CSR out).

        Row k of the result is the set of etree nodes reachable from entries
        of A(k, 0:k) without passing through nodes >= k — the classic
        LDL/SimplicialCholesky row-pattern algorithm (reference
        SparseStructure.cpp:224-293). Sequential by nature; kept as a tight
        Python loop over rows with C-speed inner ops where possible (a C++
        fast path is provided by baspacho_tpu.native when built).
        """
        from . import native  # local import to avoid cycles

        fast = native.try_full_elim_fill(self.ptrs, self.inds)
        if fast is not None:
            return SparseStructure(fast[0], fast[1])

        ord_ = self.order
        parent = np.full(ord_, -1, dtype=np.int64)
        tags = np.full(ord_, -1, dtype=np.int64)
        ptrs, inds = self.ptrs, self.inds
        out_rows: list[np.ndarray] = []
        for k in range(ord_):
            tags[k] = k
            row = [k]
            for i in inds[ptrs[k]:ptrs[k + 1]]:
                if i >= k:
                    continue
                i = int(i)
                while tags[i] != k:
                    if parent[i] == -1:
                        parent[i] = k
                    row.append(i)
                    tags[i] = k
                    i = int(parent[i])
            r = np.array(row, dtype=np.int64)
            r.sort()
            out_rows.append(r)
        counts = np.array([len(r) for r in out_rows], dtype=np.int64)
        return SparseStructure(cum_sum_vec(counts), np.concatenate(out_rows))

    def fill_reducing_permutation(self) -> np.ndarray:
        """AMD-style fill-reducing ordering of the block graph.

        Returns perm with perm[i] = old index moving to position i (same
        convention as reference SparseStructure.cpp:295-332).
        """
        from . import native
        from .ordering import minimum_degree_ordering

        fast = native.try_amd_order(self.ptrs, self.inds)
        if fast is not None:
            return fast
        return minimum_degree_ordering(self.ptrs, self.inds)

    def rcm_permutation(self) -> np.ndarray:
        """Reverse Cuthill-McKee ordering of the symmetrized block graph:
        bandwidth-minimizing and LOCALITY-PRESERVING — graph neighbors
        stay adjacent in index space. Used for the bottom system when a
        given sparse elimination range's columns have locality worth
        keeping (see create_solver); AMD would scramble it.

        Returns perm with perm[i] = old index moving to position i.
        """
        n = self.order
        rows = self.expanded_rows()
        cols = self.inds
        offd = rows != cols
        r = np.concatenate([rows[offd], cols[offd]])
        c = np.concatenate([cols[offd], rows[offd]])
        order_idx = np.argsort(r, kind="stable")
        r, c = r[order_idx], c[order_idx]
        deg = np.bincount(r, minlength=n)
        adj_ptr = cum_sum_vec(deg)
        perm = np.empty(n, dtype=np.int64)
        visited = np.zeros(n, dtype=bool)
        out = 0
        # process components: BFS from a minimal-degree unvisited node,
        # queueing each level's neighbors by increasing degree
        deg_order = np.argsort(deg, kind="stable")
        seed_pos = 0
        while out < n:
            while visited[deg_order[seed_pos]]:
                seed_pos += 1
            start = int(deg_order[seed_pos])
            visited[start] = True
            frontier = [start]
            while frontier:
                perm[out:out + len(frontier)] = frontier
                out += len(frontier)
                nxt = []
                for v in frontier:
                    nb = c[adj_ptr[v]:adj_ptr[v + 1]]
                    nb = nb[~visited[nb]]
                    if len(nb):
                        nb = np.unique(nb)
                        nb = nb[~visited[nb]]
                        nb = nb[np.argsort(deg[nb], kind="stable")]
                        visited[nb] = True
                        nxt.extend(nb.tolist())
                frontier = nxt
        return perm[::-1].copy()

    def extract_right_bottom(self, start: int) -> "SparseStructure":
        """Sub-structure of rows/cols >= start, reindexed from 0."""
        ord_ = self.order
        assert 0 <= start <= ord_
        rows = self.expanded_rows()
        keep = (rows >= start) & (self.inds >= start)
        return _csr_from_pairs(rows[keep] - start, self.inds[keep] - start,
                               ord_ - start, dedup=False, sort=False)
