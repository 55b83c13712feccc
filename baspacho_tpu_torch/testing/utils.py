"""Test helpers: random structure generation and naive O(n^3) oracles.

Counterpart of the reference testing layer
(upstream BaSpaCho: testing/TestingUtils.{h,cpp}): columns-of-sets
representation for readability, naive elimination-fill oracles used to
cross-check the production symbolic algorithms, and random SPD data
generators for the factor/solve oracle tests.
"""

from __future__ import annotations

from typing import List, Set

import numpy as np

from ..sparse_structure import SparseStructure
from ..utils import cum_sum_vec


def random_cols(n: int, fill: float, seed: int) -> List[Set[int]]:
    """Random lower-half columns: column j always holds j, plus rows > j
    with probability `fill`."""
    rng = np.random.RandomState(seed)
    cols = []
    for j in range(n):
        rows = {j}
        mask = rng.rand(n - j - 1) < fill
        rows.update((j + 1 + np.nonzero(mask)[0]).tolist())
        cols.append(rows)
    return cols


def columns_to_lower_csr(columns: List[Set[int]]) -> SparseStructure:
    """Columns-of-row-sets (lower half) -> lower-half CSR structure."""
    n = len(columns)
    rows_list: List[np.ndarray] = [np.empty(0, dtype=np.int64)] * 0
    pair_r = []
    pair_c = []
    for j, rows in enumerate(columns):
        r = np.fromiter(rows, dtype=np.int64)
        pair_r.append(r)
        pair_c.append(np.full(len(r), j, dtype=np.int64))
    rr = np.concatenate(pair_r) if pair_r else np.empty(0, dtype=np.int64)
    cc = np.concatenate(pair_c) if pair_c else np.empty(0, dtype=np.int64)
    key = rr * n + cc
    key = np.unique(key)
    rr, cc = key // n, key % n
    counts = np.bincount(rr, minlength=n)
    return SparseStructure(cum_sum_vec(counts), cc)


def csr_to_columns(ss: SparseStructure) -> List[Set[int]]:
    """Lower-half CSR -> columns-of-row-sets."""
    n = ss.order
    cols: List[Set[int]] = [set() for _ in range(n)]
    rows = ss.expanded_rows()
    for r, c in zip(rows.tolist(), ss.inds.tolist()):
        cols[c].add(r)
    return cols


def naive_independent_elim_fill(columns: List[Set[int]], start: int,
                                end: int) -> List[Set[int]]:
    """Oracle: eliminate each column in [start,end) independently; every
    pair of its below-diagonal rows becomes connected."""
    cols = [set(c) for c in columns]
    for i in range(start, end):
        rows = sorted(r for r in columns[i] if r > i)
        for a_idx in range(len(rows)):
            for b_idx in range(a_idx + 1, len(rows)):
                a, b = rows[a_idx], rows[b_idx]
                if b >= end:  # rows inside the range keep their pattern
                    cols[a].add(b)
    return cols


def naive_full_elim_fill(columns: List[Set[int]]) -> List[Set[int]]:
    """Oracle: full symbolic Cholesky by sequential elimination."""
    cols = [set(c) for c in columns]
    n = len(cols)
    for i in range(n):
        rows = sorted(r for r in cols[i] if r > i)
        for a_idx in range(len(rows)):
            for b_idx in range(a_idx + 1, len(rows)):
                cols[rows[a_idx]].add(rows[b_idx])
    return cols


def make_independent_elim_set(columns: List[Set[int]], start: int,
                              max_size: int) -> int:
    """Greedily reshape columns so [start, end) is an independent elim set,
    returning end. Columns in the set drop mutual connections."""
    n = len(columns)
    end = start
    while end < n and end - start < max_size:
        columns[end] = {r for r in columns[end] if r == end or r >= start + max_size}
        end += 1
    return end


def random_spd_data(data_size: int, order: int, seed: int,
                    dtype=np.float64) -> np.ndarray:
    """Random factor-layout data made SPD-safe by later damping; values in
    [-1, 1]. Caller typically applies skel.damp(data, 0, order * 1.5)."""
    rng = np.random.RandomState(seed)
    return (rng.rand(data_size).astype(dtype) * 2.0 - 1.0)


def print_pattern(ss, width: int = 80) -> str:
    """ASCII rendering of a block sparsity pattern (reference
    TestingUtils.cpp printPattern): '#' stored, '.' empty."""
    n = ss.order
    dense = np.zeros((n, n), dtype=bool)
    dense[ss.expanded_rows(), ss.inds] = True
    lines = []
    for r in range(min(n, width)):
        lines.append("".join("#" if dense[r, c] else "."
                             for c in range(min(n, width))))
    return "\n".join(lines)


def print_aggreg_pattern(skel, width: int = 80) -> str:
    """ASCII rendering of a factor skeleton at span granularity with lump
    boundaries marked '|' (reference printAggreg)."""
    n = skel.num_spans
    present = np.zeros((n, n), dtype=bool)
    for l in range(skel.num_lumps):
        s0 = int(skel.lump_to_span[l])
        for ci in range(int(skel.chain_col_ptr[l]),
                        int(skel.chain_col_ptr[l + 1])):
            r = int(skel.chain_row_span[ci])
            for s in range(s0, int(skel.lump_to_span[l + 1])):
                present[r, s] = True
    bounds = set(int(x) for x in skel.lump_to_span)
    lines = []
    for r in range(min(n, width)):
        row = []
        for c in range(min(n, width)):
            row.append("|" if c in bounds and c == r else
                       ("#" if present[r, c] else "."))
        lines.append("".join(row))
    return "\n".join(lines)
