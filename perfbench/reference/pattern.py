"""The block pattern of a configuration's matrix, in the user's parameter
numbering: what the benchmark hands the program (as a lower-half CSR of
parameters) and what it fills with values.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Pattern:
    sizes: np.ndarray      # (n,) scalars of each parameter
    ptrs: np.ndarray       # (n + 1,) lower-half CSR by row, diagonal included
    inds: np.ndarray       # column of each entry, ascending within a row
    elim_end: int          # parameters [0, elim_end) form a sparse
    #                        elimination range (0: none)

    @property
    def n(self) -> int:
        return len(self.sizes)

    @property
    def order(self) -> int:
        return int(self.sizes.sum())

    @property
    def offsets(self) -> np.ndarray:
        """First scalar row of each parameter."""
        return np.concatenate([[0], np.cumsum(self.sizes)[:-1]]) \
            .astype(np.int64)

    def off_diagonal(self) -> tuple:
        """(row, col) parameter pairs of the strictly lower blocks."""
        rows = np.repeat(np.arange(self.n, dtype=np.int64),
                         np.diff(self.ptrs))
        keep = self.inds < rows
        return rows[keep], self.inds[keep]


def lower_pattern(sizes, rows, cols, elim_end: int) -> Pattern:
    """The pattern of the (row, col) pairs, row >= col, deduplicated,
    with every diagonal block added."""
    sizes = np.asarray(sizes, dtype=np.int64)
    n = len(sizes)
    rows = np.concatenate([np.asarray(rows, np.int64),
                           np.arange(n, dtype=np.int64)])
    cols = np.concatenate([np.asarray(cols, np.int64),
                           np.arange(n, dtype=np.int64)])
    if np.any(rows < cols):
        raise ValueError("lower_pattern takes pairs with row >= col")
    key = np.unique(rows * np.int64(n) + cols)
    rows, cols = key // n, key % n
    ptrs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=ptrs[1:])
    return Pattern(sizes=sizes, ptrs=ptrs, inds=cols, elim_end=elim_end)
