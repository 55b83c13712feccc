"""The least work of a factor and of a solve, counted from the factor's
skeleton, and the least time it could take on a card.

Counts use each lump's real width n and real below rows r, never the
padded panels or a kernel's arguments, so every implementation of the
same factorization reads the same work. Operations are those of a
textbook Cholesky, each multiply-subtract counted as 2, each division
and square root as 1:
  factor, per lump: potrf sum_{s=1..n} s^2, trsm n^2 r, update n r (r+1)
  (together sum_{m=r+1..r+n} m^2, the scalar columns' (c + 1)^2 for c
  entries below each diagonal);
  solve, per pass and right-hand side: 2 nnz(L) - order.
Bytes: a factor reads and writes each stored element of L once
(nnz(L) = sum n (n + 1) / 2 + n r); a solve reads L once and each
right-hand side in and out. The stored inverse that PLANNED also
computes is not counted. Everything is multiplied by the batch.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "peaks.json")


@dataclass
class Work:
    flops: float
    bytes: float


def nnz_l(n: np.ndarray, r: np.ndarray) -> int:
    n, r = np.asarray(n, np.int64), np.asarray(r, np.int64)
    return int(np.sum(n * (n + 1) // 2 + n * r))


def factor_work(n, r, batch: int, itemsize: int) -> Work:
    n, r = np.asarray(n, np.int64), np.asarray(r, np.int64)
    potrf = n * (n + 1) * (2 * n + 1) // 6
    flops = int(np.sum(potrf + n * n * r + n * r * (r + 1)))
    return Work(float(flops * batch),
                float(2 * nnz_l(n, r) * itemsize * batch))


def solve_work(n, r, nrhs: int, batch: int, itemsize: int) -> Work:
    order = int(np.sum(n))
    nnz = nnz_l(n, r)
    flops = 2 * (2 * nnz - order) * nrhs
    return Work(float(flops * batch),
                float((nnz + 2 * order * nrhs) * itemsize * batch))


def peaks(kind: str, dtype: str):
    """(FLOP/s, bytes/s) of the card named `kind` in `dtype`, from
    peaks.json; None for a card the table does not hold."""
    with open(PEAKS_FILE) as f:
        table = json.load(f)["cards"]
    card = table.get(kind)
    if card is None or dtype not in card["flops"]:
        return None
    return card["flops"][dtype], card["bytes_per_s"]


def least_seconds(w: Work, peak) -> float:
    """The larger of operations / peak FLOP/s and bytes / peak bytes/s."""
    return max(w.flops / peak[0], w.bytes / peak[1])
