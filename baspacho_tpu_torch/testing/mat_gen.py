"""Synthetic block-sparsity generators for tests and benchmarks.

Capability parity with the reference generators
(upstream BaSpaCho: testing/TestingMatGen.{h,cpp}): flat random,
banded grid, meridian (pole-connected tracks) topologies and a prepended
Schur-eliminable set. Implemented with NumPy vectorized sampling; seeds
give deterministic structures (distributions differ from the C++ RNG, the
topology family is the contract).
"""

from __future__ import annotations

from typing import List, Set

import numpy as np

from .utils import columns_to_lower_csr


class SparseMatGenerator:
    """Holds lower-half columns-of-row-sets under construction."""

    def __init__(self, size: int, seed: int = 37):
        self.rng = np.random.RandomState(seed)
        self.columns: List[Set[int]] = [{i} for i in range(size)]

    @property
    def size(self) -> int:
        return len(self.columns)

    def to_structure(self):
        return columns_to_lower_csr(self.columns)

    def connect_ranges(self, begin1: int, end1: int, begin2: int, end2: int,
                       fill: float, max_offset: int = 2**62) -> None:
        """Connect i in [begin1,end1) to j in [begin2,end2) for j in
        (i, i+max_offset), each with probability `fill`."""
        if begin1 > begin2:
            begin1, end1, begin2, end2 = begin2, end2, begin1, end1
        if end1 > end2:
            self.connect_ranges(begin2, end2, end2, end1, fill, max_offset)
            end1 = end2
        for i in range(begin1, end1):
            d_begin = min(max_offset, max(begin2 - i, 1))
            d_end = min(max_offset, end2 - i)
            if d_end <= d_begin:
                continue
            js = np.arange(i + d_begin, i + d_end)
            if fill < 1.0:
                js = js[self.rng.rand(len(js)) < fill]
            self.columns[i].update(js.tolist())

    def add_sparse_connections(self, fill: float) -> None:
        self.connect_ranges(0, self.size, 0, self.size, fill)

    def add_schur_set(self, size: int, fill: float) -> None:
        """Prepend `size` independent params, each connected to random
        existing params — the Schur-eliminable set (e.g. BA landmarks)."""
        old = self.columns
        n_old = len(old)
        new_cols: List[Set[int]] = [set() for _ in range(size + n_old)]
        for i in range(size):
            new_cols[i].add(i)
            mask = self.rng.rand(n_old) < fill if fill < 1.0 else \
                np.ones(n_old, dtype=bool)
            new_cols[i].update((size + np.nonzero(mask)[0]).tolist())
        for i in range(n_old):
            new_cols[i + size].update(j + size for j in old[i])
        self.columns = new_cols

    @staticmethod
    def gen_flat(size: int, fill: float, seed: int = 37) -> "SparseMatGenerator":
        g = SparseMatGenerator(size, seed)
        g.connect_ranges(0, size, 0, size, fill)
        return g

    @staticmethod
    def gen_line(size: int, fill: float, band_size: int,
                 seed: int = 37) -> "SparseMatGenerator":
        g = SparseMatGenerator(size, seed)
        g.connect_ranges(0, size, 0, size, fill, band_size)
        return g

    @staticmethod
    def gen_grid(width: int, height: int, fill: float, conn_max_dist: int = 1,
                 seed: int = 37) -> "SparseMatGenerator":
        g = SparseMatGenerator(width * height, seed)
        for i in range(width):
            i2b, i2e = max(i - conn_max_dist, 0), min(i + conn_max_dist + 1, width)
            for j in range(height):
                j2b = max(j - conn_max_dist, 0)
                j2e = min(j + conn_max_dist + 1, height)
                off = i * height + j
                block = np.arange(i2b, i2e)[:, None] * height + \
                    np.arange(j2b, j2e)[None, :]
                block = block.ravel()
                block = block[block != off]
                if fill < 1.0:
                    block = block[g.rng.rand(len(block)) < fill]
                for off2 in block.tolist():
                    g.columns[min(off, off2)].add(max(off, off2))
        return g

    @staticmethod
    def gen_meridians(num: int, line_len: int, fill: float, band_size: int,
                      hair_len: int, n_pole_hairs: int, s_pole_hairs: int,
                      seed: int = 37) -> "SparseMatGenerator":
        """Tracks (meridians) joined at two poles, with extra 'hair' tracks:
        a SLAM-like topology stressing long chains plus dense pole coupling."""
        tot_hairs = n_pole_hairs + s_pole_hairs
        size = line_len * num + hair_len * tot_hairs
        end_meridians = line_len * num
        assert band_size <= line_len and band_size <= hair_len
        g = SparseMatGenerator(size, seed)
        for i in range(num):
            b = line_len * i
            g.connect_ranges(b, b + line_len, b, b + line_len, fill, band_size)
        for h in range(tot_hairs):
            b = end_meridians + hair_len * h
            g.connect_ranges(b, b + hair_len, b, b + hair_len, fill, band_size)
        for i in range(num):
            ib = line_len * i
            for j in range(i):
                jb = line_len * j
                g.connect_ranges(ib, ib + band_size, jb, jb + band_size,
                                 fill, band_size)
                g.connect_ranges(ib + line_len - band_size, ib + line_len,
                                 jb + line_len - band_size, jb + line_len,
                                 fill, band_size)
        for i in range(num):
            ib = line_len * i
            for h in range(n_pole_hairs):
                hb = end_meridians + hair_len * h
                g.connect_ranges(ib, ib + band_size, hb, hb + band_size,
                                 fill, band_size)
            for h in range(s_pole_hairs):
                hb = end_meridians + hair_len * (h + n_pole_hairs)
                g.connect_ranges(ib + line_len - band_size, ib + line_len,
                                 hb, hb + band_size, fill, band_size)
        for h in range(n_pole_hairs):
            hb = end_meridians + hair_len * h
            for k in range(h):
                kb = end_meridians + hair_len * k
                g.connect_ranges(kb, kb + band_size, hb, hb + band_size,
                                 fill, band_size)
        for h in range(s_pole_hairs):
            hb = end_meridians + hair_len * (h + n_pole_hairs)
            for k in range(h):
                kb = end_meridians + hair_len * (k + n_pole_hairs)
                g.connect_ranges(kb, kb + band_size, hb, hb + band_size,
                                 fill, band_size)
        return g
