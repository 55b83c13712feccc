"""Fill-reducing ordering (pure-Python fallback).

Quotient-graph minimum-degree with element absorption — the same family of
algorithm as the AMD ordering the reference uses via Eigen/SuiteSparse
(SparseStructure.cpp:295-332). The C++ implementation in
native/symbolic.cpp (approximate minimum degree) is preferred when built;
this fallback is exact-external-degree minimum degree, deterministic, and
fast enough for problems up to a few tens of thousands of block-columns.

Returns perm with perm[i] = old index that moves to position i.
"""

from __future__ import annotations

import heapq

import numpy as np


def minimum_degree_ordering(ptrs: np.ndarray, inds: np.ndarray) -> np.ndarray:
    n = len(ptrs) - 1
    if n == 0:
        return np.empty(0, dtype=np.int64)

    # symmetrized adjacency (no self loops), as python sets
    adj = [set() for _ in range(n)]
    for i in range(n):
        for j in inds[ptrs[i]:ptrs[i + 1]]:
            j = int(j)
            if j != i:
                adj[i].add(j)
                adj[j].add(i)

    # quotient graph: eliminated pivots become "elements"; each remaining
    # variable tracks plain neighbors (adj) and adjacent elements (elems)
    elems = [set() for _ in range(n)]   # elements adjacent to variable
    evars: dict[int, set] = {}          # element -> boundary variable set
    alive = np.ones(n, dtype=bool)
    degree = np.array([len(a) for a in adj], dtype=np.int64)

    heap = [(int(degree[v]), v) for v in range(n)]
    heapq.heapify(heap)
    stamp = np.zeros(n, dtype=np.int64)  # version for lazy heap entries
    version = np.zeros(n, dtype=np.int64)

    perm = np.empty(n, dtype=np.int64)
    pos = 0
    while heap:
        d, p = heapq.heappop(heap)
        if not alive[p] or stamp[p] != version[p] or d != degree[p]:
            continue
        alive[p] = False
        perm[pos] = p
        pos += 1

        # pivot's boundary: plain neighbors plus union of adjacent elements
        boundary = set(adj[p])
        for e in elems[p]:
            boundary |= evars[e]
        boundary.discard(p)
        boundary = {v for v in boundary if alive[v]}

        # absorb adjacent elements into new element p
        for e in list(elems[p]):
            for v in evars[e]:
                elems[v].discard(e)
            del evars[e]
        evars[p] = boundary

        for v in boundary:
            adj[v] -= boundary
            adj[v].discard(p)
            elems[v].add(p)
            # exact external degree
            dset = set(adj[v])
            for e in elems[v]:
                dset |= evars[e]
            dset.discard(v)
            degree[v] = len(dset)
            version[v] += 1
            stamp[v] = version[v]
            heapq.heappush(heap, (int(degree[v]), v))

    assert pos == n
    return perm
