"""The system under test, as the benchmark drives it: the port's analysis,
its PLANNED factor and solve programs, its accessor (where the user's
blocks and vector entries live in its buffers) and its launch counters.
The only module of the benchmark that imports the port.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

import baspacho_tpu_torch as port
from baspacho_tpu_torch.ops import kernels

from .reference.inputs import Inputs
from .reference.pattern import Pattern


def analyse(pat: Pattern, device):
    """create_solver on the pattern: points (or nothing) in a sparse
    elimination range, PLANNED."""
    ranges = [0, pat.elim_end] if pat.elim_end else []
    return port.create_solver(
        port.Settings(backend=port.BackendType.PLANNED), pat.sizes,
        port.SparseStructure(pat.ptrs, pat.inds), sparse_elim_ranges=ranges,
        device=device)


def build_programs(solver) -> None:
    """The schedules and device programs of the full-range factor and
    solve (built lazily by the port, so built here, in set-up)."""
    solver.factor_program()
    solver.solve_program()


def launches() -> int:
    """__global__ launches of the port's kernels so far."""
    return sum(c.grid_launches for c in kernels.COUNTS.values())


def kernel_names() -> frozenset:
    """The names of the port's own CUDA kernels (its __global__
    functions), as a trace's short names give them."""
    found = set()
    for name in kernels.SOURCES + kernels.HEADERS:
        with open(os.path.join(kernels.CSRC, name)) as f:
            found |= set(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                r"(\w+)\s*\(", f.read()))
    return frozenset(found)


def _scatter_blocks(held: torch.Tensor, off, stride, flip,
                    vals: torch.Tensor) -> None:
    dev = held.device
    n, sr, sc = vals.shape[1:]
    off = torch.as_tensor(np.asarray(off, np.int64), device=dev)
    stride = torch.as_tensor(np.broadcast_to(np.asarray(stride, np.int64),
                                             (n,)).copy(), device=dev)
    flip = torch.as_tensor(np.broadcast_to(np.asarray(flip, bool),
                                           (n,)).copy(), device=dev)
    i = torch.arange(sr, device=dev)[None, :, None]
    j = torch.arange(sc, device=dev)[None, None, :]
    st = stride[:, None, None]
    idx = off[:, None, None] + torch.where(flip[:, None, None],
                                           j * st + i, i * st + j)
    held[:, idx.reshape(-1)] = vals.reshape(vals.shape[0], -1) \
        .to(held.dtype)


def pack(solver, pat: Pattern, inp: Inputs, dtype) -> tuple:
    """The inputs in the solver's layout: the (batch, data_size) matrix
    buffer, padding and fill zero, and the scalar map `vperm` (user scalar
    i lives at vperm[i] of the solver's vectors)."""
    acc = solver.accessor()
    held = torch.zeros(inp.batch, solver.data_size, dtype=dtype,
                       device=solver.device)
    for b in inp.diag:
        off, stride = acc.diag_block_offset(b.rows.cpu().numpy())
        _scatter_blocks(held, off, stride, False, b.vals)
    for b in inp.off:
        off, stride, flip = acc.block_offsets(b.rows.cpu().numpy(),
                                              b.cols.cpu().numpy())
        _scatter_blocks(held, off, stride, flip, b.vals)
    start = np.asarray(acc.param_start(np.arange(pat.n)), np.int64)
    vperm = np.repeat(start - pat.offsets, pat.sizes) + \
        np.arange(pat.order, dtype=np.int64)
    return held, torch.as_tensor(vperm, device=solver.device)


def damp_indices(solver) -> torch.Tensor:
    """Where the diagonal scalars live in the matrix buffer."""
    return torch.as_tensor(solver.skel.damp_indices(), device=solver.device)


def lump_shapes(solver) -> tuple:
    """Width and real (unpadded) below rows of every lump of the
    factor's skeleton."""
    sk = solver.skel
    return np.diff(sk.lump_start), np.asarray(sk.below_rows)
