"""The port's hand-written CUDA kernels, their plain twins and their
launch counters.

  K1 bucket_factor       csrc/bucket_factor.cu       panels cp <= 512
  K1-wide wide_factor    csrc/wide_factor.cu         panels cp > 512
  K2 segmented_subtract  csrc/segmented_subtract.cu
  K3 bucket_solve        csrc/bucket_solve.cu        panels cp <= 512
  K3-wide wide_solve     csrc/wide_solve.cu          panels cp > 512
  K4 dense_update        csrc/dense_level.cu         dense levels
  K3-rest tri_solve      csrc/tri_solve.cu           panels cp <= 512, by
                                                     substitution (partial
                                                     ranges)
  K3-rest wide_tri_solve csrc/tri_solve.cu           panels cp > 512
  K5 add_mv              csrc/add_mv.cu              panels cp <= 512
  K5 wide_add_mv         csrc/add_mv.cu              panels cp > 512
  K6 grad_hess           csrc/grad_hess.cu           the LM optimizer's
                                                     gradient / Hessian
                                                     assembly

Each wrapper takes the same arguments on either device. For a tensor on
the CPU it runs the plain PyTorch twin beside it; for a CUDA tensor it
launches the kernel or raises — there is no fallback. The kernels are
compiled for sm_90a with nvcc (one process per source, in parallel) and
linked into one plain-C shared library at first use (`build/` at the
repository root), bound with ctypes.

Data conventions (all tensors contiguous):
  data  (batch, data_size)   flat padded factor buffer, updated in place
  prod  (batch, P)           one level's products x . x^T
  vv    (batch, order, nrhs) RHS / solution, updated in place
  y     (batch, Y, nrhs)     one solve level's below products below . x
Index arrays are int64 tensors on the data's device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from .schedule import NARROW_MAX

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build")
SOURCES = ("bucket_factor.cu", "segmented_subtract.cu", "bucket_solve.cu",
           "wide_factor.cu", "wide_solve.cu", "dense_level.cu",
           "tri_solve.cu", "add_mv.cu", "grad_hess.cu")
# shared headers: warp_tiles.cuh (K1, K1-wide, K3, K3-rest, K4, K5),
# level_solve.cuh (K3, K3-rest narrow)
HEADERS = ("warp_tiles.cuh", "level_solve.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
WIDE_TILE = 128  # diagonal tile of the blocked wide factor (csrc/wide_factor.cu)


@dataclass
class LaunchCount:
    launches: int = 0    # wrapper calls that launched the kernel
    grid_launches: int = 0  # __global__ launches among them (K1 launches
    #                         up to three grids per call, K1-wide three
    #                         per diagonal tile but the last)
    twin_calls: int = 0  # calls of the plain twin (any device)


COUNTS = {name: LaunchCount() for name in (
    "bucket_factor", "wide_factor", "segmented_subtract", "bucket_solve",
    "wide_solve", "dense_update", "tri_solve", "wide_tri_solve", "add_mv",
    "wide_add_mv", "grad_hess")}


def reset_counts() -> None:
    for c in COUNTS.values():
        c.launches = 0
        c.grid_launches = 0
        c.twin_calls = 0


# ----------------------------------------------------------------------
# build and bind
# ----------------------------------------------------------------------
_lib_handle: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path() -> str:
    """Path of the shared library for the current sources (content-hashed,
    so an edited source never loads a stale build)."""
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libbaspacho_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds):
    """Runs the commands in parallel; raises with the output of the first
    that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [(p.communicate()[0], p.returncode) for p in procs]
    for cmd, (out, rc) in zip(cmds, outs):
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")


def build() -> str:
    """Compile the kernels if the library for these sources is missing
    (one nvcc per source, all at once, then one link); returns its path.
    Raises with nvcc's output when the build fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.path.basename(so)[:-3]}.{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, f"{tag}.{s[:-3]}.o") for s in SOURCES]
    nvcc = _nvcc()
    _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(CSRC, s)]
              for s, o in zip(SOURCES, objs)])
    tmp = f"{so}.{os.getpid()}.tmp"
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
    for o in objs:
        os.remove(o)
    os.replace(tmp, so)
    return so


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(build())
        i64, i32, vp = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
        f64 = ctypes.c_double
        sigs = {
            "bs_bucket_factor": [i32, vp, i64, vp, i64, i64, vp, vp, vp, i64,
                                 i32, i32, i32, vp],
            "bs_segmented_subtract": [i32, vp, vp, i64, vp, i64, vp, i32,
                                      i32, vp],
            "bs_bucket_solve": [i32, i32, vp, i64, vp, i64, vp, i64, i64, vp,
                                vp, vp, vp, vp, vp, i64, i64, i32, i32, i32,
                                i32, i32, i32, vp],
            "bs_wide_factor": [i32, vp, i64, vp, vp, vp, vp, i64, i32, i32,
                               i32, vp],
            "bs_wide_solve": [i32, i32, vp, i64, vp, i64, vp, i64, i64, vp,
                              vp, vp, vp, vp, vp, vp, i64, i64, i32, i32,
                              i32, i32, i32, i32, vp],
            "bs_dense_update": [i32, vp, i64, vp, i64, i32, vp, vp, vp, vp,
                                vp, vp, vp, i32, vp],
            "bs_dense_wide": [i32, vp, i64, i64, i64, i32, i64, vp, i64, vp,
                              vp, vp, vp, i32, vp],
            "bs_tri_solve": [i32, i32, vp, i64, vp, i64, vp, i64, i64, vp,
                             vp, vp, vp, vp, vp, i64, i64, i32, i32, i32,
                             i32, i32, i32, vp],
            "bs_tri_wide_solve": [i32, i32, vp, i64, vp, i64, vp, i64, i64,
                                  vp, vp, i64, vp, vp, vp, vp, vp, i64, i64,
                                  i32, i32, i32, i32, vp],
            "bs_add_mv": [i32, vp, i64, vp, i64, vp, i64, vp, i64, i64, vp,
                          vp, vp, vp, vp, vp, i64, i64, i32, i32, i32, i32,
                          i32, i32, i32, i32, f64, vp],
            "bs_grad_hess": [i32, vp, i64, i32, vp, vp, i64, vp, vp, i32, vp,
                             i32, vp],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.restype = i32
            fn.argtypes = args
        _lib_handle = lib
    return _lib_handle


_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def _check_cuda(name, floats, ints):
    dev = floats[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: tensors on {dev}, kernel needs CUDA")
    dt = floats[0].dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {dt} not supported "
                        "(float32 or float64)")
    for t in floats:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: float operands must be contiguous "
                             f"{dt} on {dev}")
    for t in ints:
        if t.device != dev or t.dtype != torch.int64 or \
                not t.is_contiguous():
            raise ValueError(f"{name}: index operands must be contiguous "
                             f"int64 on {dev}")


def _check_batch(name, *tensors):
    """The operands' leading (batch) dims must agree: a kernel runs its
    grid over the batch of the first operand and would read past the end
    of a shorter one."""
    sizes = [t.shape[0] for t in tensors if t is not None]
    if len(set(sizes)) > 1:
        raise ValueError(f"{name}: operands' batch sizes differ: {sizes}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


# ----------------------------------------------------------------------
# K1 bucket_factor
# ----------------------------------------------------------------------
def bucket_factor(data, prod, off, rows, cols, cp: int, rp: int,
                  prod_base: int) -> None:
    """Factor the bucket's panels in place in `data` (x = below . Linv^T
    overwrites the below rows) and, when rp > 0 and `prod` is given,
    write their products x . x^T into prod[:, prod_base:]. Dense levels
    pass prod None: their update reads x from the data (K4)."""
    with_prod = rp > 0 and prod is not None
    _check_batch("bucket_factor", data, prod if with_prod else None)
    if data.device.type == "cpu":
        return bucket_factor_twin(data, prod, off, rows, cols, cp, rp,
                                  prod_base)
    _check_cuda("bucket_factor", [data, prod] if with_prod else [data],
                [off, rows, cols])
    batch = data.shape[0]
    err = _lib().bs_bucket_factor(
        _DTYPE_CODE[data.dtype], data.data_ptr(), data.shape[1],
        prod.data_ptr() if with_prod else None,
        prod.shape[1] if with_prod else 0, prod_base, off.data_ptr(),
        rows.data_ptr(), cols.data_ptr(), off.shape[0], cp, rp, batch,
        _stream(data))
    COUNTS["bucket_factor"].launches += 1
    # chol (warp or block), then below when the panels have below rows,
    # then prod (warp or tile)
    COUNTS["bucket_factor"].grid_launches += 1 + (rp > 0) + with_prod
    _raise_on("bucket_factor", err)


def bucket_factor_twin(data, prod, off, rows, cols, cp: int, rp: int,
                       prod_base: int) -> None:
    """Plain twin of K1: PlannedBackend._factor_bucket in torch."""
    COUNTS["bucket_factor"].twin_calls += 1
    batch, B, h = data.shape[0], off.shape[0], cp + rp
    dt, dev = data.dtype, data.device
    idx = off[:, None] + torch.arange(h * cp, device=dev)
    panels = data[:, idx].view(batch, B, h, cp)
    ar = torch.arange(cp, device=dev)
    ii, jj = ar[:, None], ar[None, :]
    pad_eye = ((ii == jj) & (ii >= cols[:, None, None])).to(dt)  # (B,cp,cp)
    diag_in = panels[:, :, :cp] + pad_eye
    sym = torch.tril(diag_in) + torch.tril(diag_in, -1).mT
    L, info = torch.linalg.cholesky_ex(sym)
    # NaN where a panel is not positive definite, as the kernel's
    # sqrt / division and the JAX package's unrolled Cholesky give
    L = torch.where((info > 0)[..., None, None], torch.nan, L)
    eye = torch.eye(cp, dtype=dt, device=dev).expand_as(L)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    store = torch.where(ii >= jj, L - pad_eye, 0.0) + \
        torch.where(ii < jj, Linv.mT, 0.0)
    if rp > 0:
        x = torch.einsum("zbrk,zbjk->zbrj", panels[:, :, cp:], Linv)
        store = torch.cat([store, x], dim=2)
        if prod is not None:
            pr = torch.einsum("zbrk,zbsk->zbrs", x, x)
            prod[:, prod_base:prod_base + B * rp * rp] = \
                pr.reshape(batch, -1)
    data[:, idx] = store.reshape(batch, B, h * cp)


# ----------------------------------------------------------------------
# K1-wide wide_factor
# ----------------------------------------------------------------------
def wide_factor(data, off, rows, cols, cp: int, rp: int, off_h,
                cols_h) -> None:
    """Blocked factor of a bucket of wide panels (cp > 512, a multiple of
    WIDE_TILE), in place in the layout bucket_factor writes: L on and
    below the diagonal, the full Linv^T strictly above, x = below . L^-T
    below; no product. On the card, one C call runs the whole schedule
    (csrc/wide_factor.cu: per diagonal tile a tile grid, a rows grid and,
    but after the last tile, an update grid, each over every panel and
    batch item), with each diagonal tile's dense Linv^T in a cached
    scratch. off_h / cols_h are host copies of off / cols (the twin's
    per-panel views need them)."""
    if data.device.type == "cpu":
        return wide_factor_twin(data, off, rows, cols, cp, rp, off_h,
                                cols_h)
    _check_cuda("wide_factor", [data], [off, rows, cols])
    nb = WIDE_TILE
    if cp % nb or cp <= NARROW_MAX:
        raise ValueError(f"wide_factor: cp {cp} is not a multiple of {nb} "
                         f"above {NARROW_MAX}")
    batch, B = data.shape[0], off.shape[0]
    xk = _scratch(data, 2 * batch * B * nb * nb)
    err = _lib().bs_wide_factor(
        _DTYPE_CODE[data.dtype], data.data_ptr(), data.shape[1],
        xk.data_ptr(), off.data_ptr(), rows.data_ptr(), cols.data_ptr(), B,
        cp, rp, batch, _stream(data))
    COUNTS["wide_factor"].launches += 1
    COUNTS["wide_factor"].grid_launches += 3 * (cp // nb) - 1
    _raise_on("wide_factor", err)


def wide_factor_twin(data, off, rows, cols, cp: int, rp: int, off_h,
                     cols_h) -> None:
    """Plain twin of K1-wide: the blocked schedule with the diagonal
    tile's factor and inverse, the rows below it and the embedded
    inverse in plain torch."""
    COUNTS["wide_factor"].twin_calls += 1
    _blocked_factor(data, off, rows, cols, cp, rp, off_h, cols_h)


def _panel_view(data, o: int, cp: int, r: int, c: int, nr: int, nc: int):
    """(batch, nr, nc) view of a panel at flat offset o (row stride cp)
    from row r, column c; rows >= cp run into the below block."""
    return data.as_strided((data.shape[0], nr, nc), (data.stride(0), cp, 1),
                           data.storage_offset() + o + r * cp + c)


def _blocked_factor(data, off, rows, cols, cp, rp, off_h, cols_h):
    """Right-looking blocked Cholesky (PlannedBackend._blocked_factor) and
    blocked inverse (_blocked_lower_inv), embedded as _embed_inv does, in
    plain torch: the twin's schedule (the kernels' is csrc/wide_factor.cu).

    Per diagonal tile k (WIDE_TILE wide): `tile` factors and inverts it,
    `trsm` multiplies the rows below it by the tile's inverse, and one
    matrix product per panel and batch item updates the trailing
    diagonal and below rows. Then the block rows of Linv^T are swept
    with two products each in a scratch Xt (its diagonal tiles written
    by `tile`), and `embed` copies Xt's strict upper into the panels."""
    nb, steps = WIDE_TILE, _WideTwinSteps
    if cp % nb:
        raise ValueError(f"wide_factor: cp {cp} is not a multiple of {nb}")
    batch = data.shape[0]
    xt = data.new_zeros((batch, len(off_h), cp, cp))
    for k0 in range(0, cp, nb):
        k1 = k0 + nb
        steps.tile(data, xt, off, cols, cp, k0, off_h, cols_h)
        if cp + rp > k1:
            steps.trsm(data, xt, off, rows, cols, cp, rp, k0, off_h,
                       cols_h)
        if cp > k1:
            for o in off_h:
                x = _panel_view(data, o, cp, k1, k0, cp + rp - k1, nb)
                c = _panel_view(data, o, cp, k1, k1, cp + rp - k1, cp - k1)
                for z in range(batch):
                    c[z].addmm_(x[z], x[z, :cp - k1].mT, alpha=-1)
    for i, o in enumerate(off_h):
        for z in range(batch):
            X = xt[z, i]
            for r0 in range(nb, cp, nb):
                # Linv[r, :r] = -Dinv_r L[r, :r] Linv[:r, :r], transposed,
                # written in place by one product (beta 0: the block is
                # not read)
                st = torch.matmul(
                    X[:r0, :r0], _panel_view(data, o, cp, r0, 0, nb, r0)[z].mT)
                X[:r0, r0:r0 + nb].addmm_(st, X[r0:r0 + nb, r0:r0 + nb],
                                          beta=0, alpha=-1)
    steps.embed(data, xt, off, cp, off_h)


def _tile_linv(t: torch.Tensor, w: int) -> torch.Tensor:
    """Linv of a stored (.., w, w) diagonal tile: strict upper transposed
    and 1 / diagonal (PlannedBackend._tri_stored)."""
    ar = torch.arange(w, device=t.device)
    ii, jj = ar[:, None], ar[None, :]
    dinv = 1.0 / torch.diagonal(t, dim1=-2, dim2=-1)
    return torch.where(ii > jj, t.mT,
                       torch.where(ii == jj, dinv[..., :, None], 0.0))


class _WideTwinSteps:
    """The twin's diagonal tile, rows below it and embedded inverse."""

    @staticmethod
    def tile(data, xt, off, cols, cp, k0, off_h, cols_h):
        nb = WIDE_TILE
        for i, (o, n) in enumerate(zip(off_h, cols_h)):
            w = max(0, min(nb, n - k0))
            t = _panel_view(data, o, cp, k0, k0, nb, nb)
            new = torch.zeros_like(t)
            xt[:, i, k0:k0 + nb, k0:k0 + nb] = 0
            if w:
                a = t[:, :w, :w]
                L, info = torch.linalg.cholesky_ex(torch.tril(a) +
                                                   torch.tril(a, -1).mT)
                L = torch.where((info > 0)[..., None, None], torch.nan, L)
                eye = torch.eye(w, dtype=t.dtype, device=t.device)
                linv = torch.linalg.solve_triangular(
                    L, eye.expand_as(L), upper=False)
                new[:, :w, :w] = torch.tril(L) + torch.triu(linv.mT, 1)
                xt[:, i, k0:k0 + w, k0:k0 + w] = torch.triu(linv.mT)
            t.copy_(new)

    @staticmethod
    def trsm(data, xt, off, rows, cols, cp, rp, k0, off_h, cols_h):
        nb = WIDE_TILE
        k1 = k0 + nb
        for o, n in zip(off_h, cols_h):
            w = max(0, min(nb, n - k0))
            if not w:
                continue
            linv = _tile_linv(_panel_view(data, o, cp, k0, k0, w, w), w)
            x = _panel_view(data, o, cp, k1, k0, cp + rp - k1, w)
            x.copy_(torch.matmul(x, linv.mT))

    @staticmethod
    def embed(data, xt, off, cp, off_h):
        upper = torch.ones(cp, cp, dtype=torch.bool,
                           device=data.device).triu(1)
        for i, o in enumerate(off_h):
            p = _panel_view(data, o, cp, 0, 0, cp, cp)
            p.copy_(torch.where(upper, xt[:, i], p))


# ----------------------------------------------------------------------
# K2 segmented_subtract
# ----------------------------------------------------------------------
SEG_SHORT = 32    # sources of a segment one thread sums at most
#                   (csrc/segmented_subtract.cu seg_short_kernel)
SEG_CHUNK = 1024  # sources of a longer segment's chunk at most: a CTA of
#                   256 threads, 4 each (seg_chunk_kernel, kChunk)
SEG_I32_SOURCES = 1 << 20  # sources from which a plan of short segments
#                            alone reads int32 indices (plans with chunks
#                            do at any size): below it int64 read faster
_I32_MAX = 2 ** 31 - 1


def seg_plan(tgt, seg_ptr, src_idx) -> dict:
    """K2's grids over one target-sorted CSR (host arrays), from the CSR
    alone, so that a batch item equals its single run and reruns each
    other: the short segments (at most SEG_SHORT sources, a thread each)
    as a CSR of their own (s_tgt, s_ptr, s_src); the longer ones cut into
    chunks of at most SEG_CHUNK sources, as equal as they come (chunk c:
    sources l_src[c_ptr[c]:c_ptr[c + 1]], into target row c_dst[c] >= 0
    or, for a segment of several chunks, partial slot -1 - c_dst[c]);
    and the segments of several chunks (p_tgt; their slots p_ptr[q] ..
    p_ptr[q + 1], in chunk order). Index arrays are int32 (`idx32`)
    where every value fits and the plan has chunks or SEG_I32_SOURCES
    sources or more, else int64: on an H100, int32 took BAL 871's L-pass
    scatter and its factor levels (3.9M-29M sources) 5 % and 23 % less
    time, int64 MERI's and GRID's factor levels (at most 128k sources,
    1-7 a segment) 3-7 % less (PERF.md, PR 12)."""
    tgt = np.asarray(tgt, dtype=np.int64)
    seg_ptr = np.asarray(seg_ptr, dtype=np.int64)
    src_idx = np.asarray(src_idx, dtype=np.int64)
    lens = np.diff(seg_ptr)
    short = lens <= SEG_SHORT
    in_short = np.repeat(short, lens)
    sid, lid = np.flatnonzero(short), np.flatnonzero(~short)
    llen = lens[lid]
    nck = -(-llen // SEG_CHUNK)
    lstart = np.cumsum(llen) - llen
    seg = np.repeat(np.arange(len(lid)), nck)
    k = np.arange(int(nck.sum())) - np.repeat(np.cumsum(nck) - nck, nck)
    c_beg = lstart[seg] + k * llen[seg] // nck[seg]
    multi = nck > 1
    slot = np.cumsum(multi[seg]) - 1
    c_dst = np.where(multi[seg], -1 - slot, tgt[lid][seg])
    plan = {"s_tgt": tgt[sid], "s_ptr": np.r_[0, np.cumsum(lens[sid])],
            "s_src": src_idx[in_short], "c_dst": c_dst,
            "c_ptr": np.r_[c_beg, llen.sum()], "l_src": src_idx[~in_short],
            "p_tgt": tgt[lid][multi], "p_ptr": np.r_[0, np.cumsum(nck[multi])]}
    top = max([int(a.max()) for a in plan.values() if a.size] +
              [len(src_idx)])
    idx32 = top <= _I32_MAX and int(c_dst.min(initial=0)) >= -_I32_MAX \
        and (len(c_dst) > 0 or len(src_idx) >= SEG_I32_SOURCES)
    dt = np.int32 if idx32 else np.int64
    plan = {key: a.astype(dt) for key, a in plan.items()}
    plan.update(idx32=idx32, n_slot=int(nck[multi].sum()))
    return plan


class _SegPlanC(ctypes.Structure):
    """csrc/segmented_subtract.cu SegPlan."""
    _fields_ = [(f, ctypes.c_void_p) for f in (
        "s_tgt", "s_ptr", "s_src", "c_dst", "c_ptr", "l_src", "p_tgt",
        "p_ptr")] + [(f, ctypes.c_int64) for f in (
            "n_short", "n_chunk", "n_post", "n_slot")] + \
        [("idx32", ctypes.c_int)]


class SegLayout:
    """seg_plan's arrays on a device, with the C struct that hands them to
    the kernels; built once per CSR (host arrays or tensors; the planned
    backend keeps one beside each level's DevCSR), so that a call reads
    nothing back to the host and checks nothing that depends only on the
    plan."""

    def __init__(self, tgt, seg_ptr, src_idx, device):
        plan = seg_plan(*(a.cpu().numpy() if isinstance(a, torch.Tensor)
                          else a for a in (tgt, seg_ptr, src_idx)))
        self.idx32, self.n_slot = plan.pop("idx32"), plan.pop("n_slot")
        self.arrays = {k: torch.from_numpy(a).to(device)
                       for k, a in plan.items()}
        self.n_short = len(plan["s_tgt"])
        self.n_chunk = len(plan["c_dst"])
        self.n_post = len(plan["p_tgt"])
        self.empty = self.n_short + self.n_chunk == 0
        self.c = _SegPlanC(
            **{k: a.data_ptr() if a.numel() else None
               for k, a in self.arrays.items()},
            n_short=self.n_short, n_chunk=self.n_chunk, n_post=self.n_post,
            n_slot=self.n_slot, idx32=int(self.idx32))
        self.addr = ctypes.addressof(self.c)

    @property
    def grids(self) -> int:
        """Grids a call launches: short, chunk, post where it has any."""
        return (self.n_short > 0) + (self.n_chunk > 0) + (self.n_post > 0)


def segmented_subtract(out, src, tgt, seg_ptr, src_idx, width: int,
                       layout: Optional[SegLayout] = None) -> None:
    """out[:, tgt[t]*width + k] -= sum over the t-th segment of
    src[:, src_idx[j]*width + k]; out and src are (batch, ...) buffers.
    On the card the kernel runs the CSR's SegLayout, built with the
    program (required there; the CPU twin needs none)."""
    _check_batch("segmented_subtract", out, src)
    if out.device.type == "cpu":
        return segmented_subtract_twin(out, src, tgt, seg_ptr, src_idx,
                                       width)
    if layout is None:
        _check_cuda("segmented_subtract", [out, src], [tgt, seg_ptr, src_idx])
        raise ValueError("segmented_subtract: no layout; build the CSR's "
                         "SegLayout once, with the program")
    if layout.empty:
        return
    if not (src.device == out.device and src.dtype == out.dtype and
            out.dtype in _DTYPE_CODE and out.is_contiguous() and
            src.is_contiguous()):
        _check_cuda("segmented_subtract", [out, src], [])
    batch = out.shape[0]
    part = _scratch(out, batch * layout.n_slot * width).data_ptr() \
        if layout.n_post else None
    err = _lib().bs_segmented_subtract(
        _DTYPE_CODE[out.dtype], layout.addr, out.data_ptr(), out.stride(0),
        src.data_ptr(), src.stride(0), part, width, batch, _stream(out))
    COUNTS["segmented_subtract"].launches += 1
    COUNTS["segmented_subtract"].grid_launches += layout.grids
    _raise_on("segmented_subtract", err)


def segmented_subtract_twin(out, src, tgt, seg_ptr, src_idx, width: int,
                            layout=None) -> None:
    """Plain twin of K2: a segment sum and an indexed subtraction (the
    layout, the kernel's, is not needed)."""
    COUNTS["segmented_subtract"].twin_calls += 1
    batch, n_tgt = out.shape[0], tgt.shape[0]
    o = out.view(batch, -1, width)
    s = src.reshape(batch, -1, width)
    seg = torch.repeat_interleave(
        torch.arange(n_tgt, device=out.device), seg_ptr.diff())
    sums = torch.zeros((batch, n_tgt, width), dtype=out.dtype,
                       device=out.device).index_add_(1, seg, s[:, src_idx])
    o[:, tgt] -= sums


# ----------------------------------------------------------------------
# K3 bucket_solve and K3-wide wide_solve
# ----------------------------------------------------------------------
def _check_solve(name, data, vv, y, rp, transpose):
    use_y = not transpose and rp > 0
    _check_batch(name, data, vv, y if use_y else None)
    if use_y and y.shape[2:] != vv.shape[2:]:
        raise ValueError(f"{name}: y has {y.shape[2:]} right-hand "
                         f"sides, vv {vv.shape[2:]}")
    return use_y


SOLVE_WARP_ELEMS = 1024   # below elements (rp x cp) of a panel one warp
#                           takes at most, 4 <= cp <= 32 (csrc/bucket_solve.cu
#                           solve_l_warp_kernel / solve_lt_warp_kernel)
SOLVE_WARP_PANELS = 256   # panels of a bucket one warp each at least:
#                           fewer get a CTA each (quicker there on an H100)
SOLVE_CHUNK_ELEMS = 8192  # below elements of one CTA's chunk of rows
SOLVE_MAX_CHUNK = 256     # below rows per chunk at most: 32 a warp


def solve_layout(cp: int, rp: int, B: int,
                 warp_panels: Optional[int] = None) -> tuple:
    """K3's grid for a bucket of B (cp, rp) panels, from the bucket's
    shape alone (so that batch items equal their single runs): (below
    rows per chunk, chunks per panel); 0 rows per chunk: one warp per
    panel, for buckets of warp_panels panels or more (SOLVE_WARP_PANELS
    by default). cp must be a power of two up to NARROW_MAX (the
    padding's)."""
    if cp < 1 or cp > NARROW_MAX or cp & (cp - 1):
        raise ValueError(f"bucket_solve: cp {cp} is not a power of two "
                         f"up to {NARROW_MAX}")
    if warp_panels is None:
        warp_panels = SOLVE_WARP_PANELS
    if 4 <= cp <= 32 and rp * cp <= SOLVE_WARP_ELEMS and B >= warp_panels:
        return 0, 1
    # a multiple of a CTA step's 8 (32 / G) rows, G = min(cp, 32)
    crc = min(SOLVE_MAX_CHUNK, max(8 * (32 // min(cp, 32)),
                                   SOLVE_CHUNK_ELEMS // cp))
    return crc, -(-rp // crc)


def bucket_solve(data, vv, y, y_base: int, off, rows, cols, vec_off,
                 below_idx, cp: int, rp: int, transpose: bool) -> None:
    """Stored-inverse diagonal solve of one bucket, in place in vv.
    L pass (transpose=False): vv[rows] = Linv . vv[rows] and, when rp > 0,
    y[:, y_base + b*rp + r] = (below . x)[b, r]. Lt pass: vv[rows] =
    Linv^T . (vv[rows] - below^T . vv[below_idx]). On the card
    (csrc/bucket_solve.cu): one warp per small panel, else a CTA per panel
    for its own rows and, past one chunk of below rows, a CTA per chunk
    of them (`solve_layout`), the Lt pass's chunk sums through a cached
    scratch."""
    use_y = _check_solve("bucket_solve", data, vv, y, rp, transpose)
    if data.device.type == "cpu":
        return bucket_solve_twin(data, vv, y, y_base, off, rows, cols,
                                 vec_off, below_idx, cp, rp, transpose)
    _check_cuda("bucket_solve", [data, vv, y] if use_y else [data, vv],
                [off, rows, cols, vec_off, below_idx])
    batch, order, nrhs = vv.shape
    B = off.shape[0]
    if batch * nrhs > 65535:
        raise ValueError(f"bucket_solve: batch x nrhs {batch * nrhs} "
                         "exceeds the grid's 65535")
    crc, nchunk = solve_layout(cp, rp, B)
    two = crc > 0 and nchunk > 1
    part = _scratch(vv, batch * nrhs * B * nchunk * cp).data_ptr() \
        if two and transpose else None
    err = _lib().bs_bucket_solve(
        _DTYPE_CODE[data.dtype], int(transpose), data.data_ptr(),
        data.shape[1], vv.data_ptr(), order * nrhs,
        y.data_ptr() if use_y else None, y[0].numel() if use_y else 0,
        y_base, part, off.data_ptr(), rows.data_ptr(),
        cols.data_ptr(), vec_off.data_ptr(), below_idx.data_ptr(), order, B,
        cp, rp, nrhs, batch, crc, nchunk, _stream(data))
    COUNTS["bucket_solve"].launches += 1
    # the warp grid, or the diag grid and, past one chunk, the rows grid
    COUNTS["bucket_solve"].grid_launches += 2 if two else 1
    _raise_on("bucket_solve", err)


WIDE_SOLVE_STRIP = 256  # K3-wide's Lt rows grid: columns of a CTA's strip
#                         (csrc/wide_solve.cu kStrip)
WIDE_SOLVE_CHUNK = 64   # its below rows per chunk (kChunk)


def wide_solve_layout(cp: int, rp: int) -> tuple:
    """K3-wide's grids for a bucket of (cp, rp) panels, from the shape
    alone (so that batch items equal their single runs): (the L pass's
    tile edge, the Lt pass's chunks of below rows per panel, at least
    one). BAL 871's buckets: cp 1024 -> 136 tiles a panel, 112 chunks x 4
    strips; cp 3072 -> 300 tiles, 64 chunks x 12 strips; cp 4096 -> 528
    tiles."""
    edge = 64 if cp <= 2048 else 128
    return edge, max(1, -(-rp // WIDE_SOLVE_CHUNK))


def wide_solve(data, vv, y, y_base: int, off, rows, cols, vec_off,
               below_idx, cp: int, rp: int, transpose: bool) -> None:
    """bucket_solve for wide panels (cp > 512): the same arguments and
    result, each pass's column sums spread over the card by blocks of
    rows, their partials added in block order by a post grid
    (csrc/wide_solve.cu; layout `wide_solve_layout`), through a cached
    scratch: the L pass by tiles of the stored triangle (then the below
    products, rp > 0), the Lt pass by chunks of below rows (a post past
    one chunk) and then a warp per row of the stored triangle."""
    use_y = _check_solve("wide_solve", data, vv, y, rp, transpose)
    if data.device.type == "cpu":
        return wide_solve_twin(data, vv, y, y_base, off, rows, cols,
                               vec_off, below_idx, cp, rp, transpose)
    _check_cuda("wide_solve", [data, vv, y] if use_y else [data, vv],
                [off, rows, cols, vec_off, below_idx])
    batch, order, nrhs = vv.shape
    B = off.shape[0]
    if batch > 65535:
        raise ValueError(f"wide_solve: batch {batch} exceeds the grid's "
                         "65535")
    edge, nchunk = wide_solve_layout(cp, rp)
    nt = batch * B * cp * nrhs
    blocks = -(-cp // edge) if not transpose else \
        (nchunk if nchunk > 1 else 0)
    buf = _scratch(vv, nt * (1 + blocks))
    err = _lib().bs_wide_solve(
        _DTYPE_CODE[data.dtype], int(transpose), data.data_ptr(),
        data.shape[1], vv.data_ptr(), order * nrhs,
        y.data_ptr() if use_y else None, y[0].numel() if use_y else 0,
        y_base * nrhs, buf.data_ptr(), buf[nt:].data_ptr() if blocks else
        None, off.data_ptr(), rows.data_ptr(), cols.data_ptr(),
        vec_off.data_ptr(), below_idx.data_ptr(), order, B, cp, rp, nrhs,
        batch, edge, nchunk, _stream(data))
    COUNTS["wide_solve"].launches += 1
    # L: tiles, post and, with below rows, their products; Lt: rows, the
    # post past one chunk, the triangle's rows
    COUNTS["wide_solve"].grid_launches += \
        2 + (rp > 0 if not transpose else nchunk > 1)
    _raise_on("wide_solve", err)


def _stored_linv(P, cols):
    """Linv from a stored diag block (PlannedBackend._tri_stored)."""
    cp, dev = P.shape[-1], P.device
    ar = torch.arange(cp, device=dev)
    ii, jj = ar[:, None], ar[None, :]
    d = torch.diagonal(P, dim1=-2, dim2=-1)
    dinv = torch.where(ar < cols[:, None], 1.0 / d, 1.0)
    return torch.where(ii > jj, P.mT,
                       torch.where(ii == jj, dinv[..., :, None], 0.0))


def _diag_solve_plain(data, vv, y, y_base: int, off, rows, cols, vec_off,
                      below_idx, cp: int, rp: int, transpose: bool) -> None:
    """PlannedBackend._diag_solve(use_inv=True) in torch, with the below
    scatter of the L pass left to K2."""
    batch, order, nrhs = vv.shape
    B, h, dev = off.shape[0], cp + rp, data.device
    idx = off[:, None] + torch.arange(h * cp, device=dev)
    panels = data[:, idx].view(batch, B, h, cp)
    Linv = _stored_linv(panels[:, :, :cp], cols)
    below = panels[:, :, cp:]
    xr = torch.arange(cp, device=dev)
    xidx = torch.where(xr < cols[:, None], vec_off[:, None] + xr, order)
    ext = torch.cat([vv, vv.new_zeros((batch, 1, nrhs))], dim=1)
    x = ext[:, xidx]  # (batch, B, cp, nrhs)
    if not transpose:
        x = torch.einsum("zbij,zbjn->zbin", Linv, x)
        if rp > 0:
            yb = torch.einsum("zbrk,zbkn->zbrn", below, x)
            y[:, y_base:y_base + B * rp] = yb.reshape(batch, B * rp, nrhs)
    else:
        if rp > 0:
            x = x - torch.einsum("zbrk,zbrn->zbkn", below,
                                 ext[:, below_idx])
        x = torch.einsum("zbji,zbjn->zbin", Linv, x)
    ext[:, xidx] = x
    vv.copy_(ext[:, :order])


def bucket_solve_twin(*args) -> None:
    """Plain twin of K3."""
    COUNTS["bucket_solve"].twin_calls += 1
    _diag_solve_plain(*args)


def wide_solve_twin(*args) -> None:
    """Plain twin of K3-wide (the same function as K3's)."""
    COUNTS["wide_solve"].twin_calls += 1
    _diag_solve_plain(*args)


# ----------------------------------------------------------------------
# K4 dense_update
# ----------------------------------------------------------------------
def dense_update(data, d) -> None:
    """Subtract a dense level's update from its target panels, in place:
    for every touched span-block (a, b), a >= b, sum over the origins o
    whose below rows hold both spans of x_o[a] . x_o[b]^T, in origin
    order. `d` is the level's DenseUpdate as device tensors
    (planned_backend.DevDense); x_o is read from the data, where the
    bucket factor left it. One launch per wide origin (its x x^T by
    tiles, csrc/dense_level.cu dense_wide_kernel), then one over d's
    destination-sorted records for the short destinations (a warp each)
    and one for the long ones (a CTA each)."""
    if data.device.type == "cpu":
        return dense_update_twin(data, d)
    _check_cuda("dense_update", [data],
                [d.rec, d.dst_off, d.dst_ld, d.dst_rows, d.dst_cols,
                 d.dst_ptr, d.dst_nk, d.dst_short, d.dst_long, d.w_tile,
                 d.w_rch, d.w_rin, d.w_pt, d.w_cld])
    lib, code, st = _lib(), _DTYPE_CODE[data.dtype], _stream(data)
    COUNTS["dense_update"].launches += 1
    batch = data.shape[0]

    def at(t, i):  # address of element i of an int64 tensor
        return t.data_ptr() + 8 * i

    for xoff, rows, n, ld, r0, p0, c0, t0, nt in d.wide:
        err = lib.bs_dense_wide(
            code, data.data_ptr(), data.shape[1], xoff, ld, n, rows,
            at(d.w_tile, t0), nt, at(d.w_rch, r0), at(d.w_rin, r0),
            at(d.w_pt, p0), at(d.w_cld, c0), batch, st)
        COUNTS["dense_update"].grid_launches += 1
        _raise_on("dense_update (wide)", err)
    for ids, long_mode in ((d.dst_short, 0), (d.dst_long, 1)):
        if ids.shape[0] == 0:
            continue
        err = lib.bs_dense_update(
            code, data.data_ptr(), data.shape[1], ids.data_ptr(),
            ids.shape[0], long_mode, d.rec.data_ptr(), d.dst_off.data_ptr(),
            d.dst_ld.data_ptr(), d.dst_rows.data_ptr(),
            d.dst_cols.data_ptr(), d.dst_ptr.data_ptr(),
            d.dst_nk.data_ptr(), batch, st)
        COUNTS["dense_update"].grid_launches += 1
        _raise_on("dense_update", err)


TWIN_CHUNK_ELEMS = 1 << 22  # product elements per chunk of the K4 twin


def dense_update_twin(data, d) -> None:
    """Plain twin of K4: the compact update U = sum_o x_o x_o^T built in
    chunks of origins (index_add of each chunk's products at compact
    rows), then U's lower span-blocks subtracted into the target slices.
    Memory: U is (R + 1)^2, a chunk TWIN_CHUNK_ELEMS products."""
    COUNTS["dense_update"].twin_calls += 1
    batch, R, dev = data.shape[0], d.R, data.device
    U = data.new_zeros((batch, (R + 1) * (R + 1)))
    n_rows = d.crow.shape[0]
    for cp, rp, first, end in d.groups:
        step = max(1, TWIN_CHUNK_ELEMS // (rp * rp))
        ar = torch.arange(rp, device=dev)
        for a in range(first, end, step):
            b = min(end, a + step)
            xo = d.org_xoff[a:b]
            X = data[:, xo[:, None] + torch.arange(rp * cp, device=dev)]
            X = X.view(batch, b - a, rp, cp)
            ri = d.org_rptr[a:b, None] + ar
            cr = torch.where(ar < d.org_rows[a:b, None],
                             d.crow[ri.clamp(max=n_rows - 1)], R)
            flat = cr[:, :, None] * (R + 1) + cr[:, None, :]
            U.index_add_(1, flat.reshape(-1),
                         torch.matmul(X, X.mT).reshape(batch, -1))
    S = d.sp_cs.shape[0]
    s_of = torch.repeat_interleave(torch.arange(S, device=dev),
                                   d.slice_ptr.diff())
    sb = d.sp_size[s_of]
    ne = d.sl_size * sb
    q = torch.repeat_interleave(torch.arange(len(ne), device=dev), ne)
    k = torch.arange(int(ne.sum()), device=dev) - \
        torch.repeat_interleave(torch.cumsum(ne, 0) - ne, ne)
    i, c = k // sb[q], k % sb[q]
    tgt = d.sl_off[q] + i * d.sp_ld[s_of[q]] + c
    src = (d.sl_cs[q] + i) * (R + 1) + d.sp_cs[s_of[q]] + c
    data[:, tgt] -= U[:, src]


# ----------------------------------------------------------------------
# K3-rest tri_solve and wide_tri_solve
# ----------------------------------------------------------------------
# K3-rest's warp grid takes a bucket of panels of at most TRI_WARP_CP
# columns and TRI_WARP_ROWS below rows whatever its panel count
TRI_WARP_CP, TRI_WARP_ROWS = 4, 64


def tri_layout(cp: int, rp: int, B: int) -> tuple:
    """K3-rest narrow's grid: K3's layout (`solve_layout`), but a bucket of
    cp-4 panels of at most 64 below rows takes the warp grid at any panel
    count: its chain of three steps on the lanes beats a CTA's barriers
    (tools/tri_layout_probe.py, PERF.md); with more rows one warp's y
    loop is the longer chain."""
    few = cp <= TRI_WARP_CP and rp <= TRI_WARP_ROWS
    return solve_layout(cp, rp, B, 1 if few else None)


def tri_solve(data, vv, y, y_base: int, off, rows, cols, vec_off,
              below_idx, cp: int, rp: int, transpose: bool) -> None:
    """Diagonal solve of one bucket by substitution on the lower triangle
    of each diag block (no stored inverse: partial-range solves, and
    pseudo-factored data), in place in vv, with bucket_solve's arguments
    and result: L pass vv[rows] = L^-1 vv[rows] and y = below . x; Lt
    pass vv[rows] = L^-T (vv[rows] - below^T vv[below_idx]). On the card
    (csrc/tri_solve.cu) the grids of K3 with the substitution in place of
    the inverse's product, in K3's layout (`tri_layout`): one warp per
    small panel, else a CTA per panel and, past one chunk of below rows,
    a CTA per chunk of them, the Lt pass's chunk sums through a cached
    scratch."""
    use_y = _check_solve("tri_solve", data, vv, y, rp, transpose)
    if data.device.type == "cpu":
        return tri_solve_twin(data, vv, y, y_base, off, rows, cols, vec_off,
                              below_idx, cp, rp, transpose)
    _check_cuda("tri_solve", [data, vv, y] if use_y else [data, vv],
                [off, rows, cols, vec_off, below_idx])
    batch, order, nrhs = vv.shape
    B = off.shape[0]
    if batch * nrhs > 65535:
        raise ValueError(f"tri_solve: batch x nrhs {batch * nrhs} exceeds "
                         "the grid's 65535")
    crc, nchunk = tri_layout(cp, rp, B)
    two = crc > 0 and nchunk > 1
    part = _scratch(vv, batch * nrhs * B * nchunk * cp).data_ptr() \
        if two and transpose else None
    err = _lib().bs_tri_solve(
        _DTYPE_CODE[data.dtype], int(transpose), data.data_ptr(),
        data.shape[1], vv.data_ptr(), order * nrhs,
        y.data_ptr() if use_y else None, y[0].numel() if use_y else 0,
        y_base, part, off.data_ptr(), rows.data_ptr(), cols.data_ptr(),
        vec_off.data_ptr(), below_idx.data_ptr(), order, B, cp, rp, nrhs,
        batch, crc, nchunk, _stream(data))
    COUNTS["tri_solve"].launches += 1
    # the warp grid, or the diag grid and, past one chunk, the rows grid
    COUNTS["tri_solve"].grid_launches += 2 if two else 1
    _raise_on("tri_solve", err)


def wide_tri_solve(data, vv, y, y_base: int, off, rows, cols, vec_off,
                   below_idx, cp: int, rp: int, transpose: bool, off_h,
                   cols_h) -> None:
    """tri_solve for wide panels (cp > 512, a multiple of WIDE_TILE), as
    PlannedBackend._big_panel_solve, in three launches from one host
    call: one gathers each panel's RHS rows into a (batch, B, cp, nrhs)
    scratch xs (Lt pass: minus below^T vv[below_idx]) and zeroes the
    flags; one persistent launch runs the chain of WIDE_TILE-wide tiles
    of every panel on the device (csrc/tri_solve.cu: tiles claimed by
    ticket in row order, each off-diagonal tile's product into a scratch
    slot of its own, each diagonal tile's solution published with a
    flag); the last writes the solution back and, in the L pass, y.
    off_h / cols_h are host copies of off / cols (unused here: the
    twin's signature)."""
    use_y = _check_solve("wide_tri_solve", data, vv, y, rp, transpose)
    if data.device.type == "cpu":
        return wide_tri_solve_twin(data, vv, y, y_base, off, rows, cols,
                                   vec_off, below_idx, cp, rp, transpose,
                                   off_h, cols_h)
    _check_cuda("wide_tri_solve", [data, vv, y] if use_y else [data, vv],
                [off, rows, cols, vec_off, below_idx])
    nb = WIDE_TILE
    if cp % nb:
        raise ValueError(f"wide_tri_solve: cp {cp} is not a multiple of "
                         f"{nb}")
    COUNTS["wide_tri_solve"].launches += 1
    batch, order, nrhs = vv.shape
    B = off.shape[0]
    K, P = cp // nb, B * batch
    # one float scratch (xs, xsol, the partial slots) and the flags
    nx = P * cp * nrhs
    scratch = _scratch(vv, 2 * nx + P * K * K * nb * nrhs)
    nflags = 1 + P * K * (K + 1)
    flags = _scratch(vv, nflags, torch.int32)
    err = _lib().bs_tri_wide_solve(
        _DTYPE_CODE[data.dtype], int(transpose), data.data_ptr(),
        data.shape[1], vv.data_ptr(), order * nrhs,
        y.data_ptr() if use_y else None, y[0].numel() if use_y else 0,
        y_base * nrhs, scratch.data_ptr(), flags.data_ptr(), nflags,
        off.data_ptr(), rows.data_ptr(), cols.data_ptr(), vec_off.data_ptr(),
        below_idx.data_ptr(), order, B, cp, rp, nrhs, batch, _stream(data))
    COUNTS["wide_tri_solve"].grid_launches += 3
    _raise_on("wide_tri_solve", err)


_SCRATCH = {}


def _scratch(like, n: int, dtype=None) -> torch.Tensor:
    """n elements of a work buffer kept per (device, dtype, stream) and
    grown as needed, so that a call allocates nothing: calls on one
    stream run in order, and no call reads what an earlier one left
    (K3-rest wide's pre kernel zeroes its flags; K5 writes every partial
    it reads; K1-wide's tiles write every Linv^T tile it reads; K3 and
    K3-wide write every partial and every t value they read)."""
    dtype = dtype or like.dtype
    key = (like.device, dtype, _stream(like))
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.empty(n, dtype=dtype, device=like.device)
        _SCRATCH[key] = buf
    return buf[:n]


def wide_tri_solve_twin(*args) -> None:
    """Plain twin of K3-rest wide (the same function as tri_solve's; the
    host copies off_h / cols_h are not needed)."""
    COUNTS["wide_tri_solve"].twin_calls += 1
    _tri_plain(*args[:12])


def _lower_masked(P, cols):
    """The diag blocks' lower triangles over their real columns, with
    identity on the padded ones (PlannedBackend._pad_eye); nothing above
    the diagonal or in the padding is read."""
    cp, dev = P.shape[-1], P.device
    ar = torch.arange(cp, device=dev)
    ii, jj = ar[:, None], ar[None, :]
    real = (ii < cols[:, None, None]) & (jj < cols[:, None, None])
    pad_eye = ((ii == jj) & (ii >= cols[:, None, None])).to(P.dtype)
    return torch.where(real & (ii >= jj), P, 0.0) + pad_eye


def _below_masked(below, rows, cols):
    """Below blocks with their padded rows and columns zeroed."""
    rp, cp, dev = below.shape[-2], below.shape[-1], below.device
    keep = (torch.arange(rp, device=dev)[:, None] < rows[:, None, None]) & \
        (torch.arange(cp, device=dev) < cols[:, None, None])
    return torch.where(keep, below, 0.0)


def _bucket_panels(data, off, cp, rp):
    batch, B, h = data.shape[0], off.shape[0], cp + rp
    idx = off[:, None] + torch.arange(h * cp, device=data.device)
    return data[:, idx].view(batch, B, h, cp)


def _tri_plain(data, vv, y, y_base: int, off, rows, cols, vec_off,
               below_idx, cp: int, rp: int, transpose: bool) -> None:
    """PlannedBackend._diag_solve(use_inv=False) in torch, with the below
    scatter of the L pass left to K2."""
    batch, order, nrhs = vv.shape
    B, dev = off.shape[0], data.device
    panels = _bucket_panels(data, off, cp, rp)
    L = _lower_masked(panels[:, :, :cp], cols)
    below = _below_masked(panels[:, :, cp:], rows, cols)
    xr = torch.arange(cp, device=dev)
    xidx = torch.where(xr < cols[:, None], vec_off[:, None] + xr, order)
    ext = torch.cat([vv, vv.new_zeros((batch, 1, nrhs))], dim=1)
    x = ext[:, xidx]  # (batch, B, cp, nrhs)
    if not transpose:
        x = torch.linalg.solve_triangular(L, x, upper=False)
        if rp > 0:
            yb = torch.einsum("zbrk,zbkn->zbrn", below, x)
            y[:, y_base:y_base + B * rp] = yb.reshape(batch, B * rp, nrhs)
    else:
        if rp > 0:
            x = x - torch.einsum("zbrk,zbrn->zbkn", below,
                                 ext[:, below_idx])
        x = torch.linalg.solve_triangular(L.mT, x, upper=True)
    ext[:, xidx] = x
    vv.copy_(ext[:, :order])


def tri_solve_twin(*args) -> None:
    """Plain twin of K3-rest."""
    COUNTS["tri_solve"].twin_calls += 1
    _tri_plain(*args)


# ----------------------------------------------------------------------
# K5 add_mv and wide_add_mv
# ----------------------------------------------------------------------
def _check_mv(name, data, x, out, y, rp):
    _check_batch(name, data, x, out, y if rp > 0 else None)
    if x.shape != out.shape:
        raise ValueError(f"{name}: x {tuple(x.shape)} and out "
                         f"{tuple(out.shape)} differ")
    if rp > 0 and y.shape[2:] != x.shape[2:]:
        raise ValueError(f"{name}: y has {y.shape[2:]} right-hand sides, "
                         f"x {x.shape[2:]}")


MV_WARP_ELEMS = 1024   # a panel of at most this many elements (4 <= cp <=
#                        32) is one warp's (csrc/add_mv.cu mv_warp_kernel)
MV_CHUNK_ELEMS = 8192  # elements of one CTA's chunk of rows x strip (wide
#                        panels: twice as many, to halve their partials)
MV_STRIP = 512         # the widest column strip of a CTA
MV_MAX_CHUNK = 256     # rows per chunk at most: 32 a warp


def mv_layout(cp: int, rp: int) -> tuple:
    """K5's grid for a bucket of (cp, rp) panels, from the shape alone (so
    that batch items equal their single runs): (strip width, rows per
    chunk, chunks per panel); 0 rows per chunk: one warp per panel."""
    h = cp + rp
    if 4 <= cp <= 32 and h * cp <= MV_WARP_ELEMS:
        return cp, 0, 1
    W = min(cp, MV_STRIP)
    elems = MV_CHUNK_ELEMS * (2 if cp > MV_STRIP else 1)
    # a multiple of 32 (the post reads 32 columns' partials as one list)
    # and of a CTA step's 8 (32 / W) rows
    crc = min(MV_MAX_CHUNK, max(32, 8 * (32 // min(W, 32)), elems // W))
    return W, crc, -(-h // crc)


def _mv_launch(name, data, x, out, y, y_base, off, rows, cols, vec_off,
               below_idx, cp, rp, alpha, wide: bool) -> None:
    _check_cuda(name, [data, x, out, y] if rp > 0 else [data, x, out],
                [off, rows, cols, vec_off, below_idx])
    batch, order, nrhs = x.shape
    B = off.shape[0]
    if batch * nrhs > 65535:
        raise ValueError(f"{name}: batch x nrhs {batch * nrhs} exceeds the "
                         "grid's 65535")
    W, crc, nchunk = mv_layout(cp, rp)
    nstrip = -(-cp // W)
    post = crc > 0 and (nchunk > 1 or nstrip > 1)
    part = _scratch(x, batch * nrhs * B * (nchunk * cp + nstrip * (cp + rp))
                    ).data_ptr() if post else None
    err = _lib().bs_add_mv(
        _DTYPE_CODE[data.dtype], data.data_ptr(), data.shape[1],
        x.data_ptr(), order * nrhs, out.data_ptr(), order * nrhs,
        y.data_ptr() if rp > 0 else None, y[0].numel() if rp > 0 else 0,
        y_base, part, off.data_ptr(), rows.data_ptr(), cols.data_ptr(),
        vec_off.data_ptr(), below_idx.data_ptr(), order, B, cp, rp, nrhs,
        batch, W, crc, nchunk, int(wide), float(alpha), _stream(data))
    COUNTS[name].launches += 1
    COUNTS[name].grid_launches += 2 if post else 1
    _raise_on(name, err)


def add_mv(data, x, out, y, y_base: int, off, rows, cols, vec_off,
           below_idx, cp: int, rp: int, alpha: float) -> None:
    """Block mat-vec of one bucket: out[own rows] += alpha (sym(lower(
    diag)) x_own + below^T x[below_idx]) in place, and, when rp > 0,
    y[:, y_base + b*rp + r] = -alpha (below . x_own)[b, r] for K2 to
    subtract into out[below_idx] once every bucket has run. On the card
    (csrc/add_mv.cu): one warp per panel for small panels (cp <= 32),
    else CTAs over chunks of rows, each element read once for both
    terms, partial sums through a cached scratch (`mv_layout`)."""
    _check_mv("add_mv", data, x, out, y, rp)
    if data.device.type == "cpu":
        return add_mv_twin(data, x, out, y, y_base, off, rows, cols,
                           vec_off, below_idx, cp, rp, alpha)
    _mv_launch("add_mv", data, x, out, y, y_base, off, rows, cols, vec_off,
               below_idx, cp, rp, alpha, False)


def wide_add_mv(data, x, out, y, y_base: int, off, rows, cols, vec_off,
                below_idx, cp: int, rp: int, alpha: float) -> None:
    """add_mv for wide panels (cp > 512): the narrow grid over 512-wide
    column strips (the lower triangle's strips above a chunk of own rows
    skipped), then a pass that sums each row's strip and chunk partials
    in a fixed order."""
    _check_mv("wide_add_mv", data, x, out, y, rp)
    if data.device.type == "cpu":
        return wide_add_mv_twin(data, x, out, y, y_base, off, rows, cols,
                                vec_off, below_idx, cp, rp, alpha)
    if cp <= MV_STRIP:
        raise ValueError(f"wide_add_mv: cp {cp} is narrow (<= {MV_STRIP})")
    _mv_launch("wide_add_mv", data, x, out, y, y_base, off, rows, cols,
               vec_off, below_idx, cp, rp, alpha, True)


def _add_mv_plain(data, x, out, y, y_base: int, off, rows, cols, vec_off,
                  below_idx, cp: int, rp: int, alpha: float) -> None:
    """PlannedBackend.make_add_mv's per-bucket step in torch, with the
    below scatter left to K2 (through y)."""
    batch, order, nrhs = x.shape
    B, dev = off.shape[0], data.device
    panels = _bucket_panels(data, off, cp, rp)
    lower = _lower_masked(panels[:, :, :cp], cols)
    ar = torch.arange(cp, device=dev)
    lower = torch.where(ar[:, None] < cols[:, None, None], lower, 0.0)
    sym = lower + torch.tril(lower, -1).mT
    xidx = torch.where(ar < cols[:, None], vec_off[:, None] + ar, order)
    xe = torch.cat([x, x.new_zeros((batch, 1, nrhs))], dim=1)
    xl = xe[:, xidx]
    contrib = torch.einsum("zbij,zbjn->zbin", sym, xl)
    if rp > 0:
        below = _below_masked(panels[:, :, cp:], rows, cols)
        contrib = contrib + torch.einsum("zbrk,zbrn->zbkn", below,
                                         xe[:, below_idx])
        yb = torch.einsum("zbrk,zbkn->zbrn", below, xl)
        y[:, y_base:y_base + B * rp] = -alpha * yb.reshape(batch, B * rp,
                                                           nrhs)
    oe = torch.cat([out, out.new_zeros((batch, 1, nrhs))], dim=1)
    oe[:, xidx] += alpha * contrib
    out.copy_(oe[:, :order])


def add_mv_twin(*args) -> None:
    """Plain twin of K5."""
    COUNTS["add_mv"].twin_calls += 1
    _add_mv_plain(*args)


def wide_add_mv_twin(*args) -> None:
    """Plain twin of K5 wide (the same function as add_mv's)."""
    COUNTS["wide_add_mv"].twin_calls += 1
    _add_mv_plain(*args)


# ----------------------------------------------------------------------
# K6 grad_hess
# ----------------------------------------------------------------------
def grad_hess(W, hdata, grad, plan) -> None:
    """Adds one factor family's contributions into the Hessian data and
    the gradient, in place: per factor f, J_k^T J_l of every pair of its
    live slots into hdata (transposed where the block is stored so) and
    J_k^T r into grad. W is the family's (F, rdim, tdw) buffer of
    weighted Jacobians and residual, `plan` its ops.assembly
    FamilyAssembly. On the card (csrc/grad_hess.cu), one C call: a CTA
    per chunk of a long segment's records, both outputs' chunks in turn,
    into a cached scratch of partial blocks, then a thread per row of
    both outputs' short segments, piece by piece, then a thread per
    element of the long ones adding its chunks' partials. Every destination
    element is summed in a fixed order: no atomics, the same bits from
    run to run."""
    if W.shape[1:] != (plan.rdim, plan.tdw):
        raise ValueError(f"grad_hess: W is {tuple(W.shape)}, the plan wants "
                         f"(F, {plan.rdim}, {plan.tdw})")
    if W.device.type == "cpu":
        return grad_hess_twin(W, hdata, grad, plan)
    h, g = plan.hess, plan.grad
    _check_cuda("grad_hess", [W, hdata, grad],
                [plan.tab_a, plan.tab_b, *(getattr(s, k) for s in (h, g)
                                           for k in ("off", "stride", "rows",
                                                     "cols", "ptr", "rec",
                                                     "chunk_seg", "chunk_p0",
                                                     "chunk_ptr"))])
    sizes = [s.chunk_seg.shape[0] * s.max_e_long for s in (h, g)]
    part = _scratch(W, max(1, sum(sizes)))
    outs = np.asarray([
        v for out, s, p in ((hdata, h, part.data_ptr()),
                            (grad, g, part[sizes[0]:].data_ptr()))
        for v in (out.data_ptr(), *(getattr(s, k).data_ptr() for k in (
            "off", "stride", "rows", "cols", "ptr", "rec", "chunk_seg",
            "chunk_p0", "chunk_ptr")), p, s.chunk_seg.shape[0],
            s.short.shape[0], s.chunk_rec, s.max_rc_long, s.max_e_long)],
        dtype=np.int64)
    se, le = plan.short_entries, plan.long_entries
    err = _lib().bs_grad_hess(
        _DTYPE_CODE[W.dtype], W.data_ptr(), plan.tdw, plan.rdim,
        plan.tab_a.data_ptr(), plan.tab_b.data_ptr(), plan.Q,
        outs.ctypes.data, se.ctypes.data, len(se), le.ctypes.data, len(le),
        _stream(W))
    COUNTS["grad_hess"].launches += 1
    COUNTS["grad_hess"].grid_launches += gh_grids(plan)
    _raise_on("grad_hess", err)


GH_MAX_CLASSES = 32  # class entries of one launch (csrc/grad_hess.cu
#                      kMaxCls)


def gh_grids(plan) -> int:
    """The grids K6 launches for one family: the chunk grid of both
    outputs' long segments, the short grid and the post grid, each of
    the last two in launches of up to GH_MAX_CLASSES class entries."""
    chunks = any(s.chunk_seg.shape[0] > 0 for s in (plan.hess, plan.grad))
    return int(chunks) + -(-len(plan.short_entries) // GH_MAX_CLASSES) + \
        (-(-len(plan.long_entries) // GH_MAX_CLASSES) if chunks else 0)


def grad_hess_twin(W, hdata, grad, plan) -> None:
    """Plain twin of K6: Optimizer._accumulate_family of the JAX package
    in torch, the gradient's einsums and index_add_ first, then each
    pair's."""
    COUNTS["grad_hess"].twin_calls += 1
    dev = W.device
    r = W[:, :, -1]
    for a, td, vec_off in plan.vecs:
        g = torch.einsum("bri,br->bi", W[:, :, a:a + td], r)
        idx = vec_off[:, None] + torch.arange(td, device=dev)
        grad.index_add_(0, idx.reshape(-1), g.reshape(-1))
    for a, ti, b, tj, off, stride, flip in plan.pairs:
        h = torch.einsum("bri,brj->bij", W[:, :, a:a + ti],
                         W[:, :, b:b + tj])
        e = torch.arange(ti * tj, device=dev)
        rr, cc = e // tj, e % tj
        plain = off[:, None] + rr * stride[:, None] + cc
        flipped = off[:, None] + cc * stride[:, None] + rr
        idx = torch.where(flip[:, None], flipped, plain)
        hdata.index_add_(0, idx.reshape(-1), h.reshape(-1))


# the plain twins under the wrappers' names, for running a whole path
# through them (timing and comparison on the card)
TWINS = SimpleNamespace(bucket_factor=bucket_factor_twin,
                        wide_factor=wide_factor_twin,
                        segmented_subtract=segmented_subtract_twin,
                        bucket_solve=bucket_solve_twin,
                        wide_solve=wide_solve_twin,
                        dense_update=dense_update_twin,
                        tri_solve=tri_solve_twin,
                        wide_tri_solve=wide_tri_solve_twin,
                        add_mv=add_mv_twin,
                        wide_add_mv=wide_add_mv_twin,
                        grad_hess=grad_hess_twin)
