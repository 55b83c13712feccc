"""The port's three hand-written CUDA kernels, their plain twins and
their launch counters.

  K1 bucket_factor       csrc/bucket_factor.cu
  K2 segmented_subtract  csrc/segmented_subtract.cu
  K3 bucket_solve        csrc/bucket_solve.cu

Each wrapper takes the same arguments on either device. For a tensor on
the CPU it runs the plain PyTorch twin beside it; for a CUDA tensor it
launches the kernel or raises — there is no fallback. The kernels are
compiled for sm_90a with nvcc into one plain-C shared library at first
use (`build/` at the repository root) and bound with ctypes.

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

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build")
SOURCES = ("bucket_factor.cu", "segmented_subtract.cu", "bucket_solve.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


@dataclass
class LaunchCount:
    launches: int = 0    # wrapper calls that launched the kernel
    grid_launches: int = 0  # __global__ launches among them (K1 launches
    #                         three grids per call on panels with below rows)
    twin_calls: int = 0  # calls of the plain twin (any device)


COUNTS = {"bucket_factor": LaunchCount(),
          "segmented_subtract": LaunchCount(),
          "bucket_solve": LaunchCount()}


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
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libbaspacho_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if the library for these sources is missing;
    returns its path. Raises with nvcc's output when the build fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[os.path.join(CSRC, s) for s in SOURCES]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}"
                           f"\n{res.stderr}")
    os.replace(tmp, so)
    return so


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(build())
        i64, i32, vp = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
        lib.bs_bucket_factor.restype = i32
        lib.bs_bucket_factor.argtypes = [
            i32, vp, i64, vp, i64, i64, vp, vp, vp, i64, i32, i32, i32, vp]
        lib.bs_segmented_subtract.restype = i32
        lib.bs_segmented_subtract.argtypes = [
            i32, vp, i64, vp, i64, vp, vp, vp, i64, i64, i32, vp]
        lib.bs_bucket_solve.restype = i32
        lib.bs_bucket_solve.argtypes = [
            i32, i32, vp, i64, vp, i64, vp, i64, i64, vp, vp, vp, vp, vp,
            i64, i64, i32, i32, i32, i32, vp]
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
    """Factor the bucket's panels in place in `data` and, when rp > 0,
    write their products x . x^T into prod[:, prod_base:]."""
    _check_batch("bucket_factor", data, prod if rp else None)
    if data.device.type == "cpu":
        return bucket_factor_twin(data, prod, off, rows, cols, cp, rp,
                                  prod_base)
    floats = [data] if rp == 0 else [data, prod]
    _check_cuda("bucket_factor", floats, [off, rows, cols])
    if cp > 512:
        raise ValueError("bucket_factor: cp > 512 needs the blocked wide "
                         "path, which is not ported")
    batch = data.shape[0]
    prod_ptr = prod.data_ptr() if rp else None
    prod_bstride = prod.shape[1] if rp else 0
    err = _lib().bs_bucket_factor(
        _DTYPE_CODE[data.dtype], data.data_ptr(), data.shape[1], prod_ptr,
        prod_bstride, prod_base, off.data_ptr(), rows.data_ptr(),
        cols.data_ptr(), off.shape[0], cp, rp, batch, _stream(data))
    COUNTS["bucket_factor"].launches += 1
    # chol_inv, then below and prod when the panels have below rows
    COUNTS["bucket_factor"].grid_launches += 3 if rp else 1
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
    L, _ = torch.linalg.cholesky_ex(sym)
    eye = torch.eye(cp, dtype=dt, device=dev).expand_as(L)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    store = torch.where(ii >= jj, L - pad_eye, 0.0) + \
        torch.where(ii < jj, Linv.mT, 0.0)
    if rp > 0:
        x = torch.einsum("zbrk,zbjk->zbrj", panels[:, :, cp:], Linv)
        store = torch.cat([store, x], dim=2)
        pr = torch.einsum("zbrk,zbsk->zbrs", x, x)
        prod[:, prod_base:prod_base + B * rp * rp] = pr.reshape(batch, -1)
    data[:, idx] = store.reshape(batch, B, h * cp)


# ----------------------------------------------------------------------
# K2 segmented_subtract
# ----------------------------------------------------------------------
def segmented_subtract(out, src, tgt, seg_ptr, src_idx, width: int) -> None:
    """out[:, tgt[t]*width + k] -= sum over the t-th segment of
    src[:, src_idx[j]*width + k]; out and src are (batch, ...) buffers."""
    _check_batch("segmented_subtract", out, src)
    if out.device.type == "cpu":
        return segmented_subtract_twin(out, src, tgt, seg_ptr, src_idx,
                                       width)
    _check_cuda("segmented_subtract", [out, src], [tgt, seg_ptr, src_idx])
    n_tgt = tgt.shape[0]
    if n_tgt == 0:
        return
    batch = out.shape[0]
    err = _lib().bs_segmented_subtract(
        _DTYPE_CODE[out.dtype], out.data_ptr(), out[0].numel(),
        src.data_ptr(), src[0].numel(), tgt.data_ptr(), seg_ptr.data_ptr(),
        src_idx.data_ptr(), n_tgt, width, batch, _stream(out))
    COUNTS["segmented_subtract"].launches += 1
    COUNTS["segmented_subtract"].grid_launches += 1
    _raise_on("segmented_subtract", err)


def segmented_subtract_twin(out, src, tgt, seg_ptr, src_idx,
                            width: int) -> None:
    """Plain twin of K2: a segment sum and an indexed subtraction."""
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
# K3 bucket_solve
# ----------------------------------------------------------------------
def bucket_solve(data, vv, y, y_base: int, off, rows, cols, vec_off,
                 below_idx, cp: int, rp: int, transpose: bool) -> None:
    """Stored-inverse diagonal solve of one bucket, in place in vv.
    L pass (transpose=False): vv[rows] = Linv . vv[rows] and, when rp > 0,
    y[:, y_base + b*rp + r] = (below . x)[b, r]. Lt pass: vv[rows] =
    Linv^T . (vv[rows] - below^T . vv[below_idx])."""
    use_y = not transpose and rp > 0
    _check_batch("bucket_solve", data, vv, y if use_y else None)
    if use_y and y.shape[2:] != vv.shape[2:]:
        raise ValueError(f"bucket_solve: y has {y.shape[2:]} right-hand "
                         f"sides, vv {vv.shape[2:]}")
    if data.device.type == "cpu":
        return bucket_solve_twin(data, vv, y, y_base, off, rows, cols,
                                 vec_off, below_idx, cp, rp, transpose)
    floats = [data, vv] if (transpose or rp == 0) else [data, vv, y]
    _check_cuda("bucket_solve", floats, [off, rows, cols, vec_off,
                                         below_idx])
    if cp > 512:
        raise ValueError("bucket_solve: cp > 512 needs the blocked wide "
                         "path, which is not ported")
    batch, order, nrhs = vv.shape
    err = _lib().bs_bucket_solve(
        _DTYPE_CODE[data.dtype], int(transpose), data.data_ptr(),
        data.shape[1], vv.data_ptr(), order * nrhs,
        y.data_ptr() if use_y else None, y[0].numel() if use_y else 0,
        y_base * nrhs, off.data_ptr(), rows.data_ptr(), cols.data_ptr(),
        vec_off.data_ptr(), below_idx.data_ptr(), order, off.shape[0], cp,
        rp, nrhs, batch, _stream(data))
    COUNTS["bucket_solve"].launches += 1
    COUNTS["bucket_solve"].grid_launches += 1
    _raise_on("bucket_solve", err)


def _stored_linv(P, cols):
    """Linv from a stored diag block (PlannedBackend._tri_stored)."""
    cp, dev = P.shape[-1], P.device
    ar = torch.arange(cp, device=dev)
    ii, jj = ar[:, None], ar[None, :]
    d = torch.diagonal(P, dim1=-2, dim2=-1)
    dinv = torch.where(ar < cols[:, None], 1.0 / d, 1.0)
    return torch.where(ii > jj, P.mT,
                       torch.where(ii == jj, dinv[..., :, None], 0.0))


def bucket_solve_twin(data, vv, y, y_base: int, off, rows, cols, vec_off,
                      below_idx, cp: int, rp: int, transpose: bool) -> None:
    """Plain twin of K3: PlannedBackend._diag_solve(use_inv=True) in
    torch, with the below scatter of the L pass left to K2."""
    COUNTS["bucket_solve"].twin_calls += 1
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


# the plain twins under the wrappers' names, for running a whole path
# through them (timing and comparison on the card)
TWINS = SimpleNamespace(bucket_factor=bucket_factor_twin,
                        segmented_subtract=segmented_subtract_twin,
                        bucket_solve=bucket_solve_twin)
