// K1-wide: the hand-written steps of the blocked factor of wide panels
// (padded width cp > 512, a multiple of the tile nb).
//
// Replaces PlannedBackend._blocked_factor and _blocked_lower_inv
// (baspacho_tpu/ops/planned_backend.py:1277, :1353), reached through
// _factor_panels (:1411-1414), with the stored layout of _embed_inv
// (:1453). ops/kernels.py `_blocked_factor` drives the steps, one
// diagonal tile k0 = 0, nb, 2 nb, ... at a time:
//   tile   factor and invert the nb x nb diagonal tile in shared memory,
//          by sub-blocks of 32 (one warp factors and inverts each
//          sub-block's diagonal block in registers); write it back in
//          the stored layout (L, Linv^T of the tile strictly above) and
//          its Linv^T (diagonal 1 / L) into the tile's diagonal block of
//          the scratch xt;
//   trsm   x = A . Linv_tile^T for every row below the tile (the trailing
//          diagonal rows and the below rows, one stride), a product with
//          the dense Linv^T tile of xt;
// then torch.matmul updates the trailing rows (the syrk / gemm of
// _blocked_factor) and, after the last tile, sweeps the block rows of
// Linv^T in xt (the products of _blocked_lower_inv); last,
//   embed  copies xt's strict upper (the full Linv^T) into the panel.
//
// Bounds: `tile` runs on one SM per panel, for cp / nb tiles in a row:
// the latency chain of the wide factor (about 20 CTA barriers and four
// register-resident 32 x 32 warp factorizations per tile, the products
// in between blocked 4 rows per warp). `trsm` is a small product
// (rows x 128 x 128) tiled through shared memory with 4 x 4 outputs per
// thread. The large products go to cuBLAS through torch.
//
// Real width n = cols[i]: columns and rows >= n are padding. They come
// out zero in L, in Linv^T and in x, as in the JAX routine's stored block.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_tiles.cuh"

namespace {

__device__ __forceinline__ int tile_width(int64_t n, int k0, int nb) {
  const int64_t w = n - k0;
  return w < 0 ? 0 : (w > nb ? nb : (int)w);
}

// One CTA per (panel, batch item) factors and inverts the diagonal tile,
// staged in shared memory, in sub-blocks of kSub columns: one warp
// factors and inverts the sub-block's diagonal block (in registers),
// all warps multiply the rows below it by that inverse and update
// the trailing rows; then the tile's inverse is swept by block rows,
// X[i, :i] = -Dinv_i (L[i, :i] X[:i, :i]). About 20 CTA barriers per tile.
// A holds L on and below the diagonal and X^T = Linv^T strictly above it
// (the stored layout), dx the diagonal of X (warp_chol_inv and kSub:
// warp_tiles.cuh).

constexpr int kWideThreads = 512;  // wide_tile_kernel

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    wide_tile_kernel(T* data, int64_t bstride, T* xt, const int64_t* off,
                     const int64_t* cols, int cp, int k0, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the tile, its rows padded to nb + 1 values (and the panel scratch's
  // to kSub + 1) so that a warp walking a column hits distinct banks
  const int ls = nb + 1, lt = kSub + 1;
  T* A = reinterpret_cast<T*>(smem_raw);
  T* dx = A + nb * ls;  // diagonal of X
  T* tmp = dx + nb;     // (nb - kSub) x lt scratch
  const int64_t i = blockIdx.x, B = gridDim.x;
  const int64_t ld = cp;
  T* P = data + (int64_t)blockIdx.y * bstride + off[i] + k0 * ld + k0;
  T* X = xt + ((int64_t)blockIdx.y * B + i) * ld * ld + k0 * ld + k0;
  const int w = tile_width(cols[i], k0, nb);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int tx = tid & 31, ty = tid >> 5, nty = nt >> 5;
  for (int t0 = 0; t0 < nb * nb; t0 += 8 * nt) {  // 8 loads in flight
    T v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = t0 + u * nt + tid, r = t / nb, c = t % nb;
      v[u] = (t < nb * nb && r < w && c <= r) ? P[r * ld + c] : T(0);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = t0 + u * nt + tid;
      if (t < nb * nb) A[(t / nb) * ls + t % nb] = v[u];
    }
  }
  for (int t = tid; t < nb; t += nt) dx[t] = T(0);  // warp_chol_inv reads it
  __syncthreads();

  // The products below give each warp 4 rows and each lane a column:
  // the rows' values are broadcast reads, the column's walk a padded
  // stride, and the 4 sums are independent.

  // Cholesky, sub-block by sub-block (right-looking)
  for (int p0 = 0; p0 < w; p0 += kSub) {
    const int pw = min(kSub, w - p0), q0 = p0 + pw, nr = w - q0;
    if (ty == 0) warp_chol_inv<kSub>(A, dx, ls, p0, pw);
    __syncthreads();
    // rows below: tmp[r][c] = sum_{m <= c} a[r][m] X[c][m], with
    // X[c][m] = A[(p0 + m) * ls + p0 + c] for m < c
    for (int r = 4 * ty; r < nr; r += 4 * nty) {
      const int c = tx;
      T acc[4] = {};
      for (int m = 0; m < pw; ++m) {
        const T xv = c >= pw ? T(0)
                     : m < c  ? A[(p0 + m) * ls + p0 + c]
                     : m == c ? dx[p0 + c] : T(0);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[u] += A[(q0 + min(r + u, nr - 1)) * ls + p0 + m] * xv;
      }
      if (c < pw)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (r + u < nr) tmp[(r + u) * lt + c] = acc[u];
    }
    __syncthreads();
    // write the panel back and update the trailing lower triangle
    for (int t = tid; t < nr * pw; t += nt) {
      const int r = t / pw, c = t % pw;
      A[(q0 + r) * ls + p0 + c] = tmp[r * lt + c];
    }
    for (int r = 4 * ty; r < nr; r += 4 * nty) {
      for (int c0 = 0; c0 <= r + 3 && c0 < nr; c0 += 32) {
        const int c = c0 + tx;
        const T* tc = tmp + min(c, nr - 1) * lt;
        T acc[4] = {};
        for (int m = 0; m < pw; ++m) {
          const T t = tc[m];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            acc[u] += tmp[min(r + u, nr - 1) * lt + m] * t;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (r + u < nr && c <= r + u) A[(q0 + r + u) * ls + q0 + c] -= acc[u];
      }
    }
    __syncthreads();
  }

  // inverse by block rows: tmp = L[i, :i] X[:i, :i], then
  // X[i, :i] = -Dinv_i tmp, stored transposed (X[m][c] = A[c * ls + m]
  // for m > c)
  for (int r0 = kSub; r0 < w; r0 += kSub) {
    const int rw = min(kSub, w - r0), ng = r0 / 32;
    for (int it = ty; it < ((rw + 3) / 4) * ng; it += nty) {
      const int r = 4 * (it / ng), c0 = 32 * (it % ng), c = c0 + tx;
      T acc[4] = {};
      for (int m = c0; m < r0; ++m) {
        const T xv = m > c ? A[c * ls + m] : m == c ? dx[c] : T(0);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[u] += A[(r0 + min(r + u, rw - 1)) * ls + m] * xv;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (r + u < rw) tmp[(r + u) * r0 + c] = acc[u];
    }
    __syncthreads();
    for (int it = ty; it < ((rw + 3) / 4) * ng; it += nty) {
      const int r = 4 * (it / ng), c = 32 * (it % ng) + tx;
      T acc[4] = {};
      for (int q = 0; q < min(r + 4, rw); ++q) {
        const T t = tmp[q * r0 + c];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int ru = r + u;  // X[r0 + ru][r0 + q], q <= ru
          if (q <= ru && ru < rw)
            acc[u] += (q == ru ? dx[r0 + ru] : A[(r0 + q) * ls + r0 + ru]) * t;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (r + u < rw) A[c * ls + r0 + r + u] = -acc[u];
    }
    __syncthreads();
  }

  for (int t = tid; t < nb * nb; t += nt) {
    const int r = t / nb, c = t % nb;
    const T a = A[r * ls + c];
    P[r * ld + c] = a;
    T v = T(0);
    if (c < w && r <= c) v = r == c ? dx[r] : a;
    X[r * ld + c] = v;
  }
}

// x = a . Linv_tile^T = a . Xt_tile for the rows below the tile, read
// from the dense Linv^T tile in xt: one CTA per (panel, 32 rows, batch
// item), each thread a 4 x 4 block of outputs. The rows are staged in
// shared memory first, so the product overwrites them in place.
constexpr int kTrsmRows = 32;
constexpr int kTrsmK = 8;

template <typename T>
__global__ void wide_trsm_kernel(T* data, int64_t bstride, const T* xt,
                                 const int64_t* off, const int64_t* rows,
                                 int cp, int k0) {
  constexpr int nb = 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);  // kTrsmRows x nb
  T* sb = sa + kTrsmRows * nb;              // kTrsmK x nb
  const int64_t i = blockIdx.x, B = gridDim.x, ld = cp;
  T* P = data + (int64_t)blockIdx.z * bstride + off[i];
  const T* Xt = xt + ((int64_t)blockIdx.z * B + i) * ld * ld + k0 * ld + k0;
  const int first = k0 + nb;  // rows first .. cp + rows[i] - 1
  const int r0 = blockIdx.y * kTrsmRows;
  const int nr = min(kTrsmRows, cp + (int)rows[i] - first - r0);
  if (nr <= 0) return;  // uniform over the CTA
  T* A = P + (first + r0) * ld + k0;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  for (int t = tid; t < kTrsmRows * nb; t += 256) {
    const int r = t / nb, c = t % nb;
    sa[t] = r < nr ? A[r * ld + c] : T(0);
  }
  T acc[4][4] = {};
  for (int k = 0; k < nb; k += kTrsmK) {
    __syncthreads();
    for (int t = tid; t < kTrsmK * nb; t += 256) {
      const int kk = t / nb, c = t % nb;
      sb[t] = Xt[(k + kk) * ld + c];
    }
    __syncthreads();
    for (int kk = 0; kk < kTrsmK; ++kk) {
      T a[4], b[4];
      for (int u = 0; u < 4; ++u) a[u] = sa[(4 * ty + u) * nb + k + kk];
      for (int v = 0; v < 4; ++v) b[v] = sb[kk * nb + tx + 32 * v];
      for (int u = 0; u < 4; ++u)
        for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * b[v];
    }
  }
  for (int u = 0; u < 4; ++u) {
    const int r = 4 * ty + u;
    if (r < nr)
      for (int v = 0; v < 4; ++v) A[r * ld + tx + 32 * v] = acc[u][v];
  }
}

template <typename T>
__global__ void wide_embed_kernel(T* data, int64_t bstride, const T* xt,
                                  const int64_t* off, int cp) {
  const int64_t i = blockIdx.y, B = gridDim.y, ld = cp;
  T* P = data + (int64_t)blockIdx.z * bstride + off[i];
  const T* X = xt + ((int64_t)blockIdx.z * B + i) * ld * ld;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < ld * ld; e += (int64_t)gridDim.x * blockDim.x) {
    if (e % ld > e / ld) P[e] = X[e];
  }
}

template <typename T>
int launch_tile(void* data, int64_t bstride, void* xt, const int64_t* off,
                const int64_t* cols, int64_t B, int cp, int k0, int nb,
                int batch, cudaStream_t stream) {
  const size_t smem = ((size_t)nb * (nb + 1) + nb +
                       (size_t)(nb - kSub) * (kSub + 1)) * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      wide_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  wide_tile_kernel<T><<<dim3((unsigned)B, batch), kWideThreads, smem,
                        stream>>>(
      static_cast<T*>(data), bstride, static_cast<T*>(xt), off, cols, cp,
      k0, nb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_trsm(void* data, int64_t bstride, const void* xt,
                const int64_t* off, const int64_t* rows, int64_t B, int cp,
                int rp, int k0, int nb, int batch, cudaStream_t stream) {
  if (nb != 128) return (int)cudaErrorInvalidValue;
  const int total = cp + rp - (k0 + nb);
  if (total <= 0) return 0;
  const size_t smem = (size_t)(kTrsmRows + kTrsmK) * nb * sizeof(T);
  wide_trsm_kernel<T><<<dim3((unsigned)B,
                             (total + kTrsmRows - 1) / kTrsmRows, batch),
                        256, smem, stream>>>(
      static_cast<T*>(data), bstride, static_cast<const T*>(xt), off, rows,
      cp, k0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_embed(void* data, int64_t bstride, const void* xt,
                 const int64_t* off, int64_t B, int cp, int batch,
                 cudaStream_t stream) {
  int64_t blocks = ((int64_t)cp * cp + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  wide_embed_kernel<T><<<dim3((unsigned)blocks, (unsigned)B, batch), 256, 0,
                         stream>>>(static_cast<T*>(data), bstride,
                                   static_cast<const T*>(xt), off, cp);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64. Each returns the cudaError_t of its launch.
extern "C" int bs_wide_tile(int dtype, void* data, int64_t bstride, void* xt,
                            const int64_t* off, const int64_t* cols,
                            int64_t B, int cp, int k0, int nb, int batch,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_tile<float>(data, bstride, xt, off, cols, B, cp, k0, nb,
                              batch, s);
  if (dtype == 1)
    return launch_tile<double>(data, bstride, xt, off, cols, B, cp, k0, nb,
                               batch, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int bs_wide_trsm(int dtype, void* data, int64_t bstride,
                            const void* xt, const int64_t* off,
                            const int64_t* rows, int64_t B, int cp, int rp,
                            int k0, int nb, int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_trsm<float>(data, bstride, xt, off, rows, B, cp, rp, k0,
                              nb, batch, s);
  if (dtype == 1)
    return launch_trsm<double>(data, bstride, xt, off, rows, B, cp, rp, k0,
                               nb, batch, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int bs_wide_embed(int dtype, void* data, int64_t bstride,
                             const void* xt, const int64_t* off, int64_t B,
                             int cp, int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_embed<float>(data, bstride, xt, off, B, cp, batch, s);
  if (dtype == 1)
    return launch_embed<double>(data, bstride, xt, off, B, cp, batch, s);
  return (int)cudaErrorInvalidValue;
}
