// K3-wide wide_solve: stored-inverse diagonal solve of a bucket of wide
// panels (padded width cp > 512).
//
// Replaces PlannedBackend._diag_solve with use_inv=True and _tri_stored
// (baspacho_tpu/ops/planned_backend.py:2134, :2118) for wide buckets, as
// driven level by level by make_solve (:2383). The arguments, layout and
// result are bucket_solve's (bucket_solve.cu): U[m][j] = P[m * cp + j] is
// Linv[j][m] for m < j (the stored Linv^T), Linv[j][j] = 1 / P[j][j];
// Linv is never materialised. With n = cols[p] real columns and nrows =
// rows[p] real below rows:
//   L pass:  t[j] = b[j] / P[j][j] + sum_{m < j} U[m][j] b[m]  (b: own rows)
//            vv[own] = t; y[y_base + p rp + r] = below[r] . t (0 past nrows)
//   Lt pass: t[j] = b[j] - sum_{r < nrows} below[r][j] vv[bidx[r]] (no term
//            for the sentinel bidx == order)
//            vv[own][j] = t[j] / P[j][j] + sum_{m > j} U[j][m] t[m]
//
// A wide level holds one or a few panels (BAL 871: one each of cp 1024
// with 6,930 real below rows, cp 3072 with 4,096, cp 4096 with none), so
// work on one panel has to cover the card. Bound by reading the panel
// once per pass (BAL's cp-1024 below block is 57 MB in f64: ~17 us at
// 3.35 TB/s); the earlier design ran a thread per column walking every
// below row with a dependent gather each, on 8 CTAs (5.25 ms on an H100).
// Both column-sum phases are now one pattern (col_sums): a CTA reads a
// block of rows x a strip of columns once, row-major and coalesced, warp w
// on rows w, w + 8, ... with up to 16 loads a lane in flight, each element
// times the block's per-row weights (staged in shared memory, all the
// block's gathers issued at once), the warps joined in warp order into one
// partial per (block, column, RHS column); a post grid adds a column's
// partials in block order (warp w on every eighth, joined in warp order).
// The grids, over (work item, batch item):
//   L pass
//     wide_l_tile  a CTA per tile (row block c <= column block s) of the
//                  stored upper triangle, E x E (E = 64 or 128): column
//                  partials of U[m][j] b[m] over m < j
//     wide_l_post  a CTA per 32 columns: t = partials + b / P[j][j], into
//                  the scratch t and the own rows of vv
//     wide_l_y     (rp > 0) a warp per below row: y[r] = below[r] . t, every
//                  RHS column from one read of the row, butterfly sums
//   Lt pass
//     wide_lt_rows a CTA per (chunk of crc below rows, strip of W columns):
//                  column partials of below[r][j] vv[bidx[r]]; a panel of
//                  one chunk (or no below rows) writes t = b - partial
//                  directly, else
//     wide_lt_post a CTA per 32 columns: t = b - (partials in chunk order)
//     wide_ltmv    a warp per row j of the stored upper triangle
//                  (contiguous): vv[own][j] = t[j] / P[j][j] + U[j] . t,
//                  every RHS column from one read of the row, butterfly
//                  sums
// The layout (E, crc, chunks) depends on the bucket's shape only
// (ops/kernels.py wide_solve_layout), and every sum's order on the layout
// only: batch items equal their single runs and reruns each other,
// bitwise. No atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_tiles.cuh"

namespace {

constexpr int kWarps = 8;  // warps per CTA of every grid
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 4;    // RHS columns summed per pass over a block
constexpr int kStrip = 256;  // Lt rows grid: strip width (ops/kernels.py
//                              WIDE_SOLVE_STRIP)
constexpr int kChunk = 64;   // Lt rows grid: below rows per chunk
//                              (WIDE_SOLVE_CHUNK)

// one launch's operands and grid layout (bs_wide_solve); strides in
// elements
struct Ws {
  const void* data;
  int64_t data_bs;
  void* vv;
  int64_t vv_bs;
  void* y;
  int64_t y_bs;
  int64_t y_base;  // first y element of the bucket (row * nrhs)
  void* tmp;       // t: (batch, B, cp, nrhs)
  void* part;      // partials: (batch, B, blocks, cp, nrhs)
  const int64_t* off;
  const int64_t* rows;
  const int64_t* cols;
  const int64_t* vec_off;
  const int64_t* bidx;
  int64_t order;
  int64_t B;
  int cp, rp, nrhs;
  int E;       // L pass: tile edge
  int nblk;    // ceil(cp / E)
  int nstrip;  // Lt pass: ceil(cp / kStrip)
  int nchunk;  // Lt pass: chunks of kChunk below rows, at least 1
};

// Column sums of rows [r0, r1) of a row-major matrix A (row stride ld)
// over the strip [c0, c0 + 32 CT): sum_r A[r][j] g[r - r0][kk] for kk <
// nk, elements with real(r, j) false read as zero; warp w takes rows r0 +
// w, r0 + w + kWarps, ... in order, the warps' sums are joined in warp
// order and handed to emit(j, kk, sum) by thread j - c0. g: (r1 - r0) x
// kGroup in shared memory (zero past nk). Barriers: every thread of the
// CTA must call it.
template <typename T, int CT, typename Real, typename Emit>
__device__ __forceinline__ void col_sums(const T* A, int64_t ld, int r0,
                                         int r1, int c0, const T* g, int nk,
                                         const Real& real, T (*red)[32 * CT],
                                         const Emit& emit) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T acc[CT][kGroup];
#pragma unroll
  for (int t = 0; t < CT; ++t)
#pragma unroll
    for (int kk = 0; kk < kGroup; ++kk) acc[t][kk] = T(0);
#pragma unroll(CT >= 16 ? 1 : 16 / CT)
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const T* Ar = A + (int64_t)r * ld;
    T e[CT];
#pragma unroll
    for (int t = 0; t < CT; ++t) {
      const int j = c0 + lane + 32 * t;
      e[t] = real(r, j) ? Ar[j] : T(0);
    }
    const T* gr = g + (r - r0) * kGroup;
#pragma unroll
    for (int kk = 0; kk < kGroup; ++kk) {
      const T w = gr[kk];
#pragma unroll
      for (int t = 0; t < CT; ++t) acc[t][kk] += e[t] * w;
    }
  }
  for (int kk = 0; kk < nk; ++kk) {
#pragma unroll
    for (int t = 0; t < CT; ++t) red[warp][lane + 32 * t] = acc[t][kk];
    __syncthreads();
    for (int j = threadIdx.x; j < 32 * CT; j += kThreads) {
      T v = T(0);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[w][j];
      emit(c0 + j, kk, v);
    }
    __syncthreads();
  }
}

// L pass, tile (c, s), c <= s, of E = 32 CT rows and columns; blockIdx.x
// = panel * tiles + tri index (tri_tile gives (s, c))
template <typename T, int CT>
__global__ void __launch_bounds__(kThreads) wide_l_tile_kernel(Ws a) {
  constexpr int E = 32 * CT;
  __shared__ T red[kWarps][E];
  __shared__ T gs[E * kGroup];
  const int per = a.nblk * (a.nblk + 1) / 2;
  const int64_t i = blockIdx.x / per;
  int s, c;
  tri_tile((int)(blockIdx.x % per), s, c);
  const int n = (int)a.cols[i], m0 = c * E, c0 = s * E;
  if (c0 >= n) return;  // uniform over the CTA
  const int m1 = min(m0 + E, n), nrhs = a.nrhs, z = blockIdx.y;
  const T* P = static_cast<const T*>(a.data) + z * a.data_bs + a.off[i];
  const T* b = static_cast<const T*>(a.vv) + z * a.vv_bs +
               a.vec_off[i] * nrhs;
  T* part = static_cast<T*>(a.part) +
            (((int64_t)z * a.B + i) * a.nblk + c) * a.cp * nrhs;
  for (int k0 = 0; k0 < nrhs; k0 += kGroup) {
    const int nk = min(kGroup, nrhs - k0);
    for (int t = threadIdx.x; t < E * kGroup; t += kThreads) {
      const int m = m0 + t / kGroup, kk = t % kGroup;
      gs[t] = m < m1 && kk < nk ? b[(int64_t)m * nrhs + k0 + kk] : T(0);
    }
    __syncthreads();
    col_sums<T, CT>(
        P, a.cp, m0, m1, c0, gs, nk,
        [&](int m, int j) { return m < j && j < n; }, red,
        [&](int j, int kk, T v) {
          if (j < n) part[(int64_t)j * nrhs + k0 + kk] = v;
        });
  }
}

// The post of either pass: a CTA per (panel, 32 columns), lane = column,
// warp w summing the column's partials w, w + 8, ... (blocks in order),
// the warps joined in warp order. L: t = sum + b / P[j][j], into t and
// vv; Lt: t = b - sum.
template <typename T, bool kL>
__device__ __forceinline__ void post(const Ws& a, T (*red)[32]) {
  const int ncb = (a.cp + 31) / 32, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t i = blockIdx.x / ncb;
  const int j0 = (int)(blockIdx.x % ncb) * 32, j = j0 + lane;
  const int n = (int)a.cols[i];
  if (j0 >= n) return;  // uniform over the CTA
  const int nrhs = a.nrhs, z = blockIdx.y;
  const int nrows = a.rp > 0 ? (int)a.rows[i] : 0;
  const int ne = kL ? j0 / a.E + 1 : (nrows + kChunk - 1) / kChunk;
  const int64_t item = (int64_t)z * a.B + i;
  const T* pp = static_cast<const T*>(a.part) +
                item * (kL ? a.nblk : a.nchunk) * a.cp * nrhs;
  T* t = static_cast<T*>(a.tmp) + item * a.cp * nrhs;
  T* b = static_cast<T*>(a.vv) + z * a.vv_bs + a.vec_off[i] * nrhs;
  const T* P = static_cast<const T*>(a.data) + z * a.data_bs + a.off[i];
  for (int k = 0; k < nrhs; ++k) {
    T acc = T(0);
    if (j < n) {
#pragma unroll 4
      for (int e = warp; e < ne; e += kWarps)
        acc += pp[((int64_t)e * a.cp + j) * nrhs + k];
    }
    red[warp][lane] = acc;
    __syncthreads();
    if (warp == 0 && j < n) {
      T v = T(0);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[w][lane];
      T* bj = b + (int64_t)j * nrhs + k;
      if (kL) {
        const T x = v + *bj / P[(int64_t)j * a.cp + j];
        t[(int64_t)j * nrhs + k] = x;
        *bj = x;
      } else {
        t[(int64_t)j * nrhs + k] = *bj - v;
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) wide_l_post_kernel(Ws a) {
  __shared__ T red[kWarps][32];
  post<T, true>(a, red);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) wide_lt_post_kernel(Ws a) {
  __shared__ T red[kWarps][32];
  post<T, false>(a, red);
}

// A warp's dot products of one row with nk <= kGroup RHS columns:
// s[kk] = sum_{m0 <= m < m1} row[m] x[m nrhs + kk], lane l taking m = m0 +
// l, m0 + l + 32, ... in order, then a butterfly; every lane gets the
// sums. The row is read once for the nk columns. At nrhs 1 (the LM path)
// a plain loop, the same sums: the general one takes twice as long there
// in wide_ltmv on an H100 (PERF.md).
template <typename T>
__device__ __forceinline__ void row_dot(const T* row, const T* x, int nrhs,
                                        int nk, int m0, int m1,
                                        T (&s)[kGroup]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < kGroup; ++kk) s[kk] = T(0);
  if (nrhs == 1) {
    for (int m = m0 + lane; m < m1; m += 32) s[0] += row[m] * x[m];
    s[0] = group_sum(s[0], 32);
    return;
  }
#pragma unroll 4
  for (int m = m0 + lane; m < m1; m += 32) {
    const T e = row[m];
    const T* xm = x + (int64_t)m * nrhs;
#pragma unroll
    for (int kk = 0; kk < kGroup; ++kk)
      if (kk < nk) s[kk] += e * xm[kk];
  }
#pragma unroll
  for (int kk = 0; kk < kGroup; ++kk)
    if (kk < nk) s[kk] = group_sum(s[kk], 32);  // nk: uniform over the warp
}

// L pass, rp > 0: a warp per below row, y[r] = below[r] . t (row_dot)
template <typename T>
__global__ void __launch_bounds__(kThreads) wide_l_y_kernel(Ws a) {
  const int nrb = (a.rp + kWarps - 1) / kWarps;
  const int64_t i = blockIdx.x / nrb;
  const int r = (int)(blockIdx.x % nrb) * kWarps + (threadIdx.x >> 5);
  if (r >= a.rp) return;  // uniform over the warp; no CTA barrier
  const int lane = threadIdx.x & 31, nrhs = a.nrhs, z = blockIdx.y;
  const int n = (int)a.cols[i];
  const bool real = r < (int)a.rows[i];
  const int64_t item = (int64_t)z * a.B + i;
  const T* br = static_cast<const T*>(a.data) + z * a.data_bs + a.off[i] +
                (int64_t)(a.cp + r) * a.cp;
  const T* x = static_cast<const T*>(a.tmp) + item * a.cp * nrhs;
  T* yo = static_cast<T*>(a.y) + z * a.y_bs + a.y_base +
          (i * a.rp + r) * (int64_t)nrhs;
  for (int k0 = 0; k0 < nrhs; k0 += kGroup) {
    const int nk = min(kGroup, nrhs - k0);
    T acc[kGroup];
    row_dot(br, x + k0, nrhs, nk, 0, real ? n : 0, acc);
#pragma unroll
    for (int kk = 0; kk < kGroup; ++kk)
      if (lane == 0 && kk < nk) yo[k0 + kk] = acc[kk];
  }
}

// Lt pass, (chunk c, strip s) of a panel: blockIdx.x = (panel * nchunk +
// c) * nstrip + s
template <typename T>
__global__ void __launch_bounds__(kThreads) wide_lt_rows_kernel(Ws a) {
  constexpr int CT = kStrip / 32;
  __shared__ T red[kWarps][kStrip];
  __shared__ T gs[kChunk * kGroup];
  const int per = a.nchunk * a.nstrip;
  const int64_t i = blockIdx.x / per;
  const int c = (int)(blockIdx.x % per) / a.nstrip;
  const int s = (int)(blockIdx.x % a.nstrip);
  const int n = (int)a.cols[i], c0 = s * kStrip;
  const int nrows = a.rp > 0 ? (int)a.rows[i] : 0;
  const int r0 = c * kChunk, r1 = min(r0 + kChunk, nrows);
  const bool fused = a.nchunk == 1;
  // uniform over the CTA; a chunk past the real rows is not read by the
  // post
  if (c0 >= n || (!fused && r0 >= nrows)) return;
  const int nrhs = a.nrhs, z = blockIdx.y;
  const T* below = static_cast<const T*>(a.data) + z * a.data_bs +
                   a.off[i] + (int64_t)a.cp * a.cp;
  const T* v = static_cast<const T*>(a.vv) + z * a.vv_bs;
  const T* b = v + a.vec_off[i] * nrhs;
  const int64_t* bidx = a.bidx + i * a.rp;
  const int64_t item = (int64_t)z * a.B + i;
  T* out = static_cast<T*>(fused ? a.tmp : a.part) +
           (item * (fused ? 1 : a.nchunk) + (fused ? 0 : c)) * a.cp * nrhs;
  for (int k0 = 0; k0 < nrhs; k0 += kGroup) {
    const int nk = min(kGroup, nrhs - k0);
    // the chunk's gathers, all issued at once (the sentinel gives zero)
    for (int t = threadIdx.x; t < kChunk * kGroup; t += kThreads) {
      const int r = r0 + t / kGroup, kk = t % kGroup;
      T g = T(0);
      if (r < r1 && kk < nk) {
        const int64_t q = bidx[r];
        if (q != a.order) g = v[q * nrhs + k0 + kk];
      }
      gs[t] = g;
    }
    __syncthreads();
    col_sums<T, CT>(
        below, a.cp, r0, r1, c0, gs, nk,
        [&](int, int j) { return j < n; }, red, [&](int j, int kk, T sum) {
          if (j >= n) return;
          const int64_t e = (int64_t)j * nrhs + k0 + kk;
          out[e] = fused ? b[e] - sum : sum;
        });
  }
}

// Lt pass: vv[own][j] = t[j] / P[j][j] + sum_{m > j} U[j][m] t[m], a warp
// per row j of the stored upper triangle (contiguous; row_dot)
template <typename T>
__global__ void __launch_bounds__(kThreads) wide_ltmv_kernel(Ws a) {
  const int nrb = (a.cp + kWarps - 1) / kWarps;
  const int64_t i = blockIdx.x / nrb;
  const int j = (int)(blockIdx.x % nrb) * kWarps + (threadIdx.x >> 5);
  const int n = (int)a.cols[i];
  if (j >= n) return;  // uniform over the warp; no CTA barrier
  const int lane = threadIdx.x & 31, nrhs = a.nrhs, z = blockIdx.y;
  const T* row = static_cast<const T*>(a.data) + z * a.data_bs + a.off[i] +
                 (int64_t)j * a.cp;
  const T* t = static_cast<const T*>(a.tmp) +
               ((int64_t)z * a.B + i) * a.cp * nrhs;
  T* v = static_cast<T*>(a.vv) + z * a.vv_bs + (a.vec_off[i] + j) * nrhs;
  for (int k0 = 0; k0 < nrhs; k0 += kGroup) {
    const int nk = min(kGroup, nrhs - k0);
    T acc[kGroup];
    row_dot(row, t + k0, nrhs, nk, j + 1, n, acc);
#pragma unroll
    for (int kk = 0; kk < kGroup; ++kk)
      if (lane == 0 && kk < nk)
        v[k0 + kk] = acc[kk] + t[(int64_t)j * nrhs + k0 + kk] / row[j];
  }
}

template <typename T>
int launch(int transpose, const Ws& a, int batch, cudaStream_t st) {
  const unsigned zb = (unsigned)batch;
  const unsigned ncb = (unsigned)(a.B * ((a.cp + 31) / 32));
  if (!transpose) {
    const dim3 tg((unsigned)(a.B * a.nblk * (a.nblk + 1) / 2), zb);
    if (a.E == 64)
      wide_l_tile_kernel<T, 2><<<tg, kThreads, 0, st>>>(a);
    else if (a.E == 128)
      wide_l_tile_kernel<T, 4><<<tg, kThreads, 0, st>>>(a);
    else
      return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    wide_l_post_kernel<T><<<dim3(ncb, zb), kThreads, 0, st>>>(a);
    if (a.rp > 0) {
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      const int nrb = (a.rp + kWarps - 1) / kWarps;
      wide_l_y_kernel<T><<<dim3((unsigned)(a.B * nrb), zb), kThreads, 0,
                           st>>>(a);
    }
  } else {
    wide_lt_rows_kernel<T><<<dim3((unsigned)(a.B * a.nchunk * a.nstrip), zb),
                             kThreads, 0, st>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (a.nchunk > 1) {
      wide_lt_post_kernel<T><<<dim3(ncb, zb), kThreads, 0, st>>>(a);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    const int nrb = (a.cp + kWarps - 1) / kWarps;
    wide_ltmv_kernel<T><<<dim3((unsigned)(a.B * nrb), zb), kThreads, 0,
                          st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64; transpose: 0 L pass, 1 Lt pass; edge: the
// L pass's tile edge (64 or 128), nchunk: the Lt pass's chunks per panel
// (ops/kernels.py wide_solve_layout); tmp: batch * B * cp * nrhs values,
// part: batch * B * (L: cp / edge, Lt: nchunk) * cp * nrhs (unused by an
// Lt pass of one chunk). Returns the cudaError_t of the launches.
extern "C" int bs_wide_solve(int dtype, int transpose, const void* data,
                             int64_t data_bstride, void* vv,
                             int64_t vv_bstride, void* y, int64_t y_bstride,
                             int64_t y_base, void* tmp, void* part,
                             const int64_t* off, const int64_t* rows,
                             const int64_t* cols, const int64_t* vec_off,
                             const int64_t* below_idx, int64_t order,
                             int64_t B, int cp, int rp, int nrhs, int batch,
                             int edge, int nchunk, void* stream) {
  if (B == 0) return 0;
  if (nchunk < 1 || (int64_t)nchunk * kChunk < rp)
    return (int)cudaErrorInvalidValue;
  Ws a{data,     data_bstride, vv,   vv_bstride, y,
       y_bstride, y_base,      tmp,  part,       off,
       rows,     cols,         vec_off, below_idx, order,
       B,        cp,           rp,   nrhs,       edge,
       edge > 0 ? (cp + edge - 1) / edge : 0,
       (cp + kStrip - 1) / kStrip, nchunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(transpose, a, batch, s);
  if (dtype == 1) return launch<double>(transpose, a, batch, s);
  return (int)cudaErrorInvalidValue;
}
