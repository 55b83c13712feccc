// K3 bucket_solve: stored-inverse diagonal solve of one bucket.
//
// Replaces PlannedBackend._diag_solve with use_inv=True
// (baspacho_tpu/ops/planned_backend.py:2134) and _tri_stored (:2118),
// as driven level by level by make_solve (:2383).
//
// Each panel's diag block holds L on and below the diagonal and Linv^T
// strictly above (written by bucket_factor): U[m][j] = P[m * cp + j] is
// Linv[j][m] for m < j, and Linv[j][j] = 1 / d[j], d[j] = P[j * cp + j].
// With n = cols[p] real columns and nrows = rows[p] real below rows, the
// panel's RHS rows are vec_off[p] .. vec_off[p] + n - 1 of vv (order x
// nrhs, row-major, one block per batch item).
//   L pass:  x[j] = b[j] / d[j] + sum_{m < j} U[m][j] b[m]   (b: own rows)
//            vv[own] = x; y[y_base + p * rp + r] = below[r] . x (0 past
//            nrows; the segmented-subtract kernel, K2, then applies
//            vv[bidx] -= y)
//   Lt pass: x[j] = b[j] - sum_r below[r][j] vv[bidx[r]]  (no term for the
//            sentinel bidx == order)
//            vv[own][j] = x[j] / d[j] + sum_{m > j} U[j][m] x[m]
// So each pass is a column-sum phase over one set of the panel's rows
// (L: the own rows' strict upper, weights b; Lt: the below rows, weights
// the gathered vv[bidx]) that gives x, then a row-dot phase with x over
// the other set (L: the below rows, into y; Lt: the strict upper). Only
// real rows and columns are read. Panels of one level touch disjoint RHS
// rows and their below rows belong to other levels, so no two work items
// of a launch race.
//
// Bound by reading the panels and by the gathers' latency: BAL 871's
// point bucket is 527,478 cp-4 panels of ~45 real below rows, where a
// thread per (column, RHS) walking every below row would keep 3 threads
// of a panel busy on a chain of dependent bidx -> vv gathers. So the rows
// are on the lanes, as in K5 (add_mv.cu): G = min(cp, 32) lanes a row,
// each lane on columns m + 32 t (t < CT = max(1, cp / 32)), RG = 32 / G
// rows a warp step; a row's dot by a butterfly within its group, column
// sums per lane in row order, joined across the groups by a butterfly
// and across warps in warp order. Every sum's order depends on the
// bucket's shape (cp, rp, panels) only (ops/kernels.py solve_layout), so
// batch items equal their single runs and reruns each other, bitwise:
//   solve_l_warp_kernel / solve_lt_warp_kernel (4 <= cp <= 32, rp cp <=
//     1024, at least 256 panels: BAL's and Schur's points, MERI's and
//     GRID's largest small-panel buckets):
//     one warp per panel, eight a CTA, no block barrier. The panel's
//     real below elements are copied into shared memory by cp.async
//     first; meanwhile Lt loads all its rows' bidx, then all their
//     gathers, and L runs its n x n phase; x sits in the lanes, and the
//     n x n phase runs on them with shuffles.
//   solve_l_diag_kernel / solve_lt_diag_kernel (every other bucket): one
//     CTA of eight warps per panel for the own rows' phase (Lt: a thread
//     a row of the strict upper); when the below rows are one chunk of at
//     most crc rows, their phase too. The loads that need no result of
//     the panel come first, so that a small panel waits on about one
//     round of loads: below ~256 panels this is quicker than the warp
//     grid.
//   solve_l_rows_kernel / solve_lt_rows_kernel (more below rows than one
//     chunk: FLAT's 15-wide lump, BAL's pair levels, GRID's long panels):
//     a CTA per (panel, chunk of crc rows). L, after the diag grid: each
//     row's dot with x (read back from vv) into y. Lt, before the diag
//     grid: each chunk's column sums into a partial scratch, its gathers
//     loaded a warp's rows at once; the diag grid adds them in chunk
//     order.
// Grids run over (work item, batch item x RHS column): each RHS column
// of each batch item is an independent pass over the same panels; but
// the L warp grid at more than one column runs over (work item, batch
// item), a warp taking the columns in turn from one staged copy of its
// panel's below rows and writing each y row's columns side by side.

#include <cuda_runtime.h>
#include <stdint.h>

#include "level_solve.cuh"

namespace {

// ---------------------------------------------------------------------
// one warp per panel (4 <= CP <= 32)
// ---------------------------------------------------------------------

// L pass: the below rows staged; x = Linv b by column sums of the strict
// upper (lane column m, rows over the groups); then y = below . x by row
// dots from shared memory. KB = 1: one RHS column (blockIdx.y = batch
// item x column); else the warp takes a batch item's columns KB at a
// time from one staged copy, each row's KB dots written side by side
// (for cp <= 8 by a lane a row, its columns in order)
template <typename T, int CP, int KB>
__global__ void __launch_bounds__(kThreads) solve_l_warp_kernel(Sv a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int RG = 32 / CP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t p = (int64_t)blockIdx.x * kWarps + warp;
  if (p >= a.B) return;
  const int nrhs = a.nrhs;
  const Item<T> it(a, p, KB == 1 ? blockIdx.y : blockIdx.y * nrhs);
  const int n = it.n, gi = lane / CP, m = lane % CP;
  T* sp = reinterpret_cast<T*>(smem) + warp * a.rp * CP;
  stage_below<T, CP>(sp, it.P + CP * CP, n, it.nrows, lane);
  for (int k0 = 0; k0 < (KB == 1 ? 1 : nrhs); k0 += KB) {
    T x[KB];
    if constexpr (KB == 1) {
      const T b = m < n ? it.v[(it.v0 + m) * nrhs] : T(0);
      T acc = T(0);
      for (int i0 = 0; i0 < n; i0 += RG) {
        const int i = i0 + gi;  // < 32: i0 < n <= CP and CP + RG <= 32
        const T bi = __shfl_sync(kFull, b, i & 31);
        if (i < n && m > i && m < n) acc += it.P[i * CP + m] * bi;
      }
      acc = across_groups(acc, CP);
      x[0] = m < n ? b / it.P[m * CP + m] + acc : T(0);
      if (gi == 0 && m < n) it.v[(it.v0 + m) * nrhs] = x[0];
    } else {
      // the KB columns' b first, then their column sums side by side (at
      // one column this order ran slower on BAL's point bucket)
      T b[KB], acc[KB];
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        const bool live = k0 + kk < nrhs && m < n;
        b[kk] = live ? it.v[(it.v0 + m) * nrhs + k0 + kk] : T(0);
        acc[kk] = T(0);
      }
      for (int i0 = 0; i0 < n; i0 += RG) {
        const int i = i0 + gi;  // < 32: i0 < n <= CP and CP + RG <= 32
        const bool up = i < n && m > i && m < n;
        const T u = up ? it.P[i * CP + m] : T(0);
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) {
          const T bi = __shfl_sync(kFull, b[kk], i & 31);
          if (up) acc[kk] += u * bi;
        }
      }
      const T dm = m < n ? it.P[m * CP + m] : T(1);
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        acc[kk] = across_groups(acc[kk], CP);
        x[kk] = m < n ? b[kk] / dm + acc[kk] : T(0);
        if (gi == 0 && m < n && k0 + kk < nrhs)
          it.v[(it.v0 + m) * nrhs + k0 + kk] = x[kk];
      }
    }
    if (k0 == 0) {
      cp_async_wait<0>();
      __syncwarp();
    }
    warp_l_y<T, CP, KB>(a, it, sp, x, k0, lane);
  }
}

// Lt pass: the below rows staged, and meanwhile their bidx, then their
// gathers, loaded into shared memory; x = b - below^T g by column sums;
// then vv[own] = Linv^T x by row dots of the strict upper
template <typename T, int CP>
__global__ void __launch_bounds__(kThreads) solve_lt_warp_kernel(Sv a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int RG = 32 / CP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t p = (int64_t)blockIdx.x * kWarps + warp;
  if (p >= a.B) return;
  const Item<T> it(a, p, blockIdx.y);
  const int nrhs = a.nrhs, n = it.n, gi = lane / CP, m = lane % CP;
  T* sp = reinterpret_cast<T*>(smem) + warp * a.rp * (CP + 1);
  const T x = warp_lt_x<T, CP>(a, it, sp, lane);  // x[m] in every lane of
  //                                                  column m
  for (int j0 = 0; j0 < n; j0 += RG) {
    const int j = j0 + gi;  // < 32, as i in the L pass
    const T e = j < n && m > j && m < n ? it.P[j * CP + m] : T(0);
    const T d = group_sum(e * x, CP);
    const T xj = __shfl_sync(kFull, x, j & 31);
    if (m == 0 && j < n) it.v[(it.v0 + j) * nrhs] = xj / it.P[j * CP + j] + d;
  }
}

// ---------------------------------------------------------------------
// CTAs per panel: G = min(cp, 32) lanes a row, CT columns a lane
// ---------------------------------------------------------------------

// L pass, the own rows of panel blockIdx.x: x = Linv b (column sums of
// the strict upper over the warps), into vv; with one chunk of below
// rows, their dots into y too. b and the diagonal are loaded first and,
// with ahead<CT>(), the first step's rows of the strict upper and of the
// below rows too, before the first barrier, so that a small panel waits
// on about one round of loads
template <typename T, int CT>
__global__ void __launch_bounds__(kThreads) solve_l_diag_kernel(Sv a) {
  __shared__ T red[kWarps][CT * 32];
  __shared__ T sx[CT * 32];
  const int64_t p = blockIdx.x;
  const Item<T> it(a, p, blockIdx.y);
  const int cp = a.cp, nrhs = a.nrhs, n = it.n, G = cp < 32 ? cp : 32;
  const int RG = 32 / G, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane / G, m = lane % G, step = kWarps * RG;
  T bj[2], dj[2];  // b and the diagonal of columns tid, tid + kThreads
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = threadIdx.x + u * kThreads;
    bj[u] = j < n ? it.v[(it.v0 + j) * nrhs] : T(0);
    dj[u] = j < n ? it.P[(int64_t)j * cp + j] : T(1);
    if (j < n) sx[j] = bj[u];
  }
  T e[CT], acc[CT];
#pragma unroll
  for (int t = 0; t < CT; ++t) acc[t] = e[t] = T(0);
  int ib0 = warp * RG;  // the first step that reads b from shared memory
  if (ahead<CT>()) {
    below_row<T, CT>(a, it, a.nchunk == 1 ? ib0 + gi : it.nrows, m, e);
    const int i = ib0 + gi;
    const T bi = i < n ? it.v[(it.v0 + i) * nrhs] : T(0);
#pragma unroll
    for (int t = 0; t < CT; ++t) {
      const int col = m + 32 * t;
      if (i < n && col > i && col < n)
        acc[t] += it.P[(int64_t)i * cp + col] * bi;
    }
    ib0 += step;
  }
  __syncthreads();
#pragma unroll 4
  for (int ib = ib0; ib < n; ib += step) {
    const int i = ib + gi;
    if (i < n) {
      const T bi = sx[i];
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        const int col = m + 32 * t;
        if (col > i && col < n) acc[t] += it.P[(int64_t)i * cp + col] * bi;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < CT; ++t) {
    acc[t] = across_groups(acc[t], G);
    if (gi == 0) red[warp][m + 32 * t] = acc[t];
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = threadIdx.x + u * kThreads;
    if (j >= n) break;
    T s = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][j];
    const T x = bj[u] / dj[u] + s;
    sx[j] = x;
    it.v[(it.v0 + j) * nrhs] = x;
  }
  if (a.nchunk != 1) return;
  __syncthreads();
  T xs[CT];
#pragma unroll
  for (int t = 0; t < CT; ++t) {
    const int col = m + 32 * t;
    xs[t] = col < n ? sx[col] : T(0);
  }
  l_below_dots<T, CT>(a, it, 0, a.rp, xs, e);
}

// L pass, below rows of chunk blockIdx.x % nchunk, after the diag grid
template <typename T, int CT>
__global__ void __launch_bounds__(kThreads) solve_l_rows_kernel(Sv a) {
  l_rows<T, CT>(a);
}

// Lt pass, below rows of chunk blockIdx.x % nchunk, before the diag grid
template <typename T, int CT>
__global__ void __launch_bounds__(kThreads) solve_lt_rows_kernel(Sv a) {
  __shared__ T red[kWarps][CT * 32];
  lt_rows<T, CT>(a, red);
}

// Lt pass, panel blockIdx.x: x = b - (the below rows' column sums: of its
// one chunk here, or the rows grid's partials in chunk order), then vv[own]
// = Linv^T x, a thread a row of the strict upper walking its columns in
// order (each row's loads stay in its thread's cache lines); b and the
// diagonal are loaded first
template <typename T, int CT>
__global__ void __launch_bounds__(kThreads) solve_lt_diag_kernel(Sv a) {
  __shared__ T red[kWarps][CT * 32];
  __shared__ T sx[CT * 32];
  const int64_t p = blockIdx.x;
  const Item<T> it(a, p, blockIdx.y);
  const int cp = a.cp, nrhs = a.nrhs, n = it.n;
  T bj[2], dj[2];  // b and the diagonal of columns tid, tid + kThreads
  lt_diag_x<T, CT>(a, it, bj, dj, red, sx);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = threadIdx.x + u * kThreads;
    if (j >= n) break;
    const T* Pj = it.P + (int64_t)j * cp;
    T z = sx[j] / dj[u];
    for (int m = j + 1; m < n; ++m) z += Pj[m] * sx[m];
    it.v[(it.v0 + j) * nrhs] = z;
  }
}

// shared memory of a warp grid's CTA: each warp's staged below rows
// (and, Lt, their gathers), up to 80 KB, past the default 48. The Lt
// grid and the L grid at one RHS column run over (panels, batch item x
// column); the L grid at more columns over (panels, batch item), a warp
// taking 4 columns at a time
template <typename T, int CP>
int launch_warp(const Sv& a, bool lt, int batch, cudaStream_t st) {
  constexpr int KB = 4;
  static bool sized = false;
  if (!sized) {
    const int most = kWarps * (kWarpElems + kWarpElems / CP) * sizeof(T);
    cudaFuncSetAttribute(solve_l_warp_kernel<T, CP, 1>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    cudaFuncSetAttribute(solve_l_warp_kernel<T, CP, KB>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    cudaFuncSetAttribute(solve_lt_warp_kernel<T, CP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    sized = true;
  }
  const unsigned bx = (unsigned)((a.B + kWarps - 1) / kWarps);
  const size_t smem = kWarps * a.rp * (CP + (lt ? 1 : 0)) * sizeof(T);
  if (lt)
    solve_lt_warp_kernel<T, CP><<<dim3(bx, batch * a.nrhs), kThreads, smem,
                                  st>>>(a);
  else if (a.nrhs == 1)
    solve_l_warp_kernel<T, CP, 1><<<dim3(bx, batch), kThreads, smem, st>>>(a);
  else
    solve_l_warp_kernel<T, CP, KB><<<dim3(bx, batch), kThreads, smem, st>>>(
        a);
  return (int)cudaGetLastError();
}

template <typename T, int CT>
int launch_cta(const Sv& a, bool lt, unsigned zk, cudaStream_t st) {
  const dim3 diag((unsigned)a.B, zk);
  const dim3 rows((unsigned)(a.B * a.nchunk), zk);
  cudaError_t e;
  if (lt) {
    if (a.nchunk > 1) {
      solve_lt_rows_kernel<T, CT><<<rows, kThreads, 0, st>>>(a);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    solve_lt_diag_kernel<T, CT><<<diag, kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  solve_l_diag_kernel<T, CT><<<diag, kThreads, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess || a.nchunk <= 1) return (int)e;
  solve_l_rows_kernel<T, CT><<<rows, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Sv& a, bool lt, int batch, cudaStream_t st) {
  const unsigned zk = (unsigned)(batch * a.nrhs);
  const int cp = a.cp;
  if (cp < 1 || cp > 512 || (cp & (cp - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (a.crc == 0) {
    if (cp < 4 || cp > 32 || a.rp * cp > kWarpElems)
      return (int)cudaErrorInvalidValue;
    switch (cp) {
      case 4: return launch_warp<T, 4>(a, lt, batch, st);
      case 8: return launch_warp<T, 8>(a, lt, batch, st);
      case 16: return launch_warp<T, 16>(a, lt, batch, st);
      default: return launch_warp<T, 32>(a, lt, batch, st);
    }
  }
  const int RG = 32 / (cp < 32 ? cp : 32);
  if (a.crc > kMaxChunk || a.crc % (kWarps * RG) != 0 ||
      (int64_t)a.nchunk * a.crc < a.rp)
    return (int)cudaErrorInvalidValue;
  switch (cp >= 32 ? cp / 32 : 1) {
    case 1: return launch_cta<T, 1>(a, lt, zk, st);
    case 2: return launch_cta<T, 2>(a, lt, zk, st);
    case 4: return launch_cta<T, 4>(a, lt, zk, st);
    case 8: return launch_cta<T, 8>(a, lt, zk, st);
    default: return launch_cta<T, 16>(a, lt, zk, st);
  }
}

}  // namespace

// dtype: 0 float32, 1 float64; transpose: 0 L pass, 1 Lt pass. chunk /
// nchunk: the grid layout (ops/kernels.py solve_layout; chunk 0: one warp
// per panel); part: the Lt pass's column partials, batch * nrhs * B *
// nchunk * cp elements, read only with nchunk > 1. Returns the
// cudaError_t of the launches.
extern "C" int bs_bucket_solve(int dtype, int transpose, const void* data,
                               int64_t data_bstride, void* vv,
                               int64_t vv_bstride, void* y, int64_t y_bstride,
                               int64_t y_base, void* part, const int64_t* off,
                               const int64_t* rows, const int64_t* cols,
                               const int64_t* vec_off,
                               const int64_t* below_idx, int64_t order,
                               int64_t B, int cp, int rp, int nrhs,
                               int batch, int chunk, int nchunk,
                               void* stream) {
  if (B == 0) return 0;
  Sv a{data, data_bstride, vv, vv_bstride, y, y_bstride, y_base, part, off,
       rows, cols, vec_off, below_idx, order, B, cp, rp, nrhs, chunk,
       nchunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, transpose != 0, batch, s);
  if (dtype == 1) return launch<double>(a, transpose != 0, batch, s);
  return (int)cudaErrorInvalidValue;
}
