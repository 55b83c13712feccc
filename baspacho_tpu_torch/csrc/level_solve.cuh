// Pieces shared by K3 (bucket_solve.cu: the level solve from the stored
// inverse) and K3-rest narrow (tri_solve.cu: the same solve by
// substitution on the lower triangle). The two differ only in how a
// panel's own n x n block maps b to x; their below phases are the same:
//   L pass:  y[y_base + p * rp + r] = below[r] . x   (0 past nrows; K2
//            then applies vv[bidx] -= y)
//   Lt pass: x[j] = b[j] - sum_r below[r][j] vv[bidx[r]]  (no term for
//            the sentinel bidx == order)
// Here: a launch's operands (Sv), a work item's (Item), the warp grid's
// staged below rows, its y dots and its Lt gathers and column sums, the
// CTA grids' below dots and column sums by chunks of rows, the rows
// grids' bodies and the Lt diag grid's x. Every sum's order depends on
// the bucket's shape (cp, rp, panels) only (ops/kernels.py
// solve_layout), so batch items equal their single runs and reruns each
// other, bitwise. See bucket_solve.cu for the lane layout.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_tiles.cuh"

namespace {

constexpr int kWarps = 8;  // warps per CTA of every grid
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpElems = 1024;  // rp * cp of a warp's panel at most
//                                   (ops/kernels.py SOLVE_WARP_ELEMS)
constexpr int kMaxChunk = 256;  // below rows per chunk at most: 32 a warp
constexpr unsigned kFull = 0xffffffffu;

// one launch's operands and grid layout (bs_bucket_solve); strides in
// elements
struct Sv {
  const void* data;
  int64_t data_bs;
  void* vv;
  int64_t vv_bs;
  void* y;
  int64_t y_bs;
  int64_t y_base;  // first y row of the bucket
  void* part;      // Lt column partials: (batch x RHS, B, nchunk, cp)
  const int64_t* off;
  const int64_t* rows;
  const int64_t* cols;
  const int64_t* vec_off;
  const int64_t* bidx;
  int64_t order;
  int64_t B;
  int cp, rp, nrhs;
  int crc;     // below rows per chunk (0: one warp per panel)
  int nchunk;  // ceil(rp / crc)
};

// the operands of work item (panel p, zk = batch item z x RHS column k)
template <typename T>
struct Item {
  const T* P;  // the panel, (cp + rp) x cp
  T* v;        // vv of batch item z, column k: element i at v[i * nrhs]
  T* y;        // the panel's y rows, column k (nullptr without below rows)
  const int64_t* bidx;
  int64_t v0;
  int n, nrows;
  __device__ __forceinline__ Item(const Sv& a, int64_t p, int zk) {
    const int z = zk / a.nrhs, k = zk % a.nrhs;
    P = static_cast<const T*>(a.data) + z * a.data_bs + a.off[p];
    v = static_cast<T*>(a.vv) + z * a.vv_bs + k;
    y = a.rp > 0 && a.y != nullptr
            ? static_cast<T*>(a.y) + z * a.y_bs +
                  (a.y_base + p * a.rp) * a.nrhs + k
            : nullptr;
    bidx = a.bidx + p * a.rp;
    v0 = a.vec_off[p];
    n = (int)a.cols[p];
    nrows = a.rp > 0 ? (int)a.rows[p] : 0;
  }
};

// the panel's real below elements (rows < nrows, columns < n; zeros in
// their place elsewhere) copied into sp by cp.async, in flight until
// cp_async_wait
template <typename T, int CP>
__device__ __forceinline__ void stage_below(T* sp, const T* below, int n,
                                            int nrows, int lane) {
  for (int e = lane; e < nrows * CP; e += 32) {
    const bool real = e % CP < n;
    cp_async_el(sp + e, real ? below + e : below, real ? (int)sizeof(T) : 0);
  }
  cp_async_commit();
}

// y = below . x of a warp's panel (L pass), x[kk] the RHS columns k0 +
// kk of this lane's column m in every group, the below rows staged in
// sp. KB > 1 and CP <= 8: a lane a row, its KB columns' x broadcast to
// every lane (no butterfly per column, and the warp writes its rows' y
// whole); else RG rows a step, each row's dot by a butterfly in its
// group
template <typename T, int CP, int KB>
__device__ __forceinline__ void warp_l_y(const Sv& a, const Item<T>& it,
                                         const T* sp, const T (&x)[KB],
                                         int k0, int lane) {
  constexpr int RG = 32 / CP;
  const int nrhs = a.nrhs, n = it.n, gi = lane / CP, m = lane % CP;
  if constexpr (KB > 1 && CP <= 8) {
    T xc[KB][CP];
#pragma unroll
    for (int kk = 0; kk < KB; ++kk)
#pragma unroll
      for (int c = 0; c < CP; ++c) xc[kk][c] = __shfl_sync(kFull, x[kk], c);
    for (int r = lane; r < a.rp; r += 32) {
      T d[KB];
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) d[kk] = T(0);
      if (r < it.nrows) {
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          const T e = sp[r * CP + c];  // 0 past the real columns
#pragma unroll
          for (int kk = 0; kk < KB; ++kk) d[kk] += e * xc[kk][c];
        }
      }
#pragma unroll
      for (int kk = 0; kk < KB; ++kk)
        if (k0 + kk < nrhs) it.y[(int64_t)r * nrhs + k0 + kk] = d[kk];
    }
  } else {
    for (int r0 = 0; r0 < a.rp; r0 += RG) {
      const int r = r0 + gi;
      const T e = r < it.nrows && m < n ? sp[r * CP + m] : T(0);
      T d[KB];
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) d[kk] = group_sum(e * x[kk], CP);
      if (m == 0 && r < a.rp) {
#pragma unroll
        for (int kk = 0; kk < KB; ++kk)
          if (KB == 1 || k0 + kk < nrhs)
            it.y[(int64_t)r * nrhs + k0 + kk] = d[kk];
      }
    }
  }
}

// x = b - below^T g of a warp's panel (Lt pass) in RHS column k of the
// item's vv, returned in every lane of column m: the below rows staged
// into sp (with `stage`; without, a copy staged by an earlier call is
// read again) and meanwhile their bidx, then their gathers g, loaded
// into shared memory after them (NQ x 32 rows' gathers at once); then
// column sums, lane column m, rows over the groups in row order, joined
// across the groups by a butterfly. sp holds rp x (CP + 1) elements
template <typename T, int CP>
__device__ __forceinline__ T warp_lt_x(const Sv& a, const Item<T>& it,
                                       T* sp, int lane, int k = 0,
                                       bool stage = true) {
  constexpr int RG = 32 / CP, NQ = 4;
  const int nrhs = a.nrhs, n = it.n, nrows = it.nrows;
  const int gi = lane / CP, m = lane % CP;
  T* gsm = sp + a.rp * CP;
  int64_t q[NQ];
#pragma unroll
  for (int w = 0; w < NQ; ++w) {
    const int i = 32 * w + lane;
    q[w] = i < nrows ? it.bidx[i] : a.order;
  }
  if (stage)
    stage_below<T, CP>(sp, it.P + CP * CP, n, nrows, lane);
  else
    __syncwarp();  // the last column's sums have read gsm
  for (int i0 = 0; i0 < nrows; i0 += 32 * NQ) {
#pragma unroll
    for (int w = 0; w < NQ; ++w) {
      const int i = i0 + 32 * w + lane;
      if (i0 > 0) q[w] = i < nrows ? it.bidx[i] : a.order;
    }
#pragma unroll
    for (int w = 0; w < NQ; ++w) {
      const int i = i0 + 32 * w + lane;
      if (i < nrows)
        gsm[i] = q[w] != a.order ? it.v[q[w] * nrhs + k] : T(0);
    }
  }
  const T b = m < n ? it.v[(it.v0 + m) * nrhs + k] : T(0);
  if (stage) cp_async_wait<0>();
  __syncwarp();
  T acc = T(0);
  for (int i0 = 0; i0 < nrows; i0 += RG) {
    const int i = i0 + gi;
    if (i < nrows && m < n) acc += sp[i * CP + m] * gsm[i];
  }
  acc = across_groups(acc, CP);
  return b - acc;
}

// Lt column sums of the below rows [r0, r1) (r1 - r0 <= kMaxChunk) into
// red[warp][column]: warp w on the rows of steps w, w + 8, ..., its
// rows' gathers loaded first, lane l holding the l-th
template <typename T, int CT>
__device__ __forceinline__ void lt_below_sums(const Sv& a, const Item<T>& it,
                                              int r0, int r1,
                                              T (*red)[CT * 32]) {
  const int cp = a.cp, G = cp < 32 ? cp : 32, RG = 32 / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane / G, m = lane % G;
  const int il = r0 + warp * RG + (lane / RG) * kWarps * RG + lane % RG;
  T gw = T(0);
  if (il < r1) {
    const int64_t q = it.bidx[il];
    if (q != a.order) gw = it.v[q * a.nrhs];
  }
  const T* below = it.P + (int64_t)cp * cp;
  T acc[CT];
#pragma unroll
  for (int t = 0; t < CT; ++t) acc[t] = T(0);
  int kk = 0;
#pragma unroll(CT >= 16 ? 1 : 16 / CT)
  for (int ib = r0 + warp * RG; ib < r1; ib += kWarps * RG, ++kk) {
    const int i = ib + gi;
    const T g = __shfl_sync(kFull, gw, kk * RG + gi);
    const T* Bi = below + (int64_t)i * cp;
#pragma unroll
    for (int t = 0; t < CT; ++t) {
      const int col = m + 32 * t;
      if (i < r1 && col < it.n) acc[t] += Bi[col] * g;
    }
  }
#pragma unroll
  for (int t = 0; t < CT; ++t) {
    acc[t] = across_groups(acc[t], G);
    if (gi == 0) red[warp][m + 32 * t] = acc[t];
  }
}

// below row r's elements in this lane's columns (col = m + 32 t), 0 past
// the real rows and columns
template <typename T, int CT>
__device__ __forceinline__ void below_row(const Sv& a, const Item<T>& it,
                                          int r, int m, T (&e)[CT]) {
  const T* Br = it.P + (int64_t)(a.cp + r) * a.cp;
#pragma unroll
  for (int t = 0; t < CT; ++t) {
    const int col = m + 32 * t;
    e[t] = r < it.nrows && col < it.n ? Br[col] : T(0);
  }
}

// whether a CTA grid's lanes load a step's rows ahead of the step that
// needs them: for up to 4 columns a lane (cp <= 128); wider lanes keep
// their registers for the columns (ahead, cp 256 and 512 ran ~1.5x
// slower in f64)
template <int CT>
__host__ __device__ constexpr bool ahead() {
  return CT <= 4;
}

// y rows [r0, r1) of the L pass: row dots with x (x[col] in xs[t] for
// col = m + 32 t), 0 past nrows. With ahead<CT>(), e holds the elements
// of this thread's first row, loaded by the caller ahead of x, and each
// step loads the next step's row before its dot; else each step loads
// its own row into e
template <typename T, int CT>
__device__ __forceinline__ void l_below_dots(const Sv& a, const Item<T>& it,
                                             int r0, int r1, const T* xs,
                                             T (&e)[CT]) {
  const int cp = a.cp, G = cp < 32 ? cp : 32, RG = 32 / G;
  const int step = kWarps * RG, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, gi = lane / G, m = lane % G;
#pragma unroll(CT >= 8 ? 1 : 8 / CT)
  for (int rb = r0 + warp * RG; rb < r1; rb += step) {
    const int r = rb + gi;
    T nx[CT];
    if (ahead<CT>())
      below_row<T, CT>(a, it, r + step < r1 ? r + step : it.nrows, m, nx);
    else
      below_row<T, CT>(a, it, r, m, e);
    T d = T(0);
#pragma unroll
    for (int t = 0; t < CT; ++t) {
      const int col = m + 32 * t;
      if (r < it.nrows && col < it.n) d += e[t] * xs[t];
      if (ahead<CT>()) e[t] = nx[t];
    }
    d = group_sum(d, G);
    if (m == 0 && r < r1) it.y[(int64_t)r * a.nrhs] = d;
  }
}

// the rows grids' bodies (a CTA per (panel, chunk of crc below rows))
// L pass, below rows of chunk blockIdx.x % nchunk, after the diag grid:
// their dots with x from vv into y
template <typename T, int CT>
__device__ __forceinline__ void l_rows(const Sv& a) {
  const int64_t p = blockIdx.x / a.nchunk;
  const int c = (int)(blockIdx.x % a.nchunk);
  const Item<T> it(a, p, blockIdx.y);
  const int G = a.cp < 32 ? a.cp : 32, m = (threadIdx.x & 31) % G;
  const int r0 = c * a.crc, r1 = min(r0 + a.crc, a.rp);
  const int RG = 32 / G, gi = (threadIdx.x & 31) / G;
  T e[CT], xs[CT];
  if (ahead<CT>())
    below_row<T, CT>(a, it, r0 + (threadIdx.x >> 5) * RG + gi, m, e);
#pragma unroll
  for (int t = 0; t < CT; ++t) {
    const int col = m + 32 * t;
    xs[t] = col < it.n ? it.v[(it.v0 + col) * a.nrhs] : T(0);
  }
  l_below_dots<T, CT>(a, it, r0, r1, xs, e);
}

// Lt pass, below rows of chunk blockIdx.x % nchunk, before the diag grid:
// their column sums into the partial scratch (chunks past the real rows
// write nothing, and the diag grid reads nothing of them)
template <typename T, int CT>
__device__ __forceinline__ void lt_rows(const Sv& a, T (*red)[CT * 32]) {
  const int64_t p = blockIdx.x / a.nchunk;
  const int c = (int)(blockIdx.x % a.nchunk);
  const Item<T> it(a, p, blockIdx.y);
  const int r0 = c * a.crc;
  if (r0 >= it.nrows) return;
  lt_below_sums<T, CT>(a, it, r0, min(r0 + a.crc, it.nrows), red);
  __syncthreads();
  T* part = static_cast<T*>(a.part) +
            (((int64_t)blockIdx.y * a.B + p) * a.nchunk + c) * a.cp;
  for (int j = threadIdx.x; j < it.n; j += kThreads) {
    T s = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][j];
    part[j] = s;
  }
}

// Lt diag grid, panel blockIdx.x: b and the diagonal of columns tid, tid
// + kThreads into bj, dj (loaded first), then sx[j] = x[j] = b[j] - (the
// below rows' column sums: of its one chunk here, or the rows grid's
// partials in chunk order); ends with a barrier
template <typename T, int CT>
__device__ __forceinline__ void lt_diag_x(const Sv& a, const Item<T>& it,
                                          T (&bj)[2], T (&dj)[2],
                                          T (*red)[CT * 32], T* sx) {
  const int cp = a.cp, nrhs = a.nrhs, n = it.n, nrows = it.nrows;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = threadIdx.x + u * kThreads;
    bj[u] = j < n ? it.v[(it.v0 + j) * nrhs] : T(0);
    dj[u] = j < n ? it.P[(int64_t)j * cp + j] : T(1);
  }
  const bool one = a.nchunk == 1 && nrows > 0;
  if (one) lt_below_sums<T, CT>(a, it, 0, nrows, red);
  __syncthreads();
  const T* part = static_cast<const T*>(a.part) +
                  ((int64_t)blockIdx.y * a.B + blockIdx.x) * a.nchunk * cp;
  const int nc = a.nchunk > 1 ? (nrows + a.crc - 1) / a.crc : 0;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = threadIdx.x + u * kThreads;
    if (j >= n) break;
    T s = T(0);
    if (one) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][j];
    }
    for (int c = 0; c < nc; ++c) s += part[(int64_t)c * cp + j];
    sx[j] = bj[u] - s;
  }
  __syncthreads();
}

}  // namespace
