// Building blocks shared by K1 (bucket_factor.cu), K1-wide
// (wide_factor.cu), K3 (bucket_solve.cu), K4 (dense_level.cu) and K5
// (add_mv.cu): the register-resident 32 x 32 Cholesky and inverse of a
// diagonal block; a warp's 32 x 32 block of a product A . B^T over 32
// columns on the f64 tensor cores (mma.m8n8k4), or by FMAs in f32, and
// its step; cp.async copies; a CTA's 64 x 64 tile of x x^T from cp.async stages; butterfly sums over
// groups of lanes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSub = 32;  // sub-block width: one warp's diagonal block

// One warp factors and inverts the pw x pw (pw <= kW <= 32) diagonal
// block at (p0, p0) of A (row stride ls): the Cholesky in registers (lane
// r holds row r, columns move by shuffles), the next pivot's reciprocal
// square root taken as soon as its column is updated, so that its
// latency overlaps the rest of the step; then the inverse X, lane c
// holding column c, right-looking: once X[k][c] is known it is folded
// into the sums of every later row, s[i] += L[i][k] X[k][c], so each
// step waits on two operations, not on a sum of k terms. L goes back
// below the diagonal, X^T above it, the diagonal of X into dx. Only the
// lower triangle is read; rows and columns pw..kW-1 of the block must be
// zero, and dx[p0 + pw .. p0 + kW) defined (zero, say). Columns past pw
// take a unit pivot, which changes nothing, so the steps run without
// branches. A block that is not positive definite gives NaN from its
// failing column on. No barriers beyond the warp's own.
template <int kW, typename T>
__device__ void warp_chol_inv(T* A, T* dx, int ls, int p0, int pw) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  T* D = A + p0 * ls + p0;  // the sub-block, row stride ls
  {
    T row[kW];
#pragma unroll
    for (int c = 0; c < kW; ++c)
      row[c] = (lane < pw && c <= lane) ? D[lane * ls + c] : T(0);
    // the pivot of column k (a unit pivot past pw) and its 1 / sqrt
    T akk = pw > 0 ? __shfl_sync(kAll, row[0], 0) : T(1);
    T inv = rsqrt(akk);
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      row[k] = lane == k ? akk * inv : row[k] * inv;
      T akk1 = T(1), inv1 = T(1);
      if (k + 1 < kW) {  // column k + 1 first: it holds the next pivot
        const T lck = __shfl_sync(kAll, row[k], k + 1);
        if (k + 1 <= lane) row[k + 1] -= row[k] * lck;
        const T a = __shfl_sync(kAll, row[k + 1], k + 1);
        akk1 = k + 1 < pw ? a : T(1);
        inv1 = rsqrt(akk1);
      }
#pragma unroll
      for (int c = k + 2; c < kW; ++c) {
        const T lck = __shfl_sync(kAll, row[k], c);
        if (c <= lane) row[c] -= row[k] * lck;
      }
      akk = akk1;
      inv = inv1;
    }
    if (lane < pw) {
      T d = T(0);  // row[lane], without indexing row at run time (which
      //              would put it in local memory)
#pragma unroll
      for (int c = 0; c < kW; ++c) {
        if (c <= lane) D[lane * ls + c] = row[c];
        if (c == lane) d = row[c];
      }
      dx[p0 + lane] = T(1) / d;
    }
  }
  __syncwarp();
  // X[k][c] = 1 / L[k][k] for k = c, -s[k] / L[k][k] for k > c
  T s[kW];
#pragma unroll
  for (int i = 0; i < kW; ++i) s[i] = T(0);
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    const T dk = dx[p0 + k];
    const T xk = lane == k ? dk : (lane < k ? -s[k] * dk : T(0));
    if (k > lane && k < pw) D[lane * ls + k] = xk;
#pragma unroll
    for (int i = k + 1; i < kW; ++i) s[i] += D[i * ls + k] * xk;
  }
}

// One step of a warp's 8 NM x 8 NN block acc += A B^T in mma32's layout
// (below). f64: four columns on the tensor cores, an mma.m8n8k4 per 8 x 8
// part, a[mi] A's fragment (row mi * 8 + lane / 4, column lane % 4), b[nj]
// B's (column nj * 8 + lane / 4, row lane % 4).
template <int NM, int NN>
__device__ __forceinline__ void mma_step(double (&acc)[NM][NN][2],
                                         const double (&a)[NM],
                                         const double (&b)[NN]) {
#pragma unroll
  for (int mi = 0; mi < NM; ++mi)
#pragma unroll
    for (int nj = 0; nj < NN; ++nj)
      asm volatile(
          "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, "
          "{%2}, {%3}, {%0, %1};\n"
          : "+d"(acc[mi][nj][0]), "+d"(acc[mi][nj][1])
          : "d"(a[mi]), "d"(b[nj]));
}

// f32: one column by FMAs, a[mi] A's element in row mi * 8 + lane / 4,
// b[nj][h] B's in column nj * 8 + (lane % 4) * 2 + h.
template <int NM, int NN>
__device__ __forceinline__ void mma_step(float (&acc)[NM][NN][2],
                                         const float (&a)[NM],
                                         const float (&b)[NN][2]) {
#pragma unroll
  for (int mi = 0; mi < NM; ++mi)
#pragma unroll
    for (int nj = 0; nj < NN; ++nj) {
      acc[mi][nj][0] += a[mi] * b[nj][0];
      acc[mi][nj][1] += a[mi] * b[nj][1];
    }
}

// A warp's 32 x 32 block acc += A B^T over 32 columns: acc[mi][nj][h] is
// the element (mi * 8 + lane / 4, nj * 8 + (lane % 4) * 2 + h); fa(r, k)
// and fb(c, k) give A's and B's elements (r, c, k < 32), so any layout,
// transpose or mask is the caller's. f64: eight mma.m8n8k4 steps of four
// columns (A row lane / 4, column lane % 4; B column lane / 4, row
// lane % 4), in a fixed order. kPreA: A's fragments of four steps are
// loaded together before their products (for an A read from device
// memory: one wait on its latency per 16 columns, not per 4).
template <bool kPreA = false, typename FA, typename FB>
__device__ __forceinline__ void mma32(double (&acc)[4][4][2], const FA& fa,
                                      const FB& fb, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < kSub; kc += 16) {
    double pa[4][4];
    if constexpr (kPreA) {
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int m = 0; m < 4; ++m) pa[s][m] = fa(m * 8 + g, kc + 4 * s + t);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k0 = kc + 4 * s;
      double a[4], b[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        a[m] = kPreA ? pa[s][m] : fa(m * 8 + g, k0 + t);
        b[m] = fb(m * 8 + g, k0 + t);
      }
      mma_step(acc, a, b);
    }
  }
}

// f32: FMAs over the 32 columns in order (no TF32: it would keep ~3
// digits, and the f32 factor must stay near a 4e-7 residual); plain code
// whose loads the compiler schedules ahead itself, so kPreA is moot.
template <bool kPreA = false, typename FA, typename FB>
__device__ __forceinline__ void mma32(float (&acc)[4][4][2], const FA& fa,
                                      const FB& fb, int lane) {
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll 4
  for (int k = 0; k < kSub; ++k) {
    float a[4], b[4][2];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      a[m] = fa(m * 8 + g, k);
      b[m][0] = fb(m * 8 + t2, k);
      b[m][1] = fb(m * 8 + t2 + 1, k);
    }
    mma_step(acc, a, b);
  }
}

// one element, global -> shared; src_bytes 0 writes a zero
template <typename T>
__device__ __forceinline__ void cp_async_el(T* dst, const T* src,
                                            int src_bytes = sizeof(T)) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
}

// 16 bytes, global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kTile = 64;          // gram_tile: tile edge
constexpr int kTk = 32;            // columns per stage
constexpr int kTld = kTk + 4;      // padded stage row: conflict-free frags
constexpr int kTileThreads = 128;  // 2 x 2 warps of 32 x 32

// The 64 x 64 block at (r0, c0) of x x^T, x (rows x n, row stride ld)
// read as zero past `rows` and past column n, for a CTA of kTileThreads:
// 32-column stages of both row blocks are loaded by cp.async into sm
// (2 x 2 kTile x kTld values), double-buffered so that one stage's loads
// overlap the previous stage's products; warp w sums the quarter
// (w / 2, w % 2) into acc with mma32, in column order. sm may be reused
// when it returns.
template <typename T>
__device__ void gram_tile(T (&acc)[4][4][2], const T* X, int64_t ld, int n,
                          int64_t rows, int64_t r0, int64_t c0, T* sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int nchunk = (n + kTk - 1) / kTk;
  // stage rows r0.. (shared rows 0-63) and c0.. (64-127), columns
  // k0..k0+31
  const auto stage = [&](int ci) {
    T* b = sm + (ci & 1) * 2 * kTile * kTld;
    const int k0 = ci * kTk;
    for (int i = tid; i < 2 * kTile * kTk; i += kTileThreads) {
      const int r = i / kTk, k = i % kTk;
      const int64_t row = r < kTile ? r0 + r : c0 + r - kTile;
      const bool ok = row < rows && k0 + k < n;
      cp_async_el(b + r * kTld + k, ok ? X + row * ld + k0 + k : X,
                  ok ? (int)sizeof(T) : 0);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) acc[mi][nj][0] = acc[mi][nj][1] = T(0);
  if (nchunk > 0) stage(0);
  for (int ci = 0; ci < nchunk; ++ci) {
    if (ci + 1 < nchunk) {
      stage(ci + 1);  // its buffer was last read in chunk ci - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* a = sm + (ci & 1) * 2 * kTile * kTld + wm * 32 * kTld;
    const T* b = sm + (ci & 1) * 2 * kTile * kTld + (kTile + wn * 32) * kTld;
    mma32(acc, [&](int r, int k) { return a[r * kTld + k]; },
          [&](int c, int k) { return b[c * kTld + k]; }, lane);
    __syncthreads();  // chunk ci's buffer may be refilled
  }
}

// f(element, row, column) for each of a warp's 32 x 32 block elements in
// the layout of mma32
template <typename T, typename F>
__device__ __forceinline__ void acc_each(T (&acc)[4][4][2], int lane,
                                         const F& f) {
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(acc[mi][nj][h], mi * 8 + g, nj * 8 + t2 + h);
}

// sum over aligned groups of G lanes (G a power of two), every lane of
// the group gets it
template <typename T>
__device__ __forceinline__ T group_sum(T v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum over the lanes of the same position in each group of G lanes
template <typename T>
__device__ __forceinline__ T across_groups(T v, int G) {
  for (int o = G; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Tile t of the lower triangle of a grid of tiles, row by row:
// t = I (I + 1) / 2 + J with J <= I.
__device__ __forceinline__ void tri_tile(int t, int& I, int& J) {
  int i = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  while (i * (i + 1) / 2 > t) --i;
  I = i;
  J = t - i * (i + 1) / 2;
}

}  // namespace
