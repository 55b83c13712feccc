// K1 bucket_factor: batched supernode panel factor of one bucket.
//
// Replaces PlannedBackend._factor_bucket
// (baspacho_tpu/ops/planned_backend.py:1423) with its helpers
// _pad_eye, _factor_panels, _unrolled_chol, _unrolled_lower_inv,
// _lower_inv and _embed_inv (:1269-1464), for padded widths cp <= 512.
//
// Every panel is [(cp x cp) diag | (rp x cp) below], row-major with row
// stride cp, at flat offset off[i] of the data buffer. With n = cols[i]
// the real width (columns >= n are padding, held at zero), the kernels
//   * factor L = chol(diag[:n, :n]) from the lower triangle only; the
//     padded columns carry the identity in the JAX routine, which leaves
//     them zero in the stored block, so they are skipped here;
//   * store L on and below the diagonal and Linv^T strictly above it
//     (the layout of _embed_inv);
//   * overwrite the below block with x = below . Linv^T;
//   * write the products x . x^T, (rp x rp) per panel, into the level's
//     product buffer at prod_base + i * rp * rp (zero on rows at or past
//     rows[i]), unless prod is null: a dense level's update
//     (dense_level.cu) reads x from the data instead.
//
// Three grids, launched back to back on the current stream (chol, then,
// with below rows, below and prod):
//   chol_warp   (cp <= 32) one warp per panel, four panels per CTA: the
//               panel's Cholesky and inverse in registers (warp_chol_inv,
//               warp_tiles.cuh);
//   chol_block  (cp > 32) one CTA per (panel, batch item): a blocked
//               right-looking Cholesky in sub-blocks of 32 columns (one
//               warp factors and inverts the diagonal block in registers;
//               all warps solve the rows below it and update the trailing
//               lower triangle, 32 x 32 tiles on the f64 tensor cores;
//               the next diagonal block is factored while the rest of the
//               update runs), then the inverse by block rows,
//               X[i, :i] = -Dinv_i (L[i, :i] X[:i, :i])
//               (_blocked_lower_inv :1353). The panel is worked in place
//               in device memory (L2-resident; a copy in shared memory
//               was no faster). About n / 16 steps of a few barriers each:
//               the old design took 2n dependent steps, each up to three
//               barriers and a pass over the panel.
//   below_warp  (cp <= 16) one warp per (panel, chunk of up to 128 below
//               rows), four a CTA: lanes over the rows' elements, a row's
//               others by shuffles;
//   below_tile  (cp >= 32) one CTA per (panel, block of 8, 16 or 32 below
//               rows, batch item): the rows staged in shared memory by
//               cp.async, x = below . Linv^T by 32-column blocks on the
//               f64 tensor cores (mma.m8n8k4), or FMAs in f32, in 8, 4
//               or 2 independent sums, the zero lower part of Linv^T
//               skipped, in place. The earlier design ran a
//               thread per (row, column) entry over a dependent loop on
//               the stored Linv^T in L2 (1.22 ms of GRID's factor on an
//               H100, PERF.md);
//   prod_entry  (cp <= 8, rp <= 32) one thread per product entry, the
//               panels packed over the CTAs;
//   prod_tile   (else) one CTA per (panel, 64 x 64 tile (I, J), I >= J,
//               batch item): 32-column stages of both row blocks by
//               cp.async, double-buffered; four warps of 32 x 32 on the f64
//               tensor cores (mma.m8n8k4), or FMAs in f32, in a fixed
//               column order; the tile goes to (I, J) and, transposed, to
//               (J, I). Half the products of the full square; a tile past
//               rows[i] is written as zeros without being computed.
//
// Bounds (H100, f64): chol is a latency chain on one SM per panel (a few
// panels per level), below the tensor cores' chains of up to cp / 32
// steps; prod on BAL 871's pair levels (rp 3,072
// to 7,680) is bound about equally by its operations (r (r + 1) n) and
// by writing the rp x rp products (0.8 GB per factor).
//
// Sums run in a fixed order with no atomics: a batch item and a single
// run agree bitwise, and so do reruns.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_tiles.cuh"

namespace {

constexpr int kPanelsPerCta = 4;     // chol_warp: warps (panels) per CTA
constexpr int kEntryCp = 8;          // prod_entry: the widest cp it takes
constexpr int kBlockThreads = 256;   // chol_block: 8 warps
constexpr int kWarps = kBlockThreads / 32;
constexpr int kOld = kTile + 1;      // prod_tile: the output tile's row

// store(e, load(e)) for e = tid, tid + nt, ... < count, kInFlight loads
// issued before their stores: a load and its store in turn would wait out
// the memory latency once per element (the compiler cannot tell a shared
// destination from a device-memory source behind generic pointers)
template <typename T, int kInFlight = 8, typename L, typename S>
__device__ __forceinline__ void copy_batched(int count, int tid, int nt,
                                             const L& load, const S& store) {
  for (int e0 = tid; e0 < count; e0 += kInFlight * nt) {
    T v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (e0 + u * nt < count) v[u] = load(e0 + u * nt);
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (e0 + u * nt < count) store(e0 + u * nt, v[u]);
  }
}

// cp <= kW (4, 8, 16 or 32): one warp per panel; the panel's lower
// triangle is staged in the warp's shared slab (kW x kW, zero past it),
// factored and inverted there, and written back whole (zero on padding).
template <typename T, int kW>
__global__ void __launch_bounds__(32 * kPanelsPerCta)
    chol_warp_kernel(T* data, int64_t bstride, const int64_t* off,
                     const int64_t* cols, int64_t B, int cp) {
  constexpr int ls = kW + 1;
  __shared__ T slab[kPanelsPerCta][kW * ls];
  __shared__ T dxs[kPanelsPerCta][kW];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * kPanelsPerCta + warp;
  if (i >= B) return;  // uniform over the warp; no CTA barrier below
  T* P = data + (int64_t)blockIdx.y * bstride + off[i];
  const int n = (int)cols[i];
  T* A = slab[warp];
  copy_batched<T>(
      kW * kW, lane, 32,
      [&](int t) {
        const int r = t / kW, c = t % kW;
        return (r < n && c <= r) ? P[r * cp + c] : T(0);
      },
      [&](int t, T v) { A[(t / kW) * ls + t % kW] = v; });
  if (lane < kW) dxs[warp][lane] = T(0);
  __syncwarp();
  warp_chol_inv<kW>(A, dxs[warp], ls, 0, n);
  __syncwarp();
  for (int t = lane; t < cp * cp; t += 32) P[t] = A[(t / cp) * ls + t % cp];
}

// cp > 32 (a multiple of 32): one CTA per (panel, batch item), the panel
// worked in place in device memory (row stride cp). Shared memory holds
// dx (the diagonal of X = Linv), dbuf (the diagonal block being factored
// or applied) and a work area for each step's operands: the solved block
// column (rows past it x kCld) for the trailing update, block row i of L
// for the inverse sweep. A step's operand read from device memory is
// preloaded (mma32<true>).
constexpr int kDld = kSub + 1;  // dbuf's row
constexpr int kCld = kSub + 4;  // a staged block column's row

template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
    chol_block_kernel(T* data, int64_t bstride, const int64_t* off,
                      const int64_t* cols, int cp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const dx = reinterpret_cast<T*>(smem_raw);
  T* const dbuf = dx + cp;
  T* const work = dbuf + kSub * kDld;
  T* const A = data + (int64_t)blockIdx.y * bstride + off[blockIdx.x];
  const int n = (int)cols[blockIdx.x];
  const int np = (n + kSub - 1) / kSub * kSub, nb = np / kSub;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = cp;
  // the strict upper triangle will receive Linv^T
  for (int t = tid; t < cp * cp; t += kBlockThreads)
    if (t % cp > t / cp) A[t] = T(0);
  for (int t = tid; t < cp; t += kBlockThreads) dx[t] = T(0);
  __syncthreads();

  // warp 0: diagonal block p, factored and inverted in dbuf, written back
  // (L below the diagonal, X^T above it)
  const auto factor_diag = [&](int p) {
    const int p0 = p * kSub;
    T* const Dg = A + (int64_t)p0 * ld + p0;
    copy_batched<T, 16>(
        kSub * kSub, lane, 32,
        [&](int t) {
          const int r = t / kSub, c = t % kSub;
          return c <= r ? Dg[r * ld + c] : T(0);
        },
        [&](int t, T v) { dbuf[(t / kSub) * kDld + t % kSub] = v; });
    __syncwarp();
    warp_chol_inv<kSub>(dbuf, dx + p0, kDld, 0, min(kSub, n - p0));
    __syncwarp();
    for (int t = lane; t < kSub * kSub; t += 32)
      Dg[(t / kSub) * ld + t % kSub] = dbuf[(t / kSub) * kDld + t % kSub];
  };

  // Cholesky by sub-blocks of 32 columns, right-looking, one step ahead:
  // warp 0 factors diagonal block p + 1 while the others finish step p's
  // update
  if (warp == 0 && nb > 0) factor_diag(0);
  __syncthreads();
  for (int p = 0; p < nb; ++p) {
    const int p0 = p * kSub, q0 = p0 + kSub;
    // the rows below, in place and into the work area:
    // x[r][c] = sum_{k <= c} a[r][k] X[c][k], X[c][k] = dbuf[k][c] above
    // the diagonal, dx on it
    for (int g = p + 1 + warp; g < nb; g += kWarps) {
      T* a = A + (int64_t)g * kSub * ld + p0;
      T* w = work + (g - p - 1) * kSub * kCld;
      T acc[4][4][2] = {};
      mma32<true>(acc, [&](int r, int k) { return a[r * ld + k]; },
                  [&](int c, int k) {
                    return k < c ? dbuf[k * kDld + c]
                                 : (k == c ? dx[p0 + c] : T(0));
                  },
                  lane);
      __syncwarp();  // the warp's rows are read; overwrite them
      acc_each(acc, lane, [&](T& v, int r, int c) {
        a[r * ld + c] = v;
        w[r * kCld + c] = v;
      });
    }
    __syncthreads();
    // the trailing lower triangle: A[I][J] -= x_I x_J^T, 32 x 32 tiles
    // (a diagonal tile's upper half is overwritten when it is factored);
    // warp 0 updates tile (0, 0), the next diagonal block, and factors it
    const auto update = [&](int t) {
      int I, J;
      tri_tile(t, I, J);
      T* tile = A + (int64_t)(q0 + I * kSub) * ld + q0 + J * kSub;
      const T* xi = work + I * kSub * kCld;
      const T* xj = work + J * kSub * kCld;
      T acc[4][4][2];
      acc_each(acc, lane, [&](T& v, int r, int c) { v = tile[r * ld + c]; });
      mma32(acc, [&](int r, int k) { return -xi[r * kCld + k]; },
            [&](int c, int k) { return xj[c * kCld + k]; }, lane);
      acc_each(acc, lane, [&](T& v, int r, int c) { tile[r * ld + c] = v; });
    };
    const int m = nb - p - 1;
    if (warp == 0) {
      if (m > 0) {
        update(0);
        __syncwarp();
        factor_diag(p + 1);
      }
    } else {
      for (int t = warp; t < m * (m + 1) / 2; t += kWarps - 1) update(t);
    }
    __syncthreads();
  }

  // Linv by block rows i: S = L[i, :i] X[:i, :i], then X[i, :i] = -Dinv_i
  // S. Both are formed transposed, as X^T is stored (X[r][c] at A[c][r]),
  // one warp per 32-row block C < i of X^T; S^T goes to its destination
  // block first and is read back from there.
  for (int i = 1; i < nb; ++i) {
    const int r0 = i * kSub;
    // block row i of L (the work area) and the diagonal block (dbuf: X^T
    // above the diagonal)
    const T* Li = work;
    const int lld = r0 + 4;
    copy_batched<T>(
        kSub * r0, tid, kBlockThreads,
        [&](int t) { return A[(int64_t)(r0 + t / r0) * ld + t % r0]; },
        [&](int t, T v) { work[(t / r0) * lld + t % r0] = v; });
    copy_batched<T>(
        kSub * kSub, tid, kBlockThreads,
        [&](int t) {
          return A[(int64_t)(r0 + t / kSub) * ld + r0 + t % kSub];
        },
        [&](int t, T v) { dbuf[(t / kSub) * kDld + t % kSub] = v; });
    __syncthreads();
    for (int C = warp; C < i; C += kWarps) {
      const int c0 = C * kSub;
      T* dst = A + (int64_t)c0 * ld + r0;  // X^T[C][i]
      T acc[4][4][2] = {};
      // S^T[c][r] = sum_{m >= c0} X^T[c0 + c][m] L[r0 + r][m]
      for (int M = C; M < i; ++M) {
        const int m0 = M * kSub;
        const T* xt = A + (int64_t)c0 * ld + m0;
        const auto lr = [&](int r, int k) { return Li[r * lld + m0 + k]; };
        if (M == C)
          mma32<true>(acc, [&](int c, int k) {
                        return c < k ? xt[c * ld + k]
                                     : (c == k ? dx[c0 + c] : T(0));
                      }, lr, lane);
        else
          mma32<true>(acc, [&](int c, int k) { return xt[c * ld + k]; }, lr,
                      lane);
      }
      acc_each(acc, lane, [&](T& v, int c, int r) { dst[c * ld + r] = v; });
      __syncwarp();
      // X^T[c0 + c][r0 + r] = -sum_{q <= r} S^T[c][q] Dinv_i[r][q]
      T out[4][4][2] = {};
      mma32<true>(out, [&](int c, int q) { return -dst[c * ld + q]; },
                  [&](int r, int q) {
                    return q < r ? dbuf[q * kDld + r]
                                 : (q == r ? dx[r0 + r] : T(0));
                  },
                  lane);
      __syncwarp();  // S^T is read; overwrite it
      acc_each(out, lane, [&](T& v, int c, int r) { dst[c * ld + r] = v; });
    }
    __syncthreads();  // before the next block row's staging
  }
}

// x = below . Linv^T, x[r][j] = sum_{k <= j} below[r][k] Linv[j][k], with
// Linv[j][k] = P[k][j] (k < j, the stored Linv^T) and 1 / P[j][j] (k = j),
// in place on the real rows and columns; two grids by width.
//
// below_warp (cp <= 16: MERI's and GRID's thousands of small panels): one
// warp per (panel, chunk of up to kBelowChunk below rows), kPanelsPerCta
// warps a CTA, no block barrier. The panel's Linv (kW x kW, zero outside
// the real lower triangle) in the warp's shared slab; lane l takes column
// l % kW of rows l / kW, l / kW + 32 / kW, ...: it loads its own element
// (a warp step reads 32 / kW whole rows, coalesced), takes the row's
// others by shuffles and sums over k in order; four steps' loads are
// issued before their sums.
constexpr int kBelowChunk = 128;  // below_warp: below rows of a warp item
constexpr int kBelowMaxWarps = 8;

template <typename T, int kW>
__global__ void __launch_bounds__(32 * kPanelsPerCta)
    below_warp_kernel(T* data, int64_t bstride, const int64_t* off,
                      const int64_t* rows, const int64_t* cols, int64_t B,
                      int cp, int nch) {
  constexpr int ls = kW + 1, RG = 32 / kW, kAhead = 4;
  __shared__ T slab[kPanelsPerCta][kW * ls];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t item = (int64_t)blockIdx.x * kPanelsPerCta + warp;
  if (item >= B * nch) return;  // uniform over the warp
  const int64_t i = item / nch;
  const int n = (int)cols[i];
  const int r0 = (int)(item % nch) * kBelowChunk;
  const int r1 = min(r0 + kBelowChunk, (int)rows[i]);
  if (r0 >= r1) return;
  T* P = data + (int64_t)blockIdx.y * bstride + off[i];
  T* below = P + (int64_t)cp * cp;
  const int gi = lane / kW, j = lane % kW, base = lane - j;
  T e[kAhead];
  const auto load = [&](int rb) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int r = rb + u * RG + gi;
      e[u] = (r < r1 && j < n) ? below[(int64_t)r * cp + j] : T(0);
    }
  };
  load(r0);  // the first rows' loads go out before Linv's
  T* X = slab[warp];
  for (int t = lane; t < kW * kW; t += 32) {
    const int jj = t / kW, k = t % kW;
    X[jj * ls + k] = (jj < n && k <= jj)
                         ? (k < jj ? P[k * cp + jj] : T(1) / P[jj * cp + jj])
                         : T(0);
  }
  __syncwarp();
  for (int rb = r0; rb < r1; rb += kAhead * RG) {
    T x[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      x[u] = T(0);
#pragma unroll
      for (int k = 0; k < kW; ++k)
        x[u] += __shfl_sync(0xffffffffu, e[u], base + k) * X[j * ls + k];
    }
    if (rb + kAhead * RG < r1) load(rb + kAhead * RG);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int r = rb + u * RG + gi;
      if (r < r1 && j < n) below[(int64_t)r * cp + j] = x[u];
    }
  }
}

// below_tile (cp >= 32, a multiple of 32): one CTA per (panel, block of
// 8 NG below rows (below_groups), batch item), below_warps(cp) warps.
// The block's real rows are staged in shared memory by cp.async (zero
// past the real rows and columns), so x can overwrite them in device
// memory; then the 32-column blocks J of x, the longest first, go to the
// warps in a snake order (warp w takes J = nj - 1 - w, then J = nj - 1 -
// (2 NW - 1 - w), ...), each as x[R, J]^T = sum_{K <= J} Linv^T[K, J]^T
// below[R, K]^T on the f64 tensor cores (mma.m8n8k4; FMAs in f32) in 8 /
// NG independent sums (mma_sets), K in order in each, joined in set
// order; the zero lower part of Linv^T is skipped. Each warp streams its
// 32 x 32 tiles of the stored block through two shared buffers by
// cp.async (the fragments keep the strict upper part; the diagonal 1 /
// P[j][j] from dinv), the next tile in flight while the current one is
// multiplied. Templated on cp, staging only the column blocks the
// products read, by 16-byte copies where the panel is 16-byte aligned.
constexpr int kBelowTld = kSub + 4;  // a staged tile's row (kTld's padding)

__host__ __device__ constexpr int below_warps(int cp) {
  // cp 512: four warps, so that the rows and the tiles fit in 227 KB
  return cp >= 512 ? 4 : (cp / kSub < kBelowMaxWarps ? cp / kSub
                                                     : kBelowMaxWarps);
}

// count elements from src to dst (shared) by a warp, of which the first
// `real` are read and the rest zero-filled; V = 16 / sizeof(T) elements
// a copy when `vec` (both 16-byte aligned), else one; count <= kMax
// (compile time)
template <typename T, int kMax>
__device__ __forceinline__ void stage_row(T* dst, const T* src, int count,
                                          int real, bool vec, int lane) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
#pragma unroll
    for (int u = 0; u < (kMax + 32 * V - 1) / (32 * V); ++u) {
      const int c = (u * 32 + lane) * V;
      if (c < count) {
        const int b = max(0, min(V, real - c)) * (int)sizeof(T);
        cp_async16(dst + c, b ? src + c : src, b);
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < (kMax + 31) / 32; ++u) {
      const int c = u * 32 + lane;
      if (c < count)
        cp_async_el(dst + c, c < real ? src + c : src,
                    c < real ? (int)sizeof(T) : 0);
    }
  }
}

// below_tile's products: a warp's 32 x 8 NG block of x^T (32 columns of
// x by NG 8-row groups) from one 32-column stage, summed into NS = 8 / NG
// independent accumulators, set s taking the stage's columns 32 s / NS ..
// 32 (s + 1) / NS - 1 in order (8 / NS mma_step's of four columns, or of
// one column each in f32; warp_tiles.cuh), the sets' steps interleaved,
// so that a K step's products wait on few others: on an H100 the
// dependent chain of mma steps, not their number, bounds these small
// products. acc[s][mi][nj][h] is the element (mi * 8 +
// lane / 4, nj * 8 + (lane % 4) * 2 + h) of set s (mma32's layout); the
// registers are the same for every NG.
template <int NG>
struct BelowSets {
  static constexpr int NS = 8 / NG, W = kSub / NS;  // sets, their columns
};

template <int NG, typename FA, typename FB>
__device__ __forceinline__ void mma_sets(double (&acc)[8 / NG][4][NG][2],
                                         const FA& fa, const FB& fb,
                                         int lane) {
  constexpr int NS = BelowSets<NG>::NS, W = BelowSets<NG>::W;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < W; h += 4)
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      const int k0 = W * st + h;
      double a[4], b[NG];
#pragma unroll
      for (int m = 0; m < 4; ++m) a[m] = fa(m * 8 + g, k0 + t);
#pragma unroll
      for (int m = 0; m < NG; ++m) b[m] = fb(m * 8 + g, k0 + t);
      mma_step(acc[st], a, b);
    }
}

template <int NG, typename FA, typename FB>
__device__ __forceinline__ void mma_sets(float (&acc)[8 / NG][4][NG][2],
                                         const FA& fa, const FB& fb,
                                         int lane) {
  constexpr int NS = BelowSets<NG>::NS, W = BelowSets<NG>::W;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int kk = 0; kk < W; ++kk)
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      const int k = W * st + kk;
      float a[4], b[NG][2];
#pragma unroll
      for (int m = 0; m < 4; ++m) a[m] = fa(m * 8 + g, k);
#pragma unroll
      for (int m = 0; m < NG; ++m) {
        b[m][0] = fb(m * 8 + t2, k);
        b[m][1] = fb(m * 8 + t2 + 1, k);
      }
      mma_step(acc[st], a, b);
    }
}

template <typename T, int CP, int NG>
__global__ void __launch_bounds__(32 * kBelowMaxWarps)
    below_tile_kernel(T* data, int64_t bstride, const int64_t* off,
                      const int64_t* rows, const int64_t* cols, int nrb) {
  constexpr int rb = 8 * NG, NS = BelowSets<NG>::NS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ld = CP + 4;  // conflict-free fragment reads (kTld's)
  const int tid = threadIdx.x, NW = blockDim.x >> 5;
  const int lane = tid & 31, warp = tid >> 5;
  T* const sb = reinterpret_cast<T*>(smem_raw);
  T* const dinv = sb + rb * ld;
  T* const tiles = dinv + CP + warp * 2 * kSub * kBelowTld;
  const int64_t i = blockIdx.x / nrb;
  const int r0 = (int)(blockIdx.x % nrb) * rb;
  const int nrows = (int)rows[i];
  if (r0 >= nrows) return;  // uniform over the CTA
  const int n = (int)cols[i];
  T* P = data + (int64_t)blockIdx.y * bstride + off[i];
  T* below = P + (int64_t)CP * CP;
  // 16-byte copies where the panel is 16-byte aligned (its rows then are)
  const bool vec = (reinterpret_cast<uintptr_t>(P) & 15) == 0;
  const int nj = (n + kSub - 1) / kSub, ncol = nj * kSub;
  // the warp's column blocks in snake order; J < 0: none left
  const auto block_of = [&](int q) {
    const int idx = q * NW + ((q & 1) ? NW - 1 - warp : warp);
    return idx < nj ? nj - 1 - idx : -1;
  };
  // tile (K, J) of the stored block into buffer b, one group (the
  // fragments keep its strict upper part)
  const auto stage = [&](int K, int J, int b) {
    constexpr int V = 16 / sizeof(T), TV = kSub / V, RS = 32 / TV;
    T* t = tiles + b * kSub * kBelowTld;
    const T* src = P + (int64_t)K * kSub * CP + J * kSub;
    const int real = n - J * kSub;
    if (vec) {  // RS rows a step, TV copies a row
      const int c = (lane % TV) * V;
      const int bytes = max(0, min(V, real - c)) * (int)sizeof(T);
#pragma unroll
      for (int k = lane / TV; k < kSub; k += RS)
        cp_async16(t + k * kBelowTld + c, bytes ? src + k * CP + c : src,
                   bytes);
    } else {
#pragma unroll
      for (int k = 0; k < kSub; ++k)
        cp_async_el(t + k * kBelowTld + lane,
                    lane < real ? src + k * CP + lane : src,
                    lane < real ? (int)sizeof(T) : 0);
    }
    cp_async_commit();
  };
  // the block's rows over the columns the fragments read
  for (int r = warp; r < rb; r += NW)
    stage_row<T, CP>(sb + r * ld, below + (int64_t)(r0 + r) * CP, ncol,
                     r0 + r < nrows ? n : 0, vec, lane);
  cp_async_commit();
  int J = block_of(0), q = 0, K = 0, buf = 0;
  if (J >= 0) stage(0, J, 0);
  for (int t = tid; t < ncol; t += blockDim.x)
    dinv[t] = t < n ? T(1) / P[(int64_t)t * CP + t] : T(0);
  cp_async_wait<0>();
  __syncthreads();  // the rows and dinv; each warp's first tile
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  T acc[NS][4][NG][2] = {};
  while (J >= 0) {
    // the next tile: (K + 1, J), or the first of the next column block
    int nK = K + 1, nJ = J, nq = q;
    if (nK > J) {
      nq = q + 1;
      nJ = block_of(nq);
      nK = 0;
    }
    if (nJ >= 0) {
      stage(nK, nJ, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const T* tl = tiles + buf * kSub * kBelowTld;
    const int k0 = K * kSub, j0 = J * kSub;
    mma_sets<NG>(
        acc,
        [&](int j, int k) {  // Linv^T[k0 + k][j0 + j]
          return k0 + k < j0 + j ? tl[k * kBelowTld + j]
                                 : (k0 + k == j0 + j ? dinv[j0 + j] : T(0));
        },
        [&](int r, int k) { return sb[r * ld + k0 + k]; }, lane);
    __syncwarp();  // the buffer may be refilled
    if (nK == 0) {  // the column block is done: its sets joined in order
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < NG; ++nj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = j0 + mi * 8 + g, r = r0 + nj * 8 + t2 + h;
            T v = acc[0][mi][nj][h];
#pragma unroll
            for (int st = 1; st < NS; ++st) v += acc[st][mi][nj][h];
            if (r < nrows && j < n) below[(int64_t)r * CP + j] = v;
#pragma unroll
            for (int st = 0; st < NS; ++st) acc[st][mi][nj][h] = T(0);
          }
    }
    J = nJ;
    K = nK;
    q = nq;
    buf ^= 1;
  }
}

// below_tile's 8-row groups a CTA, from the bucket's shape: the most of
// 4, 2 and 1 that still gives kBelowFill CTAs a batch item (GRID's
// buckets of 1-11 panels take 1; BAL's pair levels 2 or 4: a block of
// more rows stages each tile of Linv^T for more of them)
constexpr int kBelowFill = 132;  // the H100's SMs

int below_groups(int64_t B, int rp) {
  for (int ng = 4; ng > 1; ng /= 2)
    if (B * ((rp + 8 * ng - 1) / (8 * ng)) >= kBelowFill) return ng;
  return 1;
}

template <typename T, int CP, int NG>
int below_tile_launch(T* d, int64_t bstride, const int64_t* off,
                      const int64_t* rows, const int64_t* cols, int64_t B,
                      int rp, int batch, cudaStream_t stream) {
  const int nrb = (rp + 8 * NG - 1) / (8 * NG);
  const int nw = below_warps(CP);
  // the rows, dinv, two tiles a warp
  const int smem = (int)((8 * NG * (CP + 4) + CP +
                          nw * 2 * kSub * kBelowTld) * sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      below_tile_kernel<T, CP, NG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  below_tile_kernel<T, CP, NG><<<dim3((unsigned)(B * nrb), batch), 32 * nw,
                                 smem, stream>>>(d, bstride, off, rows, cols,
                                                 nrb);
  return (int)cudaGetLastError();
}

template <typename T, int CP>
int below_tile_launch(T* d, int64_t bstride, const int64_t* off,
                      const int64_t* rows, const int64_t* cols, int64_t B,
                      int rp, int batch, cudaStream_t stream) {
  switch (below_groups(B, rp)) {
    case 4: return below_tile_launch<T, CP, 4>(d, bstride, off, rows, cols,
                                               B, rp, batch, stream);
    case 2: return below_tile_launch<T, CP, 2>(d, bstride, off, rows, cols,
                                               B, rp, batch, stream);
    default: return below_tile_launch<T, CP, 1>(d, bstride, off, rows, cols,
                                                B, rp, batch, stream);
  }
}

// cp <= 8 and rp <= 32 (the narrow buckets of MERI and GRID: hundreds
// to thousands of panels, n <= 8, a few hundred product entries each):
// one thread per product entry, the panels packed one after another over
// the CTAs; each thread forms its entry from two rows of x in device
// memory (at n <= 8 there is nothing to reuse). FMAs in column order, so
// the product is symmetric bit for bit; rows past rows[i] give zero.
template <typename T>
__global__ void prod_entry_kernel(const T* data, int64_t bstride, T* prod,
                                  int64_t pstride, int64_t prod_base,
                                  const int64_t* off, const int64_t* rows,
                                  const int64_t* cols, int64_t B, int cp,
                                  int rp) {
  const int64_t per = (int64_t)rp * rp;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B * per) return;
  const int64_t i = e / per;
  const int q = (int)(e % per), r = q / rp, c = q % rp;
  const T* X = data + (int64_t)blockIdx.y * bstride + off[i] +
               (int64_t)cp * cp;
  const int n = (int)cols[i], nr = (int)rows[i];
  T acc = T(0);
  if (r < nr && c < nr)
    for (int k = 0; k < n; ++k) acc += X[r * cp + k] * X[c * cp + k];
  prod[(int64_t)blockIdx.y * pstride + prod_base + e] = acc;
}

// Every other bucket: one CTA per (panel, tile pair, batch item),
// blockIdx.x = i * pairs + t with (I, J) = tri_tile(t); rp < 64 is one
// tile, masked.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    prod_tile_kernel(const T* data, int64_t bstride, T* prod,
                     int64_t pstride, int64_t prod_base, const int64_t* off,
                     const int64_t* rows, const int64_t* cols, int cp,
                     int rp, int pairs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // two stages of 128 rows x kTld; after the sums, the 64 x kOld tile
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int64_t i = blockIdx.x / pairs;
  int I, J;
  tri_tile((int)(blockIdx.x % pairs), I, J);
  const T* X = data + (int64_t)blockIdx.y * bstride + off[i] +
               (int64_t)cp * cp;
  T* out = prod + (int64_t)blockIdx.y * pstride + prod_base +
           i * rp * rp;
  const int n = (int)cols[i], nr = (int)rows[i];
  const int r0 = I * kTile, c0 = J * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  // (r, c) of the tile to (r0 + r, c0 + c) and, off the diagonal,
  // (c0 + c, r0 + r); both loops walk consecutive output columns
  auto emit = [&](auto val) {
    for (int t = tid; t < kTile * kTile; t += kTileThreads) {
      const int r = t / kTile, c = t % kTile;
      if (r0 + r < rp && c0 + c < rp)
        out[(int64_t)(r0 + r) * rp + c0 + c] = val(r, c);
    }
    if (I != J)
      for (int t = tid; t < kTile * kTile; t += kTileThreads) {
        const int c = t / kTile, r = t % kTile;
        if (r0 + r < rp && c0 + c < rp)
          out[(int64_t)(c0 + c) * rp + r0 + r] = val(r, c);
      }
  };
  if (r0 >= nr || c0 >= nr) {  // no real rows: uniform over the CTA
    emit([](int, int) { return T(0); });
    return;
  }
  T acc[4][4][2];
  gram_tile(acc, X, cp, n, nr, r0, c0, sm);
  acc_each(acc, lane, [&](T& v, int r, int c) {
    sm[(wm * 32 + r) * kOld + wn * 32 + c] = v;
  });
  __syncthreads();
  emit([&](int r, int c) { return sm[r * kOld + c]; });
}

template <typename T>
int launch(void* data, int64_t data_bstride, void* prod,
           int64_t prod_bstride, int64_t prod_base, const int64_t* off,
           const int64_t* rows, const int64_t* cols, int64_t B, int cp,
           int rp, int batch, cudaStream_t stream) {
  T* d = static_cast<T*>(data);
  if (cp <= kSub) {
    const dim3 grid((unsigned)((B + kPanelsPerCta - 1) / kPanelsPerCta),
                    batch);
    const int nt = 32 * kPanelsPerCta;
    if (cp <= 4)
      chol_warp_kernel<T, 4><<<grid, nt, 0, stream>>>(d, data_bstride, off,
                                                      cols, B, cp);
    else if (cp <= 8)
      chol_warp_kernel<T, 8><<<grid, nt, 0, stream>>>(d, data_bstride, off,
                                                      cols, B, cp);
    else if (cp <= 16)
      chol_warp_kernel<T, 16><<<grid, nt, 0, stream>>>(d, data_bstride, off,
                                                       cols, B, cp);
    else
      chol_warp_kernel<T, 32><<<grid, nt, 0, stream>>>(d, data_bstride, off,
                                                       cols, B, cp);
  } else {
    if (cp % kSub) return (int)cudaErrorInvalidValue;
    // dx, dbuf, then the work area: the solved block column below the
    // first diagonal block, (cp - 32) x kCld, which also holds a block row
    // of L, 32 x (cp - 28) at most (cp >= 64)
    const int smem =
        (int)((cp + kSub * kDld + (cp - kSub) * kCld) * sizeof(T));
    cudaError_t e = cudaFuncSetAttribute(
        chol_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    chol_block_kernel<T><<<dim3((unsigned)B, batch), kBlockThreads, smem,
                           stream>>>(d, data_bstride, off, cols, cp);
  }
  if (rp > 0) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (cp <= 16) {
      const int nch = (rp + kBelowChunk - 1) / kBelowChunk;
      const dim3 grid(
          (unsigned)((B * nch + kPanelsPerCta - 1) / kPanelsPerCta), batch);
      const int nt = 32 * kPanelsPerCta;
      if (cp <= 4)
        below_warp_kernel<T, 4><<<grid, nt, 0, stream>>>(
            d, data_bstride, off, rows, cols, B, cp, nch);
      else if (cp <= 8)
        below_warp_kernel<T, 8><<<grid, nt, 0, stream>>>(
            d, data_bstride, off, rows, cols, B, cp, nch);
      else
        below_warp_kernel<T, 16><<<grid, nt, 0, stream>>>(
            d, data_bstride, off, rows, cols, B, cp, nch);
    } else {
      int err;
      switch (cp) {
        case 32: err = below_tile_launch<T, 32>(d, data_bstride, off, rows,
                                                cols, B, rp, batch, stream);
          break;
        case 64: err = below_tile_launch<T, 64>(d, data_bstride, off, rows,
                                                cols, B, rp, batch, stream);
          break;
        case 128: err = below_tile_launch<T, 128>(d, data_bstride, off, rows,
                                                  cols, B, rp, batch, stream);
          break;
        case 256: err = below_tile_launch<T, 256>(d, data_bstride, off, rows,
                                                  cols, B, rp, batch, stream);
          break;
        case 512: err = below_tile_launch<T, 512>(d, data_bstride, off, rows,
                                                  cols, B, rp, batch, stream);
          break;
        default: return (int)cudaErrorInvalidValue;
      }
      if (err != 0) return err;
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (prod != nullptr) {
      T* pr = static_cast<T*>(prod);
      if (cp <= kEntryCp && rp <= kSub) {
        const int64_t total = B * rp * rp;
        prod_entry_kernel<T><<<dim3((unsigned)((total + 255) / 256), batch),
                               256, 0, stream>>>(
            d, data_bstride, pr, prod_bstride, prod_base, off, rows, cols,
            B, cp, rp);
      } else {
        const int nt = (rp + kTile - 1) / kTile, pairs = nt * (nt + 1) / 2;
        const int smem = 2 * 2 * kTile * kTld * sizeof(T);
        e = cudaFuncSetAttribute(
            prod_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (e != cudaSuccess) return (int)e;
        prod_tile_kernel<T><<<dim3((unsigned)(B * pairs), batch),
                              kTileThreads, smem, stream>>>(
            d, data_bstride, pr, prod_bstride, prod_base, off, rows, cols,
            cp, rp, pairs);
      }
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64. Returns the cudaError_t of the launches.
extern "C" int bs_bucket_factor(int dtype, void* data, int64_t data_bstride,
                                void* prod, int64_t prod_bstride,
                                int64_t prod_base, const int64_t* off,
                                const int64_t* rows, const int64_t* cols,
                                int64_t B, int cp, int rp, int batch,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(data, data_bstride, prod, prod_bstride, prod_base,
                         off, rows, cols, B, cp, rp, batch, s);
  if (dtype == 1)
    return launch<double>(data, data_bstride, prod, prod_bstride, prod_base,
                          off, rows, cols, B, cp, rp, batch, s);
  return (int)cudaErrorInvalidValue;
}
