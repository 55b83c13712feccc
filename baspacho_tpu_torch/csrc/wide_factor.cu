// K1-wide: the blocked factor of wide panels (padded width cp > 512, a
// multiple of the diagonal tile kNb = 128), from one C call.
//
// Replaces PlannedBackend._blocked_factor and _blocked_lower_inv
// (baspacho_tpu/ops/planned_backend.py:1277, :1353), reached through
// _factor_panels (:1411-1414), with the stored layout of _embed_inv
// (:1453): L on and below the diagonal, the full Linv^T strictly above
// it, x = below . L^-T in the below rows.
//
// bs_wide_factor runs the right-looking blocked schedule for every panel
// and batch item of a bucket at once, three kinds of ordinary grid per
// diagonal tile k (columns k0 = k kNb .. k1 = k0 + kNb) on the caller's
// stream, batch item = blockIdx.y:
//   wide_tile    one CTA per (panel, batch item): applies step k - 1's
//                update to the tile's own lower triangle, then factors and
//                inverts the tile in shared memory by 32-column
//                sub-blocks (each diagonal block by one warp in panels of
//                8 columns), products on the tensor cores, and writes it
//                back, each column block once it is finished, in the
//                stored layout (L, the tile's Linv^T above its diagonal)
//                and densely (Linv^T with 1 / diag L on the diagonal) into
//                a scratch slot of its own;
//   wide_rows    one CTA per (panel, 32-row block, batch item), 32 x 128
//                outputs of a product with X_k = the tile's Linv, in
//                place (a CTA owns whole 128-column rows):
//                - x = a . X_k^T for the rows below tile k (the trailing
//                  diagonal rows and the below rows);
//                - block row k of Linv, stored transposed above the
//                  diagonal: X^T[rows, k0:k1] = -T^T X_k^T, where T^T =
//                  (L[k, :k0] X[:k0, :k0])^T was summed there by earlier
//                  steps' wide_update;
//   wide_update  one CTA per (panel, 64 x 64 tile, batch item) over the
//                tile's 128 columns:
//                - the trailing lower tile triangle (but tile k + 1's
//                  own) and the below rows against the trailing columns:
//                  C -= x x^T on real lower elements;
//                - the inverse's partial sums, right-looking: T^T[c][r]
//                  (+)= X^T[c][k0:k1] . x_r for the rows c < k1 and the
//                  trailing rows r, so that _blocked_lower_inv's sweep
//                  (X[i, :i] = -Dinv_i L[i, :i] X[:i, :i]) is spread over
//                  the steps in products of 128 columns, not a chain of
//                  ever longer ones after the factor.
// Order: tile 0, then per step rows k, tile k + 1, update k. The update
// grid is launched programmatically on tile k + 1's (griddepcontrol):
// it fills the card beside the tile's CTAs, and its last CTA waits for
// the tile grid, so that rows k + 1, an ordinary launch, finds both done.
// 3 cp / kNb - 1 grids a call. Every product sums on the f64 tensor cores
// (mma.m8n8k4 through mma32, warp_tiles.cuh; the tile's 32 x 32 products
// on mma.m16n8k4, mma32w below), FMAs in f32, each output in one
// fixed column order: a batch item and a single run agree bitwise, and so
// do reruns. No atomics.
//
// Bounds (H100, f64): the chain of diagonal tiles (one SM each, cp / 128
// in turn: step k - 1's update of the tile, four 32 x 32 diagonal blocks
// factored by one warp in panels of 8 columns, their products; code kept
// small, since it runs on an SM that ran other grids since) and the rows
// grid between them; the products (2 n^3 / 3 + r n^2 flops in all) are
// spread over the card beside the tile.
//
// Real width n = cols[i], real below rows rows[i]: rows and columns past
// them are padding (zero on entry), left as they are in L and x and
// written as zero in the upper triangle, as in the JAX routine's stored
// block. The strict upper triangle is never read before it is written.
// A panel that is not positive definite gives NaN from its failing
// column on.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "warp_tiles.cuh"

namespace {

constexpr int kNb = 128;           // the diagonal tile
constexpr int kTileWarps = 8;      // wide_tile: warps a CTA
constexpr int kTileCta = 32 * kTileWarps;
constexpr int kWorkers = kTileCta - 32;  // wide_tile: warps 1-7 (the load)
constexpr int kLd = kNb + 4;       // a 128-column row in shared memory:
//                                    16-byte aligned, mma32 fragments
//                                    free of bank conflicts
constexpr int kPw = 8;             // wide_tile: a panel of diag_chol_inv
constexpr int kRows = 32;          // wide_rows: rows a CTA
constexpr int kRowThreads = 256;   // wide_rows: 8 warps stage, 4 multiply

__device__ __forceinline__ int tile_width(int64_t n, int k0) {
  const int64_t w = n - k0;
  return w < 0 ? 0 : (w > kNb ? kNb : (int)w);
}

// Columns q0 .. q0 + width of `rows` rows into dst (row stride ld) by
// cp.async: row r from src(r) (null: zeros), by 16-byte groups when vec
// (every source row and dst 16-byte aligned), else value by value; any
// valid global address `some` stands in for a null source.
template <typename T, typename F>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const F& src,
                                           int rows, int width, int q0,
                                           bool vec, const T* some, int tid,
                                           int nt) {
  if (vec) {
    constexpr int kv = 16 / sizeof(T);
    const int per = width / kv;
    for (int e = tid; e < rows * per; e += nt) {
      const int r = e / per, o = e % per * kv;
      const T* s = src(r);
      cp_async16(dst + r * ld + o, s ? s + q0 + o : some, s ? 16 : 0);
    }
  } else {
    for (int e = tid; e < rows * width; e += nt) {
      const int r = e / width, o = e % width;
      const T* s = src(r);
      cp_async_el(dst + r * ld + o, s ? s + q0 + o : some,
                  s ? (int)sizeof(T) : 0);
    }
  }
}

// The dense Linv^T of diagonal tile k0 / kNb of panel i, batch item z:
// two slots a panel, by the tile's parity, so that tile k + 1 may write
// its own while step k's update grid still reads tile k's.
template <typename T>
__device__ __forceinline__ T* xk_tile(T* xk, int k0, int64_t z, int64_t B,
                                      int64_t i) {
  const int64_t slot = ((k0 / kNb) & 1) * (int64_t)gridDim.y + z;
  return xk + (slot * B + i) * kNb * kNb;
}

// wide_tile: a barrier of warps 1-7 alone
__device__ __forceinline__ void sync_workers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWorkers) : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// acc += A B^T over kPw = 8 columns for one 8 x 8 block in mma32's layout
// (acc[0][0][h]: element (lane / 4, 2 (lane % 4) + h)); fa(r, k), fb(c,
// k) give A's and B's elements. f64: two mma.m8n8k4 in column order; f32:
// FMAs in column order.
template <typename FA, typename FB>
__device__ __forceinline__ void mma8(double (&acc)[1][1][2], const FA& fa,
                                     const FB& fb, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k = 0; k < kPw; k += 4) {
    const double a[1] = {fa(g, k + t)}, b[1] = {fb(g, k + t)};
    mma_step(acc, a, b);
  }
}

template <typename FA, typename FB>
__device__ __forceinline__ void mma8(float (&acc)[1][1][2], const FA& fa,
                                     const FB& fb, int lane) {
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int k = 0; k < kPw; ++k) {
    const float a[1] = {fa(g, k)}, b[1][2] = {{fb(t2, k), fb(t2 + 1, k)}};
    mma_step(acc, a, b);
  }
}

// The wide tile's 32 x 32 products (acc += A B^T over 32 columns, fa(r,
// k), fb(c, k) as for mma32) in a layout of their own: acc[mi][nj][h] is
// the element (mi * 16 + lane / 4 + 8 (h / 2), nj * 8 + 2 (lane % 4) +
// h % 2). f64: mma.m16n8k4 in column order, 4 columns a step (on the
// H100 twice the rate of mma32's m8n8k4 at one or two warps a scheduler,
// which is the tile's case); f32: FMAs in column order.
__device__ __forceinline__ void mma16_step(double (&c)[4], double a0,
                                           double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

template <typename FA, typename FB>
__device__ __forceinline__ void mma32w(double (&acc)[2][4][4], const FA& fa,
                                       const FB& fb, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k = 0; k < kSub; k += 4) {
    double a[2][2], b[4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      a[mi][0] = fa(mi * 16 + g, k + t);
      a[mi][1] = fa(mi * 16 + g + 8, k + t);
    }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) b[nj] = fb(nj * 8 + g, k + t);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
        mma16_step(acc[mi][nj], a[mi][0], a[mi][1], b[nj]);
  }
}

template <typename FA, typename FB>
__device__ __forceinline__ void mma32w(float (&acc)[2][4][4], const FA& fa,
                                       const FB& fb, int lane) {
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll 4
  for (int k = 0; k < kSub; ++k) {
    float a[2][2], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      a[mi][0] = fa(mi * 16 + g, k);
      a[mi][1] = fa(mi * 16 + g + 8, k);
    }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      b[nj][0] = fb(nj * 8 + t2, k);
      b[nj][1] = fb(nj * 8 + t2 + 1, k);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int h = 0; h < 4; ++h)
          acc[mi][nj][h] += a[mi][h >> 1] * b[nj][h & 1];
  }
}

// f(element, row, column) for each element of mma32w's layout
template <typename T, typename F>
__device__ __forceinline__ void acc_each_w(T (&acc)[2][4][4], int lane,
                                           const F& f) {
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int h = 0; h < 4; ++h)
        f(acc[mi][nj][h], mi * 16 + g + 8 * (h >> 1), nj * 8 + t2 + (h & 1));
}

// Warp 0's diagonal block of the tile: the pw x pw (pw <= kSub) block D
// (row stride kLd) factored and inverted in place, L below the diagonal,
// X^T = Linv^T above it, the diagonal of X into dx. Only the lower
// triangle is read; rows and columns past pw must be zero and are left
// as they are (columns past pw take a unit pivot); xt (row stride kTld)
// gets X^T densely, 1 / diag L on its diagonal and zero below. A rolled
// loop over panels of kPw columns: the tile runs it once a grid on an SM
// whose instruction cache holds other grids' code, where a fully unrolled
// 32-column factor's tens of KB of code run cold. Per panel j (columns
// j0..):
// - every lane factors the panel's kPw x kPw diagonal block in registers,
//   right-looking, with its own row of the block below as one more row
//   (so each pivot's reciprocal square root is on the lane that uses it,
//   without shuffles), and solves its own column c of the inverse's rows
//   j0..: X[rows][c] = -L_jj^-1 S[rows][c], S the partial sums that
//   earlier panels left in X^T's place (c < j0), or -e_c (c in the
//   panel);
// - the 8 x 8 blocks after the panel: the trailing lower triangle -= L
//   L^T, and the inverse's partial sums S^T[c][rows] (+)= X^T[c][panel]
//   L[rows][panel]^T for c < j0 + kPw (the panel of c writes them first),
//   on the f64 tensor cores (mma8).
// A block that is not positive definite gives NaN from its failing column
// on.
template <typename T>
__device__ __noinline__ void diag_chol_inv(T* D, T* dx, T* xt, int pw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = (lane & 3) * 2;
  T* const own = D + lane * kLd;
#pragma unroll
  for (int c = 0; c < kSub; ++c) xt[lane * kTld + c] = T(0);
#pragma unroll 1
  for (int j0 = 0; j0 < pw; j0 += kPw) {
    T a[kPw][kPw], v[kPw], s[kPw], inv[kPw];
#pragma unroll
    for (int i = 0; i < kPw; ++i)
#pragma unroll
      for (int k = 0; k <= i; ++k) a[i][k] = D[(j0 + i) * kLd + j0 + k];
#pragma unroll
    for (int k = 0; k < kPw; ++k) {
      const T o = own[j0 + k];
      v[k] = j0 + k <= lane ? o : T(0);
      s[k] = lane < j0 ? o : (lane == j0 + k ? T(-1) : T(0));
    }
#pragma unroll
    for (int k = 0; k < kPw; ++k) {
      inv[k] = rsqrt(j0 + k < pw ? a[k][k] : T(1));
      v[k] *= inv[k];
      const T x = -s[k] * inv[k];
      s[k] = x;
#pragma unroll
      for (int i = k + 1; i < kPw; ++i) {
        a[i][k] *= inv[k];
#pragma unroll
        for (int m = k + 1; m <= i; ++m) a[i][m] -= a[i][k] * a[m][k];
        v[i] -= v[k] * a[i][k];
        s[i] += a[i][k] * x;
      }
    }
    __syncwarp();  // the panel is read; overwrite it
#pragma unroll
    for (int k = 0; k < kPw; ++k) {
      const int q = j0 + k;
      if (q < pw && lane < pw) own[q] = q <= lane ? v[k] : s[k];
      if (q == lane && q < pw) dx[q] = s[k];
      xt[lane * kTld + q] = lane < pw && q < pw ? s[k] : T(0);
    }
    __syncwarp();
    // the 8 x 8 blocks of rows r0 = j0 + kPw (1 + I), I < m: the trailing
    // lower triangle, tiles (I, J <= I); the partial sums of the columns
    // c0 = kPw e (e <= j). Every slot loads and multiplies (rows clamped
    // into the block) before any stores, so that their loads and products
    // overlap; a slot past the block's tiles stores nothing
    const int j = j0 / kPw, m = (kSub - j0) / kPw - 1;
    // partial-sum slot u: columns kPw e, rows j0 + kPw (1 + I); used if
    // e <= j and I < m
    const auto slot = [&](int u, int& e, int& I) {
      e = j == 0 ? 0 : (j == 1 ? u & 1 : u);
      I = j == 0 ? u : (j == 1 ? u >> 1 : 0);
    };
    if (m > 0) {
      T tr[6][1][1][2], iv[4][1][1][2];
#pragma unroll
      for (int u = 0; u < 6; ++u) {
        const int I = (u >= 1) + (u >= 3), J = u - I * (I + 1) / 2;
        const int r0 = j0 + kPw * (1 + min(I, m - 1));
        const int c0 = j0 + kPw * (1 + min(J, m - 1));
        tr[u][0][0][0] = D[(r0 + g) * kLd + c0 + t2];
        tr[u][0][0][1] = D[(r0 + g) * kLd + c0 + t2 + 1];
        mma8(tr[u], [&](int r, int k) { return -D[(r0 + r) * kLd + j0 + k]; },
             [&](int c, int k) { return D[(c0 + c) * kLd + j0 + k]; }, lane);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        int e, I;
        slot(u, e, I);
        const int c0 = kPw * e, r0 = j0 + kPw * (1 + min(I, m - 1));
        iv[u][0][0][0] = e < j ? D[(c0 + g) * kLd + r0 + t2] : T(0);
        iv[u][0][0][1] = e < j ? D[(c0 + g) * kLd + r0 + t2 + 1] : T(0);
        mma8(iv[u], [&](int c, int k) { return xt[(c0 + c) * kTld + j0 + k]; },
             [&](int r, int k) { return D[(r0 + r) * kLd + j0 + k]; }, lane);
      }
      __syncwarp();  // every slot has read; write
#pragma unroll
      for (int u = 0; u < 6; ++u) {
        const int I = (u >= 1) + (u >= 3), J = u - I * (I + 1) / 2;
        const int r = j0 + kPw * (1 + I) + g, c = j0 + kPw * (1 + J) + t2;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (I < m && r < pw && c + h < pw && c + h <= r)
            D[r * kLd + c + h] = tr[u][0][0][h];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        int e, I;
        slot(u, e, I);
        const int c = kPw * e + g, r = j0 + kPw * (1 + I) + t2;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (e <= j && I < m && c < pw && r + h < pw)
            D[c * kLd + r + h] = iv[u][0][0][h];
      }
    }
    __syncwarp();
  }
}

// One CTA per (panel, batch item) factors and inverts the diagonal tile
// in shared memory (A, row stride kLd: L on and below the diagonal, X^T
// = Linv^T strictly above it, the stored layout; dxs the diagonal of X),
// by sub-blocks of kSub columns, right-looking, as chol_block_kernel
// (bucket_factor.cu) does a panel. First, warps 1-7 load the tile's lower
// triangle and the first 32 columns of step k - 1's x by cp.async at
// once, the rest of x double-buffered beside the products of that step's
// update, while warp 0 warms the instruction cache with diag_chol_inv;
// then warp 0 factors and inverts diagonal block 0 (diag_chol_inv, X_0^T
// also dense into a buffer of its own). Per sub-block p: the rows below
// it are multiplied by that inverse, one warp per 32-row block; then, at
// once, warp 0 updates the next diagonal block and factors it (one step
// of look-ahead), warps of the three other schedulers update the rest of
// the trailing lower triangle, warps 7, 6, 5 carry the inverse forward,
// right-looking: block row p of X^T is finished from the partial sums
// T^T that earlier steps left in its place, X^T[j][p] = -T^T[j][p]
// X_p^T, then folded into the partial sums of the later blocks, T^T[j][i]
// += X^T[j][p] L[i][p]^T; and warp 4 (at the last sub-block warps 0-4)
// writes the finished column block p - 1 back. Every product is a warp's
// 32 x 32 block on the f64 tensor cores (mma32w: mma.m16n8k4). Two
// barriers a sub-block.
template <typename T>
__global__ void __launch_bounds__(kTileCta)
    wide_tile_kernel(T* data, int64_t bstride, T* xk, const int64_t* off,
                     const int64_t* cols, int cp, int k0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const warm = reinterpret_cast<T*>(smem_raw);  // kSub x kTld
  T* const A = warm + kSub * kTld;                 // kNb x kLd
  T* const dxs = A + kNb * kLd;                    // kNb
  T* const xs = dxs + kNb;                         // 2 x kNb x kTld
  // step k - 1's update grid may start beside this tile (its launch is
  // programmatic on this one's)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int64_t i = blockIdx.x, B = gridDim.x;
  const int64_t ld = cp;
  T* const P = data + (int64_t)blockIdx.y * bstride + off[i] + k0 * ld + k0;
  T* const Xk = xk_tile(xk, k0, blockIdx.y, B, i);
  const int w = tile_width(cols[i], k0), nbs = (w + kSub - 1) / kSub;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kv = 16 / sizeof(T);
  const bool vec = aligned16(P);
  for (int t = tid; t < kNb; t += kTileCta) dxs[t] = T(0);
  if (warp == 0) {
    // while warps 1-7 load the tile and apply step k - 1's update, warp 0
    // runs diag_chol_inv once on a block of one column (its reads from
    // anywhere in A, its writes into `warm` alone), so that the routine's
    // code is in the SM's instruction cache when the tile needs it
    if (nbs > 0) diag_chol_inv(warm, warm + kSub * kTld - 1, warm, 1);
  } else {
    const int wt = tid - 32;  // warps 1-7
    // the lower triangle of the real rows, zeros elsewhere
    if (vec) {
      for (int e = wt; e < kNb * kNb / kv; e += kWorkers) {
        const int r = e / (kNb / kv), c = e % (kNb / kv) * kv;
        const int n = r < w ? min(max(r - c + 1, 0), kv) : 0;
        cp_async16(A + r * kLd + c, n ? P + r * ld + c : P,
                   n * (int)sizeof(T));
      }
    } else {
      for (int e = wt; e < kNb * kNb; e += kWorkers) {
        const int r = e / kNb, c = e % kNb;
        const bool ok = r < w && c <= r;
        cp_async_el(A + r * kLd + c, ok ? P + r * ld + c : P,
                    ok ? (int)sizeof(T) : 0);
      }
    }
    // the update of step k - 1 on this tile, which that step's update grid
    // leaves to it: A[I][J] -= x_I x_J^T over the previous block's
    // columns, the 10 lower 32 x 32 blocks (tile t = warp - 1, and warps
    // 4, 1, 2 the last three: three a scheduler at most), 32 columns at a
    // time in order, as the update grid sums; x double-buffered, its
    // first 32 columns loaded with the tile
    const bool pre = k0 > 0 && w > 0;
    const auto stage = [&](int ci) {
      stage_rows(xs + (ci & 1) * kNb * kTld, kTld,
                 [&](int r) -> const T* {
                   return r < w ? P + r * ld - kNb : nullptr;
                 },
                 kNb, kTk, ci * kTk, vec, P, wt, kWorkers);
    };
    if (pre) stage(0);
    cp_async_commit();
    const int t1 = warp == 4 ? 7 : (warp == 1 ? 8 : (warp == 2 ? 9 : -1));
    if (pre) {
      T acc[2][2][4][4] = {};
      constexpr int nchunk = kNb / kTk;
      for (int ci = 0; ci < nchunk; ++ci) {
        if (ci + 1 < nchunk) {
          stage(ci + 1);  // its buffer was last read in chunk ci - 1
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        sync_workers();
        const T* const b = xs + (ci & 1) * kNb * kTld;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h == 1 && t1 < 0) break;
          int I, J;
          tri_tile(h ? t1 : warp - 1, I, J);
          const T* xi = b + I * kSub * kTld;
          const T* xj = b + J * kSub * kTld;
          mma32w(acc[h], [&](int r, int k) { return xi[r * kTld + k]; },
                 [&](int c, int k) { return xj[c * kTld + k]; }, lane);
        }
        if (ci + 1 < nchunk) sync_workers();  // chunk ci's buffer is reused
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && t1 < 0) break;
        int I, J;
        tri_tile(h ? t1 : warp - 1, I, J);
        T* blk = A + I * kSub * kLd + J * kSub;
        acc_each_w(acc[h], lane, [&](T& v, int r, int c) {
          v = blk[r * kLd + c] - v;
        });
        acc_each_w(acc[h], lane, [&](T& v, int r, int c) {
          blk[r * kLd + c] = v;
        });
      }
    } else {
      cp_async_wait<0>();
    }
  }
  __syncthreads();

  // X_p^T of diagonal block p, dense (1 / diag L on its diagonal, zero
  // below), row stride kTld: two buffers by p's parity in the first x
  // stage, free once the update above is done
  const auto xd = [&](int p) { return xs + (p & 1) * kSub * kTld; };
  // warp 0: diagonal block p factored and inverted in place
  const auto factor_diag = [&](int p) {
    const int p0 = p * kSub;
    __syncwarp();
    diag_chol_inv(A + p0 * kLd + p0, dxs + p0, xd(p), min(kSub, w - p0));
  };
  // column blocks [c0, c1) written back, by the threads [t0, t0 + nt): the
  // panel's in the stored layout, 16 bytes at a time where it allows, and
  // the dense Linv^T (1 / diag L on the diagonal, zero below) into Xk
  using V = typename std::conditional<sizeof(T) == 8, double2, float4>::type;
  const auto store = [&](int c0, int c1, int t0, int nt) {
    const int per = (c1 - c0) / kv;
    for (int e = tid - t0; e < kNb * per; e += nt) {
      const int r = e / per, c = c0 + e % per * kv;
      V a = *reinterpret_cast<const V*>(A + r * kLd + c);
      if (vec) {
        *reinterpret_cast<V*>(P + r * ld + c) = a;
      } else {
        const T* av = reinterpret_cast<const T*>(&a);
#pragma unroll
        for (int u = 0; u < kv; ++u) P[r * ld + c + u] = av[u];
      }
      T* xv = reinterpret_cast<T*>(&a);
#pragma unroll
      for (int u = 0; u < kv; ++u)
        xv[u] = r < c + u ? xv[u] : (r == c + u ? dxs[r] : T(0));
      *reinterpret_cast<V*>(Xk + r * kNb + c) = a;
    }
  };
  if (warp == 0 && nbs > 0) factor_diag(0);
  __syncthreads();
  for (int p = 0; p < nbs; ++p) {
    const int p0 = p * kSub, m = nbs - p - 1;
    // the rows below, in place: x[r][c] = sum_{k <= c} a[r][k] X[c][k]
    if (warp < m) {
      T* a = A + (p0 + kSub * (warp + 1)) * kLd + p0;
      const T* const xp = xd(p);
      T acc[2][4][4] = {};
      mma32w(acc, [&](int r, int k) { return a[r * kLd + k]; },
             [&](int c, int k) { return xp[k * kTld + c]; }, lane);
      __syncwarp();  // the warp's rows are read; overwrite them
      acc_each_w(acc, lane, [&](T& v, int r, int c) { a[r * kLd + c] = v; });
    }
    __syncthreads();
    // the trailing lower triangle: A[I][J] -= x_I x_J^T by 32 x 32 tiles;
    // warp 0 updates tile (0, 0), the next diagonal block, and factors it
    const int q0 = p0 + kSub;
    const auto update = [&](int t) {
      int I, J;
      tri_tile(t, I, J);
      T* tile = A + (q0 + I * kSub) * kLd + q0 + J * kSub;
      const T* xi = A + (q0 + I * kSub) * kLd + p0;
      const T* xj = A + (q0 + J * kSub) * kLd + p0;
      T acc[2][4][4] = {};
      mma32w(acc, [&](int r, int k) { return xi[r * kLd + k]; },
             [&](int c, int k) { return xj[c * kLd + k]; }, lane);
      acc_each_w(acc, lane,
                 [&](T& v, int r, int c) { v = tile[r * kLd + c] - v; });
      acc_each_w(acc, lane,
                 [&](T& v, int r, int c) { tile[r * kLd + c] = v; });
    };
    // the inverse, right-looking, on warps 7, 6, 5 (none of them a
    // trailing update's at the same step): task j <= p finalises
    // X^T[j][p] = -T^T[j][p] X_p^T (j < p), then adds X^T[j][p] L[i][p]^T
    // into T^T[j][i] for the later blocks i (the first, at p = j, writes)
    const T* const xp = xd(p);  // X_p^T, dense
    const auto inverse = [&](int j) {
      T* xt = A + j * kSub * kLd + p0;  // block (j, p) of X^T
      if (j < p) {
        T acc[2][4][4] = {};
        mma32w(acc, [&](int c, int q) { return xt[c * kLd + q]; },
               [&](int r, int q) { return xp[q * kTld + r]; }, lane);
        __syncwarp();  // the block is read; overwrite it
        acc_each_w(acc, lane,
                   [&](T& v, int c, int r) { xt[c * kLd + r] = -v; });
        __syncwarp();
      }
      for (int bi = p + 1; bi < nbs; ++bi) {
        T* dst = A + j * kSub * kLd + bi * kSub;
        const T* li = A + bi * kSub * kLd + p0;
        T acc[2][4][4] = {};
        if (j < p)
          mma32w(acc, [&](int c, int q) { return xt[c * kLd + q]; },
                 [&](int r, int q) { return li[r * kLd + q]; }, lane);
        else
          mma32w(acc, [&](int c, int q) { return xp[c * kTld + q]; },
                 [&](int r, int q) { return li[r * kLd + q]; }, lane);
        if (j < p)
          acc_each_w(acc, lane,
                     [&](T& v, int c, int r) { v += dst[c * kLd + r]; });
        acc_each_w(acc, lane,
                   [&](T& v, int c, int r) { dst[c * kLd + r] = v; });
      }
    };
    if (m == 0 && warp < 5) {  // the last sub-block: warps 0-4 are free
      if (p > 0) store(p0 - kSub, p0, 0, 5 * 32);
    } else if (warp == 0) {
      update(0);
      factor_diag(p + 1);
    } else if (warp >= 5 && 7 - warp <= p) {
      inverse(7 - warp);
    } else if (warp & 3) {  // the warps of the other three schedulers
      const int u = warp - 1 - (warp >> 2);  // 0..5
      for (int t = 1 + u; t < m * (m + 1) / 2; t += kTileWarps - 2)
        update(t);
    } else if (p > 0) {  // warp 4: column block p - 1 is finished
      store(p0 - kSub, p0, 4 * 32, 32);
    }
    __syncthreads();
  }
  // the rest: the last sub-block's columns and the padding's
  store(max(nbs - 1, 0) * kSub, kNb, 0, kTileCta);
}

// The rows of step k (see the header), one CTA per (panel, job, batch
// item): out = a . X_k^T, 32 rows a of columns k0..k1, in place. Per
// panel, jobs [0, nd) are the trailing diagonal rows k1 + 32 j, [nd, nd +
// nbl) the below rows (out = x), [nd + nbl, nd + nbl + k0 / 32) the rows
// 32 j of X^T, whose columns k0..k1 hold T^T = (L[k, :k0] X[:k0, :k0])^T
// as the update grids of earlier steps summed it (out = -X^T[rows,
// k0:k1]). All warps stage, warps 0-3 own the outputs' 32-column blocks:
// 32-row jobs spread a step's rows over twice as many SMs as 64-row ones.
// Shared memory: As (32 x kLd, the rows) and Xs (kNb x kLd: X_k^T,
// 1 / diag L on its diagonal, zero below, from the tile's dense copy).
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    wide_rows_kernel(T* data, int64_t bstride, const T* xk,
                     const int64_t* off, const int64_t* rows,
                     const int64_t* cols, int64_t B, int cp, int rp, int k0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const As = reinterpret_cast<T*>(smem_raw);
  T* const Xs = As + kRows * kLd;
  const int k1 = k0 + kNb;
  const int nd = (cp - k1) / kRows, nbl = (rp + kRows - 1) / kRows;
  const int jobs = nd + nbl + k0 / kRows;
  const int64_t i = blockIdx.x / jobs, z = blockIdx.y;
  const int j = blockIdx.x % jobs;
  T* const P = data + z * bstride + off[i];
  const T* const Xk = xk_tile(xk, k0, z, B, i);
  const int n = (int)cols[i], nr = (int)rows[i], w = tile_width(n, k0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t ld = cp;
  const bool inv = j >= nd + nbl;
  int r0, cnt;  // the block's first panel row, its real rows
  if (j < nd) {
    r0 = k1 + j * kRows;
    cnt = min(kRows, n - r0);
  } else if (!inv) {
    r0 = cp + (j - nd) * kRows;
    cnt = min(kRows, nr - (j - nd) * kRows);
  } else {
    r0 = (j - nd - nbl) * kRows;
    cnt = kRows;
    if (w == 0) {  // block row k is padding: its X^T block is zero
      for (int t = tid; t < kRows * kNb; t += kRowThreads)
        P[(r0 + t / kNb) * ld + k0 + t % kNb] = T(0);
      return;
    }
  }
  if (cnt <= 0 || w == 0) return;  // padding rows or columns: left as is
  stage_rows(As, kLd,
             [&](int r) -> const T* {
               return r < cnt ? P + (r0 + r) * ld + k0 : nullptr;
             },
             kRows, kNb, 0, aligned16(P), P, tid, kRowThreads);
  // X_k^T, as the tile wrote it: Xs[m][c] = X_k[c][m]
  stage_rows(Xs, kLd, [&](int m) -> const T* { return Xk + m * kNb; }, kNb,
             kNb, 0, true, Xk, tid, kRowThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // out[r][c] = sum_{m < w} As[r][m] X_k[c][m], by 32 columns in order;
  // warp w the columns 32 w..
  if (warp >= 4) return;
  T acc[4][4][2] = {};
  const T* b = Xs + warp * 32;
  for (int m0 = 0; m0 < w; m0 += kTk)
    mma32(acc, [&](int r, int k) { return As[r * kLd + m0 + k]; },
          [&](int c, int k) { return b[(m0 + k) * kLd + c]; }, lane);
  acc_each(acc, lane, [&](T& v, int r, int c) {
    if (r < cnt) P[(r0 + r) * ld + k0 + warp * 32 + c] = inv ? -v : v;
  });
}

// The update of step k, one CTA per (panel, 64 x 64 tile, batch item), K
// = the w real columns of block k, in 32-column cp.async stages,
// double-buffered. In the trailing row space (panel row k1 + r, x = its
// columns k0..k1), per panel, with m = (cp - k1) / 64:
//   tiles [0, m (m + 1) / 2)   the trailing lower tile triangle
//                              (tri_tile): C[r][c] -= x_r . x_c on real
//                              lower elements;
//   then ceil(rp / 64) m       the below rows' tiles against the trailing
//                              columns, row by row: the same, real rows;
//   then (k1 / 64) m           the inverse's partial sums, stored
//                              transposed above the diagonal: T^T[c][r]
//                              (+)= X^T[c][k0..k1] . x_r for the rows c <
//                              k1 (X^T of block k: the rows grid's output
//                              above the tile, the tile's own below its
//                              end) and the trailing rows r of the real
//                              128-column blocks; the first step that
//                              reaches T^T[c] (c in block k) writes it.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    wide_update_kernel(T* data, int64_t bstride, const T* xk,
                       const int64_t* off, const int64_t* rows,
                       const int64_t* cols, int64_t B, int cp, int rp,
                       int k0) {
  // this grid starts beside tile k + 1's (programmatic launch); its last
  // CTA waits for that grid, so that the next step's rows grid, which
  // waits for this one, finds tile k + 1 done
  if (blockIdx.x == gridDim.x - 1 && blockIdx.y == gridDim.y - 1)
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);  // two stages of 128 rows
  const T** const rs =
      reinterpret_cast<const T**>(sm + 2 * 2 * kTile * kTld);  // 128 rows
  const int k1 = k0 + kNb;
  const int m = (cp - k1) / kTile, tri = m * (m + 1) / 2;
  const int below_end = tri + (rp + kTile - 1) / kTile * m;
  const int per = below_end + k1 / kTile * m;
  const int64_t i = blockIdx.x / per, z = blockIdx.y;
  const int t = blockIdx.x % per;
  const int kind = t < tri ? 0 : (t < below_end ? 1 : 2);
  int I, J;
  if (kind == 0) {
    tri_tile(t, I, J);
  } else {
    I = (kind == 1 ? m : 0) + (t - (kind == 1 ? tri : below_end)) / m;
    J = (t - (kind == 1 ? tri : below_end)) % m;
  }
  const int n = (int)cols[i], nr = (int)rows[i], w = tile_width(n, k0);
  const int nd = n - k1;  // real trailing diagonal rows and columns
  const int nx = m * kTile + nr;  // the trailing rows held in memory
  const int r0 = I * kTile, c0 = J * kTile;
  // uniform over the CTA: no real column, or no real row, or a part of
  // tile k + 1 (which updates itself)
  if (w == 0 || (kind == 2 ? c0 >= (n + kNb - 1) / kNb * kNb - k1
                           : c0 >= nd || (kind == 1 ? r0 - m * kTile >= nr
                                                    : r0 >= nd)) ||
      (kind == 0 && r0 < kNb))
    return;
  T* const P = data + z * bstride + off[i];
  const T* const Xk = xk_tile(xk, k0, z, B, i);
  const T* const X = P + (int64_t)k1 * cp + k0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nchunk = (w + kTk - 1) / kTk;
  const bool vec = aligned16(P);
  // the staged rows' sources: 0..63 x rows r0.. (or X^T rows r0.., the
  // tile's own from its dense copy), 64..127 x rows c0..; null: zeros
  {
    const int r = tid;
    const T* src;
    if (kind == 2 && r < kTile) {
      const int c = r0 + r;
      src = c < k0 ? P + (int64_t)c * cp + k0 : Xk + (c - k0) * kNb;
    } else {
      const int R = r < kTile ? r0 + r : c0 + r - kTile;
      src = R < nx ? X + (int64_t)R * cp : nullptr;
    }
    rs[r] = src;
  }
  __syncthreads();
  const auto stage = [&](int ci) {
    T* b = sm + (ci & 1) * 2 * kTile * kTld;
    stage_rows(b, kTld, [&](int r) { return rs[r]; }, 2 * kTile, kTk,
               ci * kTk, vec, P, tid, kTileThreads);
    cp_async_commit();
  };
  // the outputs' old values, for the update (kind 2: unless this step
  // writes the partial sums first), into the stage buffer the last chunk
  // does not use, while that chunk loads and multiplies
  constexpr int kCld = 2 * kTld;  // 64 x kCld fills a stage buffer
  T* const o = kind == 2 ? P + (int64_t)r0 * cp + k1 + c0
                         : P + (int64_t)(k1 + r0) * cp + k1 + c0;
  const bool rmw = kind != 2 || r0 < k0;
  T acc[4][4][2] = {};
  stage(0);
  for (int ci = 0; ci < nchunk; ++ci) {
    if (ci + 1 < nchunk) {
      stage(ci + 1);  // its buffer was last read in chunk ci - 1
      cp_async_wait<1>();
    } else {
      if (rmw) {
        stage_rows(sm + ((ci + 1) & 1) * 2 * kTile * kTld, kCld,
                   [&](int r) -> const T* {
                     return kind != 2 && r0 + r >= nx ? nullptr
                                                      : o + (int64_t)r * cp;
                   },
                   kTile, kTile, 0, vec, P, tid, kTileThreads);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    }
    __syncthreads();
    const T* a = sm + (ci & 1) * 2 * kTile * kTld + (warp >> 1) * 32 * kTld;
    const T* b = sm + (ci & 1) * 2 * kTile * kTld +
                 (kTile + (warp & 1) * 32) * kTld;
    mma32(acc, [&](int r, int k) { return a[r * kTld + k]; },
          [&](int c, int k) { return b[c * kTld + k]; }, lane);
    if (ci + 1 < nchunk) __syncthreads();  // chunk ci's buffer may be refilled
  }
  cp_async_wait<0>();
  __syncthreads();
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
  const T* const old = sm + (nchunk & 1) * 2 * kTile * kTld;
  if (kind == 2) {
    acc_each(acc, lane, [&](T& v, int r, int c) {
      if (rmw) v += old[(wr + r) * kCld + wc + c];
      o[(int64_t)(wr + r) * cp + wc + c] = v;
    });
  } else {
    acc_each(acc, lane, [&](T& v, int r, int c) {
      const int R = r0 + wr + r, C = c0 + wc + c;
      if (C < nd && (kind == 1 ? R - m * kTile < nr : (R < nd && C <= R)))
        o[(int64_t)(wr + r) * cp + wc + c] = old[(wr + r) * kCld + wc + c] - v;
    });
  }
}

template <typename T>
int launch(void* data, int64_t bstride, void* xk, const int64_t* off,
           const int64_t* rows, const int64_t* cols, int64_t B, int cp,
           int rp, int batch, cudaStream_t stream) {
  if (cp % kNb || cp <= 4 * kNb) return (int)cudaErrorInvalidValue;
  T* d = static_cast<T*>(data);
  T* x = static_cast<T*>(xk);
  const int tile_smem = (int)(((size_t)kSub * kTld + (size_t)kNb * kLd + kNb +
                                2 * (size_t)kNb * kTld) *
                               sizeof(T));
  const int rows_smem =
      (int)(((size_t)kRows * kLd + (size_t)kNb * kLd) * sizeof(T));
  const int upd_smem =
      (int)(2 * 2 * kTile * kTld * sizeof(T) + 2 * kTile * sizeof(void*));
  cudaError_t e = cudaFuncSetAttribute(
      wide_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tile_smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wide_rows_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             rows_smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wide_update_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             upd_smem);
  if (e != cudaSuccess) return (int)e;
  const int nbl = (rp + kRows - 1) / kRows;
  const auto tile = [&](int k0) {
    wide_tile_kernel<T><<<dim3((unsigned)B, batch), kTileCta, tile_smem,
                          stream>>>(d, bstride, x, off, cols, cp, k0);
  };
  const auto rows_grid = [&](int k0) {
    const int jobs = (cp - k0 - kNb) / kRows + nbl + k0 / kRows;  // > 0
    wide_rows_kernel<T><<<dim3((unsigned)(B * jobs), batch), kRowThreads,
                          rows_smem, stream>>>(d, bstride, x, off, rows,
                                               cols, B, cp, rp, k0);
  };
  // per step: the rows grid, then tile k + 1 (which applies step k's
  // update to itself), then step k's update grid, launched programmatically
  // on the tile so that it fills the card beside the tile's CTAs
  tile(0);
  for (int k0 = 0; k0 < cp; k0 += kNb) {
    const int k1 = k0 + kNb;
    rows_grid(k0);
    if (k1 < cp) {
      tile(k1);
      const int m = (cp - k1) / kTile;
      const int per = m * (m + 1) / 2 + (rp + kTile - 1) / kTile * m +
                      k1 / kTile * m;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3((unsigned)(B * per), batch);
      cfg.blockDim = dim3(kTileThreads);
      cfg.dynamicSmemBytes = upd_smem;
      cfg.stream = stream;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
      attr[0].val.programmaticStreamSerializationAllowed = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      e = cudaLaunchKernelEx(&cfg, wide_update_kernel<T>, d, bstride,
                             static_cast<const T*>(x), off, rows, cols, B,
                             cp, rp, k0);
      if (e != cudaSuccess) return (int)e;
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// dtype: 0 float32, 1 float64; xk a scratch of 2 x batch x B x 128 x 128
// values (16-byte aligned).
// Launches 3 cp / 128 - 1 grids; returns the first cudaError_t.
extern "C" int bs_wide_factor(int dtype, void* data, int64_t bstride,
                              void* xk, const int64_t* off,
                              const int64_t* rows, const int64_t* cols,
                              int64_t B, int cp, int rp, int batch,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(data, bstride, xk, off, rows, cols, B, cp, rp,
                         batch, s);
  if (dtype == 1)
    return launch<double>(data, bstride, xk, off, rows, cols, B, cp, rp,
                          batch, s);
  return (int)cudaErrorInvalidValue;
}
