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
// Three grids, launched back to back on the current stream:
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
//   below       one CTA per (panel, chunk of below rows, batch item): the
//               chunk is staged in shared memory so the product can
//               overwrite it in place (bound by reads of the stored Linv);
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
// Bounds (H100, f64): chol and below are latency chains on one SM per
// panel (a few panels per level); prod on BAL 871's pair levels (rp 3,072
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

template <typename T>
__global__ void below_kernel(T* data, int64_t data_bstride,
                             const int64_t* off, const int64_t* rows,
                             const int64_t* cols, int cp, int rb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sb = reinterpret_cast<T*>(smem_raw);
  T* P = data + (int64_t)blockIdx.z * data_bstride + off[blockIdx.x];
  T* below = P + (int64_t)cp * cp;
  const int n = (int)cols[blockIdx.x];
  const int r0 = blockIdx.y * rb;
  const int nr = min(rb, (int)rows[blockIdx.x] - r0);
  if (nr <= 0) return;  // uniform over the CTA
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t ld = cp;
  for (int t = tid; t < nr * n; t += nt) {
    const int r = t / n, k = t % n;
    sb[t] = below[(r0 + r) * ld + k];
  }
  __syncthreads();
  // x[r][j] = sum_{k <= j} below[r][k] * Linv[j][k]
  for (int t = tid; t < nr * n; t += nt) {
    const int r = t / n, j = t % n;
    const T* br = sb + r * n;
    T acc = br[j] / P[j * ld + j];
    for (int k = 0; k < j; ++k) acc += br[k] * P[k * ld + j];
    below[(r0 + r) * ld + j] = acc;
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
    int rb = 32768 / (cp * (int)sizeof(T));
    rb = rb < 1 ? 1 : (rb > rp ? rp : rb);
    below_kernel<T><<<dim3((unsigned)B, (rp + rb - 1) / rb, batch), 256,
                      rb * cp * sizeof(T), stream>>>(d, data_bstride, off,
                                                     rows, cols, cp, rb);
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
        cudaError_t e = cudaFuncSetAttribute(
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
